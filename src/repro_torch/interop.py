"""Carry the reference's data, precision policies and LM weights into the
port.

The geostatistics path has no weights; a dataset (locations, observations,
generating theta) and a precision policy take their place.  The LM path
takes the reference's `init_lm` param tree, and LM training its whole
train state.  Everything crosses as numpy arrays and dtype names, so
nothing here needs JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.precision import PrecisionPolicy, as_dtype
from .covariance.generator import Dataset


def dataset_from_numpy(locs, z, theta0, metric: str = "euclidean", *,
                       device="cuda") -> Dataset:
    """A Dataset on `device` from numpy-convertible arrays (fp32)."""
    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Dataset(locs=tensor(locs), z=tensor(z), theta0=tensor(theta0),
                   metric=metric)


def policy_from_fields(mode: str, hi: str, lo: str, diag_thick: int,
                       lo2: str | None = None, diag_thick2: int = 0,
                       solve_dtype: str = "float32",
                       accum_dtype: str = "float32") -> PrecisionPolicy:
    """A PrecisionPolicy from the reference policy's fields, dtypes by name
    ("float32", "bfloat16", "float8_e4m3fn", ...)."""
    return PrecisionPolicy(
        mode=mode, hi=as_dtype(hi), lo=as_dtype(lo), diag_thick=diag_thick,
        lo2=None if lo2 is None else as_dtype(lo2), diag_thick2=diag_thick2,
        solve_dtype=as_dtype(solve_dtype), accum_dtype=as_dtype(accum_dtype))


def banded_from_numpy(band, off, *, lo, device="cuda"):
    """(band, off) split storage from numpy-convertible arrays.

    A bf16 array arrives as `ml_dtypes.bfloat16`, which torch.from_numpy
    rejects; it goes through float32, which holds every bf16 value exactly.
    """
    band_t = torch.as_tensor(np.asarray(band), device=device)
    off_t = torch.as_tensor(np.asarray(off, np.float32), device=device)
    return band_t, off_t.to(as_dtype(lo))


def distributed_from_numpy(off, band, *, lo, grid=None, version="masked_full",
                           device="cuda"):
    """The reference distributed engine's (off (n, n), band (p, t, nb,
    nb)) storage as the port's, or this rank's slabs of it on `grid` (see
    `core.distributed.layout`: off's row and column slab, the band tiles of
    the row slab and of each the rank's share of the nb rows): off in `lo`
    through float32 (which holds a bf16 value exactly), band in its own
    dtype."""
    from .core.distributed import layout
    band = np.asarray(band)
    p, _, nb, _ = band.shape
    lay = layout(p, grid, version)
    (ra, rb), (ca, cb) = lay.rows, lay.cols
    s0, s1 = lay.band_rows(nb)
    # copies: the engine factors in place, and a JAX array's numpy view is
    # its own buffer
    off_s = np.array(np.asarray(off, np.float32)[ra * nb:rb * nb, ca * nb:cb * nb])
    off_t = torch.tensor(off_s, device=device)
    return off_t.to(as_dtype(lo)), torch.tensor(band[ra:rb, :, s0:s1],
                                                device=device)


def lm_params_from_numpy(tree, *, device="cuda", dtype=torch.float32):
    """The reference's LM param tree (nested dicts of numpy-convertible
    arrays, e.g. `jax.tree.map(np.asarray, params)`) as the port's: the same
    keys and shapes, each leaf a `dtype` tensor on `device`."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), dtype=dtype,
                        device=device)


def train_state_from_numpy(tree, *, device="cuda"):
    """The reference's train state (params, opt's m, v and step, data_step
    and residual: nested dicts of numpy-convertible arrays, e.g.
    `jax.tree.map(np.asarray, state)`) as the port's: the same keys, shapes
    and dtypes, on `device`.  A bf16 leaf (`ml_dtypes.bfloat16`, which
    torch.from_numpy rejects) goes through float32, which holds it
    exactly."""
    if isinstance(tree, dict):
        return {k: train_state_from_numpy(v, device=device)
                for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.tensor(a.astype(np.float32), device=device)
        return t.to(torch.bfloat16)  # repro: disable=no-implicit-downcast -- a bf16 leaf's own values: exact
    return torch.tensor(a, device=device)


def problem_from_numpy(name: str, n: int, nb: int, regime: str, theta, locs,
                       z, cov, *, device="cuda"):
    """A `verify.CholeskyProblem` on `device` from the reference problem's
    fields (numpy-convertible arrays), bit for bit: locations, z and Sigma
    in fp32, theta as host floats.  The port's generators draw other bits,
    so parity runs on carried problems."""
    from .verify.generators import CholeskyProblem

    def tensor(a):  # a writable copy: the reference's arrays are read-only
        return torch.as_tensor(np.array(a, np.float32), device=device)
    return CholeskyProblem(name=name, n=int(n), nb=int(nb), regime=regime,
                           theta=tuple(float(v) for v in np.asarray(theta)),
                           locs=tensor(locs), z=tensor(z), cov=tensor(cov))
