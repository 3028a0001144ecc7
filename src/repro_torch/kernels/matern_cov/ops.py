"""Public Matern covariance functions.

The smoothness picks the path, statically, as in the reference's ops: a
half-integer nu (0.5, 1.5, 2.5) has a closed form, which the CUDA kernel
computes; any other nu needs the Bessel K_nu, whose Temme series and CF2
continued fraction run as the plain elementwise PyTorch of
`covariance/matern.py` on either device (its ~200 fixed-trip-count loop
steps per element are no kernel's job: covariance generation is a small
part of an evaluation).  That choice is made by nu alone and is not a
fallback: for a half-integer nu a CUDA tensor launches the kernel, which
raises on what it does not take (haversine distance, an output wider than
the locations, such as fp64 from fp32 locations).  A CPU tensor always
runs the plain version (ref.py).  theta: (theta1, theta2[, theta3]) as host
numbers; nu is the smoothness, and theta3 is not read.
"""

from __future__ import annotations

import torch

from ...covariance.matern import HALF_INTEGER_NUS
from . import ref
from .matern_cov import launch


def _plain(locs, nu):
    """Whether the plain version computes this call: a CPU tensor, or a
    general nu on either device."""
    return not locs.is_cuda or nu not in HALF_INTEGER_NUS


def matern_cov_tiles(locs_i, locs_j, theta, *, nu, out_dtype=torch.float32,
                     metric="euclidean", out=None):
    """(B, rows, 2) x (B, cols, 2) -> (B, rows, cols): tile b = C(locs_i[b], locs_j[b]).

    `out`, if given, is written and returned: a (B, rows, cols) view whose
    tiles are contiguous (such as a band sub-diagonal band[d:, d]).
    """
    if _plain(locs_i, nu):
        return ref.matern_cov_tiles(locs_i, locs_j, theta, nu=nu,
                                    out_dtype=out_dtype, metric=metric, out=out)
    if out is None:
        out = torch.empty(locs_i.shape[:2] + locs_j.shape[1:2],
                          dtype=out_dtype, device=locs_i.device)
    elif out.dtype != out_dtype:
        raise ValueError(f"out is {out.dtype}, expected {out_dtype}")
    return launch(locs_i, locs_j, theta, nu=nu, out=out, outer=False,
                  metric=metric)


def matern_cov_lower(locs_t, theta, *, nu, min_lag, out_dtype=torch.float32,
                     metric="euclidean"):
    """(p, nb, 2) -> (p, p, nb, nb): tile (i, j) = C(locs_t[i], locs_t[j])
    where i - j >= min_lag, else 0 (the off-band split storage)."""
    if _plain(locs_t, nu):
        return ref.matern_cov_lower(locs_t, theta, nu=nu, min_lag=min_lag,
                                    out_dtype=out_dtype, metric=metric)
    p, nb, _ = locs_t.shape
    out = torch.empty((p, p, nb, nb), dtype=out_dtype, device=locs_t.device)
    return launch(locs_t, locs_t, theta, nu=nu, out=out, outer=True,
                  min_lag=min_lag, metric=metric)


def matern_cov(locs_a, locs_b, theta, *, nu, out_dtype=torch.float32,
               metric="euclidean"):
    """(m, 2) x (n, 2) -> (m, n): the one-tile case of `matern_cov_tiles`."""
    return matern_cov_tiles(locs_a[None], locs_b[None], theta, nu=nu,
                            out_dtype=out_dtype, metric=metric)[0]
