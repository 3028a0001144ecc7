"""Launch wrapper of the CUDA Matern covariance kernel (csrc/matern_cov.cu).

Replaces the Pallas TPU kernel `repro.kernels.matern_cov.matern_cov`.
Euclidean distance with nu in {0.5, 1.5, 2.5}, written directly by the
kernel in one of two precisions: fp32 locations give fp32 or bf16 output
computed in fp32; fp64 locations give fp64 output computed in fp64, or
that value rounded once to fp32 (the panel path's fp32 off-band of the
paper pair).
"""

from __future__ import annotations

import torch

from .. import LAUNCHES
from .._build import check, library

# (locations dtype, out dtype) -> the C entry's `dtypes` code
_DTYPES = {(torch.float32, torch.float32): 0,
           (torch.float32, torch.bfloat16): 1,
           (torch.float64, torch.float64): 2,
           (torch.float64, torch.float32): 3}


def _check_locs(locs, name):
    if not locs.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if locs.ndim != 3 or locs.shape[-1] != 2 or not locs.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (tiles, rows, 2) tensor")


def _two_nu(nu, metric):
    if metric != "euclidean":
        raise NotImplementedError(
            "matern_cov kernel: haversine distance is not ported (ROADMAP)")
    if nu not in (0.5, 1.5, 2.5):
        raise NotImplementedError(
            f"matern_cov kernel: nu={nu} has no closed form (ROADMAP A2)")
    return int(round(2 * nu))


def launch(locs_i, locs_j, theta, *, nu, out, outer, min_lag=0,
           metric="euclidean"):
    """Write Matern covariance tiles into `out` with one kernel launch.

    zip   (outer=False): out[b] = C(locs_i[b], locs_j[b]); `out` is
          (B, rows, cols) with contiguous tiles and any tile stride.
    outer (outer=True):  out[i, j] = C(locs_i[i], locs_j[j]) where
          i - j >= min_lag, else 0; `out` is contiguous (Ti, Tj, rows, cols).
    theta: host floats (theta1, theta2, ...); theta[2] is not read.  The
    kernel computes in the locations' precision, theta rounded to it.
    """
    two_nu = _two_nu(nu, metric)
    dtypes = _DTYPES.get((locs_i.dtype, out.dtype))
    if locs_j.dtype != locs_i.dtype or dtypes is None:
        raise ValueError(
            f"matern_cov kernel: locations {locs_i.dtype}/{locs_j.dtype} with "
            f"out {out.dtype}; it takes fp32 locations with fp32 or bf16 out "
            "and fp64 locations with fp64 or fp32 out")
    _check_locs(locs_i, "locs_i")
    _check_locs(locs_j, "locs_j")
    if out.device != locs_i.device or locs_j.device != locs_i.device:
        raise ValueError("locs_i, locs_j and out must be on one device")
    ti, rows, _ = locs_i.shape
    tj, cols, _ = locs_j.shape
    if outer:
        if out.shape != (ti, tj, rows, cols) or not out.is_contiguous():
            raise ValueError("outer: out must be contiguous (Ti, Tj, rows, cols)")
        n_pairs, n_cols_j, stride = ti * tj, tj, rows * cols
    else:
        if ti != tj or out.shape != (ti, rows, cols):
            raise ValueError("zip: locs_i, locs_j and out need one tile count")
        if out.stride(1) != cols or out.stride(2) != 1:
            raise ValueError("zip: each out tile must be contiguous")
        n_pairs, n_cols_j, stride = ti, 0, out.stride(0)
    if not 0 < n_pairs <= 65535:
        raise ValueError(f"matern_cov kernel: {n_pairs} tiles, at most 65535")
    th1, th2 = float(theta[0]), float(theta[1])
    status = library().matern_cov_launch(
        locs_i.data_ptr(), locs_j.data_ptr(), out.data_ptr(), n_pairs,
        n_cols_j, rows, cols, stride, min_lag, th1, th2, two_nu, dtypes,
        torch.cuda.current_stream(out.device).cuda_stream)
    check(status, "matern_cov")
    LAUNCHES["matern_cov"] += 1
    return out
