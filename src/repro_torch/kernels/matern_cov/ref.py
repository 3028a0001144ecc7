"""Plain PyTorch version of the Matern covariance kernel."""

from __future__ import annotations

import torch

from ...covariance.matern import HALF_INTEGER_NUS, matern_covariance

ROWS = 4096  # rows per step of matern_cov_tiles


def _theta(theta, nu, like):
    """theta in the locations' precision: fp64 for fp64 locations, else fp32
    (what the kernel's float launch arguments hold)."""
    th = [float(v) for v in theta[:2]]
    dtype = torch.promote_types(like.dtype, torch.float32)
    return torch.tensor(th + [float(nu)], dtype=dtype, device=like.device)


def _cov(locs_a, locs_b, theta, nu, metric):
    nu_static = nu if nu in HALF_INTEGER_NUS else None
    return matern_covariance(locs_a, locs_b, _theta(theta, nu, locs_a),
                             nu_static=nu_static, metric=metric)


def matern_cov_tiles(locs_i, locs_j, theta, *, nu, out_dtype=torch.float32,
                     metric="euclidean", out=None):
    """(B, rows, 2) x (B, cols, 2) -> (B, rows, cols): tile b = C(locs_i[b], locs_j[b]).

    Built ROWS rows of the tiles at a time: the distance temporaries of a
    whole 40,960^2 fp64 tile would be 5x its 13.4 GB."""
    if out is None:
        out = torch.empty(locs_i.shape[:2] + locs_j.shape[1:2], dtype=out_dtype,
                          device=locs_i.device)
    for r0 in range(0, locs_i.shape[1], ROWS):
        rows = slice(r0, r0 + ROWS)
        out[:, rows] = _cov(locs_i[:, rows], locs_j, theta, nu, metric).to(out_dtype)
    return out


def matern_cov_lower(locs_t, theta, *, nu, min_lag, out_dtype=torch.float32,
                     metric="euclidean"):
    """(p, nb, 2) -> (p, p, nb, nb): tile (i, j) = C(locs_t[i], locs_t[j])
    where i - j >= min_lag, else 0.  Built one tile row at a time, so the
    distance temporaries stay one row of tiles."""
    p, nb, _ = locs_t.shape
    out = torch.zeros((p, p, nb, nb), dtype=out_dtype, device=locs_t.device)
    for i in range(min_lag, p):
        cols = locs_t[:i - min_lag + 1].reshape(-1, locs_t.shape[-1])
        row = _cov(locs_t[i], cols, theta, nu, metric)           # (nb, J*nb)
        out[i, :i - min_lag + 1] = row.reshape(nb, -1, nb).transpose(0, 1)
    return out


def matern_cov(locs_a, locs_b, theta, *, nu, out_dtype=torch.float32,
               metric="euclidean"):
    """(m, 2) x (n, 2) -> (m, n) covariance."""
    return matern_cov_tiles(locs_a[None], locs_b[None], theta, nu=nu,
                            out_dtype=out_dtype, metric=metric)[0]
