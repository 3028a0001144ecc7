"""Plain PyTorch version of the Matern covariance kernel."""

from __future__ import annotations

import torch

from ...covariance.matern import (HALF_INTEGER_NUS, _matern_half_integer,
                                  matern_covariance, pairwise_distance)

ROWS = 4096  # rows per step of matern_cov_tiles
GRAD_ROWS = 1024  # rows per step of matern_cov_grad (~9 temporaries a row)


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


def _grad_terms(x, nu):
    """x g(x) with theta2 dK/dtheta2 = theta1 x g(x), x = r / theta2: the
    derivative of the closed form's correlation in x, times -x."""
    e = torch.exp(-x)
    if nu == 0.5:
        return x * e
    if nu == 1.5:
        return x * (x * e)
    if nu == 2.5:
        return x * (x * (1.0 + x) / 3.0 * e)
    raise ValueError(f"no closed form for nu={nu}")


def matern_cov_grad(locs_a, locs_b, theta, grad_out, *, nu,
                    metric="euclidean"):
    """sum_ij G_ij dK_ij/dtheta_k for k = 1, 2, where K = matern_cov(locs_a,
    locs_b, theta, nu=nu) and G = grad_out (m, n): a (2,) tensor in the
    locations' precision (theta's, as `_theta` rounds it), on their device.

    With x = r / theta2: dK/dtheta1 = corr(x) and dK/dtheta2 = (theta1 /
    theta2) x g(x) (`_grad_terms`), taken as 1 and 0 at r = 0, where the
    forward writes theta1 whatever x is.  theta3 has no gradient: a
    half-integer nu ignores it.  Per-element terms are computed in theta's
    precision, as the forward computes K; the products with G are summed in
    fp64, GRAD_ROWS rows at a time.  r is the forward's distance under
    `metric` (`pairwise_distance`: direct differences for "euclidean", the
    great circle in degrees for "haversine"); it does not depend on theta,
    so only r differs between the metrics."""
    if nu not in HALF_INTEGER_NUS:
        raise ValueError(f"matern_cov_grad: nu={nu} has no closed form")
    th = _theta(theta, nu, locs_a)
    acc = torch.zeros(2, dtype=torch.float64, device=locs_a.device)
    for r0 in range(0, locs_a.shape[0], GRAD_ROWS):
        rows = slice(r0, r0 + GRAD_ROWS)
        r = pairwise_distance(locs_a[rows], locs_b, metric=metric)
        x = r / th[1]
        at0 = r == 0.0
        corr = torch.where(at0, 1.0, _matern_half_integer(x, nu))
        term = torch.where(at0, 0.0, _grad_terms(x, nu))
        g = grad_out[rows].to(torch.float64)
        acc += torch.stack([torch.sum(g * corr.double()),
                            torch.sum(g * term.double())])
    th64 = th[:2].double()
    acc[1] *= th64[0] / th64[1]
    return acc.to(th.dtype)
