"""Plain PyTorch version of the Matern covariance kernel."""

from __future__ import annotations

import torch

from ...covariance.matern import (HALF_INTEGER_NUS, _matern_half_integer,
                                  matern_covariance, pairwise_distance)

ROWS = 4096  # rows per step of matern_cov_tiles
GRAD_ROWS = 1024  # rows per step of matern_cov_grad (~9 temporaries a row)
# G elements per step of the tile-stack backward: whole tiles up to 2^24
# (~1.2 GB of fp64 temporaries), 16 tiles of 1,024^2 where one a step took
# 1,596 steps of a few elementwise launches each for the panel's off-band
GRAD_ELEMS = 1 << 24


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


def _grad_acc(locs_a, locs_b, th, g, nu, metric):
    """The two sums of `matern_cov_grad` over a stack of tiles, before the
    theta1 / theta2 factor: locs_a (B, m, 2), locs_b (B, n, 2), G (B, m, n)
    in a tile's storage dtype.  G is read in the locations' precision (a
    bf16 or fp32 G is exact there) and the products summed in fp64, GRAD_ROWS
    rows of one tile at a time, or as many whole tiles as make GRAD_ELEMS
    elements."""
    b, m, n = g.shape
    acc = torch.zeros(2, dtype=torch.float64, device=locs_a.device)
    tiles = max(1, GRAD_ELEMS // (m * n)) if b > 1 else 1
    for b0 in range(0, b, tiles):
        bs = slice(b0, b0 + tiles)
        for r0 in range(0, m, GRAD_ROWS):
            rows = slice(r0, r0 + GRAD_ROWS)
            r = pairwise_distance(locs_a[bs, rows], locs_b[bs], metric=metric)
            x = r / th[1]
            at0 = r == 0.0
            corr = torch.where(at0, 1.0, _matern_half_integer(x, nu))
            term = torch.where(at0, 0.0, _grad_terms(x, nu))
            gr = g[bs, rows].to(th.dtype).to(torch.float64)
            acc += torch.stack([torch.sum(gr * corr.double()),
                                torch.sum(gr * term.double())])
    return acc


def _grad_finish(acc, th):
    """acc with its second sum times theta1 / theta2 (fp64)."""
    th64 = th[:2].double()
    acc[1] *= th64[0] / th64[1]
    return acc


def _check_nu(nu):
    if nu not in HALF_INTEGER_NUS:
        raise ValueError(f"matern_cov_grad: nu={nu} has no closed form")


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
    _check_nu(nu)
    th = _theta(theta, nu, locs_a)
    acc = _grad_acc(locs_a[None], locs_b[None], th, grad_out[None], nu, metric)
    return _grad_finish(acc, th).to(th.dtype)


def matern_cov_grad_tiles(locs_i, locs_j, theta, grad_tiles, *, nu,
                          metric="euclidean"):
    """The backward of `matern_cov_tiles` in (theta1, theta2): sum over b of
    sum G_b dC(locs_i[b], locs_j[b])/dtheta, G = grad_tiles (B, rows, cols)
    in a tile's storage dtype (bf16, fp32 or fp64; any tile stride).  Each
    term as `matern_cov_grad` computes it; a (2,) fp64 tensor, the sums
    across tiles kept in fp64."""
    _check_nu(nu)
    th = _theta(theta, nu, locs_i)
    return _grad_finish(_grad_acc(locs_i, locs_j, th, grad_tiles, nu, metric),
                        th)


def matern_cov_grad_lower(locs_t, theta, grad_off, *, nu, min_lag,
                          metric="euclidean"):
    """The backward of `matern_cov_lower` in (theta1, theta2): the sum over
    its computed tiles (i, j), i - j >= min_lag, of sum G_ij dC(locs_t[i],
    locs_t[j])/dtheta, G = grad_off (p, p, nb, nb) in the off-band's storage
    dtype; the other tiles are not read.  A (2,) fp64 tensor, one tile row
    at a time."""
    _check_nu(nu)
    th = _theta(theta, nu, locs_t)
    p = locs_t.shape[0]
    acc = torch.zeros(2, dtype=torch.float64, device=locs_t.device)
    for i in range(min_lag, p):
        cols = i - min_lag + 1
        acc += _grad_acc(locs_t[i].expand(cols, -1, -1), locs_t[:cols], th,
                         grad_off[i, :cols], nu, metric)
    return _grad_finish(acc, th)
