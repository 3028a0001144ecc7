"""Gaussian log-likelihood evaluation (paper Eqs. 2-3) on tile Cholesky.

Counterpart of `repro.core.likelihood`.  One likelihood evaluation = build
Sigma(theta) from the Matern kernel, factor it with the selected precision
policy, then

  l(theta) = -n/2 log(2 pi) - sum_i log L_ii - 1/2 || L^{-1} Z ||^2 .

The profiled form (Eq. 3) treats theta1 as a multiplicative scale computed
in closed form, leaving a 2-parameter optimization over (theta2, theta3):

  theta1_opt = Z^T SigmaTilde^{-1} Z / n,
  l* = -n/2 log(2 pi) - n/2 - n/2 log(theta1_opt) - log|L-tilde| .

Functions compute on the device of `locs`; theta may be a (3,) vector or a
stacked (..., 3) batch of candidates, on any device.
"""

from __future__ import annotations

import math

import torch

from ..covariance.matern import HALF_INTEGER_NUS, matern_covariance
from ..kernels.matern_cov.ops import MaternCov
from .panel_cholesky import _impl
from .precision import PrecisionPolicy
from .tile_cholesky import dst_cholesky, reference_cholesky, tile_cholesky


def _forward_solve_vec(l, z):
    """w = L^{-1} z with l (..., n, n) and z (n,); returns (..., n)."""
    zb = z.expand(l.shape[:-2] + z.shape[-1:])
    return torch.linalg.solve_triangular(l, zb[..., None], upper=False)[..., 0]


def loglik_from_factor(l, z):
    """Eq. 2 given the lower Cholesky factor of Sigma.

    l may carry leading batch axes (one factor per candidate theta); the
    result then has those batch axes.
    """
    n = z.shape[-1]
    z = z.to(l.dtype)
    diag = torch.diagonal(l, dim1=-2, dim2=-1)
    logdet_half = torch.sum(torch.log(diag), dim=-1)
    w = _forward_solve_vec(l, z)
    quad = torch.sum(w * w, dim=-1)
    return -0.5 * n * math.log(2.0 * math.pi) - logdet_half - 0.5 * quad


def profiled_loglik_from_factor(l, z):
    """Eq. 3: profile out theta1. `l` factors the CORRELATION matrix."""
    n = z.shape[-1]
    z = z.to(l.dtype)
    diag = torch.diagonal(l, dim1=-2, dim2=-1)
    logdet_half = torch.sum(torch.log(diag), dim=-1)
    w = _forward_solve_vec(l, z)
    theta1_opt = torch.sum(w * w, dim=-1) / n
    ll = (-0.5 * n * math.log(2.0 * math.pi) - 0.5 * n
          - 0.5 * n * torch.log(theta1_opt) - logdet_half)
    return ll, theta1_opt


def dst_loglik(blocks, z):
    """Eq. 2 for the block-diagonal DST factor (independent blocks).

    Block factors may carry leading batch axes, like loglik_from_factor.
    """
    n = z.shape[-1]
    total = -0.5 * n * math.log(2.0 * math.pi)
    for sl, l in blocks:
        zb = z[sl].to(l.dtype)
        diag = torch.diagonal(l, dim1=-2, dim2=-1)
        w = _forward_solve_vec(l, zb)
        total = (total - torch.sum(torch.log(diag), dim=-1)
                 - 0.5 * torch.sum(w * w, dim=-1))
    return total


def _theta(theta, locs, device=None):
    """theta as a tensor in the precision of `locs` (fp64 for fp64
    locations, else fp32, like the reference's arrays with and without
    x64), on `device` (that of `locs` if None)."""
    return torch.as_tensor(theta, device=locs.device if device is None
                           else device,
                           dtype=torch.promote_types(locs.dtype, torch.float32))


def matern_block(locs_a, locs_b, theta, *, nu_static=None,
                 metric="euclidean", dtype=None, impl: str = "kernel"):
    """Sigma_ab for each candidate theta: (..., n_a, n_b), computed in the
    precision of the locations (see `_theta`) and stored in `dtype` (that
    precision if None).

    A half-integer nu_static goes through the `matern_cov` kernel's public
    function with impl="kernel", one launch per candidate (the kernel on a
    CUDA tensor, its plain version on a CPU tensor), and through the plain
    version with impl="plain"; nu_static=None takes nu from theta[..., 2]
    through the plain general-nu path (covariance/matern.py), which autograd
    differentiates.  A theta that requires grad (with grad mode on) takes
    each candidate through `MaternCov`, whose backward is the
    `matern_cov_grad` kernel (its plain version with impl="plain"): one
    more launch per candidate in the backward.
    """
    if nu_static is None:
        cov = matern_covariance(locs_a, locs_b, _theta(theta, locs_a),
                                metric=metric)
        return cov if dtype is None else cov.to(dtype)
    # the kernel takes theta as launch arguments
    theta = _theta(theta, locs_a, "cpu")
    if nu_static not in HALF_INTEGER_NUS:
        raise ValueError(f"nu_static must be one of {HALF_INTEGER_NUS}")
    batch = theta.shape[:-1]
    locs_a, locs_b = locs_a.contiguous(), locs_b.contiguous()
    matern = _impl(impl)[0]
    if theta.requires_grad and torch.is_grad_enabled():
        out = torch.stack([
            MaternCov.apply(locs_a, locs_b, th, nu_static, metric, matern)
            for th in theta.reshape(-1, theta.shape[-1])])
        out = out.reshape(batch + out.shape[1:])
        return out if dtype is None else out.to(dtype)
    flat = theta.reshape(-1, theta.shape[-1]).tolist()
    out = torch.empty((len(flat), locs_a.shape[0], locs_b.shape[0]),
                      dtype=theta.dtype, device=locs_a.device)
    for b, th in enumerate(flat):
        matern.matern_cov_tiles(locs_a[None], locs_b[None], th,
                                nu=nu_static, out_dtype=out.dtype,
                                metric=metric, out=out[b:b + 1])
    out = out.reshape(batch + out.shape[1:])
    return out if dtype is None else out.to(dtype)


def build_covariance(locs, theta, *, nu_static=None, metric="euclidean",
                     nugget=0.0, jitter=0.0, dtype=None, impl: str = "kernel"):
    """Sigma(theta) over `locs` (see `matern_block`) in `dtype`, nugget and
    jitter added to its diagonal in the precision of the locations."""
    cov = matern_block(locs, locs, theta, nu_static=nu_static, metric=metric,
                       impl=impl)
    for v in (nugget, jitter):
        if v:
            cov.diagonal(dim1=-2, dim2=-1).add_(v)
    if dtype is not None:
        cov = cov.to(dtype)
    return cov


def make_factor_fn(locs, policy: PrecisionPolicy, *, nb: int = 128,
                   nu_static=None, metric="euclidean", nugget=0.0,
                   jitter=1e-6, use_tiles=None, impl: str = "kernel"):
    """Return theta -> lower Cholesky factor of Sigma(theta).

    This is THE covariance-build + factor-path selection (tiled Algorithm 1
    vs dense reference, per `use_tiles`/policy mode), shared by
    `make_loglik`, kriging and the batch engine's fused evaluate.  Not
    applicable to mode="dst" (block factors; see `dst_cholesky`).  `impl`
    picks kernels or plain versions for the covariance and the tile
    engine (see `tile_cholesky`).  A theta that requires grad gives a
    differentiable factor on either path.
    """
    if policy.mode == "dst":
        raise ValueError("dst mode factors independent blocks; "
                         "use dst_cholesky")
    tiled = use_tiles if use_tiles is not None else policy.mode != "full"

    def factor(theta):
        cov = build_covariance(locs, theta, nu_static=nu_static,
                               metric=metric, nugget=nugget, jitter=jitter,
                               dtype=policy.hi, impl=impl)
        if tiled:
            return tile_cholesky(cov, nb, policy, impl=impl)
        return reference_cholesky(cov, policy.hi)

    return factor


def make_loglik(locs, z, policy: PrecisionPolicy, *, nb: int = 128,
                nu_static=None, metric="euclidean", nugget=0.0,
                jitter=1e-6, profiled=False, use_tiles=None,
                impl: str = "kernel"):
    """Return theta -> log-likelihood under the given precision policy.

    use_tiles: force the tile path even for mode="full" (None = auto: tile
    path for mixed/three_tier, dense Cholesky for full).

    The returned closure accepts a single theta (3,) or a stacked batch
    (..., 3) of candidates, returning matching leading axes of
    log-likelihoods (one factorization per candidate, batched tile ops),
    as tensors on the device of `locs`.
    """
    factor = None if policy.mode == "dst" else make_factor_fn(
        locs, policy, nb=nb, nu_static=nu_static, metric=metric,
        nugget=nugget, jitter=jitter, use_tiles=use_tiles, impl=impl)

    def loglik(theta):
        theta = _theta(theta, locs, "cpu")
        cov_theta = torch.cat([torch.ones_like(theta[..., :1]),
                               theta[..., :2]], dim=-1) if profiled else theta
        if policy.mode == "dst":
            if profiled:
                raise NotImplementedError("profiled DST not needed")
            cov = build_covariance(locs, cov_theta, nu_static=nu_static,
                                   metric=metric, nugget=nugget,
                                   jitter=jitter, dtype=policy.hi, impl=impl)
            blocks = dst_cholesky(cov, nb, policy.diag_thick, hi=policy.hi)
            return dst_loglik(blocks, z)
        l = factor(cov_theta)
        if profiled:
            ll, _ = profiled_loglik_from_factor(l, z)
            return ll
        return loglik_from_factor(l, z)

    return loglik
