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

`matern_cov_grad` is the backward of `matern_cov` in theta, and `MaternCov`
the autograd Function that pairs the two, for a half-integer nu.
"""

from __future__ import annotations

import torch

from ...covariance.matern import HALF_INTEGER_NUS
from . import ref
from .matern_cov import launch, launch_grad


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


def matern_cov_grad(locs_a, locs_b, theta, grad_out, *, nu,
                    metric="euclidean"):
    """The gradient in (theta1, theta2) of sum(grad_out * matern_cov(locs_a,
    locs_b, theta)): a (2,) tensor in the locations' precision, on their
    device.  grad_out: (m, n), in that precision.  A CPU tensor runs the
    plain version, Euclidean or haversine; a CUDA tensor launches the
    backward kernel, which raises on what it does not take (a general nu,
    and haversine distance until ROADMAP A 5)."""
    if not locs_a.is_cuda:
        return ref.matern_cov_grad(locs_a, locs_b, theta, grad_out, nu=nu,
                                   metric=metric)
    return launch_grad(locs_a, locs_b, theta, grad_out, nu=nu, metric=metric)


class MaternCov(torch.autograd.Function):
    """Sigma = matern_cov(locs_a, locs_b, theta) in the locations'
    precision, differentiable in the tensor theta (theta1, theta2[,
    theta3]): the forward is `impl.matern_cov`, the backward
    `impl.matern_cov_grad`, where `impl` is this module (the kernels on a
    CUDA tensor) or `ref` (the plain versions on any device); theta3 gets a
    zero gradient (a half-integer nu ignores it) and the locations none.
    The backward recomputes from the locations and theta and saves no
    Sigma, so a caller may change Sigma in place (the jitter on its
    diagonal).

        MaternCov.apply(locs_a, locs_b, theta, nu, metric, impl)
    """

    @staticmethod
    def forward(ctx, locs_a, locs_b, theta, nu, metric, impl):
        th = [float(v) for v in theta.detach().reshape(-1).tolist()]
        ctx.save_for_backward(locs_a, locs_b)
        ctx.th, ctx.nu, ctx.metric, ctx.impl = th, nu, metric, impl
        ctx.theta_dtype, ctx.theta_device = theta.dtype, theta.device
        ctx.theta_shape = theta.shape
        # written through a view into a tensor of its own: an output that
        # is a view may not be changed in place
        out = torch.empty((locs_a.shape[0], locs_b.shape[0]),
                          dtype=torch.promote_types(locs_a.dtype,
                                                    torch.float32),
                          device=locs_a.device)
        impl.matern_cov_tiles(locs_a[None], locs_b[None], th, nu=nu,
                              out_dtype=out.dtype, metric=metric,
                              out=out[None])
        return out

    @staticmethod
    def backward(ctx, grad_out):
        locs_a, locs_b = ctx.saved_tensors
        grad = ctx.impl.matern_cov_grad(locs_a, locs_b, ctx.th,
                                        grad_out.contiguous(), nu=ctx.nu,
                                        metric=ctx.metric)
        d_theta = torch.zeros(len(ctx.th), dtype=ctx.theta_dtype,
                              device=ctx.theta_device)
        d_theta[:2] = grad.to(ctx.theta_device)
        return None, None, d_theta.reshape(ctx.theta_shape), None, None, None
