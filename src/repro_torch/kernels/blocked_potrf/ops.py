"""Public tile POTRF: plain version on a CPU tensor, the kernel on a CUDA
one; `Potrf` makes it differentiable."""

from __future__ import annotations

import torch

from . import ref
from .blocked_potrf import launch


def potrf(a):
    """Lower Cholesky factor(s) of (nb, nb) or (B, nb, nb) SPD tiles.

    Returns (l, info): info has shape a.shape[:-2]; info != 0 marks a tile
    that is not positive definite, whose factor is all NaN.  A tensor that
    requires grad (with grad mode on) goes through `Potrf`.
    """
    if a.requires_grad and torch.is_grad_enabled():
        return Potrf.apply(a, potrf)
    if not a.is_cuda:
        return ref.potrf(a)
    l, info = launch(a.reshape((-1,) + a.shape[-2:]))
    return l.reshape(a.shape), info.reshape(a.shape[:-2])


def cholesky_backward(gl, l):
    """dA of the lower Cholesky factor l of A from dL = gl, each tile on l's
    lower triangle, as torch's own Cholesky backward computes it: a product
    and two triangular solves per tile, batched.  A NaN factor (a tile that
    is not positive definite) gives a NaN dA."""
    ga = (l.mH @ gl).tril()
    ga = 0.5 * (ga + ga.tril(-1).mH)
    ga = torch.linalg.solve_triangular(l.mH, ga, upper=True, left=True)
    return torch.linalg.solve_triangular(l, ga, upper=False, left=False)


class Potrf(torch.autograd.Function):
    """(l, info) = factor(a), differentiable in a: `factor` is the forward
    (`potrf` above: the kernel on a CUDA tensor), called with autograd off;
    the backward is `cholesky_backward` in torch ops on either device, from
    the factor the forward returned; info has no gradient.

        Potrf.apply(a, factor)
    """

    @staticmethod
    def forward(ctx, a, factor):
        l, info = factor(a)
        ctx.save_for_backward(l)
        ctx.mark_non_differentiable(info)
        return l, info

    @staticmethod
    def backward(ctx, gl, _):
        (l,) = ctx.saved_tensors
        return cholesky_backward(gl, l), None
