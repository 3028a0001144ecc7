"""Public banded mixed-precision SYRK: plain version on a CPU tensor, the
kernel on a CUDA one; `MpSyrk` pairs it with its backward `mp_syrk_grad`."""

from __future__ import annotations

import torch

from . import ref
from .mp_gemm import launch, launch_grad


def mp_syrk(p, *, tile, round_k, band_blocks, hi=torch.float32,
            lo=torch.bfloat16, accum=torch.float32, plain=False):
    """U = P P^T with banded precision; see `ref.mp_syrk` for the semantics.

    On a CUDA tensor the kernel takes (hi, lo, accum) = (fp32, bf16, fp32),
    (fp64, fp32, fp32) and the all-hi (fp32, fp32, fp32), (fp64, fp64,
    fp64), and raises on any other; a CPU tensor, or plain=True, runs the
    plain version, which takes any pair.

    tile: the unit of the in-band / off-band classification (the panel
    engine's nb); round_k: the K interval at which off-band partial sums are
    rounded to `lo` (nb on the panel path: one rounding, as `lo_matmul`).

    A P that requires grad (with grad mode on) goes through `MpSyrk`: the
    same forward, and `mp_syrk_grad` as its backward.
    """
    kw = dict(tile=tile, round_k=round_k, band_blocks=band_blocks, hi=hi,
              lo=lo, accum=accum)
    if p.requires_grad and torch.is_grad_enabled():
        return MpSyrk.apply(p, kw, plain)
    if plain or not p.is_cuda:
        return ref.mp_syrk(p, **kw)
    return launch(p, **kw)


def mp_syrk_grad(g, p, *, tile, band_blocks, hi=torch.float32,
                 lo=torch.bfloat16, accum=torch.float32, plain=False):
    """dP of `mp_syrk` from dU = g (m, m) in `hi`; see `ref.mp_syrk_grad`.
    On a CUDA tensor the backward kernel takes the forward's four pairs and
    raises on any other; a CPU tensor, or plain=True, runs the plain
    version."""
    kw = dict(tile=tile, band_blocks=band_blocks, hi=hi, lo=lo, accum=accum)
    if plain or not p.is_cuda:
        return ref.mp_syrk_grad(g, p, **kw)
    return launch_grad(g, p, **kw)


class MpSyrk(torch.autograd.Function):
    """U = mp_syrk(P), differentiable in P: the forward saves P only, the
    backward is `mp_syrk_grad` (the kernel on a CUDA tensor unless plain).

        MpSyrk.apply(p, kw, plain)   # kw: mp_syrk's keywords
    """

    @staticmethod
    def forward(ctx, p, kw, plain):
        ctx.save_for_backward(p)
        ctx.kw, ctx.plain = kw, plain
        return mp_syrk(p, **kw, plain=plain)

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        kw = {k: v for k, v in ctx.kw.items() if k != "round_k"}
        return mp_syrk_grad(g.contiguous(), p, **kw, plain=ctx.plain), None, None
