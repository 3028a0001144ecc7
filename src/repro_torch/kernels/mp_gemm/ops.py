"""Public banded mixed-precision SYRK: plain version on a CPU tensor, the
kernel on a CUDA one."""

from __future__ import annotations

import torch

from . import ref
from .mp_gemm import launch


def mp_syrk(p, *, tile, round_k, band_blocks, hi=torch.float32,
            lo=torch.bfloat16, accum=torch.float32):
    """U = P P^T with banded precision; see `ref.mp_syrk` for the semantics.

    On a CUDA tensor the kernel takes (hi, lo, accum) = (fp32, bf16, fp32),
    (fp64, fp32, fp32) and the all-hi (fp32, fp32, fp32), (fp64, fp64,
    fp64), and raises on any other; a CPU tensor takes any pair.

    tile: the unit of the in-band / off-band classification (the panel
    engine's nb); round_k: the K interval at which off-band partial sums are
    rounded to `lo` (nb on the panel path: one rounding, as `lo_matmul`).
    """
    if not p.is_cuda:
        return ref.mp_syrk(p, tile=tile, round_k=round_k,
                           band_blocks=band_blocks, hi=hi, lo=lo, accum=accum)
    return launch(p, tile=tile, round_k=round_k, band_blocks=band_blocks,
                  hi=hi, lo=lo, accum=accum)
