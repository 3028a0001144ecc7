"""Launch wrapper of the CUDA banded mixed-precision SYRK (csrc/mp_syrk.cu).

Replaces the Pallas TPU kernel `repro.kernels.mp_gemm.mp_gemm`.  Takes the
{hi=fp32, lo=bf16, accum=fp32} pair, or lo=fp32 (every block in fp32).
"""

from __future__ import annotations

import torch

from .. import LAUNCHES
from .._build import check, library


def launch(p, *, tile, round_k, band_blocks, hi, lo, accum):
    """U = P P^T, (m, kdim) fp32 -> (m, m) fp32, with banded precision."""
    if not p.is_cuda or p.dtype != torch.float32:
        raise ValueError("mp_syrk kernel: p must be a float32 CUDA tensor")
    if p.ndim != 2 or not p.is_contiguous():
        raise ValueError("mp_syrk kernel: p must be a contiguous 2-D tensor")
    if hi != torch.float32 or accum != torch.float32 or lo not in (
            torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"mp_syrk kernel: (hi, lo, accum) = ({hi}, {lo}, {accum}); "
            "it takes hi = accum = float32 and lo in {bfloat16, float32}")
    m, kdim = p.shape
    if tile % 64 or m % tile or round_k % 32 or kdim % round_k:
        raise ValueError(
            f"mp_syrk kernel: needs tile % 64 == 0, m % tile == 0, "
            f"round_k % 32 == 0 and kdim % round_k == 0; got m={m}, "
            f"kdim={kdim}, tile={tile}, round_k={round_k}")
    if band_blocks < 1:
        raise ValueError(f"band_blocks must be >= 1, got {band_blocks}")
    band_blocks = min(band_blocks, m // tile)
    out = torch.empty((m, m), dtype=torch.float32, device=p.device)
    status = library().mp_syrk_launch(
        p.data_ptr(), out.data_ptr(), m, kdim, tile, round_k, band_blocks,
        int(lo == torch.bfloat16),
        torch.cuda.current_stream(p.device).cuda_stream)
    check(status, "mp_syrk")
    LAUNCHES["mp_syrk"] += 1
    return out
