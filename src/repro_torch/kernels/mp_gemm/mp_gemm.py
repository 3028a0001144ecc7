"""Launch wrapper of the CUDA banded mixed-precision SYRK (csrc/mp_syrk.cu).

Replaces the Pallas TPU kernel `repro.kernels.mp_gemm.mp_gemm`.  Takes the
{hi=fp32, lo=bf16, accum=fp32} pair, or lo=fp32 (every block in fp32).
Two kernels, each over only the lower blocks (bi >= bj) of its class, each
block written with its mirror: the fp32 band kernel and, after a pass that
writes P as bf16 into a scratch, the bf16 wgmma off-band kernel.  The C
entry sizes both grids (csrc/mp_syrk.cu: mp_syrk_launch).
"""

from __future__ import annotations

import torch

from .. import LAUNCHES
from .._build import check, library

KC = 64   # K columns of one pipeline stage of the off-band kernel


def launch(p, *, tile, round_k, band_blocks, hi, lo, accum):
    """U = P P^T, (m, kdim) fp32 -> (m, m) fp32, with banded precision."""
    m, kdim = (p.shape[0], p.shape[-1]) if p.ndim else (0, 0)
    if tile <= 0 or tile % 64 or m % tile or round_k <= 0 or round_k % KC \
            or kdim % round_k:
        raise ValueError(
            f"mp_syrk kernel: needs tile % 64 == 0, m % tile == 0, "
            f"round_k % {KC} == 0 and kdim % round_k == 0; got m={m}, "
            f"kdim={kdim}, tile={tile}, round_k={round_k}")
    if not p.is_cuda or p.dtype != torch.float32:
        raise ValueError("mp_syrk kernel: p must be a float32 CUDA tensor")
    if p.ndim != 2 or not p.is_contiguous():
        raise ValueError("mp_syrk kernel: p must be a contiguous 2-D tensor")
    if hi != torch.float32 or accum != torch.float32 or lo not in (
            torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"mp_syrk kernel: (hi, lo, accum) = ({hi}, {lo}, {accum}); "
            "it takes hi = accum = float32 and lo in {bfloat16, float32}")
    if band_blocks < 1:
        raise ValueError(f"band_blocks must be >= 1, got {band_blocks}")
    # the bf16 copy of P feeds the off-band kernel, which runs when some
    # tile lies band_blocks or more tiles off the diagonal
    off_band = lo == torch.bfloat16 and band_blocks < m // tile
    out = torch.empty((m, m), dtype=torch.float32, device=p.device)
    scratch = (torch.empty((m, kdim), dtype=torch.bfloat16, device=p.device)
               if off_band else None)
    status = library().mp_syrk_launch(
        p.data_ptr(), None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), m, kdim, tile, round_k, min(band_blocks, m // tile),
        int(lo == torch.bfloat16), 128 if tile % 128 == 0 else 64,
        torch.cuda.current_stream(p.device).cuda_stream)
    check(status, "mp_syrk")
    LAUNCHES["mp_syrk"] += 1
    return out
