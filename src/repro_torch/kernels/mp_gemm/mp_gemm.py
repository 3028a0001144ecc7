"""Launch wrapper of the CUDA banded mixed-precision SYRK (csrc/mp_syrk.cu).

Replaces the Pallas TPU kernel `repro.kernels.mp_gemm.mp_gemm`.  Takes the
(hi, lo, accum) pairs (fp32, bf16, fp32) and (fp64, fp32, fp32), the
paper's, and the all-hi (fp32, fp32, fp32) and (fp64, fp64, fp64), in which
every block is in the band.  Two kernels, each over only the lower blocks
(bi >= bj) of its class, each block written with its mirror: the band
kernel in hi and, after a pass that writes P in lo into a scratch, the
off-band kernel.  The C entry sizes both grids (csrc/mp_syrk.cu:
mp_syrk_launch).

What bounds each on the H100, and what its design does about it:

- fp32 band (fp32 hi): operations on the CUDA cores (67 TFLOP/s); SIMT with
  the operands transposed into shared memory through registers.
- bf16 off-band: the bytes of its fp32 output; TMA into a shared ring and
  wgmma, one rounding to bf16 per round_k.
- fp64 band (fp64 hi): operations at 67 TFLOP/s, reached only on the fp64
  tensor cores; mma.sync m16n8k4 in fp64 (DMMA) fed by a 4-stage cp.async
  ring, 8-byte fragment loads free of bank conflicts; a diagonal block is its
  lower triangle and that triangle's mirror.
- fp32 off-band of the paper pair: IEEE fp32 FMA at 67 TFLOP/s on the CUDA
  cores, one chain over K in order per element; a 4-stage cp.async ring,
  lanes that share a row of P share its 16-byte shared loads, and the 64
  accumulators of a thread in registers (one block per SM, no spill).

`launch_grad` runs the backward, dP = S P with S the lower tiles of dU and
their transpose, hi arithmetic inside the band and lo operands with an fp32
sum off it.  It has no TPU counterpart (the JAX package differentiates its
jnp engines).  Bound by its operations (2 m^2 kdim, twice the forward's),
it runs the forward's three engines adapted to dP = S P, after a pre-pass
that writes D + D^T in hi for each diagonal tile D of dU and, under the
split pairs, lo(dU) for each lower off-band tile (packed in row order)
and lo(P) into one scratch (`grad_scratch_layout`):

- {fp32, bf16} off-band: bf16 wgmma fed by TMA, a tile right of the band
  read MN-major through the transpose bit, the tensor cores' partial sums
  added in IEEE fp32 every 256 columns of K, the sum rounded once to bf16;
- the paper pair's fp64 band and all of all-fp64: DMMA from a cp.async
  ring;
- the fp32 band ({fp32, bf16}), all of all-fp32 and the paper pair's fp32
  off-band: IEEE fp32 FMA on the CUDA cores from a cp.async ring, 8 x 8
  outputs a thread.

The off-band kernel writes lo(off) into dP, the band's then adds its hi
sum.  tests/test_torch_syrk_grad_plan.py specifies the dataflow and the
block and chunk plan in Python.
"""

from __future__ import annotations

import torch

from .. import count_launch
from .._build import check, library

KC = 64   # K columns of one pipeline stage of the off-band kernel

# (hi, lo, accum) -> the C entry's `pair` code
PAIRS = {(torch.float32, torch.bfloat16, torch.float32): 0,
         (torch.float32, torch.float32, torch.float32): 1,
         (torch.float64, torch.float32, torch.float32): 2,
         (torch.float64, torch.float64, torch.float64): 3}
SPLIT_PAIRS = (0, 2)   # the pairs with an off-band class


def block(tile):
    """The kernels' block side bm (mp_syrk_launch's argument): 128 where it
    divides the tile, else 64."""
    return 64 if tile % 128 else 128


def launch(p, *, tile, round_k, band_blocks, hi, lo, accum):
    """U = P P^T, (m, kdim) hi -> (m, m) hi, with banded precision."""
    m, kdim = (p.shape[0], p.shape[-1]) if p.ndim else (0, 0)
    if tile <= 0 or tile % 64 or m % tile or round_k <= 0 or round_k % KC \
            or kdim % round_k:
        raise ValueError(
            f"mp_syrk kernel: needs tile % 64 == 0, m % tile == 0, "
            f"round_k % {KC} == 0 and kdim % round_k == 0; got m={m}, "
            f"kdim={kdim}, tile={tile}, round_k={round_k}")
    pair = PAIRS.get((hi, lo, accum))
    if pair is None:
        raise NotImplementedError(
            f"mp_syrk kernel: (hi, lo, accum) = ({hi}, {lo}, {accum}); it "
            "takes (float32, bfloat16, float32), (float64, float32, float32) "
            "and the all-hi (float32, float32, float32), (float64, float64, "
            "float64)")
    if not p.is_cuda or p.dtype != hi:
        raise ValueError(f"mp_syrk kernel: p must be a {hi} CUDA tensor")
    if p.ndim != 2 or not p.is_contiguous():
        raise ValueError("mp_syrk kernel: p must be a contiguous 2-D tensor")
    if band_blocks < 1:
        raise ValueError(f"band_blocks must be >= 1, got {band_blocks}")
    # the lo copy of P feeds the off-band kernel, which runs when some tile
    # lies band_blocks or more tiles off the diagonal
    off_band = pair in SPLIT_PAIRS and band_blocks < m // tile
    out = torch.empty((m, m), dtype=hi, device=p.device)
    scratch = (torch.empty((m, kdim), dtype=lo, device=p.device)
               if off_band else None)
    status = library().mp_syrk_launch(
        p.data_ptr(), None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), m, kdim, tile, round_k, min(band_blocks, m // tile),
        pair, block(tile),
        torch.cuda.current_stream(p.device).cuda_stream)
    check(status, "mp_syrk")
    count_launch("mp_syrk")
    return out


ALIGN = 1024   # alignment of each part of the backward's scratch


def grad_scratch_layout(m, kdim, tile, band_blocks, pair):
    """The backward's scratch (csrc/mp_syrk.cu: grad_scratch): byte offset
    and size of the D + D^T tiles (n_t tile^2 in hi) and, for a split pair
    with an off-band, of the n_packed lower off-band tiles of dU in lo,
    packed in row order, and of lo(P) (m kdim, transposed for bf16); each
    part 1,024-aligned.  The all-hi pairs have no off-band."""
    hi, lo = {0: (4, 2), 1: (4, 4), 2: (8, 4), 3: (8, 8)}[pair]
    n_t = m // tile
    off = n_t - min(band_blocks, n_t) if pair in SPLIT_PAIRS else 0
    n_packed = off * (off + 1) // 2
    align = lambda x: -(-x // ALIGN) * ALIGN  # noqa: E731
    out = dict(n_packed=n_packed, dd=(0, n_t * tile * tile * hi))
    total = out["dd"][1]
    if n_packed:
        out["s_lo"] = (align(total), n_packed * tile * tile * lo)
        out["p_lo"] = (align(sum(out["s_lo"])), m * kdim * lo)
        total = sum(out["p_lo"])
    out["total"] = total
    return out


def launch_grad(g, p, *, tile, band_blocks, hi, lo, accum):
    """dP (m, kdim) hi of U = P P^T from dU = g (m, m) hi (its lower tiles
    only), with the forward's banded precision."""
    m, kdim = (p.shape[0], p.shape[-1]) if p.ndim else (0, 0)
    if tile <= 0 or tile % 64 or m % tile or kdim <= 0 or kdim % 64:
        raise ValueError(
            f"mp_syrk_grad kernel: needs tile % 64 == 0, m % tile == 0 and "
            f"kdim % 64 == 0; got m={m}, kdim={kdim}, tile={tile}")
    pair = PAIRS.get((hi, lo, accum))
    if pair is None:
        raise NotImplementedError(
            f"mp_syrk_grad kernel: (hi, lo, accum) = ({hi}, {lo}, {accum}); "
            "it takes the forward's pairs")
    if not (p.is_cuda and g.is_cuda) or p.dtype != hi or g.dtype != hi:
        raise ValueError(f"mp_syrk_grad kernel: g and p must be {hi} CUDA "
                         "tensors")
    if p.ndim != 2 or g.shape != (m, m) or not (p.is_contiguous()
                                                 and g.is_contiguous()):
        raise ValueError(f"mp_syrk_grad kernel: p must be a contiguous 2-D "
                         f"tensor and g a contiguous ({m}, {m}) one")
    if band_blocks < 1:
        raise ValueError(f"band_blocks must be >= 1, got {band_blocks}")
    out = torch.empty_like(p)
    nbytes = grad_scratch_layout(m, kdim, tile, band_blocks, pair)["total"]
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=p.device)
    status = library().mp_syrk_grad_launch(
        g.data_ptr(), p.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        nbytes, m, kdim, tile, band_blocks, pair,
        torch.cuda.current_stream(p.device).cuda_stream)
    check(status, "mp_syrk_grad")
    count_launch("mp_syrk_grad")
    return out
