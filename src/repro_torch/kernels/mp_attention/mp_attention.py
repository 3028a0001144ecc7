"""Launch wrapper of the CUDA flash-decode segment kernel
(csrc/mp_attention.cu).

Replaces the Pallas TPU kernel
`repro.kernels.mp_attention.mp_attention.flash_decode_segment`: the
online-softmax partials (acc, m, l) of G query heads over one KV segment,
int8 K/V dequantized in the kernel with per-(row, block) scales.  The
grid is (B, n_split): each block takes one chunk of whole `blk`-key blocks
of one row of B (batch * kv_heads) and walks it in tiles of TILE keys, so
`blk` must be a multiple of TILE.  With more than one chunk per row a
second launch combines the chunks' partials (two device launches per call,
one count in LAUNCHES).
"""

from __future__ import annotations

import torch

from .. import count_launch
from .._build import check, library

TILE = 64                 # keys per shared-memory tile of the kernel
MAX_G = 16                # query heads per KV head
HEAD_DIMS = (64, 80, 128)  # h2o-danube-1.8b's d_head is 80
KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
TARGET_BLOCKS = 528       # four blocks for each of the H100's 132 SMs


def split_plan(b: int, s: int, blk: int) -> tuple[int, int]:
    """(chunk, n_split): keys per block, a whole number of blk-key blocks,
    and chunks per row, so that the (b, n_split) grid has at least
    TARGET_BLOCKS blocks where the segment has enough blocks of keys.
    Chunk i holds keys [i chunk, min((i + 1) chunk, s)); an empty segment
    is one empty chunk."""
    if b < 1 or blk < TILE or blk % TILE or s < 0 or s % blk:
        raise ValueError(f"mp_attention kernel: needs B >= 1, blk % {TILE} "
                         f"== 0 and S % blk == 0; got B={b}, blk={blk}, S={s}")
    n_blk = s // blk
    per_chunk = max(1, n_blk * b // TARGET_BLOCKS)
    return per_chunk * blk, max(1, -(-n_blk // per_chunk))


def check_inputs(q, k, v, scales, seg_len, *, blk: int = 128):
    """The kernel's checks of dtypes, shapes, layout and alignment, on any
    device: (b, g, d, s, chunk, n_split) of the launch, or a ValueError,
    or a NotImplementedError for a dtype, G or d the kernel does not
    take."""
    tensors = [q, k, v, seg_len] + ([] if scales is None else [scales])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("mp_attention kernel: inputs on different devices")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"mp_attention kernel: q dtype {q.dtype}; "
                                  "it takes float32 or bfloat16")
    if k.dtype not in KV_CODES or v.dtype != k.dtype:
        raise NotImplementedError(
            f"mp_attention kernel: k/v dtypes {k.dtype}/{v.dtype}; it takes "
            "one of float32, bfloat16 or int8 for both")
    if (q.ndim != 3 or k.ndim != 3 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]):
        raise ValueError(f"mp_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, g, d = q.shape
    s = k.shape[1]
    if not 1 <= g <= MAX_G or d not in HEAD_DIMS:
        raise NotImplementedError(
            f"mp_attention kernel: G={g}, d={d}; it takes G <= {MAX_G} and "
            f"d in {HEAD_DIMS}")
    chunk, n_split = split_plan(b, s, blk)
    if (k.dtype == torch.int8) != (scales is not None):
        raise ValueError("mp_attention kernel: int8 K/V take scales, "
                         "float K/V take none")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (b, s // blk, 2)):
        raise ValueError(f"mp_attention kernel: scales must be float32 "
                         f"{(b, s // blk, 2)}")
    if seg_len.dtype != torch.int32 or seg_len.shape != (b,):
        raise ValueError(f"mp_attention kernel: seg_len must be int32 ({b},)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mp_attention kernel: inputs must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("mp_attention kernel: k and v must be 16-byte aligned")
    return b, g, d, s, chunk, n_split


def launch(q, k, v, scales, seg_len, *, blk: int = 128, sm_scale: float = 1.0):
    """(acc (B, G, d) f32, m (B, G, 1) f32, l (B, G, 1) f32) of one segment.

    q: (B, G, d) fp32/bf16; k, v: (B, S, d) fp32, bf16 or int8 (then with
    scales (B, S//blk, 2) fp32, else scales is None); seg_len: (B,) int32.
    """
    tensors = [q, k, v, seg_len] + ([] if scales is None else [scales])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("mp_attention kernel: every input must be a CUDA tensor")
    b, g, d, s, chunk, n_split = check_inputs(q, k, v, scales, seg_len, blk=blk)
    acc = torch.empty((b, g, d), dtype=torch.float32, device=q.device)
    m, l = torch.empty((2, b, g, 1), dtype=torch.float32, device=q.device)
    ws = [None] * 3  # the chunks' partials (acc, m, l), for the second launch
    if n_split > 1:
        parts = b * n_split * g
        buf = torch.empty((parts * (d + 2),), dtype=torch.float32,
                          device=q.device)
        ws = [buf.data_ptr() + 4 * off for off in (0, parts * d, parts * (d + 1))]
    status = library().mp_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if scales is None else scales.data_ptr(), seg_len.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), *ws, b, g, d, s, blk,
        chunk, float(sm_scale), int(q.dtype == torch.bfloat16),
        KV_CODES[k.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    check(status, "mp_attention")
    count_launch("mp_attention")
    return acc, m, l
