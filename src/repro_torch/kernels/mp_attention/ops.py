"""Public API for banded-precision decode attention.

banded_decode_attention(q, near KV bf16/fp32, far KV int8) -> attention
output; quantize_kv() produces the far segment's int8 blocks and per-block
scales.  GQA is handled by folding kv_heads into the batch dim.  The
per-segment partials run on the CUDA kernel for a CUDA tensor (or raise)
and on the plain version (ref.py) for a CPU tensor; the quantization and
the merge are plain PyTorch on either, as in the reference.
"""

from __future__ import annotations

import torch

from . import ref
from .mp_attention import launch


def quantize_kv(k, v, *, blk: int = 128):
    """Per-(batch, block) symmetric int8 quantization of a KV segment.

    k, v: (B, S, d) float -> int8 (B, S, d), int8 (B, S, d),
    scales (B, S//blk, 2) fp32.
    """
    b, s, d = k.shape
    if s % blk:
        raise ValueError(f"segment length {s} is not a multiple of blk={blk}")
    nblk = s // blk
    kb = k.float().reshape(b, nblk, blk, d)
    vb = v.float().reshape(b, nblk, blk, d)
    k_sc = torch.amax(torch.abs(kb), dim=(2, 3)) / 127.0 + 1e-12
    v_sc = torch.amax(torch.abs(vb), dim=(2, 3)) / 127.0 + 1e-12
    kq = torch.round(kb / k_sc[:, :, None, None]).to(torch.int8).reshape(b, s, d)
    vq = torch.round(vb / v_sc[:, :, None, None]).to(torch.int8).reshape(b, s, d)
    return kq, vq, torch.stack([k_sc, v_sc], dim=-1)


def merge_partials(parts):
    """Combine per-segment (acc, m, l) with the log-sum-exp merge."""
    acc, _, l = ref.combine_chunks(parts)
    return acc / l


def flash_decode_segment(q, k, v, scales, seg_len, *, blk: int = 128,
                         sm_scale: float = 1.0):
    """(acc, m, l) of one segment: the kernel on a CUDA tensor, the plain
    version on a CPU one (see `ref.flash_decode_segment`)."""
    fn = launch if q.is_cuda else ref.flash_decode_segment
    return fn(q, k, v, scales, seg_len, blk=blk, sm_scale=sm_scale)


def banded_decode_attention(q, k_near, v_near, near_len,
                            k_far, v_far, far_scales, far_len, *,
                            blk: int = 128, sm_scale: float = 1.0):
    """Decode attention over a two-precision KV cache.

    q: (B, G, d); near: (B, Sn, d) bf16/f32; far: (B, Sf, d) int8 with
    (B, Sf//blk, 2) scales; *_len: (B,) int32 valid lengths per segment.
    Returns (B, G, d) fp32.
    """
    kw = dict(blk=blk, sm_scale=sm_scale)
    near = flash_decode_segment(q, k_near, v_near, None, near_len, **kw)
    far = flash_decode_segment(q, k_far, v_far, far_scales, far_len, **kw)
    return merge_partials([near, far])
