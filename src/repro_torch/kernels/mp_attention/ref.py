"""Plain PyTorch versions of the banded-precision decode attention."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_decode_segment(q, k, v, scales, seg_len, *, blk: int = 128,
                         sm_scale: float = 1.0):
    """Partial flash attention over one KV segment, one key block at a time
    with the reference kernel's online-softmax arithmetic.

    q: (B, G, d) fp32/bf16 -- B folds batch*kv_heads, G = q heads per kv.
    k, v: (B, S, d) fp32/bf16 (near) or int8 (far).
    scales: (B, S//blk, 2) fp32 per-block (k, v) dequant scales, or None.
    seg_len: (B,) integer valid lengths; positions >= seg_len are masked
    with -1e30, so a segment with no valid key gives m = -1e30, l = S.
    Returns un-normalized (acc (B, G, d) f32, m (B, G, 1), l (B, G, 1)).
    """
    b, g, d = q.shape
    s = k.shape[1]
    if s % blk:
        raise ValueError(f"segment length {s} is not a multiple of blk={blk}")
    qf = q.float()
    acc = torch.zeros((b, g, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, g, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, g, 1), dtype=torch.float32, device=q.device)
    offsets = torch.arange(blk, device=q.device)
    for i in range(s // blk):
        kb = k[:, i * blk:(i + 1) * blk].float()
        vb = v[:, i * blk:(i + 1) * blk].float()
        if scales is not None:
            kb = kb * scales[:, i, 0, None, None]
            vb = vb * scales[:, i, 1, None, None]
        valid = (offsets + i * blk)[None, :] < seg_len[:, None]  # (B, blk)
        scores = (qf @ kb.mT) * sm_scale
        scores = scores.masked_fill(~valid[:, None, :], NEG_INF)  # (B, G, blk)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vb
        m = m_new
    return acc, m, l


def combine_chunks(parts):
    """The segment's (acc, m, l) from the partials of its key chunks, in
    chunk order: m = max m_c, acc = sum acc_c exp(m_c - m), l = sum l_c
    exp(m_c - m).  The plain counterpart of the CUDA kernel's combine
    step."""
    m_tot = parts[0][1]
    for _, m, _ in parts[1:]:
        m_tot = torch.maximum(m_tot, m)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for acc_c, m, l_c in parts:
        w = torch.exp(m - m_tot)
        acc = acc + acc_c * w
        l = l + l_c * w
    return acc, m_tot, l


def flash_decode_segment_split(q, k, v, scales, seg_len, *, chunk: int,
                               blk: int = 128, sm_scale: float = 1.0):
    """flash_decode_segment computed as the split-KV kernel does: one
    partial per chunk of `chunk` keys (a multiple of blk), combined by
    combine_chunks.  With no valid key every chunk reads its keys (l = its
    length); otherwise a chunk wholly past seg_len reads nothing and gives
    (acc = 0, m = -1e30, l = 0)."""
    s = k.shape[1]
    if chunk < blk or chunk % blk or s % blk:
        raise ValueError(f"chunk {chunk} is not a multiple of blk={blk} "
                         f"dividing S={s}")
    seg_len = seg_len.to(torch.int64)
    parts = []
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        sc = None if scales is None else scales[:, c0 // blk:c1 // blk]
        local = (seg_len - c0).clamp(0, c1 - c0)
        acc, m, l = flash_decode_segment(q, k[:, c0:c1], v[:, c0:c1], sc, local,
                                         blk=blk, sm_scale=sm_scale)
        past = ((seg_len > 0) & (seg_len <= c0))[:, None, None]
        parts.append((acc.masked_fill(past, 0.0), m.masked_fill(past, NEG_INF),
                      l.masked_fill(past, 0.0)))
    if not parts:  # an empty segment: the unsplit version's zeros
        return flash_decode_segment(q, k, v, scales, seg_len, blk=blk,
                                    sm_scale=sm_scale)
    return combine_chunks(parts)


def banded_decode_attention_ref(q, k_near, v_near, near_len,
                                k_far, v_far, far_scales, far_len, *,
                                blk: int = 128, sm_scale: float = 1.0):
    """Full-softmax oracle with identical quantization semantics."""
    b, _, d = q.shape
    q = q.float()

    def dequant(x, col):  # an empty far segment (no block) stays empty
        nblk = far_scales.shape[1]
        xb = x.float().reshape(b, nblk, x.shape[1] // max(nblk, 1), d)
        return (xb * far_scales[:, :, col][:, :, None, None]).reshape(b, -1, d)

    kf, vf = dequant(k_far, 0), dequant(v_far, 1)
    kn, vn = k_near.float(), v_near.float()
    k = torch.cat([kn, kf], dim=1)
    v = torch.cat([vn, vf], dim=1)
    pos_n = torch.arange(kn.shape[1], device=q.device)[None] < near_len[:, None]
    pos_f = torch.arange(kf.shape[1], device=q.device)[None] < far_len[:, None]
    valid = torch.cat([pos_n, pos_f], dim=1)                 # (B, S)
    scores = torch.einsum("bgd,bsd->bgs", q, k) * sm_scale
    scores = scores.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bgs,bsd->bgd", p, v)
