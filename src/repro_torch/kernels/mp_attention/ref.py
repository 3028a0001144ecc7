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


def banded_decode_attention_ref(q, k_near, v_near, near_len,
                                k_far, v_far, far_scales, far_len, *,
                                blk: int = 128, sm_scale: float = 1.0):
    """Full-softmax oracle with identical quantization semantics."""
    b, _, d = q.shape
    q = q.float()

    def dequant(x, col):
        nblk = far_scales.shape[1]
        xb = x.float().reshape(b, nblk, -1, d)
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
