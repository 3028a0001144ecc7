"""Neural blocks of the model zoo: init + apply, plain functions on dicts.

The port of `repro.models.layers` for the dense attention models: RMSNorm,
rotary embeddings, GQA attention (with the query-chunked path for long
sequences) and the SwiGLU MLP.  MoE waits for its family (ROADMAP A 9).

Init functions take an explicit `torch.Generator` and draw fp32 params with
the reference's shapes and scales (not its random bits); `stack` prepends
leading axes, which is how the per-cycle params get their cycle axis.
Apply functions take activations in the compute dtype with fp32 params,
cast each param to the activation dtype at its product, and compute
attention scores in fp32 (the reference's `preferred_element_type`).
Sharding constraints are not ported: with no mesh they are the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # masked scores: a finite value, as the reference uses


def _init(gen, shape, scale=None, *, stack=(), device="cuda"):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    out = torch.randn(tuple(stack) + tuple(shape), generator=gen,
                      device=device, dtype=torch.float32)
    return out.mul_(scale)


# ---------------------------------------------------------------- rmsnorm

def rmsnorm_init(d, *, stack=(), device="cuda"):
    return {"scale": torch.ones(tuple(stack) + (d,), dtype=torch.float32,
                                device=device)}


def rmsnorm(p, x, eps=1e-5):
    dt = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * p["scale"]).to(dt)


# ------------------------------------------------------------------ rope

def rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention

def attention_init(gen, cfg, *, stack=(), device="cuda"):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kw = dict(stack=stack, device=device)
    p = {
        "wq": _init(gen, (d, h, hd), **kw),
        "wk": _init(gen, (d, kv, hd), **kw),
        "wv": _init(gen, (d, kv, hd), **kw),
        "wo": _init(gen, (h, hd, d), scale=1.0 / math.sqrt(h * hd), **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, **kw)
        p["k_norm"] = rmsnorm_init(hd, **kw)
    return p


def _attn_mask(sq, skv, *, swa: int | None, q_offset=0, device=None):
    """(sq, skv) causal boolean mask, banded to the last `swa` keys when
    swa is set. q_offset = absolute position of query 0."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if swa is not None:
        m &= kpos > qpos - swa
    return m


_QCHUNK_THRESHOLD = 8192  # at and above this, query-chunk the S x S scores
_QCHUNK = 2048


def attention(p, x, cfg, *, positions):
    """Causal GQA self-attention (sliding-window when cfg.swa_window is
    set). x: (B, S, d).

    Long sequences go through query chunks of _QCHUNK, so the fp32 score
    buffer is (B, KV, G, _QCHUNK, S) instead of (B, KV, G, S, S)."""
    b, sq, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // kv
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    qg = q.reshape(b, sq, kv, g, hd)
    k32 = k.float()
    swa = cfg.swa_window

    def block(q_blk, q_offset):
        # fp32 scores from exact fp32 copies of the operands, scaled into a
        # tensor of their own and masked in place, since at the chunk size
        # this buffer is GiBs (einsum returns a view: an in-place op on it
        # would make autograd clone the whole buffer's gradient in the
        # backward, twice)
        scores = torch.einsum("bskgh,btkh->bkgst", q_blk.float(), k32) \
            / math.sqrt(hd)
        mask = _attn_mask(q_blk.shape[1], sq, swa=swa, q_offset=q_offset,
                          device=x.device)
        scores.masked_fill_(~mask, NEG_INF)
        scores = torch.softmax(scores, dim=-1)
        return torch.einsum("bkgst,btkh->bskgh", scores.to(dt), v)

    if sq >= _QCHUNK_THRESHOLD and sq % _QCHUNK == 0:
        out = torch.cat([block(qg[:, i:i + _QCHUNK], i)
                         for i in range(0, sq, _QCHUNK)], dim=1)
    else:
        out = block(qg, 0)
    out = out.reshape(b, sq, h, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


# ----------------------------------------------------------- swiglu mlp

def mlp_init(gen, cfg, *, stack=(), device="cuda"):
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(stack=stack, device=device)
    return {"w_gate": _init(gen, (d, f), **kw), "w_up": _init(gen, (d, f), **kw),
            "w_down": _init(gen, (f, d), **kw)}


def mlp(p, x):
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)
