"""Serving: cache construction, prefill, and single-token decode.

The port of `repro.models.decode` for every family: attention, mamba,
mLSTM and sLSTM blocks, with a dense or an MoE FFN (whose aux loss serving
drops, as the reference does), whisper's cross-attention and the vision
stub's prepended patches.  Cache layout, one entry per block slot of the
cycle pattern, stacked over cycles as the reference's (so caches compare
directly with it):

  attn (full) : {k, v: (C, B, S_max, KV, hd)}           (rope'd at write)
  attn (SWA)  : {k, v: (C, B, W, KV, hd), pos: (C, W)}  (circular)
  kv_quant    : k, v int8 and {k_scale, v_scale: (C, B, S_max, KV)} fp32
  mamba       : {conv: (C, B, K-1, d_in) bf16, ssm: (C, B, d_in, N) fp32}
  mlstm       : {c: (C, B, H, hd, hd), n: (C, B, H, hd), m: (C, B, H)}
  slstm       : {c, n, h, m: (C, B, H, hd)}
  whisper     : the decoder's self cache + cross {k, v: (C, B, F, KV, hd)}
                bf16, also under kv_quant (the reference never quantizes
                it), written once by prefill from the encoder's output

The recurrent entries and the cross entry are constant in S.  Where the
reference returns a new cache from each decode step, `decode_step` writes
the new row (or the new state) into the cache it is given and returns that
same cache: a copy per step would move the whole cache for one row.
Decode attention is plain PyTorch here, as in the reference; the
banded-precision kernel serves `serve_lm.banded_kv_attention`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import NEG_INF, attention, rmsnorm, rope
from .ssm import mamba_init_state, mlstm_init_state, slstm_init_state
from .transformer import (_apply_block, _check_supported, _cross, _ffn,
                          cycle_slice, embed_inputs, encode, unembed_logits)

CACHE_DTYPE = torch.bfloat16


# each recurrent block's cache entry names, in its state tuple's order
_STATE_NAMES = {"mamba": ("conv", "ssm"), "mlstm": ("c", "n", "m"),
                "slstm": ("c", "n", "h", "m")}


def _state_init(bt, cfg, batch, device):
    if bt == "mamba":
        return mamba_init_state(batch, cfg, CACHE_DTYPE, device=device)
    if bt == "mlstm":
        return mlstm_init_state(batch, cfg, device=device)
    return slstm_init_state(batch, cfg, device=device)


def init_cache(cfg, batch: int, max_len: int, *, kv_quant: bool = False,
               device="cuda"):
    """Empty cache for decode.

    kv_quant=True stores attention KV int8 with per-row fp32 scales (the
    reference's XLA-path form of distance-banded precision at t = 0)."""
    _check_supported(cfg)
    c = cfg.n_cycles
    kv, hd = cfg.n_kv_heads, cfg.d_head
    w = min(cfg.swa_window or max_len, max_len)
    dt = torch.int8 if kv_quant else CACHE_DTYPE
    cache = {}
    for i, bt in enumerate(cfg.block_pattern):
        if bt != "attn":
            st = _state_init(bt, cfg, batch, device)
            cache[f"b{i}"] = {
                name: t.expand((c,) + t.shape).contiguous()
                for name, t in zip(_STATE_NAMES[bt], st)}
            continue
        entry = {name: torch.zeros((c, batch, w, kv, hd), dtype=dt,
                                   device=device) for name in ("k", "v")}
        if kv_quant:
            for name in ("k_scale", "v_scale"):
                entry[name] = torch.zeros((c, batch, w, kv),
                                          dtype=torch.float32, device=device)
        if cfg.swa_window is not None:
            entry["pos"] = torch.full((c, w), -1, dtype=torch.int32,
                                      device=device)
        cache[f"b{i}"] = entry
    if cfg.enc_dec:
        cache["cross"] = {name: torch.zeros(
            (c, batch, cfg.n_enc_frames, kv, hd), dtype=CACHE_DTYPE,
            device=device) for name in ("k", "v")}
    return cache


def quantize_rows(t):
    """Symmetric int8 per row of the last axis: (int8 values, fp32 scales)."""
    sc = torch.amax(torch.abs(t), dim=-1) / 127.0 + 1e-12
    return torch.round(t / sc[..., None]).to(torch.int8), sc


def _decode_attn(p, x, cfg, cache, pos: int):
    """Single-token GQA attention against one layer's cache (written in
    place at the token's slot). x: (B, 1, d)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // kv
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)

    w = cache["k"].shape[1]
    slot = pos % w if cfg.swa_window is not None else pos
    if not 0 <= slot < w:
        raise ValueError(f"position {pos} is past the cache's {w} slots")
    quant = "k_scale" in cache
    if quant:
        k_q, k_sc = quantize_rows(k.float())
        v_q, v_sc = quantize_rows(v.float())
        cache["k"][:, slot] = k_q[:, 0]
        cache["v"][:, slot] = v_q[:, 0]
        cache["k_scale"][:, slot] = k_sc[:, 0]
        cache["v_scale"][:, slot] = v_sc[:, 0]
        ck = cache["k"].to(dt) * cache["k_scale"][..., None].to(dt)
        cv = cache["v"].to(dt) * cache["v_scale"][..., None].to(dt)
    else:
        cache["k"][:, slot] = k[:, 0].to(CACHE_DTYPE)
        cache["v"][:, slot] = v[:, 0].to(CACHE_DTYPE)
        ck, cv = cache["k"].to(dt), cache["v"].to(dt)
    if cfg.swa_window is not None:
        cpos = cache["pos"]
        cpos[slot] = pos
        valid = (cpos >= 0) & (cpos > pos - cfg.swa_window)
    else:
        valid = torch.arange(w, device=x.device) <= pos

    qg = q.reshape(b, 1, kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), ck.float())
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~valid, NEG_INF)
    wts = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bkgst,btkh->bskgh", wts, cv).reshape(b, 1, h, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def _cross_from_cache(p, x, cfg, cache):
    """One token's cross-attention against the fixed encoder cache {k, v:
    (B, F, KV, hd)}: no mask, fp32 scores, qk-norm on q only (the cached k
    was normed when prefill wrote it). x: (B, 1, d)."""
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // kv
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    qg = q.reshape(b, 1, kv, g, hd)
    ck, cv = cache["k"].to(dt), cache["v"].to(dt)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), ck.float())
    wts = torch.softmax(scores / math.sqrt(hd), dim=-1).to(dt)
    out = torch.einsum("bkgst,btkh->bskgh", wts, cv).reshape(b, 1, h, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def _decode_block(p, x, cfg, bt: str, cache, pos: int, cross=None):
    """One block for one token; its cache entry is updated in place; a block
    with cross-attention reads `cross`, its cycle's encoder cache.  The MoE
    aux is dropped, as the reference does."""
    if bt != "attn":
        names = _STATE_NAMES[bt]
        x, _, st = _apply_block(p, x, cfg, bt, positions=None,
                                state=tuple(cache[n] for n in names))
        for name, t in zip(names, st):
            cache[name].copy_(t.to(cache[name].dtype))
        return x
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + _decode_attn(p["inner"], h, cfg, cache, pos)
    if "cross" in p:
        hx = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        x = x + _cross_from_cache(p["cross"], hx, cfg, cross)
    return _ffn(p, x, cfg)[0]


def decode_step(params, cache, tokens, pos: int, cfg, *,
                compute_dtype=torch.bfloat16):
    """One decode step. tokens: (B, 1) integer; pos: the token's position
    (after a vision-stub prefill, the patches count: P + S is the first).
    Returns (logits (B, 1, vocab) fp32, cache), the cache updated in place
    (the cross entry is read, never written)."""
    _check_supported(cfg)
    x = params["embed"][tokens].to(compute_dtype)
    for c in range(cfg.n_cycles):
        cyc_params = cycle_slice(params["cycles"], c)
        cyc_cache = cycle_slice(cache, c)
        for i, bt in enumerate(cfg.block_pattern):
            x = _decode_block(cyc_params[f"b{i}"], x, cfg, bt,
                              cyc_cache[f"b{i}"], pos, cyc_cache.get("cross"))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed_logits(params, x, cfg), cache


# ------------------------------------------------------------- prefill

def _prefill_entry(cfg, kr, v, s_tot: int):
    """One layer's cache entry from its rope'd k and its v (B, S, KV, hd)."""
    w = cfg.swa_window
    if w is not None and w < s_tot:
        return {"k": kr[:, -w:].to(CACHE_DTYPE),
                "v": v[:, -w:].to(CACHE_DTYPE),
                "pos": torch.arange(s_tot - w, s_tot, dtype=torch.int32,
                                    device=kr.device)}
    if w is not None:
        pad = w - s_tot
        return {"k": F.pad(kr, (0, 0, 0, 0, 0, pad)).to(CACHE_DTYPE),
                "v": F.pad(v, (0, 0, 0, 0, 0, pad)).to(CACHE_DTYPE),
                "pos": torch.cat([
                    torch.arange(s_tot, dtype=torch.int32, device=kr.device),
                    torch.full((pad,), -1, dtype=torch.int32,
                               device=kr.device)])}
    return {"k": kr.to(CACHE_DTYPE), "v": v.to(CACHE_DTYPE)}


def prefill(params, tokens, cfg, *, extra_embeds=None, frames=None,
            compute_dtype=torch.bfloat16):
    """Process a full prompt, returning (logits (B, 1, vocab), cache) ready
    for decode.

    extra_embeds: (B, P, d) stub patch embeddings, prepended (S_total = P +
    S); frames: (B, F, d) whisper's stub frame embeddings, through
    `encode`, whose output each decoder block attends to and whose k and v
    (k normed where qk_norm) fill the cross cache.  The cache covers
    exactly S_total (padded or trimmed to the SWA window for SWA archs);
    decode continues at pos = S_total.  Only the last position's logits
    are computed: (B, S, vocab) fp32 is GiBs at 8k.
    """
    _check_supported(cfg)
    enc_out = None
    if cfg.enc_dec:
        enc_out = encode(params, frames, cfg, compute_dtype=compute_dtype)
    x = embed_inputs(params, tokens, compute_dtype, extra_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = {}

    def store(key, c, entry):
        if c == 0:  # stacked storage, filled one cycle at a time
            cache[key] = {
                name: torch.empty((cfg.n_cycles,) + t.shape, dtype=t.dtype,
                                  device=t.device)
                for name, t in entry.items()}
        for name, t in entry.items():
            cache[key][name][c] = t

    for c in range(cfg.n_cycles):
        cyc = cycle_slice(params["cycles"], c)
        for i, bt in enumerate(cfg.block_pattern):
            p = cyc[f"b{i}"]
            if bt == "attn":
                h = rmsnorm(p["norm1"], x, cfg.norm_eps)
                # run attention AND capture rope'd k/v for the cache
                k = torch.einsum("bsd,dhk->bshk", h,
                                 p["inner"]["wk"].to(h.dtype))
                v = torch.einsum("bsd,dhk->bshk", h,
                                 p["inner"]["wv"].to(h.dtype))
                if cfg.qk_norm:
                    k = rmsnorm(p["inner"]["k_norm"], k, cfg.norm_eps)
                kr = rope(k, positions, cfg.rope_theta)
                x = x + attention(p["inner"], h, cfg, positions=positions)
                store(f"b{i}", c, _prefill_entry(cfg, kr, v, s))
                if "cross" in p and enc_out is not None:
                    x = _cross(p, x, cfg, enc_out)
                    ck = torch.einsum("bsd,dhk->bshk", enc_out,
                                      p["cross"]["wk"].to(h.dtype))
                    cv = torch.einsum("bsd,dhk->bshk", enc_out,
                                      p["cross"]["wv"].to(h.dtype))
                    if cfg.qk_norm:
                        ck = rmsnorm(p["cross"]["k_norm"], ck, cfg.norm_eps)
                    store("cross", c, {"k": ck.to(CACHE_DTYPE),
                                       "v": cv.to(CACHE_DTYPE)})
                x = _ffn(p, x, cfg)[0]
            else:  # the FFN runs in _apply_block
                x, _, st = _apply_block(p, x, cfg, bt, positions=positions,
                                        enc_out=enc_out)
                entry = dict(zip(_STATE_NAMES[bt], st))
                if bt == "mamba":
                    entry["conv"] = entry["conv"].to(CACHE_DTYPE)
                store(f"b{i}", c, entry)
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return unembed_logits(params, x, cfg), cache
