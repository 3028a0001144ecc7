"""Neural blocks of the model zoo: init + apply, plain functions on dicts.

The port of `repro.models.layers` for the attention models: RMSNorm,
rotary embeddings, GQA attention (self- and cross-attention, causal or
not, with the query-chunked path for long sequences), the SwiGLU MLP and
the top-k MoE FFN with its grouped capacity dispatch and load-balance aux
loss.

Init functions take an explicit `torch.Generator` and draw fp32 params with
the reference's shapes and scales (not its random bits); `stack` prepends
leading axes, which is how the per-cycle params get their cycle axis.
Apply functions take activations in the compute dtype with fp32 params,
cast each param to the activation dtype at its product, and compute
attention scores in fp32 (the reference's `preferred_element_type`).
Each init has an `*_axes` twin: the logical axes of its params (one packed
name string a leaf, `sharding.ax`), the reference's second return value.
Activations pass through `sharding.constrain` at the reference's sites;
with no mesh installed it hands its input back.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .sharding import activation_mesh, ax, constrain

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


def rmsnorm_axes():
    return {"scale": ax(".")}


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


def attention_axes(cfg):
    a = {"wq": ax("embed", "heads", "head_dim"),
         "wk": ax("embed", "kv_heads", "head_dim"),
         "wv": ax("embed", "kv_heads", "head_dim"),
         "wo": ax("heads", "head_dim", "embed")}
    if cfg.qk_norm:
        a["q_norm"] = rmsnorm_axes()
        a["k_norm"] = rmsnorm_axes()
    return a


def _attn_mask(sq, skv, *, causal: bool = True, swa: int | None,
               q_offset=0, device=None):
    """(sq, skv) boolean mask: causal (key position <= query position)
    and/or banded to the last `swa` keys when swa is set. q_offset =
    absolute position of query 0."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if swa is not None:
        m &= kpos > qpos - swa
    return m


_QCHUNK_THRESHOLD = 8192  # at and above this, query-chunk the S x S scores
_QCHUNK = 2048


def attention(p, x, cfg, *, positions, kv_x=None, causal=True,
              use_rope=True, mask=None):
    """GQA attention. x: (B, S, d); kv_x (B, F, d): keys and values from
    it instead of x (cross-attention: key positions arange(F), no sliding
    window).  Causal and sliding-window (cfg.swa_window) by default;
    `causal=False` drops the causal part; `use_rope=False` leaves q and k
    unrotated; an explicit boolean `mask` (broadcast against the (B, KV,
    G, S, F) scores) replaces the built one.

    Long sequences without an explicit mask go through query chunks of
    _QCHUNK, so the fp32 score buffer is (B, KV, G, _QCHUNK, F) instead of
    (B, KV, G, S, F)."""
    b, sq, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // kv
    dt = x.dtype
    src = x if kv_x is None else kv_x
    skv = src.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if kv_x is None else
                 torch.arange(skv, device=x.device).expand(b, skv),
                 cfg.rope_theta)
    qg = q.reshape(b, sq, kv, g, hd)
    k32 = k.float()
    swa = cfg.swa_window if kv_x is None else None

    def block(q_blk, blk_mask):
        # fp32 scores from exact fp32 copies of the operands, scaled into a
        # tensor of their own and masked in place, since at the chunk size
        # this buffer is GiBs (einsum returns a view: an in-place op on it
        # would make autograd clone the whole buffer's gradient in the
        # backward, twice)
        scores = torch.einsum("bskgh,btkh->bkgst", q_blk.float(), k32)
        if activation_mesh() is not None:
            # the reference pins batch and the merged (kv, g) head dim (one
            # spec entry cannot split a mesh axis over two dims)
            scores = constrain(scores.flatten(1, 2),
                               ax("act_batch", "act_heads", ".", "."),
                               allow_uneven=True).unflatten(1, (kv, g))
        scores = scores / math.sqrt(hd)
        if blk_mask is not None:
            scores.masked_fill_(~blk_mask, NEG_INF)
        scores = torch.softmax(scores, dim=-1)
        return torch.einsum("bkgst,btkh->bskgh", scores.to(dt), v)

    if sq >= _QCHUNK_THRESHOLD and mask is None and sq % _QCHUNK == 0:
        out = torch.cat([
            block(qg[:, i:i + _QCHUNK],
                  _attn_mask(_QCHUNK, skv, causal=causal, swa=swa,
                             q_offset=i, device=x.device)
                  if (causal or swa) else None)
            for i in range(0, sq, _QCHUNK)], dim=1)
    else:
        if mask is None and (causal or swa):
            mask = _attn_mask(sq, skv, causal=causal, swa=swa,
                              device=x.device)
        out = block(qg, mask)
    out = out.reshape(b, sq, h, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


# ----------------------------------------------------------- swiglu mlp

def mlp_init(gen, cfg, *, stack=(), device="cuda"):
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(stack=stack, device=device)
    return {"w_gate": _init(gen, (d, f), **kw), "w_up": _init(gen, (d, f), **kw),
            "w_down": _init(gen, (f, d), **kw)}


def mlp_axes(cfg):
    return {"w_gate": ax("embed", "ffn"), "w_up": ax("embed", "ffn"),
            "w_down": ax("ffn", "embed")}


def mlp(p, x):
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    h = constrain(h, ax("act_batch", ".", "act_ffn"))
    return h @ p["w_down"].to(dt)


# ------------------------------------------------------------------ moe

def moe_init(gen, cfg, *, stack=(), device="cuda"):
    """The router (d, E) and the experts' SwiGLU weights (E, d, fe) and
    (E, fe, d), with the reference's scales: `_init`'s default of
    1/sqrt(shape[0]) makes w_gate's and w_up's 1/sqrt(E)."""
    d, spec = cfg.d_model, cfg.moe
    e, fe = spec.n_experts, spec.d_expert
    kw = dict(stack=stack, device=device)
    return {"router": _init(gen, (d, e), **kw),
            "w_gate": _init(gen, (e, d, fe), **kw),
            "w_up": _init(gen, (e, d, fe), **kw),
            "w_down": _init(gen, (e, fe, d), scale=1.0 / math.sqrt(fe), **kw)}


def moe_axes(cfg):
    return {"router": ax("embed", "experts"),
            "w_gate": ax("experts", "embed", "expert_ffn"),
            "w_up": ax("experts", "embed", "expert_ffn"),
            "w_down": ax("experts", "expert_ffn", "embed")}


_MOE_GROUPS = 32  # dispatch groups (GShard-style), as the reference's


def _moe_group_count(t: int, e: int) -> int:
    """Largest group count <= _MOE_GROUPS keeping >= 4*E tokens per group
    (decode batches route globally; training splits into 32 groups)."""
    g = _MOE_GROUPS
    while g > 1 and (t // g) < 4 * e:
        g //= 2
    while t % g:
        g //= 2
    return max(g, 1)


def moe_route(p, x, spec):
    """The routing of `moe` for x (B, S, d): a dict of
      groups, capacity   G and C (Python ints; T = B S tokens in G groups
                         of Tg, each expert C slots a group);
      probs              (G, Tg, E) fp32 softmax of the router logits;
      expert, gate       (G, Tg, k) the top-k experts, lower index first on
                         a tie (`lax.top_k`'s order), and their gates
                         renormalised to sum to 1;
      counts             (G, E) assignments per expert before the drop;
      slot               (G, Tg, k) each assignment's slot e*C + position
                         in its expert, or E*C (the trash) where it fell
                         past the capacity: the first C assignments of an
                         expert in token order are kept.
    """
    b, s, d = x.shape
    t = b * s
    e, k = spec.n_experts, spec.top_k
    g_cnt = _moe_group_count(t, e)
    tg = t // g_cnt
    c = max(4, int(spec.capacity_factor * tg * k / e))
    xf = constrain(x.reshape(g_cnt, tg, d), ax("act_moe_groups", ".", "."))
    logits = (xf @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower index first among equal
    # probabilities, as lax.top_k does; torch.topk promises no order
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[..., :k], idx[..., :k]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    flat_e = expert.reshape(g_cnt, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    counts = torch.zeros((g_cnt, e), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, -1) - counts
    pos_in_e = (torch.arange(tg * k, device=x.device)[None]
                - torch.gather(starts, -1, se))
    sorted_slot = torch.where(pos_in_e < c, se * c + pos_in_e, e * c)
    slot = torch.empty_like(sorted_slot).scatter_(1, order, sorted_slot)
    return {"groups": g_cnt, "capacity": c, "probs": probs, "expert": expert,
            "gate": gate, "counts": counts, "slot": slot.reshape(g_cnt, tg, k)}


def moe(p, x, spec):
    """Top-k token-choice MoE with the reference's grouped sort-based
    capacity dispatch. x: (B, S, d) -> (y (B, S, d), aux loss fp32).

    Tokens split into G groups (`_moe_group_count`), each expert holding C
    slots a group (`moe_route`). The slot table's gather reads a zero row
    for an empty slot; the expert products run over all E x C slots, each
    weight cast to the activation dtype at its product. The combine sums
    gate x expert output in fp32 over each token's kept slots in ascending
    slot order (the order of the reference's scatter-add), gathered
    through the table's inverse instead of scattered, so that no atomic
    add makes the result differ between runs; then casts to x's dtype.
    The aux loss is switch-style over all groups: E sum(frac_tokens x
    frac_probs) x aux_loss_weight, frac_tokens from the counts before the
    drop.  Autograd reaches the gates, the gather and the combine; a
    dropped assignment gets no gradient and the counts carry none."""
    b, s, d = x.shape
    e, k = spec.n_experts, spec.top_k
    r = moe_route(p, x, spec)
    g_cnt, c, slot = r["groups"], r["capacity"], r["slot"]
    tg = b * s // g_cnt
    dt = x.dtype
    dev = x.device
    rows = torch.arange(g_cnt, device=dev)[:, None]

    # the slot table: the token in each slot, tg (the zero row) where empty
    table = torch.full((g_cnt, e * c + 1), tg, dtype=torch.int64, device=dev)
    tok = torch.arange(tg, device=dev)[None, :, None].expand(g_cnt, tg, k)
    table[rows, slot.reshape(g_cnt, -1)] = tok.reshape(g_cnt, -1)
    table = table[:, :-1]
    xz = torch.cat([x.reshape(g_cnt, tg, d),
                    torch.zeros((g_cnt, 1, d), dtype=dt, device=dev)], dim=1)
    xg = constrain(xz[rows, table], ax("act_moe_groups", ".", "."))
    xe = constrain(xg.reshape(g_cnt, e, c, d),
                   ax("act_moe_groups", "act_experts", ".", "."))

    h = (F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt)))
         * torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(dt)))
    h = constrain(h, ax("act_moe_groups", "act_experts", ".", "act_ffn"))
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))
    ye = constrain(ye, ax("act_moe_groups", "act_experts", ".", "."))
    # the trash slot E*C reads a zero row
    ye = torch.cat([ye.reshape(g_cnt, e * c, d),
                    torch.zeros((g_cnt, 1, d), dtype=dt, device=dev)], dim=1)

    # combine: each token's k slots in ascending order (the trash last)
    slot_sorted, j = torch.sort(slot, dim=-1)
    gate = torch.gather(r["gate"], -1, j)
    y = ye[rows, slot_sorted[..., 0]].float() * gate[..., 0, None]
    for i in range(1, k):
        y = y + ye[rows, slot_sorted[..., i]].float() * gate[..., i, None]
    y = constrain(y, ax("act_moe_groups", ".", "."))
    y = y.reshape(b, s, d).to(dt)

    frac_tokens = torch.sum(r["counts"], 0).float() / (b * s * k)
    frac_probs = torch.mean(r["probs"], dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs) * spec.aux_loss_weight
    return y, aux
