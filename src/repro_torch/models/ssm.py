"""Recurrent blocks: Mamba (jamba hybrid) and xLSTM (mLSTM/sLSTM).

The port of `repro.models.ssm`.  Each block type has an init, a sequence
form for training and prefill that takes and returns its state, and a
state init (the decode cache's entry: constant in S).  Init functions take
an explicit `torch.Generator` and draw fp32 params with the reference's
shapes and scales; `stack` prepends leading axes (the cycle axis); each
has an `*_axes` twin, its params' logical axes.  Apply
functions keep the reference's casts: projections in the activation dtype,
the recurrences in fp32.

Mamba runs a chunked selective scan: one chunk's (B, chunk, d_in, N)
decay and input at a time, scanned inside the chunk and carried across
chunks, so the peak is O(B chunk d_in N) instead of O(B S d_in N).  The
reference scans a chunk with `lax.associative_scan`; here the same combine
runs as a log2(chunk)-step doubling scan, whose tree differs from XLA's,
so the two agree to fp32 rounding.  The mLSTM and sLSTM recurrences are
sequential loops over time, checkpointed per chunk under autograd as the
reference's `_checkpointed_seq_scan` is (memory only, never values).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import _init, rmsnorm
from .sharding import ax

NEG_STATE = -1e30  # the stabiliser m's initial value, as the reference's


def _full(shape, value, *, stack=(), device="cuda"):
    return torch.full(tuple(stack) + tuple(shape), value, dtype=torch.float32,
                      device=device)


def _softplus(x):
    """The reference's softplus, logaddexp(x, 0), in x's dtype (no
    threshold branch)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _tracks_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ------------------------------------------------------------------ mamba

def mamba_init(gen, cfg, *, stack=(), device="cuda"):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_d_state
    r = max(1, d // 16)  # dt rank
    kw = dict(stack=stack, device=device)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device)).expand(d_in, n)
    return {
        "in_proj": _init(gen, (d, 2 * d_in), **kw),
        "conv_w": _init(gen, (d_in, cfg.ssm_conv), scale=0.5, **kw),
        "conv_b": _full((d_in,), 0.0, **kw),
        "x_proj": _init(gen, (d_in, r + 2 * n), **kw),
        "dt_proj": _init(gen, (r, d_in), scale=1.0 / math.sqrt(r), **kw),
        "dt_bias": torch.log(torch.expm1(_full((d_in,), 0.01, **kw))),
        "a_log": a_log.expand(tuple(stack) + (d_in, n)).contiguous(),
        "d_skip": _full((d_in,), 1.0, **kw),
        "out_proj": _init(gen, (d_in, d), scale=1.0 / math.sqrt(d_in), **kw),
    }


def mamba_axes(cfg):
    return {"in_proj": ax("embed", "ssm_inner"),
            "conv_w": ax("ssm_inner", "conv"),
            "conv_b": ax("ssm_inner"),
            "x_proj": ax("ssm_inner", "."),
            "dt_proj": ax(".", "ssm_inner"),
            "dt_bias": ax("ssm_inner"),
            "a_log": ax("ssm_inner", "ssm_state"),
            "d_skip": ax("ssm_inner"),
            "out_proj": ax("ssm_inner", "embed")}


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv along seq via shifted adds, in x's dtype.

    x: (B, S, d_in); w: (d_in, K).  conv_state: (B, K-1, d_in) history for
    decode continuity.  Returns (out, new_state: the last K-1 inputs)."""
    k = w.shape[1]
    if conv_state is None:
        hist = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    else:
        hist = conv_state.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)                 # (B, S+K-1, d_in)
    out = torch.zeros_like(x)
    s = x.shape[1]
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[:, i].to(x.dtype)
    new_state = xp[:, -(k - 1):, :] if k > 1 else hist
    return out + b.to(x.dtype), new_state


def _doubling_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 (from h = 0):
    (a_cum, b_cum) with the reference's combine (a_l a_r, b_l a_r + b_r),
    in log2(len) doubling steps."""
    n, off = a.shape[1], 1
    while off < n:  # no view outlives its step: each old pair is freed
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return a, b


def _ssm_chunk(h, a, dt_c, b_c, c_c, x_cc):
    """One chunk of the selective scan: (y (B, chunk, d_in), h_last)."""
    # the decay and input (B, chunk, d_in, N) are held by the scan alone, so
    # its first step frees them
    a_cum, b_cum = _doubling_scan(
        torch.exp(dt_c[..., None] * a),
        dt_c[..., None] * b_c[:, :, None, :] * x_cc[..., None])
    h_all = a_cum * h[:, None] + b_cum
    y = torch.einsum("bsdn,bsn->bsd", h_all, c_c)
    return y, h_all[:, -1].clone()  # not a view that keeps h_all


def _ssm_scan_chunked(dt, a, b_mat, c_mat, x_c, h0, chunk: int):
    """Chunked selective scan: y_t = C_t . h_t with
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t.

    S is padded to a multiple of the chunk with dt = 0 (decay 1, input 0).
    Under autograd each chunk is checkpointed, as the reference's step is.
    dt, x_c: (B, S, d_in); b_mat, c_mat: (B, S, N); a: (d_in, N) fp32.
    Returns (y (B, S, d_in) fp32, h_last (B, d_in, N))."""
    b, s, _ = dt.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    xs = [t.float() for t in (dt, b_mat, c_mat, x_c)]
    if pad:
        xs = [F.pad(t, (0, 0, 0, pad)) for t in xs]
    step = _ssm_chunk
    if _tracks_grad(h0, a, *xs):
        def step(*args):
            return checkpoint(_ssm_chunk, *args, use_reentrant=False)
    h, ys = h0, []
    for i in range(0, s + pad, chunk):
        y, h = step(h, a, *(t[:, i:i + chunk] for t in xs))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], h


def mamba_forward(p, x, cfg, *, state=None):
    """x: (B, S, d). state: None or (conv_state, ssm_state) for continuity.
    Returns (y, (new_conv_state, new_ssm_state))."""
    b, s, d = x.shape
    n = cfg.ssm_d_state
    d_in = cfg.ssm_expand * d
    dt_ = x.dtype
    conv_state = state[0] if state is not None else None
    h0 = (state[1] if state is not None
          else torch.zeros((b, d_in, n), dtype=torch.float32, device=x.device))

    xz = x @ p["in_proj"].to(dt_)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_c, new_conv = _causal_conv(x_in, p["conv_w"], p["conv_b"], conv_state)
    x_c = F.silu(x_c)

    dbc = x_c @ p["x_proj"].to(dt_)
    r = p["dt_proj"].shape[0]
    dt_r, b_mat, c_mat = torch.split(dbc, [r, n, n], dim=-1)
    dt = _softplus(dt_r @ p["dt_proj"].to(dt_) + p["dt_bias"].to(dt_))
    a = -torch.exp(p["a_log"])                                # (d_in, N)

    y, h_last = _ssm_scan_chunked(dt, a, b_mat, c_mat, x_c, h0,
                                  cfg.mamba_chunk)
    y = y.to(dt_)
    y = y + p["d_skip"].to(dt_) * x_c
    y = y * F.silu(z)
    return y @ p["out_proj"].to(dt_), (new_conv, h_last)


def mamba_init_state(b, cfg, dtype=torch.bfloat16, *, device="cuda"):
    """(conv state (B, K-1, d_in) in `dtype`, ssm state (B, d_in, N) fp32)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return (torch.zeros((b, cfg.ssm_conv - 1, d_in), dtype=dtype, device=device),
            torch.zeros((b, d_in, cfg.ssm_d_state), dtype=torch.float32,
                        device=device))


# --------------------------------------------------- sequential recurrences

def _seq_scan(step, n_carry: int, *tensors):
    """Loop `step` over time.  tensors: the n_carry carry tensors, then the
    inputs with time leading.  Returns the final carry's tensors and the
    stacked outputs, as one flat tuple (what `checkpoint` passes through)."""
    carry, xs = tuple(tensors[:n_carry]), tensors[n_carry:]
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x_[t] for x_ in xs))
        ys.append(y)
    return carry + (torch.stack(ys),)


def _checkpointed_seq_scan(step, carry, xs, chunk: int):
    """Loop over time with per-chunk checkpointing under autograd.

    Sequential recurrences save their carry at every step under plain
    autograd; checkpointed per chunk, the backward holds the chunks'
    boundary carries and one chunk's intermediates.  One unchunked loop
    when the length is not a multiple of the chunk (or no gradient is
    recorded).  carry, xs: tuples of tensors, xs time-leading.  Returns
    (carry, ys) with ys time-leading."""
    n = len(carry)
    s = xs[0].shape[0]
    if (chunk >= s or s % chunk != 0
            or not _tracks_grad(*carry, *xs)):
        out = _seq_scan(step, n, *carry, *xs)
        return out[:n], out[n]
    ys = []
    for i in range(0, s, chunk):
        out = checkpoint(_seq_scan, step, n, *carry,
                         *(x_[i:i + chunk] for x_ in xs), use_reentrant=False)
        carry = out[:n]
        ys.append(out[n])
    return carry, torch.cat(ys)


_MLSTM_CHUNK = 64
_SLSTM_CHUNK = 256


# ------------------------------------------------------------------ mlstm

def mlstm_init(gen, cfg, *, stack=(), device="cuda"):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    h = cfg.n_heads
    kw = dict(stack=stack, device=device)
    return {
        "up_proj": _init(gen, (d, 2 * d_in), **kw),
        "wq": _init(gen, (d_in, d_in), **kw),
        "wk": _init(gen, (d_in, d_in), **kw),
        "wv": _init(gen, (d_in, d_in), **kw),
        "w_igate": _init(gen, (d_in, h), scale=0.01, **kw),
        "w_fgate": _init(gen, (d_in, h), scale=0.01, **kw),
        "b_igate": _full((h,), 0.0, **kw),
        "b_fgate": _full((h,), 3.0, **kw),  # forget-bias init
        "out_norm": _full((d_in,), 1.0, **kw),
        "down_proj": _init(gen, (d_in, d), scale=1.0 / math.sqrt(d_in), **kw),
    }


def mlstm_axes(cfg):
    return {"up_proj": ax("embed", "ssm_inner"),
            "wq": ax("ssm_inner", "."), "wk": ax("ssm_inner", "."),
            "wv": ax("ssm_inner", "."),
            "w_igate": ax("ssm_inner", "heads"),
            "w_fgate": ax("ssm_inner", "heads"),
            "b_igate": ax("heads"), "b_fgate": ax("heads"),
            "out_norm": ax("ssm_inner"),
            "down_proj": ax("ssm_inner", "embed")}


def _mlstm_step(carry, xs):
    c_mat, n_vec, m = carry
    qt, kt, vt, igt, fgt = xs                         # (B,H,hd) x3, (B,H) x2
    m_new = torch.maximum(fgt + m, igt)
    fprime = torch.exp(fgt + m - m_new)[..., None]
    iprime = torch.exp(igt - m_new)[..., None]
    c_new = (c_mat * fprime[..., None]
             + iprime[..., None] * kt[..., :, None] * vt[..., None, :])
    n_new = n_vec * fprime + iprime * kt
    denom = torch.clamp(torch.abs(torch.sum(n_new * qt, dim=-1, keepdim=True)),
                        min=1.0)
    h = torch.einsum("bhij,bhi->bhj", c_new, qt) / denom
    return (c_new, n_new, m_new), h


def _mlstm_scan(q, k, v, ig, fg, state):
    """Stabilised exponential-gating matrix-memory recurrence.

    q, k, v: (B, S, H, hd) fp32; ig, fg: (B, S, H) log-space gates.
    state: (C (B,H,hd,hd), n (B,H,hd), m (B,H)).  Returns (h (B,S,H,hd),
    state)."""
    xs = tuple(t.movedim(1, 0) for t in (q, k, v, ig, fg))
    state, hs = _checkpointed_seq_scan(_mlstm_step, tuple(state), xs,
                                       _MLSTM_CHUNK)
    return hs.movedim(0, 1), state


def mlstm_forward(p, x, cfg, *, state=None):
    """x: (B, S, d); state: None or (C, n, m).  Returns (y, new_state).
    The head dim is d_in // n_heads (not cfg.d_head)."""
    b, s, d = x.shape
    d_in = cfg.ssm_expand * d
    h = cfg.n_heads
    hd = d_in // h
    dt_ = x.dtype
    if state is None:
        state = mlstm_init_state(b, cfg, device=x.device)

    xz = x @ p["up_proj"].to(dt_)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    q = (x_in @ p["wq"].to(dt_)).reshape(b, s, h, hd)
    k = (x_in @ p["wk"].to(dt_)).reshape(b, s, h, hd) / math.sqrt(hd)
    v = (x_in @ p["wv"].to(dt_)).reshape(b, s, h, hd)
    ig = (x_in @ p["w_igate"].to(dt_)).float() + p["b_igate"]
    fg = -_softplus(-((x_in @ p["w_fgate"].to(dt_)).float() + p["b_fgate"]))

    hs, state = _mlstm_scan(q.float(), k.float(), v.float(), ig, fg, state)
    hs = hs.to(dt_).reshape(b, s, d_in)
    hs = rmsnorm({"scale": p["out_norm"]}, hs, cfg.norm_eps)
    return (hs * F.silu(z)) @ p["down_proj"].to(dt_), state


def mlstm_init_state(b, cfg, *, device="cuda"):
    d_in = cfg.ssm_expand * cfg.d_model
    h = cfg.n_heads
    hd = d_in // h
    kw = dict(dtype=torch.float32, device=device)
    return (torch.zeros((b, h, hd, hd), **kw), torch.zeros((b, h, hd), **kw),
            torch.full((b, h), NEG_STATE, **kw))


# ------------------------------------------------------------------ slstm

def slstm_init(gen, cfg, *, stack=(), device="cuda"):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    kw = dict(stack=stack, device=device)
    # the gate biases laid out [z 0 | i 0 | f 3.0 | o 0]
    bias = _full((4 * d,), 0.0, **kw)
    bias[..., 2 * d:3 * d] = 3.0
    return {
        "w_in": _init(gen, (d, 4 * d), **kw),         # z, i, f, o pre-acts
        "r": _init(gen, (h, hd, 4 * hd), scale=1.0 / math.sqrt(hd), **kw),
        "b": bias,
        "out_proj": _init(gen, (d, d), **kw),
    }


def slstm_axes(cfg):
    return {"w_in": ax("embed", "."),
            "r": ax("heads", "head_dim", "."),
            "b": ax("."),
            "out_proj": ax("embed", "embed_no_fsdp")}


def slstm_forward(p, x, cfg, *, state=None):
    """Scalar-memory LSTM with exponential gating and a block-diagonal
    recurrence (one head = one block), sequential over S; all fp32.
    x: (B, S, d); state: None or (c, n, h, m).  Returns (y, new_state)."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    if state is None:
        state = slstm_init_state(b, cfg, device=x.device)

    pre = (x @ p["w_in"].to(x.dtype)).float() + p["b"]
    r = p["r"].float()  # a bf16 copy (the train step's) promotes, as in JAX

    def step(carry, xs):
        c, n, hprev, m = carry                        # (B, H, hd) each
        (pre_t,) = xs
        rec = torch.einsum("bhi,hij->bhj", hprev, r)  # (B, H, 4 hd)
        # pre_t: (B, 4d) laid out [z | i | f | o]; regroup per head
        pre_h = pre_t.reshape(b, 4, h, hd).transpose(1, 2).reshape(
            b, h, 4 * hd)
        zi, ii, fi, oi = torch.split(pre_h, hd, dim=-1)
        zr, ir, fr, orr = torch.split(rec, hd, dim=-1)
        zt = torch.tanh(zi + zr)
        it = ii + ir
        ft = fi + fr
        ot = torch.sigmoid(oi + orr)
        m_new = torch.maximum(ft + m, it)
        iprime = torch.exp(it - m_new)
        fprime = torch.exp(ft + m - m_new)
        c_new = fprime * c + iprime * zt
        n_new = fprime * n + iprime
        h_new = ot * c_new / torch.clamp(n_new, min=1.0)
        return (c_new, n_new, h_new, m_new), h_new

    state, hs = _checkpointed_seq_scan(step, tuple(state), (pre.movedim(1, 0),),
                                       _SLSTM_CHUNK)
    hs = hs.movedim(0, 1).reshape(b, s, d).to(x.dtype)
    return hs @ p["out_proj"].to(x.dtype), state


def slstm_init_state(b, cfg, *, device="cuda"):
    h = cfg.n_heads
    hd = cfg.d_model // h
    kw = dict(dtype=torch.float32, device=device)
    return (torch.zeros((b, h, hd), **kw), torch.zeros((b, h, hd), **kw),
            torch.zeros((b, h, hd), **kw), torch.full((b, h, hd), NEG_STATE, **kw))
