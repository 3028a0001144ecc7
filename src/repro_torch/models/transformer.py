"""Full-model init, forward and loss of every family of the model zoo.

The port of `repro.models.transformer`: dense, MoE and vision-stub
decoder-only LMs, the SSM (xLSTM) and hybrid (jamba) families, and the
whisper encoder-decoder.  Layers are grouped into cycles
(`cfg.block_pattern`) and the per-cycle params are stacked on a leading
"cycles" axis, the reference's tree, so its weights carry across
unchanged (`interop.lm_params_from_numpy`).  A block is a mixer
(attention, mamba, mLSTM or sLSTM: `models/ssm.py`), in whisper's decoder
a cross-attention sub-block over the encoder's output, and the reference's
FFN rule.  The forward pass loops over the cycle axis where the reference
scans, and under autograd `cfg.remat` checkpoints it one cycle at a time
(nested over groups of `cfg.remat_group` cycles) as the reference's
`jax.checkpoint` does.  MoE layers add their load-balance aux loss,
summed over every layer inside the checkpointed cycle.  `lm_axes` gives
the params' logical axes (the reference's second return of `init_lm`),
built by the same block code (`_block_tree`), and the activations pass
through `sharding.constrain` at the reference's sites.

whisper: stub frame embeddings (B, F, d) plus a sinusoid go through the
encoder's bidirectional attention blocks (rotary at positions arange(F),
as the reference's encoder applies them) to `enc_out`; each decoder block
attends to it after its self-attention.  The vision stub: patch
embeddings (B, P, d) through one linear adapter, prepended to the text.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .layers import (_init, attention, attention_axes, attention_init, mlp,
                     mlp_axes, mlp_init, moe, moe_axes, moe_init, rmsnorm,
                     rmsnorm_axes, rmsnorm_init)
from .sharding import ax, constrain
from .ssm import (mamba_axes, mamba_forward, mamba_init, mlstm_axes,
                  mlstm_forward, mlstm_init, slstm_axes, slstm_forward,
                  slstm_init)

_INNER_INIT = {"attn": attention_init, "mamba": mamba_init,
               "mlstm": mlstm_init, "slstm": slstm_init}
# a block's parts: the mixers, the FFNs
_PART_INIT = dict(_INNER_INIT, moe=moe_init, mlp=mlp_init)
_PART_AXES = {"attn": attention_axes, "mamba": mamba_axes,
              "mlstm": mlstm_axes, "slstm": slstm_axes, "moe": moe_axes,
              "mlp": mlp_axes}
_SSM_FORWARD = {"mamba": mamba_forward, "mlstm": mlstm_forward,
                "slstm": slstm_forward}


def _check_supported(cfg) -> None:
    for bt in cfg.block_pattern:
        if bt not in _INNER_INIT:
            raise ValueError(f"unknown block type {bt!r}")
    if cfg.enc_dec and tuple(cfg.block_pattern) != ("attn",):
        raise ValueError("an encoder-decoder takes the block pattern "
                         f"('attn',), not {cfg.block_pattern}")


def cycle_slice(tree, c: int):
    """The same nested dict with every leaf indexed at cycle c (views, so
    writes into a cache slice land in the stacked tensor)."""
    if isinstance(tree, dict):
        return {k: cycle_slice(v, c) for k, v in tree.items()}
    return tree[c]


def _block_tree(cfg, idx_in_pattern: int, make, *, cross=False):
    """The block at `idx_in_pattern` of the cycle, its parts from
    make(part) ("norm", a mixer, "moe" or "mlp"): its pre-norm and mixer,
    with `cross` a cross-attention sub-block and its pre-norm (`norm_x`,
    `cross`), and the reference's FFN rule: attention and mamba blocks get
    an MoE FFN (`ffn_moe`) where `cfg.layer_is_moe(idx_in_pattern)`, else
    the SwiGLU MLP where d_ff > 0; mLSTM and sLSTM blocks never get one."""
    bt = cfg.block_pattern[idx_in_pattern % len(cfg.block_pattern)]
    p = {"norm1": make("norm"), "inner": make(bt)}
    if cross:
        p["norm_x"] = make("norm")
        p["cross"] = make("attn")
    is_moe = cfg.layer_is_moe(idx_in_pattern)
    if bt in ("attn", "mamba") and (is_moe or cfg.d_ff > 0):
        p["norm2"] = make("norm")
        if is_moe:
            p["ffn_moe"] = make("moe")
        else:
            p["ffn"] = make("mlp")
    return p


def _block_init(gen, cfg, idx_in_pattern: int, *, cross=False, stack=(),
                device="cuda"):
    """The block's params (`_block_tree`), drawn from gen in tree order."""
    kw = dict(stack=stack, device=device)

    def make(part):
        if part == "norm":
            return rmsnorm_init(cfg.d_model, **kw)
        return _PART_INIT[part](gen, cfg, **kw)
    return _block_tree(cfg, idx_in_pattern, make, cross=cross)


def _stacked_axes(tree):
    """The axes of a stacked block: "cycles " before each leaf's names."""
    if isinstance(tree, dict):
        return {k: _stacked_axes(v) for k, v in tree.items()}
    return "cycles " + tree


def _block_axes(cfg, idx_in_pattern: int, *, cross=False):
    """The logical axes of `_block_init`'s params, unstacked."""
    return _block_tree(cfg, idx_in_pattern,
                       lambda part: rmsnorm_axes() if part == "norm"
                       else _PART_AXES[part](cfg), cross=cross)


def _ffn(p, x, cfg):
    """x plus the block's FFN of its pre-normed x: (x, aux), the aux loss of
    an MoE FFN, None for the MLP or no FFN."""
    if "ffn_moe" in p:
        out, aux = moe(p["ffn_moe"], rmsnorm(p["norm2"], x, cfg.norm_eps),
                       cfg.moe)
        return x + out, aux
    if "ffn" in p:
        x = x + mlp(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps))
    return x, None


def _cross(p, x, cfg, enc_out):
    """x plus the block's cross-attention of its pre-normed x over enc_out
    (no rope, not causal)."""
    h = rmsnorm(p["norm_x"], x, cfg.norm_eps)
    return x + attention(p["cross"], h, cfg, positions=None, kv_x=enc_out,
                         causal=False, use_rope=False)


def _apply_block(p, x, cfg, bt: str, *, positions, state=None, enc_out=None,
                 causal=True):
    """One block of type bt: mixer, cross-attention over enc_out where the
    block has one, optional FFN, pre-norm residuals.  Returns (x, aux,
    new_state): aux as `_ffn`'s, new_state the recurrent mixer's state
    after the sequence (None for attention), which starts from `state`
    (None: the mixer's initial state)."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if bt == "attn":
        out = attention(p["inner"], h, cfg, positions=positions, causal=causal)
        new_state = None
    else:
        out, new_state = _SSM_FORWARD[bt](p["inner"], h, cfg, state=state)
    x = x + out
    if "cross" in p:
        x = _cross(p, x, cfg, enc_out)
    x, aux = _ffn(p, x, cfg)
    return x, aux, new_state


# --------------------------------------------------------------- init

def init_lm(gen, cfg, *, device="cuda"):
    """Random fp32 params from `gen` (a torch.Generator on `device`), in the
    reference's tree: embed, [unembed], final_norm, cycles/b{i}/..., each
    leaf of `cycles` with a leading (n_cycles,) axis; whisper adds
    enc_cycles (one block, its leaves stacked over the n_enc_layers encoder
    layers) and enc_norm, and its
    decoder blocks their cross-attention; the vision stub adds
    vision_adapter (d, d)."""
    _check_supported(cfg)
    p = {"embed": _init(gen, (cfg.vocab, cfg.d_model), scale=0.02,
                        device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _init(gen, (cfg.d_model, cfg.vocab), device=device)
    p["final_norm"] = rmsnorm_init(cfg.d_model, device=device)
    p["cycles"] = {f"b{i}": _block_init(gen, cfg, i, cross=cfg.enc_dec,
                                        stack=(cfg.n_cycles,), device=device)
                   for i in range(len(cfg.block_pattern))}
    if cfg.enc_dec:
        # the encoder's blocks are the "attn" block without cross-attention
        p["enc_cycles"] = _block_init(gen, cfg, 0, stack=(cfg.n_enc_layers,),
                                      device=device)
        p["enc_norm"] = rmsnorm_init(cfg.d_model, device=device)
    if cfg.frontend == "vision_stub":
        # the anyres projector stub: one linear adapter on the patch
        # embeddings
        p["vision_adapter"] = _init(gen, (cfg.d_model, cfg.d_model),
                                    device=device)
    return p


def lm_axes(cfg):
    """The logical axes of `init_lm`'s params: the same tree, each leaf a
    packed string with one name a dim (`sharding.ax`), as the reference's
    init_lm returns them.  Leaves stacked over cycles (or whisper's encoder
    layers) carry the reference's "cycles " prefix.  Needs no generator
    and no device."""
    _check_supported(cfg)
    a = {"embed": ax("vocab", "embed")}
    if not cfg.tie_embeddings:
        a["unembed"] = ax("embed", "vocab")
    a["final_norm"] = rmsnorm_axes()
    a["cycles"] = {f"b{i}": _stacked_axes(_block_axes(cfg, i,
                                                      cross=cfg.enc_dec))
                   for i in range(len(cfg.block_pattern))}
    if cfg.enc_dec:
        a["enc_cycles"] = _stacked_axes(_block_axes(cfg, 0))
        a["enc_norm"] = rmsnorm_axes()
    if cfg.frontend == "vision_stub":
        a["vision_adapter"] = ax("embed", "embed_no_fsdp")
    return a


# ------------------------------------------------------------- forward

def unembed_logits(params, x, cfg):
    """fp32 logits of x (..., d) in the compute dtype."""
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"]).to(x.dtype)
    return (x @ unembed).float()


def _checkpointed(fn):
    """fn under activation checkpointing: its intermediates are recomputed
    in the backward instead of saved (the reference's jax.checkpoint)."""
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _sinusoid(positions, d):
    """(S, d) fp32: sin then cos of positions times d / 2 frequencies
    10000^(-i / (d / 2))."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params, frames, cfg, *, compute_dtype=torch.bfloat16):
    """whisper's encoder over stub frame embeddings (B, F, d): the frames
    plus the sinusoid in the compute dtype, the encoder's blocks
    (bidirectional attention, rotary at positions arange(F)), then
    enc_norm.  -> (B, F, d) in the compute dtype.  Under autograd
    `cfg.remat` checkpoints each layer."""
    b, f, _ = frames.shape
    x = frames.to(compute_dtype)
    pos = torch.arange(f, device=x.device)
    x = x + _sinusoid(pos, cfg.d_model).to(compute_dtype)
    positions = pos.expand(b, f)

    def layer_fn(x, c):
        return _apply_block(cycle_slice(params["enc_cycles"], c), x, cfg,
                            "attn", positions=positions, causal=False)[0]

    fn = (_checkpointed(layer_fn) if cfg.remat and torch.is_grad_enabled()
          else layer_fn)
    for c in range(cfg.n_enc_layers):
        x = fn(x, c)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def embed_inputs(params, tokens, compute_dtype, extra_embeds=None):
    """The token embeddings (B, S, d) in the compute dtype, with the stub
    patch embeddings (B, P, d) through the vision adapter (where the params
    have one) prepended: (B, P + S, d)."""
    x = params["embed"][tokens].to(compute_dtype)
    if extra_embeds is None:
        return x
    pe = extra_embeds.to(compute_dtype)
    if "vision_adapter" in params:
        pe = pe @ params["vision_adapter"].to(compute_dtype)
    return torch.cat([pe, x], dim=1)


def forward_lm(params, tokens, cfg, *, extra_embeds=None, enc_out=None,
               compute_dtype=torch.bfloat16):
    """tokens: (B, S) integer -> (logits (B, S_total, vocab) fp32, aux loss):
    the MoE layers' aux summed over the layers, 0 without MoE layers.

    extra_embeds: (B, P, d) stub patch embeddings, prepended (S_total =
    P + S; positions run over both).  enc_out: (B, F, d) the encoder's
    output, which every decoder block's cross-attention reads.

    With `cfg.remat` and autograd recording, each cycle is checkpointed;
    when `cfg.remat_group` > 1 divides the cycle count, groups of that many
    cycles are checkpointed too, around their checkpointed cycles (the
    reference's two-level form: the backward holds one group's carries and
    one cycle's intermediates at a time).  Without autograd (serving,
    `torch.no_grad()`) remat changes nothing."""
    _check_supported(cfg)
    x = embed_inputs(params, tokens, compute_dtype, extra_embeds)
    b, s_tot = x.shape[:2]
    positions = torch.arange(s_tot, device=x.device).expand(b, s_tot)

    # the carry is (x, aux), as the reference scans it: each cycle adds its
    # layers' aux inside the checkpointed function
    def cycle_fn(x, aux, c):
        cyc = cycle_slice(params["cycles"], c)
        x = constrain(x, ax("act_batch", ".", "."))
        for i, bt in enumerate(cfg.block_pattern):
            x, aux_i, _ = _apply_block(cyc[f"b{i}"], x, cfg, bt,
                                       positions=positions, enc_out=enc_out)
            if aux_i is not None:
                aux = aux + aux_i
        return constrain(x, ax("act_batch", ".", ".")), aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    group = cfg.remat_group if remat else 1
    inner = _checkpointed(cycle_fn) if remat else cycle_fn
    if group > 1 and cfg.n_cycles % group == 0:
        def outer_fn(x, aux, g):
            for c in range(g * group, (g + 1) * group):
                x, aux = inner(x, aux, c)
            return x, aux
        outer = _checkpointed(outer_fn)
        for g in range(cfg.n_cycles // group):
            x, aux = outer(x, aux, g)
    else:
        for c in range(cfg.n_cycles):
            x, aux = inner(x, aux, c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed_logits(params, x, cfg)
    return constrain(logits, ax("act_batch", ".", "act_vocab")), aux


def lm_loss(params, batch, cfg, *, compute_dtype=torch.bfloat16):
    """Next-token cross-entropy + MoE aux: (loss, {"ce", "aux"}).

    batch: {"tokens", "labels"} (B, S) integer, with "frames" (B, F, d) for
    whisper (through `encode`) or "patches" (B, P, d) for the vision stub
    (prepended; the loss runs over the text's logits only).  Labels below
    0 are masked and the mean runs over the unmasked tokens.  The label's
    log-probability is gathered where the reference contracts with a
    one-hot: the contraction has one non-zero term, so the value is the
    same, without a second (B, S, vocab) buffer."""
    enc_out = extra = None
    if cfg.enc_dec:
        enc_out = encode(params, batch["frames"], cfg,
                         compute_dtype=compute_dtype)
    if cfg.frontend == "vision_stub":
        extra = batch["patches"]
    logits, aux = forward_lm(params, batch["tokens"], cfg, extra_embeds=extra,
                             enc_out=enc_out, compute_dtype=compute_dtype)
    labels = batch["labels"]
    if extra is not None:
        logits = logits[:, -labels.shape[1]:]  # the text's logits only
    logp = torch.log_softmax(logits, dim=-1)
    del logits  # log_softmax keeps its output, not its input
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + aux, {"ce": loss, "aux": aux}
