"""The port's MoE family on the CPU against the JAX package, on the same
numpy inputs and on JAX's init_lm weights (carried across by
lm_params_from_numpy): `layers.moe` with its grouped capacity dispatch
(tokens dropped, several groups, decode, exact ties among the router's
probabilities, bf16) and its aux loss, their gradient, forward_lm, prefill
and decode_step, lm_loss with remat, a train step, and the counterparts of
tests/test_arch_smoke.py's cases, for qwen3-moe-30b-a3b's and grok-1-314b's
SMOKE; then chip_smoke.py's phase 18 reckonings (the predicted serving peak
and the dropped share) against a CPU run.  Each tolerance is stated beside
what it measured."""

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import grok_1_314b as j_grok
from repro.configs import qwen3_moe_30b_a3b as j_qwen
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenSource as JSource
from repro.models import layers as j_layers
from repro.models.decode import decode_step as j_decode_step
from repro.models.decode import init_cache as j_init_cache
from repro.models.decode import prefill as j_prefill
from repro.models.transformer import forward_lm as j_forward_lm
from repro.models.transformer import init_lm as j_init_lm
from repro.models.transformer import lm_loss as j_lm_loss
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import interop
from repro_torch.configs import LM_CONFIGS, LM_SMOKE_CONFIGS
from repro_torch.configs import grok_1_314b as grok
from repro_torch.configs import qwen3_moe_30b_a3b as qwen
from repro_torch.data import DataConfig, SyntheticTokenSource
from repro_torch.models import config, layers
from repro_torch.models.decode import decode_step, init_cache, prefill
from repro_torch.models.transformer import (cycle_slice, forward_lm, init_lm,
                                            lm_loss)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve_lm import _grow_cache, generate
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.launch import costmodel

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"qwen3-moe-30b-a3b": (qwen, j_qwen), "grok-1-314b": (grok, j_grok)}
NAMES = sorted(MODULES)
PROMPT = (2, 12)     # batch, prompt length: 24 tokens, one group with drops
N_STEPS = 4          # decode steps after the prefill
J_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x.astype(np.float64)))
    return np.ldexp(1.0, e - 8)


def _smoke(name):
    return MODULES[name][0].SMOKE


@pytest.fixture(scope="module")
def weights():
    """JAX's init_lm weights per config, and the port's copy of them."""
    cache = {}

    def get(cfg):
        if cfg not in cache:
            pj, _ = j_init_lm(jax.random.PRNGKey(0), cfg)
            tree = jax.tree.map(np.asarray, pj)
            cache[cfg] = (pj, interop.lm_params_from_numpy(tree, device="cpu"))
        return cache[cfg]
    return get


def _moe_params(weights, cfg, c=0):
    """Cycle c's MoE FFN params of b0 in both packages."""
    pj, pt = weights(cfg)
    return (jax.tree.map(lambda a: a[c], pj["cycles"]["b0"]["ffn_moe"]),
            cycle_slice(pt["cycles"]["b0"]["ffn_moe"], c))


def _x(shape, seed=2):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("name", NAMES)
def test_moe_configs_are_the_references(name):
    mod, ref = MODULES[name]
    for attr in ("CONFIG", "SMOKE"):
        got, want = getattr(mod, attr), getattr(ref, attr)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
    assert mod.__doc__ == ref.__doc__
    assert LM_CONFIGS[name] is mod.CONFIG
    assert LM_SMOKE_CONFIGS[name] is mod.SMOKE
    assert config.get_arch(name) is mod.CONFIG


@pytest.mark.parametrize("name", NAMES)
def test_full_config_parameters_match_assignment(name):
    """tests/test_arch_smoke.py's full-dimension case for the port's
    configs."""
    cfg = LM_CONFIGS[name]
    expected = {"qwen3-moe-30b-a3b": (48, 2048, 32, 4, 151936),
                "grok-1-314b": (64, 6144, 48, 8, 131072)}[name]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab) == expected
    if name == "qwen3-moe-30b-a3b":
        assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert) == \
            (128, 8, 768)
        assert cfg.qk_norm and cfg.d_head == 128 and cfg.d_ff == 0
    if name == "grok-1-314b":
        assert (cfg.moe.n_experts, cfg.moe.top_k) == (8, 2)
        assert cfg.moe.d_expert == 32768 and cfg.d_ff == 0


# ----------------------------------------------------------- moe_init

@pytest.mark.parametrize("name", NAMES)
def test_init_lm_draws_the_reference_tree_and_moe_scales(weights, name):
    """The port's init_lm gives JAX's tree (norm2 + ffn_moe, no ffn) and
    moe_init's scales: 1/sqrt(E) for w_gate and w_up (`_init`'s default of
    1/sqrt(shape[0]) on (E, d, fe)), 1/sqrt(d) for the router, 1/sqrt(fe)
    for w_down; the stacked cycle axis changes none of them."""
    cfg = _smoke(name)
    pj, _ = weights(cfg)
    pt = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = {tuple(p.key for p in path): tuple(x.shape) for path, x in
            jax.tree_util.tree_leaves_with_path(pj)}
    got = {k: tuple(v.shape) for k, v in _flat(pt).items()}
    assert got == want
    assert ("cycles", "b0", "ffn") not in got
    e, d, fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    m = pt["cycles"]["b0"]["ffn_moe"]
    assert tuple(m["w_gate"].shape) == (cfg.n_cycles, e, d, fe)
    # relative sampling error of a std over n draws ~ 1/sqrt(2n) <= 1.1e-2
    for leaf, scale in (("router", d ** -0.5), ("w_gate", e ** -0.5),
                        ("w_up", e ** -0.5), ("w_down", fe ** -0.5)):
        assert m[leaf].dtype == torch.float32
        assert float(m[leaf].std()) == pytest.approx(scale, rel=0.05), leaf
    gen = torch.Generator().manual_seed(1)
    alone = layers.moe_init(gen, cfg, device="cpu")
    assert float(alone["w_gate"].std()) == pytest.approx(e ** -0.5, rel=0.05)


def test_block_init_asks_layer_is_moe_with_the_index_in_the_pattern(weights):
    """A two-block pattern with MoE on every other block and a dense d_ff:
    b0 gets ffn_moe and b1 the MLP, as the reference's has_ffn rule gives,
    and the forward matches JAX's."""
    cfg = qwen.SMOKE.scaled(block_pattern=("attn", "attn"), d_ff=48,
                            moe=dataclasses.replace(qwen.SMOKE.moe, every=2))
    pj, pt = weights(cfg)
    assert set(pt["cycles"]["b0"]) == {"norm1", "inner", "norm2", "ffn_moe"}
    assert set(pt["cycles"]["b1"]) == {"norm1", "inner", "norm2", "ffn"}
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, PROMPT)
    lj, aj = j_forward_lm(pj, jnp.asarray(tokens, jnp.int32), cfg,
                          compute_dtype=jnp.float32)
    lt, at = forward_lm(pt, torch.from_numpy(tokens), cfg,
                        compute_dtype=torch.float32)
    assert _rel_err(lt, lj) <= 1e-5
    assert float(at) == pytest.approx(float(aj), rel=1e-5)


def test_lm_params_from_numpy_carries_the_moe_leaves(weights):
    cfg = qwen.SMOKE
    pj, pt = weights(cfg)
    want = jax.tree.map(np.asarray, pj["cycles"]["b0"]["ffn_moe"])
    got = pt["cycles"]["b0"]["ffn_moe"]
    assert set(got) == {"router", "w_gate", "w_up", "w_down"}
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), w)


# --------------------------------------------------- groups and capacity

def test_moe_group_count_matches_the_reference():
    for e in (1, 4, 8, 16, 128):
        for t in (1, 2, 3, 4, 24, 96, 128, 500, 512, 1000, 1024, 2048, 4096,
                  6000, 8192, 16384, 32768, 65536, 131072):
            assert layers._moe_group_count(t, e) == \
                j_layers._moe_group_count(t, e), (t, e)
    assert layers._MOE_GROUPS == j_layers._MOE_GROUPS == 32


# --------------------------------------------------------------- moe

# name -> (config, x shape, compute dtype, (groups, capacity), tolerance on
# y over max |y| and on aux, relative).  Measured in fp32: y 1.7e-7 to
# 2.1e-7, aux 0 to 1.9e-7; bf16 (bf16 roundings of sums in other orders) y
# 4.5e-3, aux 0 (the bound: tests/test_torch_models.py's bf16 logits
# tolerance)
MOE_CASES = {
    "drops": (qwen.SMOKE, (2, 12), torch.float32, (1, 7), 1e-5),
    "groups": (qwen.SMOKE, (4, 32), torch.float32, (4, 10), 1e-5),
    "decode": (qwen.SMOKE, (2, 1), torch.float32, (1, 4), 1e-5),
    "grok_groups": (grok.SMOKE, (4, 32), torch.float32, (8, 10), 1e-5),
    "bf16": (qwen.SMOKE, (4, 32), torch.bfloat16, (4, 10), 3e-2),
}


def _reference_experts(pj, xj, spec):
    """The reference's top-k experts (lax.top_k over its softmax), per
    group."""
    t = xj.shape[0] * xj.shape[1]
    g = j_layers._moe_group_count(t, spec.n_experts)
    xf = xj.reshape(g, t // g, -1)
    logits = (xf @ pj["router"].astype(xj.dtype)).astype(jnp.float32)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), spec.top_k)[1])


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_jax(weights, case):
    cfg, shape, dt, (groups, cap), tol = MOE_CASES[case]
    spec = cfg.moe
    pj, pt = _moe_params(weights, cfg)
    xj, xt = _x(shape + (cfg.d_model,))
    xj, xt = xj.astype(J_DT[dt]), xt.to(dt)
    yj, aj = j_layers.moe(pj, xj, spec)
    yt, at = layers.moe(pt, xt, spec)
    assert yt.dtype == dt and tuple(yt.shape) == shape + (cfg.d_model,)
    assert at.dtype == torch.float32 and at.dim() == 0
    assert _rel_err(yt, yj) <= tol
    assert abs(float(at) - float(aj)) <= tol * abs(float(aj))

    r = layers.moe_route(pt, xt, spec)
    t, k = shape[0] * shape[1], spec.top_k
    assert (r["groups"], r["capacity"]) == (groups, cap)
    kept = int((r["slot"] < spec.n_experts * cap).sum())
    np.testing.assert_array_equal(r["expert"].numpy(),
                                  _reference_experts(pj, xj, spec))
    if case in ("drops", "groups", "grok_groups"):
        assert kept < t * k     # capacity dropped some assignments
    if case == "decode":
        assert kept == t * k    # nothing dropped
    # the slots: each kept assignment in its expert's range, each slot once,
    # the first `cap` of an expert in token order kept
    slot = r["slot"].reshape(groups, -1)
    e_flat = r["expert"].reshape(groups, -1)
    for gi in range(groups):
        used = slot[gi][slot[gi] < spec.n_experts * cap]
        assert len(set(used.tolist())) == len(used)
        for ex in range(spec.n_experts):
            mine = slot[gi][e_flat[gi] == ex]
            n_kept = min(len(mine), cap)
            np.testing.assert_array_equal(
                mine[:n_kept].numpy(), ex * cap + np.arange(n_kept))
            assert bool((mine[n_kept:] == spec.n_experts * cap).all())


@pytest.mark.parametrize("name", NAMES)
def test_moe_ties_keep_the_lower_expert_as_lax_top_k(weights, name):
    """A router with duplicated columns, so that probabilities tie exactly:
    experts (0, 1, 2) and (3, 4) share their columns.  The port keeps the
    experts lax.top_k keeps (the lower index first), and y and aux match."""
    cfg = _smoke(name)
    spec = cfg.moe
    pj, pt = _moe_params(weights, cfg)
    router = np.asarray(pj["router"]).copy()
    dup = {1: 0, 2: 0, 4: 3} if spec.n_experts > 4 else {1: 0, 2: 0}
    for col, src in dup.items():
        router[:, col] = router[:, src]
    pj = dict(pj, router=jnp.asarray(router))
    pt = dict(pt, router=torch.from_numpy(router))
    xj, xt = _x((4, 32, cfg.d_model), seed=5)
    r = layers.moe_route(pt, xt, spec)
    probs = r["probs"]
    assert bool((probs[..., 0] == probs[..., 1]).all())   # exact ties
    # a tie straddles the top-k boundary: the lower index won it
    straddle = (r["expert"] == 0).any(-1) & (r["expert"] == 1).any(-1) \
        & ~(r["expert"] == 2).any(-1)
    assert bool(straddle.any())
    np.testing.assert_array_equal(r["expert"].numpy(),
                                  _reference_experts(pj, xj, spec))
    yj, aj = j_layers.moe(pj, xj, spec)
    yt, at = layers.moe(pt, xt, spec)
    assert _rel_err(yt, yj) <= 1e-5
    assert float(at) == pytest.approx(float(aj), rel=1e-5)


# gradient of <y, r> + aux in every MoE leaf and x, fp32, each leaf's
# largest difference over its largest entry (measured <= 4.0e-7)
MOE_GRAD_TOL = 1e-5


@pytest.mark.parametrize("case", ["drops", "groups", "grok_groups"])
def test_moe_gradient_matches_jax_grad(weights, case):
    cfg, shape, _, _, _ = MOE_CASES[case]
    spec = cfg.moe
    pj, pt = _moe_params(weights, cfg)
    xj, xt = _x(shape + (cfg.d_model,))
    rj, rt = _x(shape + (cfg.d_model,), seed=9)

    def f(p, x):
        y, aux = j_layers.moe(p, x, spec)
        return jnp.sum(y * rj) + aux
    gj_p, gj_x = jax.grad(f, argnums=(0, 1))(pj, xj)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    x = xt.clone().requires_grad_(True)
    y, aux = layers.moe(leaves, x, spec)
    (torch.sum(y * rt) + aux).backward()
    for k in leaves:
        assert leaves[k].grad is not None and \
            _rel_err(leaves[k].grad, gj_p[k]) <= MOE_GRAD_TOL, k
    assert _rel_err(x.grad, gj_x) <= MOE_GRAD_TOL


def test_moe_dropped_assignment_gets_no_gradient(weights, monkeypatch):
    """A gate whose assignment fell past the capacity gets no gradient: y
    does not depend on it (the counts carry none either)."""
    cfg = qwen.SMOKE
    spec = cfg.moe
    _, pt = _moe_params(weights, cfg)
    _, xt = _x((2, 12, cfg.d_model))
    r = layers.moe_route(pt, xt, spec)
    dropped = r["slot"] == spec.n_experts * r["capacity"]
    assert bool(dropped.any())
    gate = r["gate"].detach().requires_grad_(True)
    monkeypatch.setattr(layers, "moe_route", lambda p, x, s: dict(r, gate=gate))
    y, _ = layers.moe(pt, xt, spec)
    (g,) = torch.autograd.grad(y.sum(), gate)
    assert bool((g[dropped] == 0).all())
    assert bool((g[~dropped] != 0).all())


def test_moe_combine_gives_the_same_bits_twice(weights):
    cfg = qwen.SMOKE
    _, pt = _moe_params(weights, cfg)
    _, xt = _x((4, 32, cfg.d_model), seed=11)
    y1, a1 = layers.moe(pt, xt, cfg.moe)
    y2, a2 = layers.moe(pt, xt, cfg.moe)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


# ------------------------------------------------------- the whole path

def _serve_jax(pj, cfg, prompt, dt):
    """JAX: forward_lm logits and aux, prefill logits and cache, then
    N_STEPS greedy decode steps on a grown cache."""
    fwd = jax.jit(lambda t: j_forward_lm(pj, t, cfg, compute_dtype=dt))
    pre = jax.jit(lambda t: j_prefill(pj, t, cfg, compute_dtype=dt))
    step = jax.jit(lambda c, t, p: j_decode_step(pj, c, t, p, cfg,
                                                 compute_dtype=dt))
    out = {}
    out["forward"], out["aux"] = fwd(prompt)
    logits, cache = pre(prompt)
    out["prefill_logits"], out["prefill_cache"] = logits, cache
    cache = jax.tree.map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, N_STEPS)]
                          + [(0, 0)] * (x.ndim - 3)), cache)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out["tokens"], out["logits"] = [], []
    for i in range(N_STEPS):
        out["tokens"].append(np.asarray(tok))
        logits, cache = step(cache, tok, jnp.int32(prompt.shape[1] + i))
        out["logits"].append(logits)
        tok = jnp.argmax(logits[:, 0], axis=-1)[:, None].astype(jnp.int32)
    out["cache"] = cache
    return out


def _assert_caches_close(got, want):
    """Every bf16 entry within one bf16 ulp."""
    assert got.keys() == want.keys()
    for blk in want:
        assert got[blk].keys() == want[blk].keys(), blk
        for name, w in want[blk].items():
            g = got[blk][name]
            assert g.dtype == torch.bfloat16, (blk, name)
            gn, wn = _np(g), _np(w)
            assert gn.shape == wn.shape, (blk, name)
            tol = _bf16_ulp(np.maximum(np.abs(gn), np.abs(wn)))
            assert (np.abs(gn - wn) <= tol).all(), (blk, name)


# (config name, compute dtype) -> logits tolerance over max |logit|, as
# tests/test_torch_models.py's (measured fp32 <= 1.1e-5, bf16 <= 2.1e-2);
# the aux within 1e-6 in fp32 and 1e-2 in bf16 (measured <= 7.9e-8 and
# <= 1.5e-4)
PATH_CASES = {(n, dt): tol for n in NAMES
              for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2))}


@pytest.mark.parametrize("name,dt", list(PATH_CASES),
                         ids=[f"{n}-{str(d)[6:]}" for n, d in PATH_CASES])
def test_forward_prefill_and_decode_match_jax(weights, name, dt):
    cfg = _smoke(name)
    tol = PATH_CASES[(name, dt)]
    pj, pt = weights(cfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, PROMPT).astype(np.int32)
    want = _serve_jax(pj, cfg, jnp.asarray(prompt), J_DT[dt])
    tp = torch.from_numpy(prompt.astype(np.int64))
    logits, aux = forward_lm(pt, tp, cfg, compute_dtype=dt)
    assert tuple(logits.shape) == (*PROMPT, cfg.vocab)
    assert _rel_err(logits, want["forward"]) <= tol
    assert abs(float(aux) - float(want["aux"])) <= \
        (1e-6 if dt == torch.float32 else 1e-2) * abs(float(want["aux"]))
    logits, cache = prefill(pt, tp, cfg, compute_dtype=dt)
    assert _rel_err(logits, want["prefill_logits"]) <= tol
    if dt == torch.float32:
        _assert_caches_close(cache, want["prefill_cache"])
    cache = _grow_cache(cache, N_STEPS, kv_quant=False)
    for i, tok in enumerate(want["tokens"]):
        if dt == torch.float32:  # identical greedy ids
            np.testing.assert_array_equal(
                torch.argmax(logits[:, -1], dim=-1).numpy(), tok[:, 0])
        logits, cache = decode_step(pt, cache, torch.from_numpy(
            tok.astype(np.int64)), PROMPT[1] + i, cfg, compute_dtype=dt)
        assert tuple(logits.shape) == (PROMPT[0], 1, cfg.vocab)
        assert _rel_err(logits, want["logits"][i]) <= tol
    if dt == torch.float32:
        _assert_caches_close(cache, want["cache"])


def test_generate_serves_an_moe_model(weights):
    """serve_lm.generate on qwen's SMOKE: the ids of the example loop (the
    JAX greedy ids above), no kernel of the port on the CPU."""
    cfg = qwen.SMOKE
    pj, pt = weights(cfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, PROMPT).astype(np.int32)
    want = _serve_jax(pj, cfg, jnp.asarray(prompt), jnp.float32)
    ids, cache = generate(pt, cfg, torch.from_numpy(prompt.astype(np.int64)),
                          N_STEPS, compute_dtype=torch.float32)
    np.testing.assert_array_equal(
        ids.numpy(), np.concatenate(want["tokens"], axis=1))
    assert cache["b0"]["k"].shape[2] == PROMPT[1] + N_STEPS


# ---------------------------------------------------------------- lm_loss

def _batch(cfg, seed=3, shape=(2, 16)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels[0, :3] = -1
    return tokens, labels


# remat off, per cycle and nested (remat_group 2; 4 layers, two groups of
# two checkpointed cycles): the loss and aux within 1e-6 (measured <= 1.4e-7
# and <= 8.1e-8), each leaf's gradient within 2e-5 of its largest entry
# (measured <= 3.7e-6), tests/test_torch_train.py's fp32 tolerances
LOSS_REMAT = {"off": dict(remat=False), "per_cycle": dict(remat=True),
              "group2": dict(remat=True, remat_group=2)}


@pytest.mark.parametrize("remat", list(LOSS_REMAT))
@pytest.mark.parametrize("name", NAMES)
def test_lm_loss_value_aux_and_grad_match_jax(weights, name, remat):
    cfg = _smoke(name).scaled(n_layers=4, **LOSS_REMAT[remat])
    pj, pt = weights(cfg)
    tokens, labels = _batch(cfg)

    def f(p):
        return j_lm_loss(p, {"tokens": tokens, "labels": labels}, cfg,
                         compute_dtype=jnp.float32)
    (lj, parts_j), gj = jax.jit(jax.value_and_grad(f, has_aux=True))(pj)
    leaves = tree_map(lambda x: x.clone().requires_grad_(True), pt)
    loss, parts = lm_loss(leaves, {"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels)},
                          cfg, compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    loss, parts = loss.detach(), {k: v.detach() for k, v in parts.items()}
    assert float(loss) == pytest.approx(float(lj), rel=1e-6)
    assert float(parts["aux"]) > 0
    assert float(parts["aux"]) == pytest.approx(float(parts_j["aux"]), rel=1e-6)
    assert float(parts["ce"]) == pytest.approx(float(parts_j["ce"]), rel=1e-6)
    want = jax.tree.leaves(gj)
    assert len(grads) == len(want)
    worst = max(_rel_err(g, w) for g, w in zip(grads, want))
    assert worst <= 2e-5, worst


def test_remat_gives_the_same_moe_loss_and_gradients_bit_for_bit(weights):
    """remat per cycle and nested against off on the CPU: the same bits,
    the aux summed inside the checkpointed cycle included."""
    cfg = qwen.SMOKE.scaled(n_layers=4)
    _, pt = weights(cfg)
    tokens, labels = _batch(cfg)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    out = {}
    for name, kw in LOSS_REMAT.items():
        leaves = tree_map(lambda x: x.clone().requires_grad_(True), pt)
        loss, parts = lm_loss(leaves, batch, cfg.scaled(**kw),
                              compute_dtype=torch.float32)
        out[name] = (loss.detach(), parts["aux"].detach(),
                     torch.autograd.grad(loss, tree_leaves(leaves)))
    for name in ("per_cycle", "group2"):
        assert torch.equal(out[name][0], out["off"][0])
        assert torch.equal(out[name][1], out["off"][1])
        for a, b in zip(out[name][2], out["off"][2]):
            assert torch.equal(a, b)


# -------------------------------------------------------------- train step

# one step at lr 1e-2 (warmup 1), fp32 compute, against the reference's
# jitted step: tests/test_torch_train.py's TRAIN_TOL (loss and lr 1e-6,
# grad norm 1e-4, the params' update 1e-3 of the reference's, the moments
# 3e-4 of each leaf's largest entry); measured loss <= 2.1e-7, grad norm
# <= 2.0e-7, update <= 6.9e-5, moments <= 4.8e-6
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name, microbatches):
    cfg = _smoke(name)
    tc_kw = dict(peak_lr=1e-2, warmup=1, total_steps=10,
                 microbatches=microbatches, compute_dtype="float32")
    sj, _ = j_init_train_state(jax.random.PRNGKey(0), cfg, JTrainConfig(**tc_kw))
    st = interop.train_state_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")
    start = [x.clone() for x in tree_leaves(st["params"])]
    batch = jax.tree.map(np.asarray, JSource(cfg, JDataConfig(
        seed=0, global_batch=4, seq_len=16)).batch_at(0))
    sj, mj = jax.jit(j_make_train_step(cfg, JTrainConfig(**tc_kw)))(sj, batch)
    st, mt = make_train_step(cfg, TrainConfig(**tc_kw))(
        st, interop.train_state_from_numpy(batch, device="cpu"))
    for k in ("loss", "lr", "ce"):
        assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-6), k
    assert float(mt["aux"]) == pytest.approx(float(mj["aux"]), rel=1e-6)
    assert (float(mt["aux"]) > 0) == (microbatches == 1)
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]),
                                                   rel=1e-4)
    num = den = 0.0
    for g, w, s in zip(tree_leaves(st["params"]), jax.tree.leaves(sj["params"]),
                       start):
        w = torch.tensor(np.asarray(w))
        num += float(((g - w) ** 2).sum())
        den += float(((w - s) ** 2).sum())
    assert math.sqrt(num / den) <= 1e-3
    for k in ("m", "v"):
        worst = max(_rel_err(g, w) for g, w in zip(
            tree_leaves(st["opt"][k]), jax.tree.leaves(sj["opt"][k])))
        assert worst <= 3e-4, k


# ------------------------------------ tests/test_arch_smoke.py's counterparts

@pytest.mark.parametrize("name", NAMES)
def test_smoke_forward_and_train_step(name):
    cfg = _smoke(name)
    tc = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=10)
    state, _ = init_train_state(torch.Generator().manual_seed(0), cfg, tc,
                                device="cpu")
    src = SyntheticTokenSource(cfg, DataConfig(seed=0, global_batch=2,
                                               seq_len=16), device="cpu")
    state, metrics = make_train_step(cfg, tc)(state, src.batch_at(0))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0, f"{name}: loss={loss}"
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["aux"]) > 0
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(state["params"]))


@pytest.mark.parametrize("name", NAMES)
def test_smoke_decode_step(name):
    cfg = _smoke(name)
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = init_cache(cfg, 2, 8, device="cpu")
    want = j_init_cache(cfg, 2, 8)
    assert {k: {n: tuple(t.shape) for n, t in e.items()} for k, e in cache.items()} \
        == {k: {n: tuple(t.shape) for n, t in e.items()} for k, e in want.items()}
    logits, cache2 = decode_step(params, cache, torch.zeros((2, 1), dtype=torch.long),
                                 0, cfg)
    assert tuple(logits.shape) == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache2 is cache


# ----------------------------------------- chip_smoke.py's phase 18 reckonings

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cpu_peak_bytes(fn):
    """The largest bytes held at once by the tensors fn allocates on the
    CPU, from torch.profiler's memory records: each op's own allocations
    net of its frees and each free outside an op, summed in time order (a
    transient an op allocates and frees inside itself is not seen)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn()
    held = peak = 0
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        held += e.self_cpu_memory_usage
        peak = max(peak, held)
    return peak


@pytest.mark.parametrize("name", NAMES)
def test_chip_smoke_moe_param_count_is_the_models(name):
    cs = _chip_smoke()
    cfg = _smoke(name)
    params = init_lm(torch.Generator(), cfg, device="cpu")
    assert costmodel.train_param_count(cfg) == sum(x.numel() for x in tree_leaves(params))
    # the full configs: qwen3-moe-30b-a3b a layer 623.1 M (604.0 M in
    # experts), 16 layers and the untied embedding and head 10.59 B
    full = LM_CONFIGS["qwen3-moe-30b-a3b"]
    assert costmodel.layer_param_count(full) == 623_120_640
    assert costmodel.train_param_count(full.scaled(n_layers=16)) == 10_592_262_144


def test_chip_smoke_moe_serve_peak_against_a_cpu_run(monkeypatch):
    """The predicted peak of generate at SMOKE size (the query-chunked
    attention taken, as at 8,192 on the card): the params' and both caches'
    terms are the run's own bytes, and the rest of the total lies within
    [1, 1.3] of the peak the CPU run holds (measured 1.014: the dispatch
    decides at this size, where the card's run is decided by the scores)."""
    cs = _chip_smoke()
    monkeypatch.setattr(layers, "_QCHUNK_THRESHOLD", 64)
    monkeypatch.setattr(layers, "_QCHUNK", 32)
    cfg = qwen.SMOKE.scaled(vocab=128)
    b, s, new = 4, 128, 8
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (b, s),
                           generator=torch.Generator().manual_seed(1))
    box = {}

    def run():
        box["ids"], box["cache"] = generate(params, cfg, prompt, new,
                                            compute_dtype=torch.bfloat16)
    measured = _cpu_peak_bytes(run)
    pred = costmodel.serve_peak_bytes(cfg, b, s, new)
    assert pred["params"] == sum(x.numel() * 4 for x in tree_leaves(params))
    assert pred["cache_grown"] == sum(
        t.numel() * t.element_size() for e in box["cache"].values()
        for t in e.values())
    assert pred["cache"] * (s + new) == pred["cache_grown"] * s
    assert (pred["groups"], pred["capacity"]) == (16, 10)
    # the run's peak counts the params it allocated itself: none here
    dynamic = pred["total"] - pred["params"]
    assert 1.0 <= dynamic / measured <= 1.3, (dynamic, measured)


def test_chip_smoke_moe_serve_peak_at_full_width():
    """qwen3-moe-30b-a3b, 16 layers, 4 x 8,192 prompts and 64 new tokens:
    39.46 GiB of fp32 params, prefill's 2 x 8 GiB of chunked fp32 scores,
    under 70 GiB with the batch of 4."""
    cs = _chip_smoke()
    cfg = LM_CONFIGS["qwen3-moe-30b-a3b"].scaled(n_layers=16)
    pred = costmodel.serve_peak_bytes(cfg, 4, 8_192, 64)
    assert pred["params"] / 2**30 == pytest.approx(39.46, abs=0.01)
    assert pred["scores"] == 2 * 4 * 32 * 2_048 * 8_192 * 4
    assert (pred["groups"], pred["capacity"]) == (32, 80)
    assert 55 < pred["total"] / 2**30 < 70


@pytest.mark.parametrize("shape", [(2, 12), (4, 32), (2, 1)])
def test_chip_smoke_drop_share_is_what_moe_keeps(weights, shape):
    """moe_drop_share from the counts equals 1 - the assignments moe_route
    kept over T k; and y equals a combine of the kept assignments alone."""
    cs = _chip_smoke()
    cfg = qwen.SMOKE
    spec = cfg.moe
    _, pt = _moe_params(weights, cfg)
    _, xt = _x(shape + (cfg.d_model,))
    r = layers.moe_route(pt, xt, spec)
    kept = int((r["slot"] < spec.n_experts * r["capacity"]).sum())
    share = cs.moe_drop_share(r["counts"], r["capacity"])
    assert share == pytest.approx(1 - kept / r["slot"].numel(), abs=1e-12)
    assert (share > 0) == (shape != (2, 1))
    # the kept assignments alone, expert by expert, give moe's y
    y, _ = layers.moe(pt, xt, spec)
    xf = xt.reshape(r["groups"], -1, cfg.d_model)
    want = torch.zeros_like(xf)
    keep = r["slot"] < spec.n_experts * r["capacity"]
    for gi, ti, ki in keep.nonzero().tolist():
        ex = int(r["expert"][gi, ti, ki])
        xi = xf[gi, ti]
        hi = torch.nn.functional.silu(xi @ pt["w_gate"][ex]) * (xi @ pt["w_up"][ex])
        want[gi, ti] += r["gate"][gi, ti, ki] * (hi @ pt["w_down"][ex])
    assert _rel_err(y.reshape(want.shape), want) <= 1e-5


def test_chip_smoke_moe_routing_records_every_layer(weights):
    """moe_routing records one routing a layer through forward_lm, prefill
    and decode_step, and leaves the logits as they were."""
    cs = _chip_smoke()
    cfg = qwen.SMOKE
    _, pt = weights(cfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, PROMPT))
    plain, _ = forward_lm(pt, tokens, cfg, compute_dtype=torch.float32)
    with cs.moe_routing() as log:
        logits, _ = forward_lm(pt, tokens, cfg, compute_dtype=torch.float32)
        prefill(pt, tokens, cfg, compute_dtype=torch.float32)
    assert torch.equal(plain, logits)
    assert len(log) == 2 * cfg.n_layers
    assert cs._same_routing(log[:cfg.n_layers], log[cfg.n_layers:])
    assert not cs._same_routing(log[:1], log[1:2])
    from repro_torch.models import transformer
    assert transformer.moe is layers.moe
