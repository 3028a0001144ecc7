"""The port's LM serving path on the CPU against the JAX package, on the
same weights (JAX's init_lm tree carried across by lm_params_from_numpy)
and the same token ids: the layers, forward_lm, prefill + decode_step
(full attention, SWA, qk-norm, int8 KV rows), and serve_lm.generate
against the loop of examples/serve_lm.py, at llama3.2-1b's SMOKE size."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_1b as j_llama
from repro.models import config as j_config
from repro.models import layers as j_layers
from repro.models.decode import decode_step as j_decode_step
from repro.models.decode import init_cache as j_init_cache
from repro.models.decode import prefill as j_prefill
from repro.models.transformer import forward_lm as j_forward_lm
from repro.models.transformer import init_lm as j_init_lm
from repro_torch import interop
from repro_torch.configs import LM_CONFIGS, LM_SMOKE_CONFIGS
from repro_torch.configs import llama3_2_1b as llama
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import config, layers
from repro_torch.models.decode import decode_step, init_cache, prefill
from repro_torch.models.transformer import cycle_slice, forward_lm, init_lm
from repro_torch.serve_lm import _grow_cache, generate

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

SMOKE = llama.SMOKE
PROMPT = (2, 12)     # batch, prompt length
N_STEPS = 8          # decode steps after the prefill
J_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x.astype(np.float64)))
    return np.ldexp(1.0, e - 8)


def _assert_caches_close(got, want):
    """Every bf16 entry within one bf16 ulp, int8 within one count, fp32
    scales within rel 1e-6, positions equal."""
    assert got.keys() == want.keys()
    for blk in want:
        assert got[blk].keys() == want[blk].keys(), blk
        for name, w in want[blk].items():
            g = got[blk][name]
            assert tuple(g.shape) == tuple(w.shape), (blk, name)
            if name == "pos":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            elif g.dtype == torch.int8:
                assert np.abs(g.numpy().astype(np.int32)
                              - np.asarray(w).astype(np.int32)).max() <= 1
            elif name.endswith("_scale"):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
            else:
                assert g.dtype == torch.bfloat16, (blk, name)
                gn, wn = _np(g), _np(w)
                tol = _bf16_ulp(np.maximum(np.abs(gn), np.abs(wn)))
                assert (np.abs(gn - wn) <= tol).all(), (blk, name)


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


def _prompt(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, PROMPT).astype(np.int32)


def _serve_jax(pj, cfg, prompt, dt, *, grow):
    """JAX: forward_lm logits, prefill logits and cache, then N_STEPS greedy
    decode steps (the loop of examples/serve_lm.py): step logits, the ids
    fed to each step, and the final cache."""
    fwd = jax.jit(lambda t: j_forward_lm(pj, t, cfg, compute_dtype=dt)[0])
    pre = jax.jit(lambda t: j_prefill(pj, t, cfg, compute_dtype=dt))
    step = jax.jit(lambda c, t, p: j_decode_step(pj, c, t, p, cfg,
                                                 compute_dtype=dt))
    out = {"forward": fwd(prompt)}
    logits, cache = pre(prompt)
    out["prefill_logits"], out["prefill_cache"] = logits, cache
    if grow:
        cache = jax.tree.map(
            lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, N_STEPS)]
                              + [(0, 0)] * (x.ndim - 3)) if x.ndim == 5 else x,
            cache)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out["tokens"], out["logits"] = [], []
    for i in range(N_STEPS):
        out["tokens"].append(np.asarray(tok))
        logits, cache = step(cache, tok, jnp.int32(prompt.shape[1] + i))
        out["logits"].append(logits)
        tok = jnp.argmax(logits[:, 0], axis=-1)[:, None].astype(jnp.int32)
    out["cache"] = cache
    return out


VARIANTS = {  # name -> (config, compute dtype, logits tolerance)
    "fp32": (SMOKE, torch.float32, 1e-4),
    "bf16": (SMOKE, torch.bfloat16, 3e-2),
    "swa": (SMOKE.scaled(swa_window=8), torch.float32, 1e-4),
    "swa_padded": (SMOKE.scaled(swa_window=16), torch.float32, 1e-4),
    "qk_norm": (SMOKE.scaled(qk_norm=True), torch.float32, 1e-4),
}


@pytest.fixture(scope="module")
def served(weights):
    """Per variant: the JAX run and the port's run on the same weights, the
    port fed JAX's token ids so that every step compares like with like."""
    runs = {}

    def get(name):
        if name in runs:
            return runs[name]
        cfg, dt, _ = VARIANTS[name]
        pj, pt = weights(cfg)
        prompt = _prompt(cfg)
        grow = cfg.swa_window is None
        want = _serve_jax(pj, cfg, jnp.asarray(prompt), J_DT[dt], grow=grow)
        tp = torch.from_numpy(prompt.astype(np.int64))
        got = {"forward": forward_lm(pt, tp, cfg, compute_dtype=dt)[0]}
        logits, cache = prefill(pt, tp, cfg, compute_dtype=dt)
        got["prefill_logits"] = logits
        got["prefill_cache"] = {k: {n: t.clone() for n, t in e.items()}
                                for k, e in cache.items()}
        if grow:
            cache = _grow_cache(cache, N_STEPS, kv_quant=False)
        got["logits"], got["argmax"] = [], []
        for i, tok in enumerate(want["tokens"]):
            got["argmax"].append(torch.argmax(logits[:, -1], dim=-1))
            logits, cache = decode_step(
                pt, cache, torch.from_numpy(tok.astype(np.int64)),
                prompt.shape[1] + i, cfg, compute_dtype=dt)
            got["logits"].append(logits)
        got["cache"] = cache
        runs[name] = (want, got)
        return runs[name]
    return get


# ------------------------------------------------------------- config

def test_arch_config_is_the_reference_dataclass():
    fields = [(f.name, f.default) for f in dataclasses.fields(config.ArchConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(j_config.ArchConfig)]
    assert fields == want
    for name in ("CONFIG", "SMOKE"):
        got, ref = getattr(llama, name), getattr(j_llama, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.n_cycles == ref.n_cycles
        assert got.param_count() == ref.param_count()
    assert LM_CONFIGS["llama3.2-1b"] is llama.CONFIG
    assert LM_SMOKE_CONFIGS["llama3.2-1b"] is SMOKE
    assert config.get_arch("llama3.2-1b") is llama.CONFIG


def test_init_lm_draws_the_reference_tree_and_scales(weights):
    pj, _ = weights(SMOKE)
    pt = init_lm(torch.Generator().manual_seed(0), SMOKE, device="cpu")
    shapes_j = [(path, tuple(x.shape)) for path, x in
                jax.tree_util.tree_leaves_with_path(pj)]
    flat_t = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat_t[path + (k,)] = v
    walk(pt, ())
    assert len(flat_t) == len(shapes_j)
    for path, shape in shapes_j:
        key = tuple(p.key for p in path)
        assert tuple(flat_t[key].shape) == shape, key
        assert flat_t[key].dtype == torch.float32, key
    inner = pt["cycles"]["b0"]["inner"]
    h, hd = SMOKE.n_heads, SMOKE.d_head
    assert float(pt["embed"].std()) == pytest.approx(0.02, rel=0.05)
    assert float(inner["wo"].std()) == pytest.approx((h * hd) ** -0.5, rel=0.1)
    assert float(inner["wq"].std()) == pytest.approx(SMOKE.d_model ** -0.5,
                                                     rel=0.1)
    assert bool((pt["final_norm"]["scale"] == 1).all())


# ------------------------------------------------------------- layers

def _layer_params(weights, cfg=SMOKE):
    pj, pt = weights(cfg)
    pj0 = jax.tree.map(lambda x: x[0], pj["cycles"]["b0"])
    pt0 = cycle_slice(pt["cycles"]["b0"], 0)
    return pj0, pt0


def _x(shape, seed=2):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_rmsnorm_rope_mlp_match_jax(weights):
    pj, pt = _layer_params(weights)
    xj, xt = _x((2, 12, SMOKE.d_model))
    np.testing.assert_allclose(
        layers.rmsnorm(pt["norm1"], xt).numpy(),
        np.asarray(j_layers.rmsnorm(pj["norm1"], xj)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layers.mlp(pt["ffn"], xt).numpy(),
        np.asarray(j_layers.mlp(pj["ffn"], xj)), rtol=1e-5, atol=1e-5)
    hj, ht = _x((2, 12, 4, 16), seed=3)
    pos = np.arange(100, 112)[None].repeat(2, 0)
    np.testing.assert_allclose(
        layers.rope(ht, torch.from_numpy(pos), 5e5).numpy(),
        np.asarray(j_layers.rope(hj, jnp.asarray(pos), 5e5)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunked", [False, True], ids=["full", "chunked"])
@pytest.mark.parametrize("swa", [None, 6])
def test_attention_matches_jax(weights, monkeypatch, chunked, swa):
    cfg = SMOKE.scaled(swa_window=swa)
    if chunked:  # the query-chunked path at a small size, in both packages
        for mod in (layers, j_layers):
            monkeypatch.setattr(mod, "_QCHUNK_THRESHOLD", 16)
            monkeypatch.setattr(mod, "_QCHUNK", 8)
    pj, pt = _layer_params(weights)
    xj, xt = _x((2, 32, SMOKE.d_model), seed=4)
    pos = np.arange(32)[None].repeat(2, 0)
    want = j_layers.attention(pj["inner"], xj, cfg, positions=jnp.asarray(pos))
    got = layers.attention(pt["inner"], xt, cfg, positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------- the whole path

@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_prefill_and_decode_match_jax(served, name):
    cfg, dt, tol = VARIANTS[name]
    want, got = served(name)
    assert tuple(got["forward"].shape) == (*PROMPT, cfg.vocab)
    assert got["forward"].dtype == torch.float32
    assert _rel_err(got["forward"], want["forward"]) <= tol
    assert _rel_err(got["prefill_logits"], want["prefill_logits"]) <= tol
    for g, w in zip(got["logits"], want["logits"]):
        assert tuple(g.shape) == (PROMPT[0], 1, cfg.vocab)
        assert _rel_err(g, w) <= tol
    if dt == torch.float32:  # identical greedy ids
        for g, tok in zip(got["argmax"], want["tokens"]):
            np.testing.assert_array_equal(g.numpy(), tok[:, 0])
        _assert_caches_close(got["prefill_cache"], want["prefill_cache"])
        _assert_caches_close(got["cache"], want["cache"])


def test_int8_kv_decode_matches_jax(weights):
    # decode from an empty int8 cache, the prompt fed one token per step
    pj, pt = weights(SMOKE)
    prompt = _prompt(SMOKE)
    steps = prompt.shape[1]
    cj = j_init_cache(SMOKE, PROMPT[0], steps, kv_quant=True)
    ct = init_cache(SMOKE, PROMPT[0], steps, kv_quant=True, device="cpu")
    _assert_caches_close(ct, cj)
    step = jax.jit(lambda c, t, p: j_decode_step(pj, c, t, p, SMOKE,
                                                 compute_dtype=jnp.float32))
    for i in range(steps):
        lj, cj = step(cj, jnp.asarray(prompt[:, i:i + 1]), jnp.int32(i))
        lt, ct = decode_step(pt, ct, torch.from_numpy(
            prompt[:, i:i + 1].astype(np.int64)), i, SMOKE,
            compute_dtype=torch.float32)
        assert _rel_err(lt, lj) <= 1e-4
    assert ct["b0"]["k"].dtype == torch.int8
    _assert_caches_close(ct, cj)


def test_generate_matches_the_example_loop(weights, served):
    want, _ = served("fp32")
    _, pt = weights(SMOKE)
    prompt = torch.from_numpy(_prompt(SMOKE).astype(np.int64))
    reset_launch_counts()
    stats = {}
    ids, cache = generate(pt, SMOKE, prompt, N_STEPS + 1,
                          compute_dtype=torch.float32, stats=stats)
    assert launch_counts()["mp_attention"] == 0  # decode attention is plain
    want_ids = np.concatenate(want["tokens"] + [np.asarray(jnp.argmax(
        want["logits"][-1][:, 0], axis=-1))[:, None]], axis=1)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    # the cache grew by N_STEPS + 1 slots; the last id was never written
    assert cache["b0"]["k"].shape[2] == PROMPT[1] + N_STEPS + 1
    assert bool((cache["b0"]["k"][:, :, -1] == 0).all())
    assert stats["decode_steps"] == N_STEPS and stats["prefill_s"] > 0
    # kv_quant: the prefill rows become int8 with per-row scales
    ids_q, cache_q = generate(pt, SMOKE, prompt, 3, kv_quant=True,
                              compute_dtype=torch.float32)
    assert cache_q["b0"]["k"].dtype == torch.int8
    assert cache_q["b0"]["k_scale"].shape == cache_q["b0"]["k"].shape[:-1]
    np.testing.assert_array_equal(ids_q[:, 0].numpy(), want_ids[:, 0])
