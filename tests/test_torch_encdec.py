"""The port's encoder-decoder family (whisper-tiny's SMOKE) on the CPU
against the JAX package, on the same weights (JAX's init_lm tree carried
across by lm_params_from_numpy) and the same numpy inputs: cross- and
bidirectional attention, the sinusoid and the encoder, forward_lm over the
encoder's output, prefill from frames with its cross cache, greedy decode
steps fed JAX's ids, generate, lm_loss with frames and its gradient, and a
train step.  Tolerances are tests/test_torch_models.py's and
tests/test_torch_train.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_tiny as j_whisper
from repro.models import layers as j_layers
from repro.models import transformer as j_transformer
from repro.models.decode import decode_step as j_decode_step
from repro.models.decode import init_cache as j_init_cache
from repro.models.decode import prefill as j_prefill
from repro.models.transformer import init_lm as j_init_lm
from repro.models.transformer import lm_loss as j_lm_loss
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro_torch import interop
from repro_torch.configs import whisper_tiny as whisper
from repro_torch.models import layers, transformer
from repro_torch.models.decode import decode_step, init_cache, prefill
from repro_torch.models.transformer import (cycle_slice, encode, forward_lm,
                                            init_lm, lm_loss)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve_lm import _grow_cache, generate
from repro_torch.train import TrainConfig, make_train_step
from test_torch_models import J_DT, _assert_caches_close, _np, _rel_err
from test_torch_train import (LOSS_CASES, TRAIN_TOL, _carried_state,
                              _leaf_err, _reference_batches, _update_err)

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

SMOKE = whisper.SMOKE
PROMPT = (2, 12)     # batch, decoder prompt length
N_STEPS = 4          # decode steps after the prefill

VARIANTS = {  # name -> (config, compute dtype, logits tolerance)
    "fp32": (SMOKE, torch.float32, 1e-4),
    "bf16": (SMOKE, torch.bfloat16, 3e-2),
    "qk_norm": (SMOKE.scaled(qk_norm=True), torch.float32, 1e-4),
}


def assert_caches_near(got, want, rel=1e-4):
    """`_assert_caches_close`, where a bf16 element may also differ by up
    to `rel` (the fp32 logits' tolerance) of its entry's largest value:
    where fp32 sums cancel to near zero, the two packages' last fp32 bits,
    carried through the layers, outweigh a bf16 ulp of the small result
    (measured: whisper's self-attention k, 5.48e-6 against 5.39e-6 at
    prefill and -1.2436e-3 against -1.2741e-3 after 4 decode steps, 9.0e-6
    of the entry's 3.375)."""
    near = {}
    for blk, entry in want.items():
        near[blk] = {}
        for name, w in entry.items():
            g = got[blk][name]
            if g.dtype == torch.bfloat16:
                gn, wn = _np(g), _np(w)
                close = np.abs(gn - wn) <= rel * float(np.abs(wn).max())
                g = torch.from_numpy(np.where(close, wn, gn)).to(torch.bfloat16)
            near[blk][name] = g
    _assert_caches_close(near, want)


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(cfg):
        if cfg not in cache:
            pj, _ = j_init_lm(jax.random.PRNGKey(0), cfg)
            tree = jax.tree.map(np.asarray, pj)
            cache[cfg] = (pj, interop.lm_params_from_numpy(tree, device="cpu"))
        return cache[cfg]
    return get


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, PROMPT).astype(np.int32)
    frames = rng.standard_normal(
        (PROMPT[0], cfg.n_enc_frames, cfg.d_model)).astype(np.float32)
    return tokens, frames


def _grow_self(cache, n):
    """The JAX side's cache grown by n slots: the self-attention entries
    only (examples/serve_lm.py pads every 5-D entry, the cross one too,
    which would add zero keys to its unmasked softmax: ROADMAP C 9)."""
    return {key: entry if key == "cross" else jax.tree.map(
        lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, n)]
                          + [(0, 0)] * (x.ndim - 3)), entry)
            for key, entry in cache.items()}


@pytest.fixture(scope="module")
def served(weights):
    """Per variant: JAX's run and the port's on the same weights and
    inputs, the port fed JAX's ids."""
    runs = {}

    def get(name):
        if name in runs:
            return runs[name]
        cfg, dt, _ = VARIANTS[name]
        jdt = J_DT[dt]
        pj, pt = weights(cfg)
        tokens, frames = _inputs(cfg)
        want = {}
        enc_j = jax.jit(lambda f: j_transformer.encode(
            pj, f, cfg, compute_dtype=jdt))(jnp.asarray(frames))
        want["forward"] = jax.jit(lambda t, e: j_transformer.forward_lm(
            pj, t, cfg, enc_out=e, compute_dtype=jdt)[0])(
                jnp.asarray(tokens), enc_j)
        logits, cache = jax.jit(lambda t, f: j_prefill(
            pj, t, cfg, frames=f, compute_dtype=jdt))(
                jnp.asarray(tokens), jnp.asarray(frames))
        want["prefill_logits"], want["prefill_cache"] = logits, cache
        cache = _grow_self(cache, N_STEPS)
        step = jax.jit(lambda c, t, p: j_decode_step(pj, c, t, p, cfg,
                                                     compute_dtype=jdt))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want["tokens"], want["logits"] = [], []
        for i in range(N_STEPS):
            want["tokens"].append(np.asarray(tok))
            logits, cache = step(cache, tok, jnp.int32(PROMPT[1] + i))
            want["logits"].append(logits)
            tok = jnp.argmax(logits[:, 0], axis=-1)[:, None].astype(jnp.int32)
        want["cache"] = cache

        tt, ft = torch.from_numpy(tokens.astype(np.int64)), torch.from_numpy(frames)
        got = {"enc_out": encode(pt, ft, cfg, compute_dtype=dt)}
        got["forward"] = forward_lm(pt, tt, cfg, enc_out=got["enc_out"],
                                    compute_dtype=dt)[0]
        logits, cache = prefill(pt, tt, cfg, frames=ft, compute_dtype=dt)
        got["prefill_logits"] = logits
        got["prefill_cache"] = {k: {n: t.clone() for n, t in e.items()}
                                for k, e in cache.items()}
        cache = _grow_cache(cache, N_STEPS, kv_quant=False)
        got["logits"], got["argmax"] = [], []
        for i, tok in enumerate(want["tokens"]):
            got["argmax"].append(torch.argmax(logits[:, -1], dim=-1))
            logits, cache = decode_step(
                pt, cache, torch.from_numpy(tok.astype(np.int64)),
                PROMPT[1] + i, cfg, compute_dtype=dt)
            got["logits"].append(logits)
        got["cache"] = cache
        want["enc_out"] = enc_j
        runs[name] = (want, got)
        return runs[name]
    return get


# --------------------------------------------------------- config, init

def test_init_lm_draws_the_reference_tree(weights):
    pj, _ = weights(SMOKE)
    pt = init_lm(torch.Generator().manual_seed(0), SMOKE, device="cpu")
    want = {tuple(p.key for p in path): tuple(x.shape) for path, x in
            jax.tree_util.tree_leaves_with_path(pj)}
    got = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                got[path + (k,)] = tuple(v.shape)
    walk(pt, ())
    assert got == want
    assert ("enc_cycles", "inner", "wq") in got and ("enc_norm", "scale") in got
    assert got[("cycles", "b0", "cross", "wk")] == (
        SMOKE.n_cycles, SMOKE.d_model, SMOKE.n_kv_heads, SMOKE.d_head)
    assert got[("enc_cycles", "ffn", "w_up")][0] == SMOKE.n_enc_layers


@pytest.mark.parametrize("kv_quant", [False, True])
def test_init_cache_has_the_reference_cross_entry(kv_quant):
    want = j_init_cache(SMOKE, 2, 16, kv_quant=kv_quant)
    got = init_cache(SMOKE, 2, 16, kv_quant=kv_quant, device="cpu")
    assert got.keys() == want.keys() == {"b0", "cross"}
    for key in want:
        assert got[key].keys() == want[key].keys()
        for name, w in want[key].items():
            assert tuple(got[key][name].shape) == w.shape, (key, name)
            assert str(got[key][name].dtype).split(".")[-1] == w.dtype.name
    # the reference never quantizes the cross entry
    assert got["cross"]["k"].dtype == torch.bfloat16
    assert tuple(got["cross"]["k"].shape) == (
        SMOKE.n_cycles, 2, SMOKE.n_enc_frames, SMOKE.n_kv_heads, SMOKE.d_head)


# ------------------------------------------------------------- layers

def _layer(weights, cfg=SMOKE):
    pj, pt = weights(cfg)
    return (jax.tree.map(lambda x: x[0], pj["cycles"]["b0"]),
            cycle_slice(pt["cycles"]["b0"], 0))


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


ATTN_KINDS = {  # name -> attention's keyword arguments besides positions
    "cross": dict(kv_x=True, causal=False, use_rope=False),
    "cross_rope": dict(kv_x=True, causal=False, use_rope=True),
    "bidirectional": dict(causal=False),
    "masked": dict(causal=False, mask=True),
}


@pytest.mark.parametrize("chunked", [False, True], ids=["full", "chunked"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("kind", list(ATTN_KINDS))
def test_attention_kinds_match_jax(weights, monkeypatch, kind, qk_norm,
                                   chunked):
    cfg = SMOKE.scaled(qk_norm=qk_norm)
    if chunked:  # the query-chunked path at a small size, in both packages
        for mod in (layers, j_layers):
            monkeypatch.setattr(mod, "_QCHUNK_THRESHOLD", 16)
            monkeypatch.setattr(mod, "_QCHUNK", 8)
    pj, pt = _layer(weights, cfg)
    kw = dict(ATTN_KINDS[kind])
    xj, xt = _x((2, 32, cfg.d_model), seed=4)
    pos = np.arange(32)[None].repeat(2, 0)
    kj, kt = dict(kw), dict(kw)
    if kw.pop("kv_x", False):
        ej, et = _x((2, 24, cfg.d_model), seed=5)
        kj["kv_x"], kt["kv_x"] = ej, et
    if kw.pop("mask", False):
        m = np.random.default_rng(6).random((32, 32)) < 0.7
        m[:, 0] = True  # every query sees a key
        kj["mask"], kt["mask"] = jnp.asarray(m), torch.from_numpy(m)
    want = j_layers.attention(pj["cross"], xj, cfg, positions=jnp.asarray(pos),
                              **kj)
    got = layers.attention(pt["cross"], xt, cfg, positions=torch.from_numpy(pos),
                           **kt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_sinusoid_and_encode_match_jax(weights):
    pos = np.arange(50)
    np.testing.assert_allclose(
        transformer._sinusoid(torch.from_numpy(pos), 64).numpy(),
        np.asarray(j_transformer._sinusoid(jnp.asarray(pos), 64)),
        rtol=1e-6, atol=1e-6)
    pj, pt = weights(SMOKE)
    _, frames = _inputs(SMOKE)
    want = j_transformer.encode(pj, jnp.asarray(frames), SMOKE,
                                compute_dtype=jnp.float32)
    got = encode(pt, torch.from_numpy(frames), SMOKE,
                 compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------- the whole path

@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_prefill_and_decode_match_jax(served, name):
    cfg, dt, tol = VARIANTS[name]
    want, got = served(name)
    assert _rel_err(got["enc_out"], want["enc_out"]) <= tol
    assert tuple(got["forward"].shape) == (*PROMPT, cfg.vocab)
    assert _rel_err(got["forward"], want["forward"]) <= tol
    assert _rel_err(got["prefill_logits"], want["prefill_logits"]) <= tol
    for g, w in zip(got["logits"], want["logits"]):
        assert tuple(g.shape) == (PROMPT[0], 1, cfg.vocab)
        assert _rel_err(g, w) <= tol
    if dt == torch.float32:  # identical greedy ids, caches as the models'
        for g, tok in zip(got["argmax"], want["tokens"]):
            np.testing.assert_array_equal(g.numpy(), tok[:, 0])
        assert_caches_near(got["prefill_cache"], want["prefill_cache"])
        assert_caches_near(got["cache"], want["cache"])
        # the cross entry is the prefill's, unpadded, never rewritten
        for n in ("k", "v"):
            assert torch.equal(got["cache"]["cross"][n],
                               got["prefill_cache"]["cross"][n])


def test_generate_matches_the_reference_loop(weights, served):
    want, _ = served("fp32")
    _, pt = weights(SMOKE)
    tokens, frames = _inputs(SMOKE)
    stats = {}
    ids, cache = generate(pt, SMOKE, torch.from_numpy(tokens.astype(np.int64)),
                          N_STEPS + 1, frames=torch.from_numpy(frames),
                          compute_dtype=torch.float32, stats=stats)
    want_ids = np.concatenate(want["tokens"] + [np.asarray(jnp.argmax(
        want["logits"][-1][:, 0], axis=-1))[:, None]], axis=1)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert cache["b0"]["k"].shape[2] == PROMPT[1] + N_STEPS + 1
    assert cache["cross"]["k"].shape[2] == SMOKE.n_enc_frames
    assert stats["decode_steps"] == N_STEPS
    # kv_quant: the self rows int8, the cross entry bf16 as prefill wrote it
    _, cache_q = generate(pt, SMOKE, torch.from_numpy(tokens.astype(np.int64)),
                          2, frames=torch.from_numpy(frames), kv_quant=True,
                          compute_dtype=torch.float32)
    assert cache_q["b0"]["k"].dtype == torch.int8
    assert cache_q["cross"]["k"].dtype == torch.bfloat16
    assert set(cache_q["cross"]) == {"k", "v"}


# ------------------------------------------------------------- training

def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    frames = rng.standard_normal(
        (2, cfg.n_enc_frames, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "frames": frames}


def _loss_and_grads(pt, batch, cfg, dt):
    leaves = tree_map(lambda x: x.clone().requires_grad_(True), pt)
    pc = tree_map(lambda x: x.to(dt), leaves)
    loss, parts = lm_loss(pc, {k: torch.from_numpy(v) for k, v in batch.items()},
                          cfg, compute_dtype=dt)
    return loss.detach(), parts, torch.autograd.grad(loss, tree_leaves(leaves))


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_lm_loss_with_frames_and_grad_match_jax(weights, case):
    dt, loss_tol, grad_tol = LOSS_CASES[case]
    pj, pt = weights(SMOKE)
    batch = _batch(SMOKE)
    jdt = J_DT[dt]

    def f(p):
        pc = jax.tree.map(lambda x: x.astype(jdt), p)
        return j_lm_loss(pc, batch, SMOKE, compute_dtype=jdt)
    (lj, parts_j), gj = jax.jit(jax.value_and_grad(f, has_aux=True))(pj)
    lt, parts, grads = _loss_and_grads(pt, batch, SMOKE, dt)
    assert abs(float(lt) - float(lj)) <= loss_tol * abs(float(lj))
    assert float(parts["aux"]) == float(parts_j["aux"]) == 0.0
    gl = jax.tree.leaves(gj)
    assert len(grads) == len(gl)
    worst = max(_leaf_err(g, w) for g, w in zip(grads, gl))
    assert worst <= grad_tol, worst
    # the encoder's weights get a gradient through the cross-attention
    enc = [i for i, (path, _) in enumerate(
        jax.tree_util.tree_leaves_with_path(pj))
        if path[0].key == "enc_cycles"]
    assert enc and all(float(grads[i].abs().max()) > 0 for i in enc)


def test_remat_gives_the_same_loss_and_gradients_bit_for_bit(weights):
    _, pt = weights(SMOKE)
    batch = _batch(SMOKE)
    out = {r: _loss_and_grads(pt, batch, SMOKE.scaled(remat=r), torch.float32)
           for r in (False, True)}
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][2], out[True][2]))


def test_train_step_with_frames_matches_jax():
    # the reference's stream (frames included) and state, 2 steps of 2
    # microbatches in fp32: TRAIN_TOL as tests/test_torch_train.py
    tc_kw = dict(peak_lr=1e-2, warmup=1, total_steps=10, microbatches=2,
                 compute_dtype="float32")
    sj, st = _carried_state(tc_kw, SMOKE)
    start = [x.clone() for x in tree_leaves(st["params"])]
    j_step = jax.jit(j_make_train_step(SMOKE, JTrainConfig(**tc_kw)))
    t_step = make_train_step(SMOKE, TrainConfig(**tc_kw))
    for batch in _reference_batches(SMOKE, 2):
        assert batch["frames"].shape == (4, SMOKE.n_enc_frames, SMOKE.d_model)
        sj, mj = j_step(sj, batch)
        st, mt = t_step(st, interop.train_state_from_numpy(batch, device="cpu"))
        for k in ("loss", "lr", "ce"):
            assert float(mt[k]) == pytest.approx(float(mj[k]),
                                                 rel=TRAIN_TOL["metric"]), k
        assert float(mt["grad_norm"]) == pytest.approx(
            float(mj["grad_norm"]), rel=TRAIN_TOL["grad_norm"])
    assert _update_err(st["params"], sj["params"], start) <= TRAIN_TOL["update"]


def test_enc_dec_takes_only_attention_blocks():
    # the reference asserts block_pattern == ("attn",) for an enc-dec
    from repro_torch.configs import xlstm_1_3b
    cfg = xlstm_1_3b.SMOKE.scaled(enc_dec=True, n_enc_layers=1)
    with pytest.raises(ValueError, match="block pattern"):
        init_lm(torch.Generator(), cfg, device="cpu")
    with pytest.raises(ValueError, match="block pattern"):
        init_cache(cfg, 1, 8, device="cpu")
