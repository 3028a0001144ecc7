"""The port's vision-stub family (llava-next-34b's SMOKE) on the CPU against
the JAX package, on the same weights (JAX's init_lm tree carried across by
lm_params_from_numpy) and the same numpy inputs: forward_lm with prepended
patch embeddings, prefill from them and greedy decode from pos = n_patches
+ S fed JAX's ids, generate, lm_loss over the text's logits and its
gradient, a train step, and the query-chunked attention path through all
of them (its thresholds lowered in both packages).  Tolerances are
tests/test_torch_models.py's and tests/test_torch_train.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as j_layers
from repro.models.decode import decode_step as j_decode_step
from repro.models.decode import prefill as j_prefill
from repro.models.transformer import forward_lm as j_forward_lm
from repro.models.transformer import init_lm as j_init_lm
from repro.models.transformer import lm_loss as j_lm_loss
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro_torch import interop
from repro_torch.configs import llava_next_34b as llava
from repro_torch.models import layers
from repro_torch.models.decode import decode_step, prefill
from repro_torch.models.transformer import forward_lm, init_lm, lm_loss
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve_lm import _grow_cache, generate
from repro_torch.train import TrainConfig, make_train_step
from test_torch_encdec import assert_caches_near
from test_torch_models import J_DT, _rel_err
from test_torch_train import (LOSS_CASES, TRAIN_TOL, _carried_state,
                              _leaf_err, _reference_batches, _update_err)

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

SMOKE = llava.SMOKE
N_STEPS = 4          # decode steps after the prefill

CASES = {  # name -> (compute dtype, logits tolerance, text length, chunked)
    "fp32": (torch.float32, 1e-4, 12, False),
    "bf16": (torch.bfloat16, 3e-2, 12, False),
    # n_patches 8 + 24 text = 32 positions: four query chunks of 8
    "chunked": (torch.float32, 1e-4, 24, True),
}


def _chunk(monkeypatch):
    for mod in (layers, j_layers):
        monkeypatch.setattr(mod, "_QCHUNK_THRESHOLD", 16)
        monkeypatch.setattr(mod, "_QCHUNK", 8)


@pytest.fixture(scope="module")
def weights():
    pj, _ = j_init_lm(jax.random.PRNGKey(0), SMOKE)
    return pj, interop.lm_params_from_numpy(jax.tree.map(np.asarray, pj),
                                            device="cpu")


def _inputs(text, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, SMOKE.vocab, (2, text)).astype(np.int32)
    patches = rng.standard_normal(
        (2, SMOKE.n_patches, SMOKE.d_model)).astype(np.float32)
    return tokens, patches


def _serve(weights, name):
    """JAX's run and the port's on the same weights and inputs, the port fed
    JAX's ids; decode starts at pos = n_patches + S in both."""
    dt, _, text, _ = CASES[name]
    jdt = J_DT[dt]
    pj, pt = weights
    tokens, patches = _inputs(text)
    s_tot = SMOKE.n_patches + text
    want = {"forward": j_forward_lm(pj, jnp.asarray(tokens), SMOKE,
                                    extra_embeds=jnp.asarray(patches),
                                    compute_dtype=jdt)[0]}
    logits, cache = j_prefill(pj, jnp.asarray(tokens), SMOKE,
                              extra_embeds=jnp.asarray(patches),
                              compute_dtype=jdt)
    want["prefill_logits"], want["prefill_cache"] = logits, cache
    cache = jax.tree.map(lambda x: jnp.pad(
        x, [(0, 0), (0, 0), (0, N_STEPS)] + [(0, 0)] * (x.ndim - 3)), cache)
    step = jax.jit(lambda c, t, p: j_decode_step(pj, c, t, p, SMOKE,
                                                 compute_dtype=jdt))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want["tokens"], want["logits"] = [], []
    for i in range(N_STEPS):
        want["tokens"].append(np.asarray(tok))
        logits, cache = step(cache, tok, jnp.int32(s_tot + i))
        want["logits"].append(logits)
        tok = jnp.argmax(logits[:, 0], axis=-1)[:, None].astype(jnp.int32)
    want["cache"] = cache

    tt = torch.from_numpy(tokens.astype(np.int64))
    pe = torch.from_numpy(patches)
    got = {"forward": forward_lm(pt, tt, SMOKE, extra_embeds=pe,
                                 compute_dtype=dt)[0]}
    logits, cache = prefill(pt, tt, SMOKE, extra_embeds=pe, compute_dtype=dt)
    got["prefill_logits"] = logits
    got["prefill_cache"] = {k: {n: t.clone() for n, t in e.items()}
                            for k, e in cache.items()}
    cache = _grow_cache(cache, N_STEPS, kv_quant=False)
    got["logits"], got["argmax"] = [], []
    for i, tok in enumerate(want["tokens"]):
        got["argmax"].append(torch.argmax(logits[:, -1], dim=-1))
        logits, cache = decode_step(pt, cache, torch.from_numpy(
            tok.astype(np.int64)), s_tot + i, SMOKE, compute_dtype=dt)
        got["logits"].append(logits)
    got["cache"] = cache
    return want, got


def test_init_lm_draws_the_reference_tree(weights):
    pj, _ = weights
    pt = init_lm(torch.Generator().manual_seed(0), SMOKE, device="cpu")
    want = {tuple(p.key for p in path): tuple(x.shape) for path, x in
            jax.tree_util.tree_leaves_with_path(pj)}
    assert ("vision_adapter",) in want
    assert tuple(pt["vision_adapter"].shape) == want[("vision_adapter",)] == (
        SMOKE.d_model, SMOKE.d_model)
    assert float(pt["vision_adapter"].std()) == pytest.approx(
        SMOKE.d_model ** -0.5, rel=0.1)
    leaves = jax.tree.leaves(pj)
    assert [tuple(x.shape) for x in tree_leaves(pt)] == [x.shape for x in leaves]


@pytest.mark.parametrize("name", list(CASES))
def test_forward_prefill_and_decode_match_jax(weights, monkeypatch, name):
    dt, tol, text, chunked = CASES[name]
    if chunked:
        _chunk(monkeypatch)
    want, got = _serve(weights, name)
    s_tot = SMOKE.n_patches + text
    assert tuple(got["forward"].shape) == (2, s_tot, SMOKE.vocab)
    assert _rel_err(got["forward"], want["forward"]) <= tol
    assert _rel_err(got["prefill_logits"], want["prefill_logits"]) <= tol
    for g, w in zip(got["logits"], want["logits"]):
        assert _rel_err(g, w) <= tol
    assert got["prefill_cache"]["b0"]["k"].shape[2] == s_tot
    if dt == torch.float32:
        for g, tok in zip(got["argmax"], want["tokens"]):
            np.testing.assert_array_equal(g.numpy(), tok[:, 0])
        assert_caches_near(got["prefill_cache"], want["prefill_cache"])
        assert_caches_near(got["cache"], want["cache"])


def test_generate_decodes_after_the_patches(weights):
    """generate(extra_embeds=) against JAX's loop from pos = n_patches + S;
    its cache holds the patches, the text and the new rows."""
    want, _ = _serve(weights, "fp32")
    _, pt = weights
    tokens, patches = _inputs(12)
    ids, cache = generate(pt, SMOKE, torch.from_numpy(tokens.astype(np.int64)),
                          N_STEPS + 1, extra_embeds=torch.from_numpy(patches),
                          compute_dtype=torch.float32)
    want_ids = np.concatenate(want["tokens"] + [np.asarray(jnp.argmax(
        want["logits"][-1][:, 0], axis=-1))[:, None]], axis=1)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    s_tot = SMOKE.n_patches + 12
    assert cache["b0"]["k"].shape[2] == s_tot + N_STEPS + 1
    # the rows past the prompt hold the N_STEPS fed ids; the last is unwritten
    filled = cache["b0"]["k"][:, :, s_tot:s_tot + N_STEPS].float().abs()
    assert bool((filled.amax(dim=(3, 4)) > 0).all())
    assert bool((cache["b0"]["k"][:, :, -1] == 0).all())


def _batch(text, seed=3):
    tokens, patches = _inputs(text, seed)
    labels = np.random.default_rng(seed + 1).integers(
        0, SMOKE.vocab, tokens.shape).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": tokens, "labels": labels, "patches": patches}


@pytest.mark.parametrize("chunked", [False, True], ids=["full", "chunked"])
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_lm_loss_with_patches_and_grad_match_jax(weights, monkeypatch, case,
                                                 chunked):
    dt, loss_tol, grad_tol = LOSS_CASES[case]
    if chunked:
        _chunk(monkeypatch)
    pj, pt = weights
    batch = _batch(24 if chunked else 16)
    jdt = J_DT[dt]

    def f(p):
        pc = jax.tree.map(lambda x: x.astype(jdt), p)
        return j_lm_loss(pc, batch, SMOKE, compute_dtype=jdt)
    (lj, _), gj = jax.value_and_grad(f, has_aux=True)(pj)
    leaves = tree_map(lambda x: x.clone().requires_grad_(True), pt)
    pc = tree_map(lambda x: x.to(dt), leaves)
    lt, _ = lm_loss(pc, {k: torch.from_numpy(v) for k, v in batch.items()},
                    SMOKE, compute_dtype=dt)
    grads = torch.autograd.grad(lt, tree_leaves(leaves))
    lt = lt.detach()
    assert abs(float(lt) - float(lj)) <= loss_tol * abs(float(lj))
    gl = jax.tree.leaves(gj)
    worst = max(_leaf_err(g, w) for g, w in zip(grads, gl))
    assert worst <= grad_tol, worst
    # the adapter learns through the text's loss
    adapter = [i for i, (path, _) in enumerate(
        jax.tree_util.tree_leaves_with_path(pj))
        if path[0].key == "vision_adapter"]
    assert len(adapter) == 1 and float(grads[adapter[0]].abs().max()) > 0


def test_train_step_with_patches_matches_jax():
    tc_kw = dict(peak_lr=1e-2, warmup=1, total_steps=10, microbatches=2,
                 compute_dtype="float32")
    sj, st = _carried_state(tc_kw, SMOKE)
    start = [x.clone() for x in tree_leaves(st["params"])]
    j_step = jax.jit(j_make_train_step(SMOKE, JTrainConfig(**tc_kw)))
    t_step = make_train_step(SMOKE, TrainConfig(**tc_kw))
    for batch in _reference_batches(SMOKE, 2):
        assert batch["patches"].shape == (4, SMOKE.n_patches, SMOKE.d_model)
        sj, mj = j_step(sj, batch)
        st, mt = t_step(st, interop.train_state_from_numpy(batch, device="cpu"))
        for k in ("loss", "lr", "ce"):
            assert float(mt[k]) == pytest.approx(float(mj[k]),
                                                 rel=TRAIN_TOL["metric"]), k
        assert float(mt["grad_norm"]) == pytest.approx(
            float(mj["grad_norm"]), rel=TRAIN_TOL["grad_norm"])
    assert _update_err(st["params"], sj["params"], start) <= TRAIN_TOL["update"]
