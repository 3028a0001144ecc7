"""The port's LM training path on the CPU against the JAX package: lm_loss
and its gradient, remat, AdamW, gradient compression and the train step,
on the same inputs (made with numpy from a seed, or JAX's own init and
data carried across by `interop`), at llama3.2-1b's SMOKE size.  Each
tolerance is stated beside what it measured."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_1b as j_llama
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenSource as JSource
from repro.models.transformer import init_lm as j_init_lm
from repro.models.transformer import lm_loss as j_lm_loss
from repro.optim import adamw as j_adamw
from repro.runtime import compression as j_compression
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import interop
from repro_torch.configs import llama3_2_1b as llama
from repro_torch.models.transformer import forward_lm, lm_loss
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import compression
from repro_torch.train import TrainConfig, make_train_step

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

SMOKE = llama.SMOKE
J_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaf_err(got, want):
    """max |got - want| over max |want| (0 where both are 0)."""
    got, want = _np(got), _np(want)
    scale = np.abs(want).max()
    diff = np.abs(got - want).max()
    return float(diff / scale) if scale else float(diff)


def _tree_err(got, want_j):
    """The worst _leaf_err over the leaves (JAX's leaf order: sorted
    keys, as `tree_leaves` walks the port's tree)."""
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want_j)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert tuple(g.shape) == tuple(np.shape(w))
    return max(_leaf_err(g, w) for g, w in zip(got_l, want_l))


@pytest.fixture(scope="module")
def weights():
    """JAX's init_lm weights of SMOKE, and the port's copy of them."""
    pj, _ = j_init_lm(jax.random.PRNGKey(0), SMOKE)
    return pj, interop.lm_params_from_numpy(jax.tree.map(np.asarray, pj),
                                            device="cpu")


def _batch(seed=3, shape=(2, 16), masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, SMOKE.vocab, shape).astype(np.int32)
    labels = rng.integers(0, SMOKE.vocab, shape).astype(np.int32)
    if masked:  # some labels masked: the mean runs over the rest
        labels[0, :3] = -1
        labels[1, -2:] = -1
    return tokens, labels


def _torch_loss_and_grads(pt, tokens, labels, cfg, dt):
    leaves = tree_map(lambda x: x.clone().requires_grad_(True), pt)
    pc = tree_map(lambda x: x.to(dt), leaves)
    loss, parts = lm_loss(pc, {"tokens": torch.from_numpy(tokens),
                               "labels": torch.from_numpy(labels)},
                          cfg, compute_dtype=dt)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss.detach(), parts, dict(zip(range(len(grads)), grads)), leaves


# --------------------------------------------------------------- lm_loss

# (compute dtype, loss rel tol, per-leaf gradient tol). Measured: fp32
# 1.5e-7 and 1.9e-6; bf16 2.8e-5 and 2.9e-2 (a bf16 ulp is 3.9e-3 of a
# leaf's largest entry, and the bf16 roundings of the two graphs differ)
LOSS_CASES = {"fp32": (torch.float32, 1e-6, 2e-5),
              "bf16": (torch.bfloat16, 1e-3, 0.1)}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_lm_loss_and_grad_match_jax(weights, case):
    dt, loss_tol, grad_tol = LOSS_CASES[case]
    pj, pt = weights
    tokens, labels = _batch()
    jdt = J_DT[dt]

    def f(p):
        pc = jax.tree.map(lambda x: x.astype(jdt), p)
        return j_lm_loss(pc, {"tokens": tokens, "labels": labels}, SMOKE,
                         compute_dtype=jdt)
    (lj, parts_j), gj = jax.jit(jax.value_and_grad(f, has_aux=True))(pj)
    lt, parts, grads, _ = _torch_loss_and_grads(pt, tokens, labels, SMOKE, dt)
    assert abs(float(lt) - float(lj)) <= loss_tol * abs(float(lj))
    assert abs(float(parts["ce"].detach()) - float(parts_j["ce"])) <= \
        loss_tol * abs(float(parts_j["ce"]))
    assert float(parts["aux"]) == float(parts_j["aux"]) == 0.0
    gl = jax.tree.leaves(gj)
    assert len(grads) == len(gl)
    worst = max(_leaf_err(grads[i], w) for i, w in enumerate(gl))
    assert worst <= grad_tol, worst


def test_lm_loss_masks_labels_and_means_over_the_rest(weights):
    """The masked tokens add nothing: the loss equals the mean, over the
    unmasked positions, of the full-label loss's per-token terms; all
    labels masked gives 0, not NaN."""
    _, pt = weights
    tokens, labels = _batch(masked=False)
    logits, _ = forward_lm(pt, torch.from_numpy(tokens), SMOKE,
                           compute_dtype=torch.float32)
    nll = -torch.log_softmax(logits, -1).gather(
        -1, torch.from_numpy(labels).long()[..., None])[..., 0]
    masked = labels.copy()
    masked[:, ::2] = -1
    loss, _ = lm_loss(pt, {"tokens": torch.from_numpy(tokens),
                           "labels": torch.from_numpy(masked)}, SMOKE,
                      compute_dtype=torch.float32)
    want = nll[:, 1::2].mean()
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    none, _ = lm_loss(pt, {"tokens": torch.from_numpy(tokens),
                           "labels": torch.full(labels.shape, -1)}, SMOKE,
                      compute_dtype=torch.float32)
    assert float(none) == 0.0


# ------------------------------------------------------------------ remat

REMAT = {"off": dict(remat=False), "per_cycle": dict(remat=True),
         "group2": dict(remat=True, remat_group=2)}


@pytest.mark.parametrize("variant", ["per_cycle", "group2"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_remat_gives_the_same_loss_and_gradients_bit_for_bit(weights, variant,
                                                             dt):
    """On the CPU, remat recomputes the same ops on the same inputs: the
    loss and every gradient equal remat off's bit for bit (measured).  4
    layers, so group2 is two groups of two checkpointed cycles."""
    _, pt2 = weights
    cfg_off = SMOKE.scaled(n_layers=4, **REMAT["off"])
    cfg_on = SMOKE.scaled(n_layers=4, **REMAT[variant])
    pt = dict(pt2, cycles=tree_map(lambda x: torch.cat([x, x.flip(0)]),
                                   pt2["cycles"]))
    tokens, labels = _batch()
    l0, _, g0, _ = _torch_loss_and_grads(pt, tokens, labels, cfg_off, dt)
    l1, _, g1, _ = _torch_loss_and_grads(pt, tokens, labels, cfg_on, dt)
    assert torch.equal(l0, l1)
    for i in g0:
        assert torch.equal(g0[i], g1[i]), i


def test_remat_changes_nothing_without_autograd(weights):
    """Under torch.no_grad() (serving) remat is not applied: the logits of
    remat on and off are the same bits, and no checkpoint is entered."""
    _, pt = weights
    tokens = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        off, _ = forward_lm(pt, tokens, SMOKE.scaled(remat=False),
                            compute_dtype=torch.bfloat16)
        on, _ = forward_lm(pt, tokens, SMOKE.scaled(remat=True, remat_group=2),
                           compute_dtype=torch.bfloat16)
    assert torch.equal(off, on)


# ------------------------------------------------------------------ adamw

def _random_tree(rng, scale=1.0):
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}, "e": (1,)}
    return jax.tree.map(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def _to_torch(tree):
    return interop.train_state_from_numpy(tree, device="cpu")


# AdamW over 3 steps: params within 1e-6 of their largest entry and the
# moments within 1e-5 (fp32) or one bf16 ulp (2^-8 = 3.9e-3; bf16 m), the
# grad norm within 1e-6 (measured: params <= 1.3e-7, v <= 1.5e-7, m 0 or
# the bf16 roundings of an fp32 difference, norm <= 1.2e-7)
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("schedule", [False, True], ids=["scalar_lr", "cosine"])
def test_adamw_update_matches_jax(moment_dtype, clip_norm, schedule):
    rng = np.random.default_rng(7)
    params = _random_tree(rng)
    grads_seq = [_random_tree(rng, scale=0.5) for _ in range(3)]
    jmdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    tmdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    jlr = j_adamw.cosine_schedule(1e-2, 2, 10) if schedule else 1e-2
    tlr = adamw.cosine_schedule(1e-2, 2, 10) if schedule else 1e-2

    pj = jax.tree.map(jnp.asarray, params)
    sj = j_adamw.init(pj, moment_dtype=jmdt)
    pt = _to_torch(params)
    st = adamw.init(pt, moment_dtype=tmdt)
    for g in grads_seq:
        pj, sj, nj = j_adamw.update(pj, jax.tree.map(jnp.asarray, g), sj,
                                    lr=jlr, clip_norm=clip_norm)
        pt2, st2, nt = adamw.update(pt, _to_torch(g), st, lr=tlr,
                                    clip_norm=clip_norm)
        assert pt2 is not pt and st2 is not st
        pt, st = pt2, st2
        assert float(nt) == pytest.approx(float(nj), rel=1e-6)
    if clip_norm == 1.0:
        assert float(nj) > 1.0  # clipping was active
    assert _tree_err(pt, pj) <= 1e-6
    assert _tree_err(st["v"], sj["v"]) <= 1e-5
    assert st["m"]["a"].dtype == tmdt
    assert _tree_err(st["m"], sj["m"]) <= (4e-3 if tmdt == torch.bfloat16
                                           else 1e-5)
    assert int(st["step"]) == int(sj["step"]) == 3
    assert st["step"].dtype == torch.int32


def test_adamw_update_leaves_its_arguments_as_they_were():
    rng = np.random.default_rng(1)
    pt = _to_torch(_random_tree(rng))
    grads = _to_torch(_random_tree(rng))
    st = adamw.init(pt)
    args = {"params": pt, "grads": grads, "state": st}
    before = [x.clone() for x in tree_leaves(args)]
    adamw.update(pt, grads, st, lr=0.1)
    for a, b in zip(before, tree_leaves(args)):
        assert torch.equal(a, b)


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.update(params, grads, state, lr=0.1,
                                        weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.05


def test_cosine_schedule_matches_jax():
    """lr over steps 0..120 (warmup 10, total 100, then past the end):
    within 2 fp32 ulps of the reference's (measured <= 1)."""
    jlr = j_adamw.cosine_schedule(3e-4, 10, 100)
    tlr = adamw.cosine_schedule(3e-4, 10, 100)
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.asarray(jax.vmap(jlr)(jnp.asarray(steps)))
    got = tlr(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    assert got[1] < got[10] and got[10] == pytest.approx(3e-4, rel=1e-6)
    assert got[100] == pytest.approx(3e-5, rel=1e-6) and got[120] == got[100]


# ------------------------------------------------------------ compression

@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compress_with_feedback_matches_jax_bit_for_bit(mode):
    """5 steps of error feedback on the same grads: the dequantized grads
    and the residuals equal the reference's bit for bit (one rounding each,
    half to even)."""
    rng = np.random.default_rng(11)
    res_j = res_t = None
    for i in range(5):
        g = _random_tree(rng, scale=0.01 * (1 + i))
        if i == 2:  # ties: g / scale lands on a half for int8's largest leaf
            g["e"] = np.array([0.5], np.float32)
        dj, res_j = j_compression.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), res_j, mode=mode)
        dt_, res_t = compression.compress_with_feedback(_to_torch(g), res_t,
                                                        mode=mode)
        for a, b in zip(tree_leaves(dt_) + tree_leaves(res_t),
                        jax.tree.leaves(dj) + jax.tree.leaves(res_j)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_int8_rounds_half_to_even():
    g = {"w": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])}
    scale = 127.0 / 127.0 + 1e-12
    deq, _ = compression.compress_with_feedback(g, None, mode="int8")
    np.testing.assert_array_equal(deq["w"].numpy() / np.float32(scale),
                                  [127, 0, 2, 2, 0, -2])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compression_error_feedback_preserves_sum(mode):
    """The reference's test: with error feedback the sum of dequantized
    grads tracks the sum of true grads, up to the residual."""
    gen = torch.Generator().manual_seed(0)
    grads = {"w": torch.randn((64, 64), generator=gen) * 0.01}
    res = compression.init_residual(grads)
    total_true = torch.zeros((64, 64))
    total_deq = torch.zeros((64, 64))
    for i in range(20):
        g = {"w": grads["w"] * (1 + 0.1 * i)}
        deq, res = compression.compress_with_feedback(g, res, mode=mode)
        total_true += g["w"]
        total_deq += deq["w"]
    err = float((total_true - total_deq - res["w"]).abs().max())
    assert err < 1e-3


def test_compression_ratio():
    assert [compression.compression_ratio(m) for m in ("none", "bf16", "int8")] \
        == [j_compression.compression_ratio(m) for m in ("none", "bf16", "int8")]


# ------------------------------------------------------------- train step

def _carried_state(tc_kw, cfg=SMOKE):
    """The reference's init_train_state, and the port's copy of it."""
    sj, _ = j_init_train_state(jax.random.PRNGKey(0), cfg, JTrainConfig(**tc_kw))
    return sj, interop.train_state_from_numpy(jax.tree.map(np.asarray, sj),
                                              device="cpu")


def _reference_batches(cfg, n, gb=4, seq=16):
    src = JSource(cfg, JDataConfig(seed=0, global_batch=gb, seq_len=seq))
    return [jax.tree.map(np.asarray, src.batch_at(i)) for i in range(n)]


def _update_err(got, want_j, start):
    """||got - want|| over ||want - start|| across the param tree (start:
    the leaves before the steps, in tree_leaves order): the
    port's difference from the reference against the reference's whole
    update.  (Adam moves an element with a near-zero gradient by about lr
    either way, so a gradient that differs in its last bits can flip it:
    an element-wise bound would have to allow 2 lr a step.)"""
    num = den = 0.0
    for g, w, s in zip(tree_leaves(got), jax.tree.leaves(want_j), start):
        w = torch.tensor(np.asarray(w))
        num += float(((g - w) ** 2).sum())
        den += float(((w - s) ** 2).sum())
    return (num / den) ** 0.5


# 3 steps at lr 1e-2 (warmup 1), fp32 compute, against the reference's
# jitted step: loss and lr within 1e-6 relative (measured <= 3.1e-7,
# 9.6e-8), the grad norm within 1e-4 (measured 3.7e-5, bf16 compression's
# roundings flip where the gradients differ in their last bits), the params'
# update within 1e-3 of the reference's (measured <= 5.0e-4), the moments
# within 3e-4 of each leaf's largest entry without compression and 3e-2 with
# it (measured 9.7e-5 and 1.1e-2: a flipped rounding moves a gradient by one
# bf16 ulp or one int8 step), each residual within one rounding step, twice
# the reference's largest residual (measured 2.004 times it)
TRAIN_TOL = dict(metric=1e-6, grad_norm=1e-4, update=1e-3, moments=3e-4,
                 moments_compressed=3e-2, residual=2.1)


@pytest.mark.parametrize("compression_mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(microbatches, compression_mode):
    tc_kw = dict(peak_lr=1e-2, warmup=1, total_steps=10,
                 microbatches=microbatches, compression=compression_mode,
                 compute_dtype="float32")
    sj, st = _carried_state(tc_kw)
    start = [x.clone() for x in tree_leaves(st["params"])]
    j_step = jax.jit(j_make_train_step(SMOKE, JTrainConfig(**tc_kw)))
    t_step = make_train_step(SMOKE, TrainConfig(**tc_kw))
    for batch in _reference_batches(SMOKE, 3):
        sj, mj = j_step(sj, batch)
        st, mt = t_step(st, interop.train_state_from_numpy(batch, device="cpu"))
        assert set(mt) == set(mj) == {"loss", "grad_norm", "lr", "ce", "aux"}
        for k in ("loss", "lr", "ce"):
            assert float(mt[k]) == pytest.approx(float(mj[k]),
                                                 rel=TRAIN_TOL["metric"]), k
        assert float(mt["grad_norm"]) == pytest.approx(
            float(mj["grad_norm"]), rel=TRAIN_TOL["grad_norm"])
        assert float(mt["aux"]) == float(mj["aux"]) == 0.0
    assert set(st) == set(sj)
    assert int(st["data_step"]) == int(sj["data_step"]) == 3
    assert int(st["opt"]["step"]) == 3
    assert _update_err(st["params"], sj["params"], start) <= TRAIN_TOL["update"]
    mom = TRAIN_TOL["moments" if compression_mode == "none"
                    else "moments_compressed"]
    assert _tree_err(st["opt"]["m"], sj["opt"]["m"]) <= mom
    assert _tree_err(st["opt"]["v"], sj["opt"]["v"]) <= mom
    if compression_mode != "none":
        assert _tree_err(st["residual"], sj["residual"]) <= TRAIN_TOL["residual"]


def test_train_step_bf16_compute_matches_jax():
    """bf16 compute, fp32 masters, 2 microbatches, 2 steps at lr 1e-3: the
    loss within 1e-3 (measured 9.2e-5), the grad norm within 2e-2 (bf16
    gradients; measured 1.3e-3), the params' update within 0.2 of the
    reference's (measured 0.076: bf16 gradients differ in their last bits
    and Adam flips the near-zero ones)."""
    tc_kw = dict(peak_lr=1e-3, warmup=1, total_steps=10, microbatches=2)
    sj, st = _carried_state(tc_kw)
    start = [x.clone() for x in tree_leaves(st["params"])]
    j_step = jax.jit(j_make_train_step(SMOKE, JTrainConfig(**tc_kw)))
    t_step = make_train_step(SMOKE, TrainConfig(**tc_kw))
    for batch in _reference_batches(SMOKE, 2):
        sj, mj = j_step(sj, batch)
        st, mt = t_step(st, interop.train_state_from_numpy(batch, device="cpu"))
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-3)
        assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]),
                                                       rel=2e-2)
    assert _update_err(st["params"], sj["params"], start) <= 0.2
    assert st["params"]["embed"].dtype == torch.float32


def test_train_step_leaves_the_state_it_was_given():
    """The step is functional: the fault-tolerant loop restarts from its
    initial state before the first checkpoint."""
    tc_kw = dict(peak_lr=1e-2, warmup=1, total_steps=10, microbatches=2,
                 compression="int8", compute_dtype="float32")
    _, st = _carried_state(tc_kw)
    before = [x.clone() for x in tree_leaves(st)]
    batch = interop.train_state_from_numpy(_reference_batches(SMOKE, 1)[0],
                                           device="cpu")
    new, _ = make_train_step(SMOKE, TrainConfig(**tc_kw))(st, batch)
    for a, b in zip(before, tree_leaves(st)):
        assert torch.equal(a, b)
    assert not torch.equal(tree_leaves(new["params"])[0],
                           tree_leaves(st["params"])[0])


def test_train_config_matches_the_reference():
    fields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert fields == {f.name: f.default for f in dataclasses.fields(JTrainConfig)}


def test_train_state_from_numpy_keeps_dtypes():
    sj, st = _carried_state(dict(moment_dtype="bfloat16", compression="bf16"))
    assert st["opt"]["m"]["embed"].dtype == torch.bfloat16
    assert st["opt"]["step"].dtype == torch.int32 and st["opt"]["step"].dim() == 0
    assert st["data_step"].dtype == torch.int32
    assert st["residual"]["embed"].dtype == torch.float32
    assert _tree_err(st, sj) == 0.0
