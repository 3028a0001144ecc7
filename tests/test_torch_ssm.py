"""The port's recurrent mixers on the CPU against the JAX package, on the
same numpy inputs and on JAX's init_lm weights (carried across by
lm_params_from_numpy): `models/ssm.py`'s causal conv, chunked selective
scan, mamba, mLSTM and sLSTM with and without an incoming state; the
hybrid block's FFN rule; forward_lm, prefill, decode_step and generate for
xlstm-1.3b's and jamba-v0.1-52b's SMOKE in fp32 and bf16; lm_loss and its
gradient with remat; a train step; the cache layout; then chip_smoke.py's
phase 19 reckonings (the parameter count and the predicted serving peak).
Each tolerance is stated beside what it measured."""

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_v0_1_52b as j_jamba
from repro.configs import xlstm_1_3b as j_xlstm
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenSource as JSource
from repro.models import ssm as j_ssm
from repro.models import transformer as j_transformer
from repro.models import decode as j_decode
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
from repro_torch.configs import jamba_v0_1_52b as jamba
from repro_torch.configs import xlstm_1_3b as xlstm
from repro_torch.models import config, layers, ssm, transformer
from repro_torch.models import decode as t_decode
from repro_torch.models.decode import decode_step, init_cache, prefill
from repro_torch.models.transformer import (cycle_slice, forward_lm, init_lm,
                                            lm_loss)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve_lm import _grow_cache, generate
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.launch import costmodel

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"xlstm-1.3b": (xlstm, j_xlstm), "jamba-v0.1-52b": (jamba, j_jamba)}
NAMES = sorted(MODULES)
PROMPT = (2, 12)     # batch, prompt length: jamba's mamba_chunk is 8, so the
                     # prompt pads its second chunk
N_STEPS = 4          # decode steps after the prefill
J_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel_err(got, want):
    """max |got - want| over max |want| (the difference where want is 0)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    diff = np.abs(got - want).max()
    return float(diff / scale) if scale else float(diff)


def _smoke(name):
    return MODULES[name][0].SMOKE


def _x(shape, seed=2, scale=1.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


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


def _block_params(weights, cfg, i, c=0):
    """Cycle c's block b{i} in both packages."""
    pj, pt = weights(cfg)
    return (jax.tree.map(lambda a: a[c], pj["cycles"][f"b{i}"]),
            cycle_slice(pt["cycles"][f"b{i}"], c))


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("name", NAMES)
def test_ssm_configs_are_the_references(name):
    mod, ref = MODULES[name]
    for attr in ("CONFIG", "SMOKE"):
        got, want = getattr(mod, attr), getattr(ref, attr)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
    assert mod.__doc__ == ref.__doc__
    assert LM_CONFIGS[name] is mod.CONFIG
    assert LM_SMOKE_CONFIGS[name] is mod.SMOKE
    assert config.get_arch(name) is mod.CONFIG


# ---------------------------------------------------------------- init

@pytest.mark.parametrize("name", NAMES)
def test_init_lm_draws_the_reference_tree(weights, name):
    """The port's init_lm gives JAX's tree, leaf for leaf, all fp32."""
    cfg = _smoke(name)
    pj, _ = weights(cfg)
    pt = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = {tuple(p.key for p in path): tuple(x.shape) for path, x in
            jax.tree_util.tree_leaves_with_path(pj)}
    got = {k: tuple(v.shape) for k, v in _flat(pt).items()}
    assert got == want
    assert all(v.dtype == torch.float32 for v in _flat(pt).values())


def _std(t):
    return float(t.std())


def test_mamba_mlstm_slstm_init_scales():
    """The reference's scales and constants: mamba conv_w 0.5, dt_proj
    1/sqrt(r), in/x_proj 1/sqrt(fan-in), dt_bias log(expm1(0.01)), a_log
    log(1..N) on every row, d_skip 1, out_proj 1/sqrt(d_in); mLSTM gates
    0.01, b_fgate 3, b_igate 0, out_norm 1, down_proj 1/sqrt(d_in); sLSTM
    r 1/sqrt(hd), b [z 0 | i 0 | f 3 | o 0].  Standard deviations of a few
    thousand draws: within 10 % (sampling error ~ 1/sqrt(2n) <= 3 %)."""
    cfg = jamba.CONFIG.scaled(d_model=128, n_heads=4, ssm_d_state=16)
    gen = torch.Generator().manual_seed(3)
    d, d_in, n = 128, 256, 16
    r = max(1, d // 16)
    m = ssm.mamba_init(gen, cfg, stack=(2,), device="cpu")
    assert tuple(m["a_log"].shape) == (2, d_in, n)
    for key, scale in (("in_proj", d ** -0.5), ("conv_w", 0.5),
                       ("x_proj", d_in ** -0.5), ("dt_proj", r ** -0.5),
                       ("out_proj", d_in ** -0.5)):
        assert _std(m[key]) == pytest.approx(scale, rel=0.1), key
    # the constants as the reference computes them in fp32, to one ulp
    np.testing.assert_allclose(m["a_log"][1, 7].numpy(),
                               np.log(np.arange(1, n + 1)), rtol=1.2e-7)
    np.testing.assert_allclose(m["dt_bias"].numpy(),
                               math.log(math.expm1(0.01)), rtol=1.2e-7)
    assert float(torch.nn.functional.softplus(m["dt_bias"][0, 0])) == \
        pytest.approx(0.01, rel=1e-5)
    assert bool((m["d_skip"] == 1).all()) and bool((m["conv_b"] == 0).all())

    x = xlstm.CONFIG.scaled(d_model=128, n_heads=4)
    ml = ssm.mlstm_init(gen, x, device="cpu")
    assert tuple(ml["wq"].shape) == (d_in, d_in)
    for key, scale in (("w_igate", 0.01), ("w_fgate", 0.01),
                       ("up_proj", d ** -0.5), ("wk", d_in ** -0.5),
                       ("down_proj", d_in ** -0.5)):
        assert _std(ml[key]) == pytest.approx(scale, rel=0.1), key
    assert bool((ml["b_fgate"] == 3).all()) and bool((ml["b_igate"] == 0).all())
    assert bool((ml["out_norm"] == 1).all())

    sl = ssm.slstm_init(gen, x, stack=(3,), device="cpu")
    hd = 128 // 4
    assert tuple(sl["r"].shape) == (3, 4, hd, 4 * hd)
    assert _std(sl["r"]) == pytest.approx(hd ** -0.5, rel=0.1)
    want_b = np.concatenate([np.zeros(2 * d), np.full(d, 3.0), np.zeros(d)])
    for c in range(3):
        np.testing.assert_array_equal(sl["b"][c].numpy(), want_b)


@pytest.mark.parametrize("name", NAMES)
def test_ffn_rule_is_the_references(weights, name):
    """mLSTM and sLSTM blocks get no FFN; jamba's attention and mamba slots
    get the MoE FFN where layer_is_moe(slot) (b1, b3, b5, b7) and the MLP
    elsewhere, as JAX's tree has them."""
    cfg = _smoke(name)
    pj, pt = weights(cfg)
    for i, bt in enumerate(cfg.block_pattern):
        got = set(pt["cycles"][f"b{i}"])
        assert got == set(pj["cycles"][f"b{i}"]), i
        if bt in ("mlstm", "slstm"):
            assert got == {"norm1", "inner"}
        elif cfg.layer_is_moe(i):
            assert got == {"norm1", "inner", "norm2", "ffn_moe"}
        else:
            assert got == {"norm1", "inner", "norm2", "ffn"}
    if name == "jamba-v0.1-52b":
        assert [("ffn_moe" in pt["cycles"][f"b{i}"]) for i in range(8)] == \
            [False, True] * 4


@pytest.mark.parametrize("name", NAMES)
def test_lm_params_from_numpy_carries_the_ssm_leaves(weights, name):
    cfg = _smoke(name)
    pj, pt = weights(cfg)
    for i, bt in enumerate(cfg.block_pattern):
        want = jax.tree.map(np.asarray, pj["cycles"][f"b{i}"]["inner"])
        got = pt["cycles"][f"b{i}"]["inner"]
        assert set(got) == set(want), bt
        for k, w in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), w)


# ---------------------------------------------------------- causal conv

@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_causal_conv_matches_jax(history, dt):
    """Shifted adds in x's dtype, the history cast to x's dtype: fp32 the
    same to 1e-6 of the output's scale (measured <= 1.2e-7), bf16 the same
    bits (each add rounds the same way)."""
    xj, xt = _x((2, 9, 24))
    wj, wt = _x((24, 4), seed=3)
    bj, bt_ = _x((24,), seed=4)
    xj, xt = xj.astype(J_DT[dt]), xt.to(dt)
    hj = ht = None
    if history:
        hj, ht = _x((2, 3, 24), seed=5)
        hj, ht = hj.astype(jnp.bfloat16), ht.to(torch.bfloat16)
    yj, sj = j_ssm._causal_conv(xj, wj, bj, hj)
    yt, st = ssm._causal_conv(xt, wt, bt_, ht)
    assert yt.dtype == st.dtype == dt
    if dt == torch.float32:
        assert _rel_err(yt, yj) <= 1e-6
    else:
        np.testing.assert_array_equal(_np(yt), _np(yj))
    np.testing.assert_array_equal(_np(st), _np(sj))


# ------------------------------------------------------- selective scan

def _scan_inputs(b, s, d_in, n, seed=7):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d_in)))).astype(np.float32) * 0.3
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    xc = rng.standard_normal((b, s, d_in)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d_in, 1))
    h0 = rng.standard_normal((b, d_in, n)).astype(np.float32)
    return dt, a, bm, cm, xc, h0


# (S, chunk): a multiple of the chunk, not a multiple (padded with dt = 0),
# S = 1 (decode), several chunks; y and h_last in fp32 within 1e-5 of their
# scale (measured <= 4.8e-7: the doubling scan's tree against XLA's
# associative scan, fp32 rounding)
SCAN_CASES = {"multiple": (16, 8), "padded": (13, 8), "decode": (1, 8),
              "chunks": (40, 8), "one_chunk": (7, 16)}


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_ssm_scan_chunked_matches_jax(case, h0):
    s, chunk = SCAN_CASES[case]
    dt, a, bm, cm, xc, h = _scan_inputs(2, s, 12, 4)
    if not h0:
        h = np.zeros_like(h)
    args = (dt, a, bm, cm, xc, h)
    yj, hj = j_ssm._ssm_scan_chunked(*map(jnp.asarray, args), chunk)
    yt, ht = ssm._ssm_scan_chunked(*map(torch.from_numpy, args), chunk)
    assert yt.dtype == ht.dtype == torch.float32
    assert tuple(yt.shape) == (2, s, 12) and tuple(ht.shape) == (2, 12, 4)
    assert _rel_err(yt, yj) <= 1e-5
    assert _rel_err(ht, hj) <= 1e-5


def test_doubling_scan_is_the_sequential_recurrence():
    """The doubling scan against h_t = a_t h_{t-1} + b_t step by step in
    fp64 (lengths that are not powers of two too): within 1e-6 of the
    scale in fp32 (measured <= 2.4e-7)."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 8, 13, 32):
        a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
        b = rng.standard_normal((2, n, 3)).astype(np.float32)
        ac, bc = ssm._doubling_scan(torch.from_numpy(a), torch.from_numpy(b))
        ha, hb = np.ones((2, 3)), np.zeros((2, 3))
        want_a, want_b = [], []
        for t in range(n):
            ha, hb = ha * a[:, t], hb * a[:, t] + b[:, t]
            want_a.append(ha)
            want_b.append(hb)
        assert _rel_err(ac, np.stack(want_a, 1)) <= 1e-6
        assert _rel_err(bc, np.stack(want_b, 1)) <= 1e-6


# ------------------------------------------------------------- mixers

def _mixer_state(cfg, bt, b, seed=11):
    """An incoming state of the mixer's shapes (random, m finite)."""
    rng = np.random.default_rng(seed)
    if bt == "mamba":
        d_in = cfg.ssm_expand * cfg.d_model
        conv = rng.standard_normal((b, cfg.ssm_conv - 1, d_in)).astype(np.float32)
        ssm_ = rng.standard_normal((b, d_in, cfg.ssm_d_state)).astype(np.float32)
        return ((jnp.asarray(conv, jnp.bfloat16), jnp.asarray(ssm_)),
                (torch.from_numpy(conv).to(torch.bfloat16), torch.from_numpy(ssm_)))
    if bt == "mlstm":
        d_in = cfg.ssm_expand * cfg.d_model
        h, hd = cfg.n_heads, d_in // cfg.n_heads
        shapes = ((b, h, hd, hd), (b, h, hd), (b, h))
    else:
        h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
        shapes = ((b, h, hd),) * 4
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    arrs[-1] = arrs[-1] * 0.5  # the stabiliser m
    return (tuple(map(jnp.asarray, arrs)), tuple(map(torch.from_numpy, arrs)))


MIXERS = {"mamba": (jamba, 1, j_ssm.mamba_forward, ssm.mamba_forward),
          "mlstm": (xlstm, 0, j_ssm.mlstm_forward, ssm.mlstm_forward),
          "slstm": (xlstm, 1, j_ssm.slstm_forward, ssm.slstm_forward)}
# y and each state leaf: fp32 within 1e-5 of the scale (measured <= 6.3e-7),
# bf16 within 3e-2 (measured <= 1.2e-2: bf16 roundings of products summed
# in other orders; the bound is tests/test_torch_models.py's bf16 one)
MIXER_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("s", [13, 1])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_forward_matches_jax(weights, mixer, s, state, dt):
    mod, slot, jfn, tfn = MIXERS[mixer]
    cfg = mod.SMOKE
    pj, pt = _block_params(weights, cfg, slot)
    xj, xt = _x((2, s, cfg.d_model))
    xj, xt = xj.astype(J_DT[dt]), xt.to(dt)
    sj = st = None
    if state:
        sj, st = _mixer_state(cfg, mixer, 2)
    yj, nj = jfn(pj["inner"], xj, cfg, state=sj)
    yt, nt = tfn(pt["inner"], xt, cfg, state=st)
    tol = MIXER_TOL[dt]
    assert yt.dtype == dt and tuple(yt.shape) == (2, s, cfg.d_model)
    assert _rel_err(yt, yj) <= tol
    assert len(nt) == len(nj)
    for a, b in zip(nt, nj):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert _rel_err(a, b) <= tol


def test_slstm_regroups_the_gates_per_head(weights):
    """A pre-activation that differs only in head 1's forget gate moves
    only head 1's state: the [z | i | f | o] layout regrouped per head, as
    the reference's reshape(b, 4, h, hd).transpose(0, 2, 1, 3)."""
    cfg = xlstm.SMOKE
    _, pt = _block_params(weights, cfg, 1)
    p = dict(pt["inner"])
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    _, xt = _x((1, 3, d))
    base = ssm.slstm_forward(p, xt, cfg)[1]
    b2 = p["b"].clone()
    b2[2 * d + 1 * hd:2 * d + 2 * hd] -= 5.0   # f, head 1
    moved = ssm.slstm_forward(dict(p, b=b2), xt, cfg)[1]
    c0, c1 = base[0], moved[0]
    changed = (c0 - c1).abs().amax(dim=(0, 2))
    assert bool(changed[1] > 0)
    assert bool((changed[[0, 2, 3]] == 0).all())


# ------------------------------------------------------- the whole path

def _serve_jax(pj, cfg, prompt, dt):
    """JAX: forward_lm logits, prefill logits and cache, then N_STEPS
    greedy decode steps on a grown cache (attention entries padded on S)."""
    fwd = jax.jit(lambda t: j_forward_lm(pj, t, cfg, compute_dtype=dt))
    pre = jax.jit(lambda t: j_prefill(pj, t, cfg, compute_dtype=dt))
    step = jax.jit(lambda c, t, p: j_decode_step(pj, c, t, p, cfg,
                                                 compute_dtype=dt))
    out = {}
    out["forward"], _ = fwd(prompt)
    logits, cache = pre(prompt)
    out["prefill_logits"], out["prefill_cache"] = logits, cache
    cache = {k: ({n: jnp.pad(v, [(0, 0), (0, 0), (0, N_STEPS), (0, 0), (0, 0)])
                  for n, v in e.items()} if "k" in e else e)
             for k, e in cache.items()}
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out["tokens"], out["logits"] = [], []
    for i in range(N_STEPS):
        out["tokens"].append(np.asarray(tok))
        logits, cache = step(cache, tok, jnp.int32(prompt.shape[1] + i))
        out["logits"].append(logits)
        tok = jnp.argmax(logits[:, 0], axis=-1)[:, None].astype(jnp.int32)
    out["cache"] = cache
    return out


def _assert_caches_close(got, want, tol):
    """The same entries, shapes and dtypes; fp32 entries (the recurrent
    state) within tol of each entry's scale, bf16 ones within one bf16 ulp
    of each element plus tol of the entry's scale (the fp32 value it was
    rounded from already differs by that much)."""
    assert got.keys() == want.keys()
    for blk in want:
        assert got[blk].keys() == want[blk].keys(), blk
        for name, w in want[blk].items():
            g = got[blk][name]
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (blk, name)
            gn, wn = _np(g), _np(w)
            assert gn.shape == wn.shape, (blk, name)
            if g.dtype == torch.bfloat16:
                _, e = np.frexp(np.maximum(np.abs(gn), np.abs(wn)).astype(np.float64))
                bound = np.ldexp(1.0, e - 8) + tol * np.abs(wn).max()
                assert (np.abs(gn - wn) <= bound).all(), (blk, name)
            else:
                assert _rel_err(g, w) <= tol, (blk, name)


def _cache_from_jax(cache):
    """A copy of a JAX cache in the port's tensors, dtypes kept."""
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    return {k: {n: torch.from_numpy(np.array(jnp.asarray(v, jnp.float32))).to(
        dts[str(v.dtype)]) for n, v in e.items()} for k, e in cache.items()}


# (config, dtype) -> logits tolerance over max |logit|.  fp32: 1e-4
# (tests/test_torch_models.py's; measured <= 7.1e-5 on jamba's decode,
# <= 2.7e-6 elsewhere), the recurrent state after prefill 1e-5 (measured
# <= 1.1e-6).  After 4 chained decode steps jamba's state within 3e-3
# (measured 6.8e-4): its conv state is stored bf16, an element of it rounds
# one bf16 ulp (3.9e-3 of it) the other way now and then, and the next
# layers carry that; so each step is also taken from JAX's own cache, where
# the new state is within 1e-5 (measured <= 1.5e-6) and the bf16 entries
# within one ulp (two, measured, where a value of 5.9e-5 is a sum that
# cancels).  bf16 (xlstm): 3e-2 (measured <= 9.3e-3)
PATH_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# jamba in bf16: test_jamba_bf16_path_matches_jax
PATH_CASES = [(n, torch.float32) for n in NAMES] + [("xlstm-1.3b", torch.bfloat16)]


@pytest.mark.parametrize("name,dt", PATH_CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in PATH_CASES])
def test_forward_prefill_and_decode_match_jax(weights, name, dt):
    cfg = _smoke(name)
    tol = PATH_TOL[dt]
    pj, pt = weights(cfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, PROMPT).astype(np.int32)
    want = _serve_jax(pj, cfg, jnp.asarray(prompt), J_DT[dt])
    tp = torch.from_numpy(prompt.astype(np.int64))
    logits, _ = forward_lm(pt, tp, cfg, compute_dtype=dt)
    assert tuple(logits.shape) == (*PROMPT, cfg.vocab)
    assert _rel_err(logits, want["forward"]) <= tol
    logits, cache = prefill(pt, tp, cfg, compute_dtype=dt)
    assert _rel_err(logits, want["prefill_logits"]) <= tol
    if dt == torch.float32:
        _assert_caches_close(cache, want["prefill_cache"], 1e-5)
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
        _assert_caches_close(cache, want["cache"], 3e-3)


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_from_the_references_cache(weights, name):
    """Each of N_STEPS fp32 decode steps taken from JAX's cache of the step
    before: logits within 1e-5 (measured <= 2.3e-6), the new state within
    1e-5 (measured <= 1.5e-6) and the bf16 entries within one ulp plus 1e-5
    of their scale (measured: one ulp, two where 5.9e-5 is a sum that
    cancels)."""
    cfg = _smoke(name)
    pj, pt = weights(cfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, PROMPT).astype(np.int32)
    step = jax.jit(lambda c, t, p: j_decode_step(pj, c, t, p, cfg,
                                                 compute_dtype=jnp.float32))
    logits, cache = jax.jit(lambda t: j_prefill(
        pj, t, cfg, compute_dtype=jnp.float32))(jnp.asarray(prompt))
    cache = {k: ({n: jnp.pad(v, [(0, 0), (0, 0), (0, N_STEPS), (0, 0), (0, 0)])
                  for n, v in e.items()} if "k" in e else e)
             for k, e in cache.items()}
    for i in range(N_STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        got, got_cache = decode_step(
            pt, _cache_from_jax(cache), torch.from_numpy(np.asarray(tok, np.int64)),
            PROMPT[1] + i, cfg, compute_dtype=torch.float32)
        logits, cache = step(cache, tok, jnp.int32(PROMPT[1] + i))
        assert _rel_err(got, logits) <= 1e-5
        _assert_caches_close(got_cache, cache, 1e-5)


def _jax_chain(pj, cfg, tokens, dt):
    """JAX's forward, one block at a time (`_apply_block`, eagerly): each
    block's input and output, and the final logits."""
    b, s = tokens.shape
    x = pj["embed"][tokens].astype(dt)
    positions = jnp.arange(s)[None, :].repeat(b, 0)
    blocks = []
    for c in range(cfg.n_cycles):
        for i, bt in enumerate(cfg.block_pattern):
            p = jax.tree.map(lambda a: a[c], pj["cycles"][f"b{i}"])
            y, _, _ = j_transformer._apply_block(p, x, cfg, bt,
                                                 positions=positions)
            blocks.append((c, i, bt, x, y))
            x = y
    return blocks


def test_jamba_bf16_path_matches_jax(weights):
    """jamba's SMOKE in bf16, held block by block and step by step on the
    reference's own chain: every block of the cycle fed JAX's bf16 input
    gives JAX's output within 3e-2 of its scale (measured <= 9.9e-3), and so
    does every block of N_STEPS decode steps fed JAX's input and JAX's
    cache entry (`_decode_block`; measured <= 1.6e-2).  The whole chain is not compared in bf16: at
    this size it diverges where a router's choice flips (prompt token (0, 1)
    routes to other experts in the MoE of slot 5 after 1.5e-2 of bf16
    drift, and its logits then differ by 0.51 of their scale); the fp32
    chain is held whole above."""
    cfg = jamba.SMOKE
    pj, pt = weights(cfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, PROMPT).astype(np.int32)
    positions = torch.arange(PROMPT[1]).expand(*PROMPT)
    worst = 0.0
    for c, i, bt, xj, yj in _jax_chain(pj, cfg, jnp.asarray(prompt), jnp.bfloat16):
        xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
        yt, _, _ = transformer._apply_block(cycle_slice(pt["cycles"][f"b{i}"], c),
                                            xt, cfg, bt, positions=positions)
        assert yt.dtype == torch.bfloat16
        worst = max(worst, _rel_err(yt, yj))
    assert worst <= 3e-2, worst

    want = _serve_jax(pj, cfg, jnp.asarray(prompt), jnp.bfloat16)
    cache = want["prefill_cache"]
    cache = {k: ({n: jnp.pad(v, [(0, 0), (0, 0), (0, N_STEPS), (0, 0), (0, 0)])
                  for n, v in e.items()} if "k" in e else e)
             for k, e in cache.items()}
    worst = 0.0
    for i, tok in enumerate(want["tokens"]):
        pos = PROMPT[1] + i
        xj = pj["embed"][jnp.asarray(tok)].astype(jnp.bfloat16)
        for slot, bt in enumerate(cfg.block_pattern):
            key = f"b{slot}"
            p = jax.tree.map(lambda a: a[0], pj["cycles"][key])
            entry = {n: v[0] for n, v in cache[key].items()}
            yj, new = j_decode._decode_block(p, xj, cfg, bt, entry, pos)
            got_entry = _cache_from_jax({key: entry})[key]
            xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
            yt = t_decode._decode_block(cycle_slice(pt["cycles"][key], 0), xt,
                                        cfg, bt, got_entry, pos)
            assert yt.dtype == torch.bfloat16
            worst = max(worst, _rel_err(yt, yj))
            cache[key] = {n: v.at[0].set(new[n]) for n, v in cache[key].items()}
            xj = yj
    assert worst <= 3e-2, worst


@pytest.mark.parametrize("name", NAMES)
def test_generate_serves_a_recurrent_model(weights, name):
    """serve_lm.generate on the SMOKE: the greedy ids of the reference's
    loop above, the recurrent entries passed through _grow_cache as
    prefill and decode left them (constant in S), attention entries grown
    by the new tokens."""
    cfg = _smoke(name)
    pj, pt = weights(cfg)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, PROMPT).astype(np.int32)
    want = _serve_jax(pj, cfg, jnp.asarray(prompt), jnp.float32)
    ids, cache = generate(pt, cfg, torch.from_numpy(prompt.astype(np.int64)),
                          N_STEPS, compute_dtype=torch.float32)
    np.testing.assert_array_equal(
        ids.numpy(), np.concatenate(want["tokens"], axis=1))
    for i, bt in enumerate(cfg.block_pattern):
        entry = cache[f"b{i}"]
        if bt == "attn":
            assert entry["k"].shape[2] == PROMPT[1] + N_STEPS
        else:
            want_shapes = {n: tuple(v.shape) for n, v in
                           want["cache"][f"b{i}"].items()}
            assert {n: tuple(v.shape) for n, v in entry.items()} == want_shapes


# ------------------------------------------------------------- the cache

@pytest.mark.parametrize("name", NAMES)
def test_init_cache_is_the_references(name):
    """init_cache: the reference's entries, shapes, dtypes and values
    (zeros; the stabiliser m at -1e30), at two lengths; the recurrent
    entries do not grow with the length."""
    cfg = _smoke(name)
    for max_len in (8, 64):
        got = init_cache(cfg, 3, max_len, device="cpu")
        want = j_init_cache(cfg, 3, max_len)
        assert got.keys() == want.keys()
        for blk, e in want.items():
            assert got[blk].keys() == e.keys(), blk
            for n, w in e.items():
                g = got[blk][n]
                assert tuple(g.shape) == w.shape, (blk, n)
                assert str(g.dtype).split(".")[-1] == str(w.dtype), (blk, n)
                np.testing.assert_array_equal(_np(g), _np(w))
    if name == "xlstm-1.3b":
        d_in, h = 2 * cfg.d_model, cfg.n_heads
        assert tuple(got["b0"]["c"].shape) == (1, 3, h, d_in // h, d_in // h)
        assert float(got["b1"]["m"].min()) == float(np.float32(-1e30))


def test_grow_cache_passes_recurrent_entries_through():
    """The same tensors for the recurrent entries (no copy, no pad), the
    attention entries padded by n slots and, with kv_quant, made int8."""
    cfg = jamba.SMOKE
    cache = init_cache(cfg, 2, 6, device="cpu")
    for kv_quant in (False, True):
        grown = _grow_cache(cache, 5, kv_quant=kv_quant)
        for i, bt in enumerate(cfg.block_pattern):
            if bt == "attn":
                assert grown[f"b{i}"]["k"].shape[2] == 11
                assert (grown[f"b{i}"]["k"].dtype == torch.int8) == kv_quant
            else:
                assert grown[f"b{i}"] is cache[f"b{i}"]
    xc = init_cache(xlstm.SMOKE, 2, 6, device="cpu")
    assert all(_grow_cache(xc, 5, kv_quant=False)[k] is xc[k] for k in xc)


# ---------------------------------------------------------------- lm_loss

def _batch(cfg, seed=3, shape=(2, 16)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels[0, :3] = -1
    return tokens, labels


def _leaf_errs(got, want_tree):
    """Each leaf's largest difference over its largest entry, except the
    mLSTM's b_igate: the loss does not depend on it (the stabiliser m
    absorbs any shift of the input gate, so c, n and h stay as they were),
    its gradient is 0 but for rounding in both packages (measured max
    4.1e-8 here, 7.6e-9 in JAX), and it is measured over the largest entry
    of all leaves."""
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_leaves_with_path(want_tree)]
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want) == len(paths)
    top = max(float(np.abs(_np(w)).max()) for w in want)
    out = []
    for path, g, w in zip(paths, got, want):
        if path[-1] == "b_igate":
            out.append(float(np.abs(_np(g) - _np(w)).max()) / top)
        else:
            out.append(_rel_err(g, w))
    return out


# remat off, per cycle and nested (remat_group 2 over 2 cycles); S = 16 and
# S = 128 (two _MLSTM_CHUNKs: the checkpointed chunks of
# _checkpointed_seq_scan; sLSTM's 256 stays one loop, as in the reference).
# The loss within 1e-6 (measured <= 3.5e-7), each leaf's gradient within
# 2e-5 of its largest entry (measured <= 4.1e-6): tests/test_torch_train.py's
# fp32 tolerances
LOSS_REMAT = {"off": dict(remat=False), "per_cycle": dict(remat=True),
              "group2": dict(remat=True, remat_group=2)}
LOSS_CASES = [(n, r, s) for n in NAMES for r in LOSS_REMAT for s in (16, 128)
              if s == 16 or n == "xlstm-1.3b"]


@pytest.mark.parametrize("name,remat,s", LOSS_CASES,
                         ids=[f"{n}-{r}-{s}" for n, r, s in LOSS_CASES])
def test_lm_loss_value_and_grad_match_jax(weights, name, remat, s):
    base = _smoke(name)
    cfg = base.scaled(n_layers=2 * base.n_layers, **LOSS_REMAT[remat])
    pj, pt = weights(cfg)
    tokens, labels = _batch(cfg, shape=(2, s))

    def f(p):
        return j_lm_loss(p, {"tokens": tokens, "labels": labels}, cfg,
                         compute_dtype=jnp.float32)
    (lj, parts_j), gj = jax.jit(jax.value_and_grad(f, has_aux=True))(pj)
    leaves = tree_map(lambda x: x.clone().requires_grad_(True), pt)
    loss, parts = lm_loss(leaves, {"tokens": torch.from_numpy(tokens),
                                   "labels": torch.from_numpy(labels)},
                          cfg, compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    assert float(loss) == pytest.approx(float(lj), rel=1e-6)
    assert float(parts["aux"]) == pytest.approx(float(parts_j["aux"]),
                                                rel=1e-6, abs=1e-12)
    worst = max(_leaf_errs(grads, gj))
    assert worst <= 2e-5, worst


@pytest.mark.parametrize("name", NAMES)
def test_remat_gives_the_same_loss_and_gradients_bit_for_bit(weights, name):
    """remat per cycle and nested against off on the CPU: the same bits,
    with the sequence scans' own chunk checkpoints inside (S = 128: two
    mLSTM chunks, 16 mamba chunks)."""
    base = _smoke(name)
    cfg = base.scaled(n_layers=2 * base.n_layers)
    _, pt = weights(cfg)
    tokens, labels = _batch(cfg, shape=(2, 128))
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    out = {}
    for key, kw in LOSS_REMAT.items():
        leaves = tree_map(lambda x: x.clone().requires_grad_(True), pt)
        loss, _ = lm_loss(leaves, batch, cfg.scaled(**kw),
                          compute_dtype=torch.float32)
        out[key] = (loss.detach(), torch.autograd.grad(loss, tree_leaves(leaves)))
    for key in ("per_cycle", "group2"):
        assert torch.equal(out[key][0], out["off"][0])
        for a, b in zip(out[key][1], out["off"][1]):
            assert torch.equal(a, b)


def test_seq_scan_checkpoints_change_no_bit():
    """_checkpointed_seq_scan with a chunk that divides S (checkpointed
    chunks) against one loop: the same outputs, final carry and gradients,
    bit for bit; a chunk that does not divide S runs one loop."""
    cfg = xlstm.SMOKE
    gen = torch.Generator().manual_seed(5)
    p = {k: v.requires_grad_(True) for k, v in
         ssm.slstm_init(gen, cfg, device="cpu").items()}
    x = torch.randn((2, 24, cfg.d_model), generator=gen)
    got = {}
    for chunk in (8, 24, 5):
        old = ssm._SLSTM_CHUNK
        ssm._SLSTM_CHUNK = chunk
        try:
            y, st = ssm.slstm_forward(p, x, cfg)
        finally:
            ssm._SLSTM_CHUNK = old
        grads = torch.autograd.grad((y.sum() + st[0].sum()), list(p.values()))
        got[chunk] = (y.detach(), [t.detach() for t in st], grads)
    for chunk in (8, 5):
        assert torch.equal(got[chunk][0], got[24][0])
        for a, b in zip(got[chunk][1] + list(got[chunk][2]),
                        got[24][1] + list(got[24][2])):
            assert torch.equal(a, b)


# -------------------------------------------------------------- train step

@pytest.mark.parametrize("name", NAMES)
def test_smoke_train_step_in_bf16(name):
    """tests/test_arch_smoke.py's train-step case: the default bf16
    compute, where the step casts the params to bf16 once (the sLSTM's
    recurrent weight then promotes to fp32 in its product, as in JAX):
    a finite loss and gradient norm, finite params after the step."""
    from repro_torch.data import DataConfig, SyntheticTokenSource
    from repro_torch.train import init_train_state
    cfg = _smoke(name)
    tc = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=10)
    state, _ = init_train_state(torch.Generator().manual_seed(0), cfg, tc,
                                device="cpu")
    src = SyntheticTokenSource(cfg, DataConfig(seed=0, global_batch=2,
                                               seq_len=16), device="cpu")
    state, metrics = make_train_step(cfg, tc)(state, src.batch_at(0))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    assert np.isfinite(float(metrics["grad_norm"]))
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(state["params"]))


# one step at lr 1e-2 (warmup 1), fp32 compute, against the reference's
# jitted step: tests/test_torch_train.py's TRAIN_TOL (loss and lr 1e-6,
# grad norm 1e-4, the params' update 1e-3 of the reference's, the moments
# 3e-4 of each leaf's largest entry); measured loss <= 1.9e-7, grad norm
# <= 2.6e-7, update <= 3.1e-5, moments <= 4.2e-6
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name):
    cfg = _smoke(name)
    tc_kw = dict(peak_lr=1e-2, warmup=1, total_steps=10, microbatches=2,
                 compute_dtype="float32")
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
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]),
                                                   rel=1e-4)
    num = den = 0.0
    for g, w, s in zip(tree_leaves(st["params"]), jax.tree.leaves(sj["params"]),
                       start):
        w = torch.tensor(np.asarray(w))
        num += float(((g - w) ** 2).sum())
        den += float(((w - s) ** 2).sum())
    assert math.sqrt(num / den) <= 1e-3
    for k in ("m", "v"):  # b_igate's over all leaves' largest (_leaf_errs)
        worst = max(_leaf_errs(tree_leaves(st["opt"][k]), sj["opt"][k]))
        assert worst <= 3e-4, k


# ----------------------------------------- chip_smoke.py's phase 19 reckonings

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
def test_chip_smoke_param_count_is_the_models(name):
    """train_param_count against init_lm's tree at SMOKE size, and at full
    width: xlstm-1.3b's 48 layers 2,623,146,176 (the reference's
    ArchConfig.param_count says 2,789,965,824: its mLSTM and sLSTM terms are
    approximate), jamba-v0.1-52b's first 8 layers (one cycle) 13,295,235,072,
    as jax.eval_shape over the reference's init_lm counts them."""
    cs = _chip_smoke()
    cfg = _smoke(name)
    params = init_lm(torch.Generator(), cfg, device="cpu")
    assert costmodel.train_param_count(cfg) == sum(x.numel() for x in tree_leaves(params))
    full = LM_CONFIGS[name]
    if name == "xlstm-1.3b":
        want, cut = 2_623_146_176, full
    else:
        want, cut = 13_295_235_072, full.scaled(n_layers=8)
    assert costmodel.train_param_count(cut) == want
    shapes = jax.eval_shape(lambda k: j_init_lm(k, cut)[0], jax.random.PRNGKey(0))
    assert sum(math.prod(x.shape) for x in jax.tree.leaves(shapes)) == want


@pytest.mark.parametrize("name", NAMES)
def test_chip_smoke_state_bytes_are_the_caches(name):
    """ssm_state_bytes equals the recurrent entries of init_cache, at two
    batch sizes and any length."""
    cs = _chip_smoke()
    cfg = _smoke(name)
    for b, max_len in ((1, 8), (3, 40)):
        cache = init_cache(cfg, b, max_len, device="cpu")
        got = sum(t.numel() * t.element_size() for key, e in cache.items()
                  if "k" not in e for t in e.values())
        assert costmodel.ssm_state_bytes(cfg, b) == got


# (config, batch, prompt, new) at which each term decides the CPU peak: the
# mLSTM layer's loop (xlstm), the mamba scan's chunk (jamba with a wide
# state and chunk) and the attention scores (jamba at a longer prompt).
# The params' and the state's terms are the run's own bytes; the rest of the
# total lies within [1, 1.3] of the peak the CPU run holds (measured 1.145,
# 1.001 and 1.041)
PEAK_CASES = {
    "mlstm": (xlstm.SMOKE.scaled(d_model=128, vocab=128), 4, 64, 4),
    "mamba": (jamba.SMOKE.scaled(vocab=128, ssm_d_state=64, mamba_chunk=32),
              4, 96, 4),
    "scores": (jamba.SMOKE.scaled(vocab=128), 4, 256, 4),
}


@pytest.mark.parametrize("case", list(PEAK_CASES))
def test_chip_smoke_ssm_serve_peak_against_a_cpu_run(case):
    cs = _chip_smoke()
    cfg, b, s, new = PEAK_CASES[case]
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
    held = {k: sum(t.numel() * t.element_size() for t in e.values())
            for k, e in box["cache"].items()}
    assert pred["state"] == sum(v for k, v in held.items()
                                if "k" not in box["cache"][k])
    assert pred["cache_grown"] == sum(v for k, v in held.items()
                                      if "k" in box["cache"][k])
    dynamic = pred["total"] - pred["params"]
    assert 1.0 <= dynamic / measured <= 1.3, (dynamic, measured)


def test_chip_smoke_ssm_serve_peak_at_full_width():
    """xlstm-1.3b at 4 x 1,024: 9.77 GiB of fp32 params and 1.51 GiB of
    state (the mLSTM memories: 24 x 4 x 4 x 1,024^2 fp32), far under 70
    GiB.  jamba at 8 layers: 49.53 GiB of params; at 4 x 4,096 its one
    attention layer's two fp32 (B, H, S, S) score buffers add 16 GiB and
    the total passes 65 GiB, at 2 x 4,096 it is under 60."""
    cs = _chip_smoke()
    x = costmodel.serve_peak_bytes(LM_CONFIGS["xlstm-1.3b"], 4, 1_024, 64)
    assert x["params"] / 2**30 == pytest.approx(9.772, abs=1e-3)
    assert x["state"] == 24 * 4 * 4 * (1_024 ** 2 + 1_024 + 1) * 4 \
        + 24 * 4 * 4 * 2_048 * 4
    assert x["scores"] == x["cache"] == x["dispatch"] == 0
    assert x["total"] / 2**30 < 15
    j = LM_CONFIGS["jamba-v0.1-52b"].scaled(n_layers=8)
    j4 = costmodel.serve_peak_bytes(j, 4, 4_096, 32)
    assert j4["params"] / 2**30 == pytest.approx(49.53, abs=0.01)
    assert j4["scores"] == 2 * 4 * 32 * 4_096 * 4_096 * 4
    assert (j4["groups"], j4["capacity"]) == (32, 80)
    assert 65 < j4["total"] / 2**30 < 70
    assert costmodel.serve_peak_bytes(j, 2, 4_096, 32)["total"] / 2**30 < 60
