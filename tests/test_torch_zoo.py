"""The rest of the model zoo on the CPU against the JAX package: the five
configs of whisper-tiny, llava-next-34b, qwen3-4b, qwen3-32b and
h2o-danube-1.8b field for field, the registry of all ten, the dense ones
served (qwen3's qk-norm, h2o-danube's sliding window at its real d_head
80, scaled down in width only) against JAX on the same weights, the
synthetic stream's patches and frames, and `input_specs` against the
reference's for every cell `cell_applicable` admits."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import h2o_danube_1_8b as j_h2o
from repro.configs import llava_next_34b as j_llava
from repro.configs import qwen3_32b as j_qwen32
from repro.configs import qwen3_4b as j_qwen4
from repro.configs import whisper_tiny as j_whisper
from repro.configs.shapes import input_specs as j_input_specs
from repro.models.transformer import init_lm as j_init_lm
from repro_torch import interop
from repro_torch.configs import (LM_CONFIGS, LM_SMOKE_CONFIGS, SHAPES,
                                 cell_applicable, h2o_danube_1_8b,
                                 input_specs, llava_next_34b, qwen3_32b,
                                 qwen3_4b, whisper_tiny)
from repro_torch.data import DataConfig, SyntheticTokenSource
from repro_torch.models import config
from repro_torch.models.decode import decode_step, prefill
from repro_torch.serve_lm import _grow_cache, banded_kv_attention, fold_banded
from repro_torch.launch import costmodel
from test_torch_encdec import assert_caches_near
from test_torch_mle_adam import _chip_smoke
from test_torch_models import N_STEPS, PROMPT, _prompt, _rel_err, _serve_jax

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

MODULES = {"whisper-tiny": (whisper_tiny, j_whisper),
           "llava-next-34b": (llava_next_34b, j_llava),
           "qwen3-4b": (qwen3_4b, j_qwen4),
           "qwen3-32b": (qwen3_32b, j_qwen32),
           "h2o-danube-1.8b": (h2o_danube_1_8b, j_h2o)}


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("name", list(MODULES))
def test_configs_are_the_references(name):
    mod, ref = MODULES[name]
    for attr in ("CONFIG", "SMOKE"):
        got, want = getattr(mod, attr), getattr(ref, attr)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_cycles == want.n_cycles
        assert got.param_count() == want.param_count()
    assert mod.__doc__ == ref.__doc__
    assert LM_CONFIGS[name] is mod.CONFIG
    assert LM_SMOKE_CONFIGS[name] is mod.SMOKE
    assert config.get_arch(name) is mod.CONFIG


def test_the_registry_holds_the_references_ten():
    assert list(LM_CONFIGS) == list(j_configs.ALL_ARCHS)
    assert list(LM_SMOKE_CONFIGS) == list(j_configs.SMOKE_ARCHS)
    assert len(LM_CONFIGS) == 10


# ------------------------------------------------- the dense ones served

SERVED = {  # name -> the config served against JAX
    "qwen3-4b": qwen3_4b.SMOKE,
    "qwen3-32b": qwen3_32b.SMOKE,
    # d_head 80 as the full config has it; the window of 8 wraps: the prompt
    # of 12 is trimmed to it and the decode steps overwrite its slots
    "h2o-danube-1.8b": h2o_danube_1_8b.SMOKE.scaled(d_head=80),
}


@pytest.mark.parametrize("name", list(SERVED))
def test_dense_configs_serve_as_jax(name):
    cfg = SERVED[name]
    pj, _ = j_init_lm(jax.random.PRNGKey(0), cfg)
    pt = interop.lm_params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    prompt = _prompt(cfg)
    grow = cfg.swa_window is None
    want = _serve_jax(pj, cfg, jnp.asarray(prompt), jnp.float32, grow=grow)
    tp = torch.from_numpy(prompt.astype(np.int64))
    logits, cache = prefill(pt, tp, cfg, compute_dtype=torch.float32)
    assert _rel_err(logits, want["prefill_logits"]) <= 1e-4
    assert_caches_near(cache, want["prefill_cache"])
    if grow:
        cache = _grow_cache(cache, N_STEPS, kv_quant=False)
    for i, tok in enumerate(want["tokens"]):
        np.testing.assert_array_equal(
            torch.argmax(logits[:, -1], dim=-1).numpy(), tok[:, 0])
        logits, cache = decode_step(pt, cache, torch.from_numpy(
            tok.astype(np.int64)), PROMPT[1] + i, cfg,
            compute_dtype=torch.float32)
        assert _rel_err(logits, want["logits"][i]) <= 1e-4
    assert_caches_near(cache, want["cache"])
    if name == "h2o-danube-1.8b":
        assert tuple(cache["b0"]["k"].shape[2:]) == (8, cfg.n_kv_heads, 80)
        # the window holds the last 8 positions, in circular slots
        last = PROMPT[1] + N_STEPS - 1
        assert sorted(cache["b0"]["pos"][0].tolist()) == list(
            range(last - 7, last + 1))


def test_h2o_window_through_banded_attention_at_d80():
    """One layer's wrapped SWA cache of h2o-danube's SMOKE at d_head 80, its
    slots put in position order, through the banded-precision attention
    (the plain version here) against exact attention, as chip_smoke.py's
    phase 20 (c) holds the card's kernel."""
    cs = _chip_smoke()
    cfg = SERVED["h2o-danube-1.8b"].scaled(swa_window=256)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.transformer import init_lm
    params = init_lm(gen, cfg, device="cpu")
    # a prompt of two windows, as the card's 8,192 is of 4,096: prefill
    # leaves position p in slot p % 256, where decode writes (ROADMAP C 25)
    prompt = torch.randint(0, cfg.vocab, (2, 512), generator=gen)
    full_cfg = cfg.scaled(swa_window=None)
    _, cache = prefill(params, prompt, cfg, compute_dtype=torch.float32)
    _, full = prefill(params, prompt, full_cfg, compute_dtype=torch.float32)
    full = _grow_cache(full, 2, kv_quant=False)
    for i, t in enumerate((5, 7)):  # two steps: slots 0 and 1 rewritten
        tok = torch.full((2, 1), t)
        decode_step(params, cache, tok, 512 + i, cfg, compute_dtype=torch.float32)
        decode_step(params, full, tok, 512 + i, full_cfg,
                    compute_dtype=torch.float32)
    entry = cache["b0"]
    k, v, length = cs.window_in_order(entry, 0, None)
    assert length == 256 and tuple(k.shape) == (2, 256, cfg.n_kv_heads, 80)
    assert int(torch.argmax(entry["pos"][0])) == 1
    assert torch.equal(k[:, -1], entry["k"][0][:, 1])
    # layer 0's k does not depend on the window: the full cache's last 256
    # of its 514 rows, in order
    k_full, v_full, n = cs.window_in_order(full["b0"], 0, 514)
    assert n == 514 and torch.equal(k_full[:, -256:], k)
    assert torch.equal(v_full[:, -256:], v)
    g = cfg.n_heads // cfg.n_kv_heads
    q = torch.randn((2 * cfg.n_kv_heads, g, 80), generator=gen)
    out, exact = banded_kv_attention(k, v, q, length, near=128, blk=64)
    assert float((out - exact).abs().max()) < 0.05
    # the far segment holds two int8 blocks, the near one the latest 128
    segs, _ = fold_banded(k, v, length, near=128, blk=64)
    assert int(segs[6][0]) == 128 and int(segs[2][0]) == 128


def test_swa_prefill_slots_as_the_reference_leaves_them():
    """ROADMAP C 25: prefill puts the last W positions in slots 0..W-1 in
    order, decode writes position p at slot p % W; the two agree only when
    the prompt is a multiple of W.  The port keeps the reference's slots."""
    cfg = h2o_danube_1_8b.SMOKE  # window 8
    pj, _ = j_init_lm(jax.random.PRNGKey(0), cfg)
    from repro.models.decode import prefill as j_prefill
    for s in (12, 16):
        tokens = np.zeros((1, s), np.int32)
        _, cj = j_prefill(pj, jnp.asarray(tokens), cfg, compute_dtype=jnp.float32)
        pt = interop.lm_params_from_numpy(jax.tree.map(np.asarray, pj),
                                          device="cpu")
        _, ct = prefill(pt, torch.from_numpy(tokens.astype(np.int64)), cfg,
                        compute_dtype=torch.float32)
        pos = ct["b0"]["pos"][0]
        np.testing.assert_array_equal(pos.numpy(), np.asarray(cj["b0"]["pos"][0]))
        assert pos.tolist() == list(range(s - 8, s))
        assert (pos % 8 == torch.arange(8)).all().item() == (s % 8 == 0)


# --------------------------------------------------- the synthetic stream

def _digest(src, steps=(0, 1, 7)):
    h = hashlib.sha256()
    for step in steps:
        b = src.batch_at(step)
        h.update(b["tokens"].numpy().tobytes())
        h.update(b["labels"].numpy().tobytes())
    return h.hexdigest()[:16]


# the stream of seed 3, 4 x 16, steps 0, 1 and 7 of a vocab-512 SMOKE, as
# the pipeline drew it before patches and frames were added
TOKENS_DIGEST = "9a50463e552a3082"


@pytest.mark.parametrize("name", sorted(LM_SMOKE_CONFIGS))
def test_stream_tokens_are_unchanged_and_stubs_follow(name):
    cfg = LM_SMOKE_CONFIGS[name]
    dc = DataConfig(seed=3, global_batch=4, seq_len=16)
    src = SyntheticTokenSource(cfg, dc, device="cpu")
    assert _digest(src) == TOKENS_DIGEST
    batch = src.batch_at(2)
    keys = {"tokens", "labels"}
    if cfg.frontend == "vision_stub":
        keys.add("patches")
        assert tuple(batch["patches"].shape) == (4, cfg.n_patches, cfg.d_model)
    if cfg.enc_dec:
        keys.add("frames")
        assert tuple(batch["frames"].shape) == (4, cfg.n_enc_frames,
                                                cfg.d_model)
    assert set(batch) == keys
    for key in keys - {"tokens", "labels"}:
        assert batch[key].dtype == torch.float32
        assert torch.equal(batch[key], src.batch_at(2)[key])  # per step
        assert not torch.equal(batch[key], src.batch_at(3)[key])


@pytest.mark.parametrize("name", ["whisper-tiny", "llava-next-34b"])
def test_stub_inputs_follow_the_references_law(name):
    """Standard normal: over 64 x n x d draws the mean within 5 standard
    errors of 0 and the variance within 5 % of 1, as JAX's draws are."""
    cfg = LM_SMOKE_CONFIGS[name]
    key = "frames" if cfg.enc_dec else "patches"
    dc = DataConfig(seed=0, global_batch=64, seq_len=8)
    x = SyntheticTokenSource(cfg, dc, device="cpu").batch_at(0)[key].double()
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticTokenSource as JSource
    xj = np.asarray(JSource(cfg, JDataConfig(seed=0, global_batch=64,
                                             seq_len=8)).batch_at(0)[key])
    assert tuple(x.shape) == xj.shape and xj.dtype == np.float32
    for a in (x.numpy(), xj.astype(np.float64)):
        assert abs(a.mean()) < 5 / np.sqrt(a.size)
        assert abs(a.var() - 1) < 0.05


# ---------------------------------------------------------- input_specs

def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


CELLS = [(a, s) for a in LM_CONFIGS for s in SHAPES
         if cell_applicable(LM_CONFIGS[a], SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_are_the_references(arch, shape):
    cfg, spec = LM_CONFIGS[arch], SHAPES[shape]
    got = _flat(input_specs(cfg, spec))
    want = _flat(j_input_specs(j_configs.ALL_ARCHS[arch],
                               j_configs.shapes.SHAPES[shape]))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, path


def test_input_specs_allocate_nothing():
    # jamba's decode_32k cache is GiBs; on the meta device it is no bytes
    cfg = LM_CONFIGS["jamba-v0.1-52b"]
    specs = input_specs(cfg, SHAPES["decode_32k"])
    leaves = _flat(specs).values()
    assert sum(t.numel() * t.element_size() for t in leaves) > 2**30
    assert all(t.is_meta for t in leaves)
    skipped = [(a, s) for a in LM_CONFIGS for s in SHAPES
               if not cell_applicable(LM_CONFIGS[a], SHAPES[s])[0]]
    assert ("whisper-tiny", "long_500k") in skipped
    assert ("h2o-danube-1.8b", "long_500k") not in skipped  # SWA


# --------------------------------------- chip_smoke.py's phase 20 reckonings

@pytest.mark.parametrize("name", list(MODULES))
def test_chip_smoke_param_count_is_the_models(name):
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.adamw import tree_leaves
    cs = _chip_smoke()
    cfg = LM_SMOKE_CONFIGS[name]
    params = init_lm(torch.Generator(), cfg, device="cpu")
    assert costmodel.train_param_count(cfg) == sum(x.numel() for x in tree_leaves(params))


def test_chip_smoke_param_counts_at_full_width():
    """whisper-tiny 61.07 M params (0.244 GB fp32); llava-next-34b 557.86 M a
    layer, 8 layers with its embeddings and adapter 5.43 B (21.7 GB), all 60
    ~138 GB; qwen3-32b ~131 GB; h2o-danube-1.8b 1.83 B (7.3 GB)."""
    cs = _chip_smoke()
    assert costmodel.train_param_count(LM_CONFIGS["whisper-tiny"]) == 61_074_432
    llava = LM_CONFIGS["llava-next-34b"]
    assert costmodel.layer_param_count(llava) == 557_856_768
    assert costmodel.train_param_count(llava.scaled(n_layers=8)) == 5_431_745_536
    assert 137e9 < 4 * costmodel.train_param_count(llava) < 139e9
    assert 130e9 < 4 * costmodel.train_param_count(LM_CONFIGS["qwen3-32b"]) < 132e9
    assert costmodel.train_param_count(LM_CONFIGS["h2o-danube-1.8b"]) == 1_831_201_280


PEAK_CASES = {  # name -> (config, batch, prompt, new); the dominant term
    # the encoder's fp32 (B, H, F, F) scores at F = 256
    "whisper": (whisper_tiny.SMOKE.scaled(n_enc_frames=256), 4, 16, 4),
    # the (B, H, S, S) scores over 8 patches + 120 tokens
    "llava": (llava_next_34b.SMOKE, 4, 120, 4),
    # a window of 64 under a 128-token prompt: the cache is the window
    "h2o": (h2o_danube_1_8b.SMOKE.scaled(swa_window=64, d_head=80), 4, 128, 4),
}


@pytest.mark.parametrize("case", list(PEAK_CASES))
def test_chip_smoke_zoo_serve_peak_against_a_cpu_run(case):
    """serve_peak_bytes' prediction of generate with the stub inputs: the
    params', caches' and inputs' terms are the run's own bytes, and the
    rest of the total lies within [1, 1.3] of the peak the CPU run holds
    (the stub inputs' fp32 bytes are the caller's, outside the run;
    measured 1.11 whisper (1.19 before its encoder moment was
    tightened), 1.09 llava, 1.25 h2o)."""
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve_lm import generate
    from test_torch_moe import _cpu_peak_bytes
    cs = _chip_smoke()
    cfg, b, s, new = PEAK_CASES[case]
    gen = torch.Generator().manual_seed(0)
    params = init_lm(gen, cfg, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    stubs = cs.stub_inputs(cfg, b, gen, device="cpu")
    box = {}

    def run():
        box["ids"], box["cache"] = generate(params, cfg, prompt, new,
                                            compute_dtype=torch.bfloat16,
                                            **stubs)
    measured = _cpu_peak_bytes(run)
    pred = costmodel.serve_peak_bytes(cfg, b, s, new)
    assert pred["params"] == sum(x.numel() * 4 for x in tree_leaves(params))
    inputs = sum(x.numel() * 4 for x in stubs.values())
    assert pred["inputs"] == inputs * 6 // 4  # and their bf16 copy
    cache = box["cache"]
    assert pred["cross"] == sum(t.numel() * t.element_size()
                                for t in cache.get("cross", {}).values())
    self_bytes = sum(cache["b0"][n].numel() * 2 for n in ("k", "v"))
    if cfg.swa_window is None:
        assert pred["cache_grown"] == self_bytes
    else:  # the window, prefill's and the grown cache's one tensor
        assert pred["cache"] == self_bytes and pred["cache_grown"] == 0
    dynamic = pred["total"] - pred["params"] - inputs
    assert 1.0 <= dynamic / measured <= 1.3, (dynamic, measured)
