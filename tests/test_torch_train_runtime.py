"""The port's training runtime on the CPU against the JAX package: the data
pipeline, FileSource, checkpoints (each package restores what the other
wrote), the fault-tolerant loop, the two training entry points, and
chip_smoke.py's phase 17 reckonings (peak memory and flops of a step)."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.data import DataConfig as JDataConfig
from repro.data import FileSource as JFileSource
from repro.runtime import FaultTolerantLoop as JLoop
from repro.runtime import LoopConfig as JLoopConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import interop
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import LM_CONFIGS, SHAPES, cell_applicable
from repro_torch.configs import llama3_2_1b as llama
from repro_torch.data import DataConfig, FileSource, SyntheticTokenSource
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import (FaultTolerantLoop, LoopConfig,
                                 make_failure_injector)
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.launch import costmodel

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, remat=False)


def _tiny_state(tc, seed=0):
    return init_train_state(torch.Generator().manual_seed(seed), TINY, tc,
                            device="cpu")[0]


def _source(**kw):
    return SyntheticTokenSource(TINY, DataConfig(**kw), device="cpu")


# ---------------------------------------------------------- data pipeline

def test_pipeline_deterministic_and_host_sharded():
    src = _source(seed=1, global_batch=8, seq_len=32)
    b1, b2 = src.batch_at(5), _source(seed=1, global_batch=8,
                                      seq_len=32).batch_at(5)
    assert b1["tokens"].dtype == b1["labels"].dtype == torch.int32
    assert torch.equal(b1["tokens"], b2["tokens"])  # a pure function
    assert torch.equal(b1["labels"], src.batch_at(5)["labels"])
    assert not torch.equal(b1["tokens"], src.batch_at(6)["tokens"])
    assert not torch.equal(b1["tokens"],
                           _source(seed=2, global_batch=8,
                                   seq_len=32).batch_at(5)["tokens"])
    # two hosts partition the global batch without overlap
    s0 = _source(seed=1, global_batch=8, seq_len=32, n_processes=2,
                 process_index=0)
    s1 = _source(seed=1, global_batch=8, seq_len=32, n_processes=2,
                 process_index=1)
    assert s0.batch_at(0)["tokens"].shape == (4, 32)
    assert not torch.equal(s0.batch_at(0)["tokens"], s1.batch_at(0)["tokens"])
    with pytest.raises(ValueError):
        _source(global_batch=6, n_processes=4)


def test_pipeline_labels_shift():
    b = _source(global_batch=2, seq_len=16).batch_at(0)
    # label[i] is the next token of tokens[i] in the same stream
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_keeps_the_streams_law():
    """Each row is (t0 + a i + noise_i) mod vocab with one a in [1, 8) and
    noise in [0, 3): each step tokens[i+1] - tokens[i] - a lies in [-2, 2]
    mod vocab, for the same a along the row."""
    b = _source(seed=4, global_batch=16, seq_len=64).batch_at(3)
    stream = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1).long()
    v = TINY.vocab
    diff = (stream[:, 1:] - stream[:, :-1]) % v
    found = []
    for row in diff:
        ok = [a for a in range(1, 8)
              if bool((((row - a + 2) % v) <= 4).all())]
        assert ok, row
        found.append(ok)
    assert len({a for ok in found for a in ok}) > 1  # a varies by row
    assert int(stream.min()) >= 0 and int(stream.max()) < v


def test_pipeline_same_stream_on_two_devices_of_one_host():
    """The batch is drawn on the CPU, then moved: a source for another
    device (here a second CPU source) sees the same bits."""
    a = _source(seed=9, global_batch=4, seq_len=8).batch_at(2)
    b = SyntheticTokenSource(TINY, DataConfig(seed=9, global_batch=4,
                                              seq_len=8),
                             device=torch.device("cpu")).batch_at(2)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("step,proc", [(0, 0), (3, 1), (50, 0)])
def test_file_source_matches_the_reference_bit_for_bit(tmp_path, dtype, step,
                                                       proc):
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(5).integers(0, 1000, 5_000)
            .astype(dtype))
    kw = dict(seed=0, global_batch=4, seq_len=24, n_processes=2,
              process_index=proc)
    want = JFileSource(TINY, JDataConfig(**kw), str(path)).batch_at(step)
    got = FileSource(TINY, DataConfig(**kw), str(path),
                     device="cpu").batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------------------------ checkpoints

def _state():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3e-3, 7.0],
                                    dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_bf16(tmp_path):
    state = _state()
    ckpt.save(str(tmp_path), 3, state, async_=False).result()
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored = ckpt.restore(str(tmp_path), 3, state)
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert restored["b"]["d"].dtype == torch.int32
    assert restored["b"]["d"].dim() == 0
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(a, b)
    manifest = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert manifest == {"step": 3, "keys": ["a", "b/c", "b/d"], "dtypes": {
        "a": "float32", "b/c": "bfloat16", "b/d": "int32"}}
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_save_snapshots_before_it_returns(tmp_path):
    """An in-place change after save() returns does not reach the file,
    though the write runs later on the worker thread."""
    state = _state()
    fut = ckpt.save(str(tmp_path), 1, state)
    state["a"].add_(100.0)
    state["b"]["c"].mul_(2)
    fut.result()
    restored = ckpt.restore(str(tmp_path), 1, state)
    assert torch.equal(restored["a"], _state()["a"])
    assert torch.equal(restored["b"]["c"], _state()["b"]["c"])


def test_checkpoint_async_and_gc(tmp_path):
    state = {"x": torch.zeros(16)}
    futs = [ckpt.save(str(tmp_path), s, state) for s in (1, 2, 3)]
    for f in futs:
        f.result()
    assert ckpt.latest_step(str(tmp_path)) == 3
    loop = FaultTolerantLoop(LoopConfig(ckpt_dir=str(tmp_path), keep_last=2),
                             None, None, state)
    loop._gc(3)
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    assert not any(d.startswith(".tmp") for d in os.listdir(tmp_path))


def _jax_state():
    return {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3) / 7,
            "b": {"c": jnp.asarray([1.5, -2.25, 3e-3, 7.0], jnp.bfloat16),
                  "d": jnp.int32(7)},
            "e": {"f": jnp.linspace(-1, 1, 10, dtype=jnp.float32)}}


def _assert_same(port_tree, jax_tree):
    pl, jl = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        j = np.asarray(j)
        assert tuple(p.shape) == j.shape
        if p.dtype == torch.bfloat16:
            assert j.dtype == jnp.bfloat16
            np.testing.assert_array_equal(p.view(torch.int16).numpy(),
                                          j.view(np.int16))
        else:
            assert str(j.dtype) == str(p.numpy().dtype)
            np.testing.assert_array_equal(p.numpy(), j)


def test_checkpoint_reference_writes_port_restores(tmp_path):
    js = _jax_state()
    j_ckpt.save(str(tmp_path), 5, js, async_=False).result()
    like = interop.train_state_from_numpy(jax.tree.map(np.zeros_like, js),
                                          device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 5
    _assert_same(ckpt.restore(str(tmp_path), 5, like), js)


def test_checkpoint_port_writes_reference_restores(tmp_path):
    js = _jax_state()
    ps = interop.train_state_from_numpy(jax.tree.map(np.asarray, js),
                                        device="cpu")
    ckpt.save(str(tmp_path), 6, ps, async_=False).result()
    assert j_ckpt.latest_step(str(tmp_path)) == 6
    restored = j_ckpt.restore(str(tmp_path), 6, jax.tree.map(jnp.zeros_like, js))
    _assert_same(ps, restored)
    assert restored["b"]["c"].dtype == jnp.bfloat16


def test_checkpoint_of_a_train_state_crosses_both_ways(tmp_path):
    """A whole SMOKE train state (bf16 moments, a residual, int32 steps):
    the reference's checkpoint restores into the port bit for bit, and the
    port's, written from it, restores into the reference bit for bit."""
    tc = JTrainConfig(moment_dtype="bfloat16", compression="int8")
    sj, _ = j_init_train_state(jax.random.PRNGKey(0), llama.SMOKE, tc)
    j_ckpt.save(str(tmp_path / "j"), 1, sj, async_=False).result()
    st = ckpt.restore(str(tmp_path / "j"), 1, interop.train_state_from_numpy(
        jax.tree.map(np.asarray, sj), device="cpu"))
    _assert_same(st, sj)
    ckpt.save(str(tmp_path / "t"), 2, st, async_=False).result()
    _assert_same(st, j_ckpt.restore(str(tmp_path / "t"), 2, sj))


# -------------------------------------------------------- fault tolerance

def test_fault_tolerant_loop_survives_failures_and_resumes(tmp_path):
    """The reference's test."""
    tc = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=30)
    state = _tiny_state(tc)
    step = make_train_step(TINY, tc)
    src = _source(seed=0, global_batch=4, seq_len=16)
    lc = LoopConfig(ckpt_dir=str(tmp_path), ckpt_every=5, max_steps=20)
    loop = FaultTolerantLoop(lc, step, src, state,
                             failure_injector=make_failure_injector([7, 13]))
    final = loop.run()
    assert loop.restarts == 2
    assert int(final["data_step"]) == 20
    losses = np.array([m["loss"] for m in loop.metrics_log])
    assert np.all(np.isfinite(losses))
    assert float(np.max(losses)) < float(losses[0]) + 1.0
    # the final checkpoint is the returned state, bit for bit
    assert ckpt.latest_step(str(tmp_path)) == 20
    restored = ckpt.restore(str(tmp_path), 20, final)
    for a, b in zip(tree_leaves(final), tree_leaves(restored)):
        assert torch.equal(a, b)
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) <= 3


def test_loop_gives_up_after_max_restarts(tmp_path):
    tc = TrainConfig(total_steps=10)
    state = _tiny_state(tc)
    src = _source(seed=0, global_batch=4, seq_len=16)
    lc = LoopConfig(ckpt_dir=str(tmp_path), ckpt_every=100, max_steps=10,
                    max_restarts=1)

    def injector(s):  # failing on the same pre-checkpoint step forever
        if s == 2:
            raise RuntimeError("persistent failure")
    loop = FaultTolerantLoop(lc, make_train_step(TINY, tc), src, state,
                             failure_injector=injector)
    with pytest.raises(RuntimeError, match="max_restarts=1"):
        loop.run()
    assert loop.restarts == 2


def test_failure_before_the_first_checkpoint_restarts_from_the_initial_state(
        tmp_path):
    """A restart with no checkpoint yet begins again from `init_state`, which
    the steps before the failure left untouched: the run ends with the bits
    of a run that never failed."""
    tc = TrainConfig(peak_lr=1e-3, warmup=2, total_steps=10, microbatches=2,
                     compression="int8", compute_dtype="float32")
    state = _tiny_state(tc)
    before = [x.clone() for x in tree_leaves(state)]
    src = _source(seed=0, global_batch=4, seq_len=16)

    def run(ckpt_dir, fail_at):
        lc = LoopConfig(ckpt_dir=str(ckpt_dir), ckpt_every=100, max_steps=6)
        loop = FaultTolerantLoop(lc, make_train_step(TINY, tc), src, state,
                                 failure_injector=make_failure_injector(fail_at))
        return loop, loop.run()

    loop, failed = run(tmp_path / "a", [4])
    assert loop.restarts == 1
    assert [m["step"] for m in loop.metrics_log] == [0, 1, 2, 3, 0, 1, 2, 3, 4, 5]
    for a, b in zip(before, tree_leaves(state)):
        assert torch.equal(a, b)
    _, clean = run(tmp_path / "b", [])
    for a, b in zip(tree_leaves(failed), tree_leaves(clean)):
        assert torch.equal(a, b)


def test_loop_matches_the_reference_loop_on_a_carried_state(tmp_path):
    """The port's loop and the reference's, both with failures at 3 and 7
    and a synchronous checkpoint every 2 steps, from one carried state on
    one FileSource stream: the same restarts, steps and final data_step,
    and losses within 1e-5 (fp32 compute; measured 2e-7)."""
    path = tmp_path / "tokens.npy"
    np.save(path, np.random.default_rng(2).integers(0, TINY.vocab, 4_000)
            .astype(np.int32))
    kw = dict(peak_lr=1e-3, warmup=2, total_steps=10, compute_dtype="float32")
    sj, _ = j_init_train_state(jax.random.PRNGKey(0), TINY, JTrainConfig(**kw))
    st = interop.train_state_from_numpy(jax.tree.map(np.asarray, sj),
                                        device="cpu")
    dc = dict(seed=0, global_batch=4, seq_len=16)
    lcj = JLoopConfig(ckpt_dir=str(tmp_path / "j"), ckpt_every=2, max_steps=10)
    jl = JLoop(lcj, jax.jit(j_make_train_step(TINY, JTrainConfig(**kw))),
               JFileSource(TINY, JDataConfig(**dc), str(path)), sj,
               failure_injector=make_failure_injector([3, 7]))
    lct = LoopConfig(ckpt_dir=str(tmp_path / "t"), ckpt_every=2, max_steps=10)
    tl = FaultTolerantLoop(lct, make_train_step(TINY, TrainConfig(**kw)),
                           FileSource(TINY, DataConfig(**dc), str(path),
                                      device="cpu"), st,
                           failure_injector=make_failure_injector([3, 7]))
    fj, ft = jl.run(), tl.run()
    assert tl.restarts == jl.restarts == 2
    assert int(ft["data_step"]) == int(fj["data_step"]) == 10
    # which step a restart resumes from depends on when the async save
    # landed, in either loop; the last step's loss does not
    assert tl.metrics_log[-1]["step"] == jl.metrics_log[-1]["step"] == 9
    assert tl.metrics_log[-1]["loss"] == pytest.approx(
        jl.metrics_log[-1]["loss"], rel=1e-5)


# ------------------------------------------------------- configs.shapes

def test_shapes_match_the_reference():
    from repro.configs import shapes as j_shapes
    from repro.configs import llama3_2_1b as j_llama
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in j_shapes.SHAPES.items()}
    cfg = LM_CONFIGS["llama3.2-1b"]
    for name, shape in SHAPES.items():
        assert cell_applicable(cfg, shape) == j_shapes.cell_applicable(
            j_llama.CONFIG, j_shapes.SHAPES[name])
    assert cell_applicable(cfg, SHAPES["long_500k"])[0] is False
    assert cell_applicable(cfg.scaled(swa_window=4096), SHAPES["long_500k"])[0]


# -------------------------------------------------------- entry points

def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)


def test_launch_train_runs_on_the_cpu(tmp_path):
    out = _run(["repro_torch.launch.train", "--arch", "llama3.2-1b",
                "--preset", "smoke", "--steps", "4", "--device", "cpu",
                "--ckpt-dir", str(tmp_path / "run")], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "[train] arch=llama3.2-1b preset=smoke" in out.stdout
    assert "steps=4" in out.stdout
    log = json.loads((tmp_path / "run" / "metrics.json").read_text())
    assert [m["step"] for m in log] == [0, 1, 2, 3]
    assert ckpt.latest_step(str(tmp_path / "run")) == 4


def test_train_lm_runs_on_the_cpu(tmp_path):
    out = _run(["repro_torch.train_lm", "--steps", "4", "--device", "cpu"],
               tmp_path)
    assert out.returncode == 0, out.stderr
    assert "over 4 steps" in out.stdout and out.stdout.startswith("model: ")


def test_train_lm_sizes_match_the_example():
    from repro_torch.train_lm import SIZES, size_config
    spec = importlib.util.spec_from_file_location(
        "train_lm_example", ROOT / "examples" / "train_lm.py")
    text = (ROOT / "examples" / "train_lm.py").read_text()
    for name, dims in SIZES.items():
        assert f'"{name}": dict(' in text
        for k, v in dims.items():
            assert f"{k}={v}" in text.split(f'"{name}": dict(')[1].split(")")[0]
    cfg = size_config("100m")
    assert cfg.remat is False and cfg.rope_theta == 5e5 and cfg.family == "dense"
    assert spec is not None


# ------------------------------------- chip_smoke.py's phase 17 reckonings

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_train_param_count_is_the_models():
    """The reckoning's parameter count equals init_lm's at SMOKE, and
    llama3.2-1b's is 1,235,814,400 (262.7 M in the tied embedding, 60.8 M a
    layer)."""
    state, _ = init_train_state(torch.Generator(), llama.SMOKE,
                                TrainConfig(), device="cpu")
    assert costmodel.train_param_count(llama.SMOKE) == sum(
        x.numel() for x in tree_leaves(state["params"]))
    cfg = LM_CONFIGS["llama3.2-1b"]
    assert costmodel.train_param_count(cfg) == 1_235_814_400
    assert cfg.vocab * cfg.d_model == 262_668_288


def test_chip_smoke_train_peak_reckoning_at_full_width():
    """llama3.2-1b at 2 x 4,096 a microbatch: the state (params, m, v: 12 N)
    and a step's fp32 gradient sum, bf16 copy and bf16 gradients (8 N), plus
    the larger of one layer's (B, H, S, S) scores and the head's (B, S, V)
    logits, 20 bytes an element in the backward (the card's softmax
    backward holds two fp32 temporaries beside its output, the saved
    output and the incoming gradient), the carries and the recomputed
    layer's four (B, S, d) fp32 copies; against the update's 32 N (old and
    new params, m, v, the sum and its clipped copy) and five largest-leaf
    temporaries.  The backward decides: 43.77 GiB (measured on an H100:
    43.95 GiB at the backward, 40.89 GiB at the update; the reckoning said
    41.83 until the softmax backward's two temporaries were found), under
    70, so 4 microbatches of 2 stay."""
    cs = _chip_smoke()
    cfg = LM_CONFIGS["llama3.2-1b"]
    n = costmodel.train_param_count(cfg)
    seq = SHAPES["train_4k"].seq_len
    e = 2 * cfg.n_heads * seq * seq
    backward = (20 * n + 20 * e + cfg.n_cycles * 2 * seq * cfg.d_model * 2
                + 4 * 2 * seq * cfg.d_model * 4)
    leaf = max(cfg.vocab * cfg.d_model, cfg.n_layers * cfg.d_model * cfg.d_ff)
    update = 32 * n + 5 * 4 * leaf
    assert costmodel.train_peak_bytes(cfg, 2, seq) == max(backward, update) \
        == backward
    assert costmodel.train_peak_bytes(cfg, 2, seq) / 2**30 == pytest.approx(
        43.77, abs=0.01)
    assert cs.train_microbatches(cfg, 8, 4, seq, 70.0) == 4


def test_chip_smoke_train_peak_reckoning_at_a_cut_config():
    """The --quick size (train_lm's 20m) at 2 x 4,096: one layer's scores
    (8 heads) decide; a limit below that halves the microbatch and doubles
    the count, down to one sequence, and refuses below that."""
    cs = _chip_smoke()
    from repro_torch.train_lm import size_config
    cfg = size_config("20m")
    seq = 4_096
    n = costmodel.train_param_count(cfg)
    e = 2 * cfg.n_heads * seq * seq
    peak = costmodel.train_peak_bytes(cfg, 2, seq)
    assert peak == (20 * n + 20 * e + cfg.n_cycles * 2 * seq * cfg.d_model * 2
                    + 4 * 2 * seq * cfg.d_model * 4)
    assert costmodel.train_peak_bytes(cfg, 1, seq) < peak
    limit = (costmodel.train_peak_bytes(cfg, 1, seq) + peak) / 2 / 2**30
    assert cs.train_microbatches(cfg, 8, 4, seq, 70.0) == 4
    assert cs.train_microbatches(cfg, 8, 4, seq, limit) == 8
    with pytest.raises(RuntimeError):
        cs.train_microbatches(cfg, 8, 4, seq, 1.0)


def test_chip_smoke_train_flops_reckoning():
    """A step's model flops: 6 N T, the attention's products over the full
    S x S (forward 4 S^2 H d_head a sequence and layer, backward twice
    that), and remat's recompute (one more forward of the layers and their
    attention); llama3.2-1b at 8 x 4,096: 3.77e14."""
    cs = _chip_smoke()
    cfg = LM_CONFIGS["llama3.2-1b"]
    n = costmodel.train_param_count(cfg)
    seq, batch = 4_096, 8
    t = seq * batch
    attn_fwd = 4 * seq * seq * cfg.n_heads * cfg.d_head * cfg.n_layers * batch
    layers = n - cfg.vocab * cfg.d_model - cfg.d_model
    parts = costmodel.train_step_flops(cfg, batch, seq, remat=True)
    assert parts == {"dense": 6 * n * t, "attention": 3 * attn_fwd,
                     "remat": 2 * layers * t + attn_fwd}
    assert sum(parts.values()) == pytest.approx(3.77e14, rel=5e-3)
    assert costmodel.train_step_flops(cfg, batch, seq, remat=False)["remat"] == 0
