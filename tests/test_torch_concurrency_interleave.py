"""The port's interleaving model checker
(repro_torch.analysis.concurrency.interleave), the counterparts of
tests/test_concurrency_interleave.py, on the CPU.

Pins determinism-from-config, the safety invariants (use-before-publish,
write-once, deadlock) on injected mutants, bitwise equality of every
explored interleaving with the in-order replay, the `SchedConfig.seed`
tie-break plumbing the explorer shares with the executor, and that the
stepper drives the executor's own fetch / run / publish without touching
the kernel set's store.  Parity: `run_matrix` gives the reference's rows
(runs and distinct interleavings of each (cell, workers)) exactly, and the
same step signatures run for run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.concurrency.interleave import (
    FAST_CELLS,
    InterleaveViolation,
    SCHEDULES,
    bitwise_equal,
    explore,
    replay_inorder,
    run_matrix,
    values_bitwise_equal,
)
from repro_torch.analysis.dag import successor_map
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.sched.config import SchedConfig
from repro_torch.sched.kernels import make_kernels
from repro_torch.sched.runtime import build_graph, priority_keys
from repro_torch.verify.generators import spd_matrix

torch.set_num_threads(1)

P, NB = 3, 4
POLICY = PrecisionPolicy.tpu(1)


@pytest.fixture(scope="module")
def cell():
    graph = build_graph("tile", P, POLICY)
    a = spd_matrix(3, P * NB, cond=50.0, device="cpu")
    kernels = make_kernels("tile", a, NB, POLICY)
    return graph, kernels


def cfg(**kw):
    kw.setdefault("workers", 3)
    kw.setdefault("backend", "sim")
    return SchedConfig(**kw)


# ---- determinism ----------------------------------------------------------

def test_same_config_same_interleaving(cell):
    graph, kernels = cell
    a = explore(graph, kernels, cfg(seed=5), schedule="random", salt=2)
    b = explore(graph, kernels, cfg(seed=5), schedule="random", salt=2)
    assert a.signature == b.signature
    assert a.dispatch == b.dispatch


def test_salts_diversify_interleavings(cell):
    graph, kernels = cell
    sigs = {explore(graph, kernels, cfg(seed=1), schedule="random",
                    salt=s).signature for s in range(8)}
    assert len(sigs) >= 2


def test_unknown_schedule_rejected(cell):
    graph, kernels = cell
    with pytest.raises(ValueError, match="unknown schedule"):
        explore(graph, kernels, cfg(), schedule="chaos")


# ---- every schedule reproduces sequential replay bitwise ------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_bitwise_equal_to_replay(cell, schedule):
    graph, kernels = cell
    reference = replay_inorder(graph, kernels)
    res = explore(graph, kernels, cfg(seed=3), schedule=schedule)
    assert res.n_steps == 3 * graph.n          # pop+compute+publish per task
    assert sorted(res.dispatch) == list(range(graph.n))
    assert values_bitwise_equal(res.values, reference) == []


def test_bitwise_equal_is_strict():
    assert bitwise_equal(np.float32(1.0), np.float32(1.0))
    assert not bitwise_equal(np.float32(1.0), np.float64(1.0))   # dtype
    assert not bitwise_equal(np.zeros(2), np.zeros((2, 1)))      # shape
    assert not bitwise_equal(np.float32(0.0), np.float32(-0.0))  # bits
    x = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    assert bitwise_equal(x, x.clone())
    assert not bitwise_equal(x, x.float())                       # dtype
    nan = torch.tensor(float("nan"))
    assert bitwise_equal(nan, nan.clone())                       # same bits


# ---- mutants trip the safety invariants -----------------------------------

def _with_deps(graph, deps):
    succs = tuple(tuple(s) for s in successor_map([list(r) for r in deps]))
    return dataclasses.replace(
        graph, deps=tuple(tuple(r) for r in deps), succs=succs)


def test_dropped_edge_caught_as_use_before_publish(cell):
    """A scheduler missing one dependency edge releases a consumer early;
    the stepper's operand fetch must catch it on some explored schedule."""
    graph, kernels = cell
    caught = 0
    for task in range(graph.n):
        producers = sorted({d for d in graph.deps[task] if d >= 0})
        if not producers:
            continue
        deps = [list(r) for r in graph.deps]
        deps[task] = [d for d in deps[task] if d != producers[-1]]
        mutant = _with_deps(graph, deps)
        try:
            for schedule in SCHEDULES:
                for salt in range(4):
                    explore(mutant, kernels, cfg(seed=1),
                            schedule=schedule, salt=salt)
        except InterleaveViolation as e:
            assert ("use-before-publish" in str(e)
                    or "arity mismatch" in str(e))
            caught += 1
    assert caught > 0, "no dropped-edge mutant tripped the stepper"


def test_cycle_caught_as_deadlock(cell):
    graph, kernels = cell
    deps = [list(r) for r in graph.deps]
    deps[0] = [graph.n - 1]          # first task waits on the last: cycle
    mutant = _with_deps(graph, deps)
    with pytest.raises(InterleaveViolation, match="deadlock"):
        explore(mutant, kernels, cfg(), schedule="random")


def test_duplicate_ready_insertion_caught_as_write_once(cell):
    """A queue that enqueues a task twice publishes twice: write-once."""
    graph, kernels = cell
    deps = [list(r) for r in graph.deps]
    succs = [list(s) for s in successor_map(deps)]
    # a duplicate succ entry drives ndeps below zero on publish
    target = next(i for i in range(graph.n)
                  if any(d >= 0 for d in graph.deps[i]))
    producer = next(d for d in graph.deps[target] if d >= 0)
    succs[producer].append(target)
    mutant = dataclasses.replace(
        graph, succs=tuple(tuple(s) for s in succs))
    with pytest.raises(InterleaveViolation,
                       match="write-once|negative"):
        for salt in range(8):
            explore(mutant, kernels, cfg(seed=1), schedule="random",
                    salt=salt)


# ---- seed plumbing --------------------------------------------------------

def test_seed_zero_keeps_historical_tie_order():
    graph = build_graph("tile", 4, POLICY)
    k0 = priority_keys(graph, cfg(priority="critical_path", seed=0))
    k0b = priority_keys(graph, cfg(priority="critical_path"))
    assert k0 == k0b


def test_seed_permutes_ties_deterministically():
    graph = build_graph("tile", 4, POLICY)
    k7 = priority_keys(graph, cfg(priority="critical_path", seed=7))
    k7b = priority_keys(graph, cfg(priority="critical_path", seed=7))
    k9 = priority_keys(graph, cfg(priority="critical_path", seed=9))
    assert k7 == k7b
    assert k7 != k9 or k7 != priority_keys(
        graph, cfg(priority="critical_path", seed=0))
    # the task index stays the last key element (the pop contract)
    assert all(k[-1] == i for i, k in enumerate(k7))


def test_seed_validation():
    with pytest.raises(ValueError, match="seed"):
        SchedConfig(seed=-1)
    with pytest.raises(ValueError, match="seed"):
        SchedConfig(seed=1.5)
    with pytest.raises(ValueError, match="seed"):
        SchedConfig(seed=True)


def test_seeded_executor_matches_seed0_bitwise(cell):
    """Tie-break permutation changes the schedule, never the bits."""
    graph, kernels = cell
    base = explore(graph, kernels, cfg(seed=0), schedule="random")
    other = explore(graph, kernels, cfg(seed=23), schedule="random")
    assert values_bitwise_equal(other.values, base.values) == []


# ---- the executor's own code ----------------------------------------------

def test_runs_leave_the_kernel_store_whole(cell):
    """The executor releases each initial tile after its last read; the
    stepper's runs release from a copy, so one kernel set serves them all,
    and the final values are the replay's whichever run comes first."""
    graph, kernels = cell
    before = dict(kernels.initial_store())
    for schedule in SCHEDULES:
        explore(graph, kernels, cfg(seed=2), schedule=schedule)
    after = kernels.initial_store()
    assert set(after) == set(before)
    assert all(after[t] is before[t] for t in before)


def test_explore_drives_the_executors_fetch_and_publish(monkeypatch, cell):
    """A publish that forgets to decrement a successor (a broken
    `_publish_locked`) deadlocks the stepper: it runs the executor's code,
    not a copy."""
    from repro_torch.analysis.concurrency import interleave
    from repro_torch.sched import runtime

    graph, kernels = cell
    real = runtime._publish_locked

    def forgetful(state, w, stream, idx, out, start, end):
        if idx == 0:
            state.ndeps[graph.succs[0][0]] += 1
        return real(state, w, stream, idx, out, start, end)

    monkeypatch.setattr(interleave, "_publish_locked", forgetful)
    with pytest.raises(InterleaveViolation, match="deadlock"):
        explore(graph, kernels, cfg(), schedule="random")


# ---- the matrix gate ------------------------------------------------------

def test_fast_matrix_cell_clean():
    rep = run_matrix(cells=(("tile", "mixed", 3),), seeds=4, workers=(2,),
                     device="cpu")
    assert rep.ok, rep.render()
    assert rep.n_runs > 0 and rep.n_distinct > 1
    (eng,) = rep.engine_rel
    assert eng["max_rel"] <= eng["bound"]


def test_run_matrix_takes_its_device():
    with pytest.raises(TypeError):
        run_matrix(cells=(("tile", "mixed", 3),), seeds=1)


@pytest.mark.concurrency
def test_full_fast_matrix_reaches_distinct_floor():
    from repro_torch.analysis.cli import INTERLEAVE_DISTINCT_MIN

    rep = run_matrix(cells=FAST_CELLS, device="cpu")
    assert rep.ok, rep.render()
    assert rep.n_distinct >= INTERLEAVE_DISTINCT_MIN


@pytest.mark.concurrency
def test_full_matrix_more_workers_and_priorities():
    for priority in ("fifo", "panel_first"):
        rep = run_matrix(cells=(("tile", "mixed", 4),
                                ("tile", "three_tier", 4)),
                         seeds=6, workers=(2, 4), priority=priority,
                         device="cpu")
        assert rep.ok, rep.render()


# ---- parity with the reference --------------------------------------------

def test_run_matrix_rows_equal_the_reference():
    """Both build the same task graph and seed the same stepper: the same
    runs and distinct interleavings for every (cell, workers)."""
    from repro.analysis.concurrency.interleave import run_matrix as ref_run

    ours = run_matrix(device="cpu")
    ref = ref_run()
    assert ours.ok and ref.ok
    assert ours.rows == ref.rows
    assert (ours.n_runs, ours.n_distinct) == (ref.n_runs, ref.n_distinct)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_step_signatures_equal_the_reference(schedule):
    """Run for run, the same (worker, phase, task) steps as the
    reference's stepper on the same graph and config."""
    from repro.analysis.concurrency.interleave import explore as ref_explore
    from repro.core.precision import PrecisionPolicy as JP
    from repro.sched.config import SchedConfig as JConfig
    from repro.sched.kernels import make_kernels as ref_kernels
    from repro.sched.runtime import build_graph as ref_graph
    from repro.verify.generators import spd_matrix as ref_spd

    for variant, p in (("tile", 4), ("panel", 4), ("dst", 4)):
        graph = build_graph(variant, p, PrecisionPolicy.tpu(2))
        kernels = make_kernels(variant, spd_matrix(1, p * NB, cond=50.0,
                                                   device="cpu"),
                               NB, PrecisionPolicy.tpu(2))
        jgraph = ref_graph(variant, p, JP.tpu(2))
        jkernels = ref_kernels(variant, ref_spd(1, p * NB, cond=50.0), NB,
                               JP.tpu(2))
        for salt in range(3):
            kw = dict(priority="critical_path", workers=3, backend="sim",
                      seed=1 + salt)
            ours = explore(graph, kernels, SchedConfig(**kw),
                           schedule=schedule, salt=salt)
            ref = ref_explore(jgraph, jkernels, JConfig(**kw),
                              schedule=schedule, salt=salt)
            assert ours.signature == ref.signature, (variant, salt)
