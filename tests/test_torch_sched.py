"""The port's task runtime (repro_torch.sched) on the CPU.

  * the simulator against repro.sched.simulate: the same makespan,
    dispatch order, events and worker loads, field for field, for every
    priority, W in {1, 3, 4} and a nonzero tie-break seed;
  * the reference's own properties (tests/test_sched.py): the makespan
    bounds, Graham's bound, critical_path no worse than fifo on a chain,
    every dispatch order replayed hazard-free through check_dag, and
    SchedConfig rejecting what the reference rejects;
  * the real executor: bitwise equal across {fifo W=1, critical_path W=4,
    panel_first W=3 seed 7} for the three variants; held to the port's
    sequential engines and to repro.sched.scheduled_cholesky on the same
    numpy input; `a` unmodified; values released once read; a kernel's
    exception raised in the caller; calibrated=True without a table
    raising;
  * the tile_cholesky(schedule=...) hook, its traces and its CLI.
"""

import dataclasses
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.costmodel as jcost
import repro.sched as jsched
from repro.core import tile_cholesky as j_tile
from repro.core.precision import PrecisionPolicy as JP
from repro.sched.trace import validate_trace as j_validate_trace
from repro_torch.analysis.dag import (Task, check_dag, storage_tier,
                                      successor_map)
from repro_torch.core import (PrecisionPolicy as TP, dst_cholesky,
                              panel_cholesky_banded, tile_cholesky)
from repro_torch.launch import costmodel as tcost
from repro_torch.sched import (SchedConfig, TaskGraph, TileKernels,
                               build_graph, chrome_trace, downstream_cost,
                               execute, load_and_validate, make_kernels,
                               priority_keys, scheduled_cholesky,
                               scheduled_tile_cholesky, simulate, simulate_dag,
                               tier_dtype, validate_trace)
from repro_torch.verify.generators import spd_matrix

torch.set_num_threads(1)

# label -> (reference policy, port policy, the matrix's dtype)
POLICIES = {
    "full": (JP.full(), TP.full(), torch.float32),
    "tpu2": (JP.tpu(2), TP.tpu(2), torch.float32),
    "three_tier13": (JP.three_tier(1, 3), TP.three_tier(1, 3), torch.float32),
    "paper_cpu2": (JP.paper_cpu(2), TP.paper_cpu(2), torch.float64),
}
VARIANTS = ("tile", "panel", "dst")
PRIORITIES = ("fifo", "panel_first", "critical_path")
# the three schedules every real run is compared across
SCHEDULES = (SchedConfig(priority="fifo", workers=1),
             SchedConfig(priority="critical_path", workers=4),
             SchedConfig(priority="panel_first", workers=3, seed=7))


def _matrix(label, p, nb, seed=0):
    return spd_matrix(seed + p, p * nb, cond=100.0, device="cpu").to(
        POLICIES[label][2])


def _same_bits(x, y):
    return x.dtype == y.dtype and x.shape == y.shape and bool(
        ((x == y) | (x.isnan() & y.isnan())).all())


def _rel(x, ref):
    x, ref = x.double(), ref.double()
    return float((x - ref).norm() / ref.norm())


# ---------------------------------------------------------------------------
# the simulator against the reference's, field for field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", (1, 3, 4))
@pytest.mark.parametrize("priority", PRIORITIES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_simulate_equals_reference(variant, priority, workers):
    for label, (jp, tp, _) in POLICIES.items():
        for seed in (0, 5):
            kw = dict(priority=priority, workers=workers, backend="sim",
                      seed=seed)
            jr = jsched.simulate(jsched.build_graph(variant, 8, jp),
                                 jsched.SchedConfig(**kw))
            tr = simulate(build_graph(variant, 8, tp), SchedConfig(**kw))
            ctx = (label, seed)
            assert tr.makespan == jr.makespan, ctx
            assert tr.dispatch_order == jr.dispatch_order, ctx
            assert [dataclasses.astuple(e) for e in tr.events] == \
                [dataclasses.astuple(e) for e in jr.events], ctx
            assert tr.worker_busy == jr.worker_busy, ctx
            assert (tr.utilization, tr.overlap_fraction, tr.p, tr.policy) == \
                (jr.utilization, jr.overlap_fraction, jr.p, jr.policy), ctx


def test_priority_keys_and_downstream_cost_equal_reference():
    for label, (jp, tp, _) in POLICIES.items():
        for seed in (0, 3):
            for priority in PRIORITIES:
                kw = dict(priority=priority, seed=seed, backend="sim")
                jg, tg = jsched.build_graph("tile", 6, jp), \
                    build_graph("tile", 6, tp)
                assert tg.deps == jg.deps and tg.succs == jg.succs
                assert priority_keys(tg, SchedConfig(**kw)) == \
                    jsched.priority_keys(jg, jsched.SchedConfig(**kw)), label
            cfg = SchedConfig(backend="sim")
            assert downstream_cost(tg, cfg) == jsched.downstream_cost(
                jg, jsched.SchedConfig(backend="sim"))


def test_calibrated_table_simulates_as_reference():
    """An injected table prices the simulator as the reference's."""
    table = {"POTRF/hi": 7.0, "TRSM/hi": 11.0, "TRSM/lo": 5.0,
             "SYRK/hi": 13.0, "GEMM/hi": 21.0, "GEMM/lo": 4.0,
             "CONVERT": 1.0}
    kw = dict(priority="critical_path", workers=3, backend="sim",
              calibrated=True)
    try:
        tcost.set_calibration(table)
        jcost.set_calibration(table)
        tr = simulate(build_graph("tile", 6, TP.tpu(2)), SchedConfig(**kw))
        jr = jsched.simulate(jsched.build_graph("tile", 6, JP.tpu(2)),
                             jsched.SchedConfig(**kw))
    finally:
        tcost.set_calibration(None)
        jcost.set_calibration(None)
    assert (tr.makespan, tr.dispatch_order) == (jr.makespan, jr.dispatch_order)


# ---------------------------------------------------------------------------
# the reference's properties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    {"priority": "lifo"},
    {"backend": "gpu"},
    {"workers": 0},
    {"workers": 2.5},
    {"convert_cost": -1.0},
    {"convert_cost": float("nan")},
    {"seed": -1},
    {"seed": True},
    {"calibrated": "yes"},
])
def test_sched_config_rejects(kwargs):
    with pytest.raises(ValueError):
        SchedConfig(**kwargs)
    with pytest.raises(ValueError):
        jsched.SchedConfig(**kwargs)


@pytest.mark.parametrize("workers", (1, 3, 4))
@pytest.mark.parametrize("priority", PRIORITIES)
def test_sim_makespan_bounds(priority, workers):
    graph = build_graph("tile", 8, TP.tpu(2))
    cfg = SchedConfig(priority=priority, workers=workers, backend="sim")
    rep = simulate(graph, cfg)
    serial = sum(tcost.task_virtual_cost(t, convert_cost=cfg.convert_cost)
                 for t in graph.tasks)
    cp = max(downstream_cost(graph, cfg))
    assert rep.makespan >= max(serial / workers, cp) - 1e-9
    assert rep.makespan <= serial + 1e-9
    if workers == 1:
        assert rep.makespan == pytest.approx(serial)
        assert rep.overlap_fraction == 0.0
    assert 0.0 < rep.utilization <= 1.0 + 1e-12


@pytest.mark.parametrize("p", (4, 8))
@pytest.mark.parametrize("workers", (2, 4))
def test_graham_bound_every_priority(p, workers):
    for _, tp, _ in POLICIES.values():
        graph = build_graph("tile", p, tp)
        for priority in PRIORITIES:
            cfg = SchedConfig(priority=priority, workers=workers,
                              backend="sim")
            rep = simulate(graph, cfg)
            serial = sum(tcost.task_virtual_cost(t) for t in graph.tasks)
            cp = max(downstream_cost(graph, cfg))
            assert rep.makespan <= serial / workers + \
                (1.0 - 1.0 / workers) * cp + 1e-9, (tp.mode, priority)


def _chain_graph(p):
    """POTRF -> TRSM -> SYRK per step: the 3p-2-task chain."""
    tasks, deps = [], []
    for k in range(p):
        tasks.append(Task("POTRF", k, (k, k), reads=((k, k),)))
        deps.append((len(tasks) - 2,))
        if k < p - 1:
            tasks.append(Task("TRSM", k, (k + 1, k),
                              reads=((k, k), (k + 1, k))))
            deps.append((len(tasks) - 2,))
            tasks.append(Task("SYRK", k, (k + 1, k + 1),
                              reads=((k + 1, k), (k + 1, k + 1))))
            deps.append((len(tasks) - 2,))
    return TaskGraph(variant="tile", p=p, policy=TP.full(),
                     tasks=tuple(tasks), deps=tuple(tuple(d) for d in deps),
                     succs=tuple(tuple(s) for s in successor_map(deps)))


@pytest.mark.parametrize("workers", (1, 2, 4))
def test_critical_path_not_worse_than_fifo_on_chain(workers):
    graph = _chain_graph(8)
    assert graph.n == 3 * 8 - 2
    mk = {pr: simulate(graph, SchedConfig(priority=pr, workers=workers,
                                          backend="sim")).makespan
          for pr in ("fifo", "critical_path")}
    assert mk["critical_path"] <= mk["fifo"]
    assert mk["critical_path"] == pytest.approx(mk["fifo"])


@pytest.mark.parametrize("priority", PRIORITIES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_dispatch_order_replays_hazard_free(variant, priority):
    for label, (_, tp, _) in POLICIES.items():
        graph = build_graph(variant, 8, tp)
        rep = simulate(graph, SchedConfig(priority=priority, workers=4,
                                          backend="sim", seed=3))
        assert sorted(rep.dispatch_order) == list(range(graph.n))
        check_dag([graph.tasks[i] for i in rep.dispatch_order], 8, tp,
                  variant, label=f"{label}/sched:{priority}")


@pytest.mark.parametrize("label", ("full", "tpu2", "three_tier13"))
def test_sim_speedup_at_p8_w4(label):
    graph = build_graph("tile", 8, POLICIES[label][1])
    r1 = simulate(graph, SchedConfig(workers=1, backend="sim"))
    r4 = simulate(graph, SchedConfig(workers=4, backend="sim"))
    assert r1.makespan / r4.makespan >= 1.5
    assert r4.overlap_fraction > 0.5


# ---------------------------------------------------------------------------
# the real executor on the CPU
# ---------------------------------------------------------------------------

def _banded(a, nb, pol):
    """The panel engine's (band, off) storage of a dense SPD matrix."""
    p = a.shape[-1] // nb
    t = min(pol.diag_thick, p)
    lo = pol.lo if pol.mode != "full" else pol.hi
    band = torch.zeros((p, t, nb, nb), dtype=pol.hi)
    off = torch.zeros((p, p, nb, nb), dtype=lo)
    for i in range(p):
        for j in range(i + 1):
            x = a[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
            if i - j < t:
                band[i, i - j] = x.to(pol.hi)
            else:
                off[i, j] = x.to(lo)
    return band, off, t


def _sequential_store(variant, a, nb, pol):
    """The port's sequential engine's factor, as the runtime's tile store."""
    p = a.shape[-1] // nb
    if variant == "tile":
        l = tile_cholesky(a, nb, pol)
        return {(i, j): l[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
                for i in range(p) for j in range(i + 1)}
    if variant == "panel":
        band, off, t = _banded(a, nb, pol)
        band, off, _ = panel_cholesky_banded(band, off, pol)
        return {(i, j): band[i, i - j] if i - j < t else off[i, j]
                for i in range(p) for j in range(i + 1)}
    out = {}
    for sl, l in dst_cholesky(a, nb, pol.diag_thick, hi=pol.hi):
        i0, w = sl.start // nb, (sl.stop - sl.start) // nb
        for i in range(w):
            for j in range(i + 1):
                out[(i0 + i, i0 + j)] = l[i * nb:(i + 1) * nb,
                                          j * nb:(j + 1) * nb]
    return out


def _dense(store, p, nb, dtype):
    out = torch.zeros((p * nb, p * nb), dtype=torch.float64)
    for (i, j), v in store.items():
        out[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = v.double()
    return out


@pytest.mark.parametrize("nb", (16, 32))
@pytest.mark.parametrize("p", (1, 4, 8))
@pytest.mark.parametrize("label", sorted(POLICIES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_executor_bitwise_across_schedules(variant, label, p, nb):
    """Every schedule gives the same bits, the W=4 report verifies and its
    dispatch order replays hazard-free; against the port's sequential
    engine: the tile and panel engines are equal bit for bit on the CPU
    (the batched column solve and the per-step SYRK's plain version round
    as the per-tile ops do here), and DST's dense super-block Cholesky is
    held to 1e-5 relative (fp32 hi; measured <= 1e-6) and 1e-13 (fp64 hi;
    measured <= 1e-15) in the Frobenius norm: the tile-level right-looking
    steps block it differently."""
    from repro_torch.analysis.concurrency import verify_sched_report
    pol = POLICIES[label][1]
    if variant == "dst" and label == "full":
        pol = TP.dst(2)     # full's band is one super-block: use a real DST
    a = _matrix(label, p, nb)
    a0 = a.clone()
    stores = []
    for cfg in SCHEDULES:
        store, rep = scheduled_cholesky(a, nb, pol, cfg, variant=variant)
        stores.append(store)
        assert torch.equal(a, a0)
        check_dag([build_graph(variant, p, pol).tasks[i]
                   for i in rep.dispatch_order], p, pol, variant)
        if cfg.workers == 4:
            hb = verify_sched_report(rep)
            assert hb.ok, hb.render()
    for store in stores[1:]:
        assert set(store) == set(stores[0])
        for tile in store:
            assert _same_bits(store[tile], stores[0][tile]), tile
    seq = _sequential_store(variant, a, nb, pol)
    assert set(seq) == set(stores[0])
    if variant != "dst":   # the tile engine's factor is assembled in hi
        for tile, v in seq.items():
            assert _same_bits(stores[0][tile].to(v.dtype), v), tile
    else:
        tol = 1e-13 if pol.hi == torch.float64 else 1e-5
        assert _rel(_dense(stores[0], p, nb, pol.hi),
                    _dense(seq, p, nb, pol.hi)) <= tol


@pytest.fixture
def jax_x64():
    """x64 for the reference's worker threads: jax.enable_x64() is a
    context of the calling thread only, so it is set process-wide here."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("label", sorted(POLICIES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_executor_vs_reference_scheduled(variant, label, request):
    """The port's scheduled factor against repro.sched.scheduled_cholesky
    on the same numpy matrix (x64 for the paper pair): the same ops in
    two libraries, so held to what they measured, not to the registry's
    bounds against the fp64 oracle.  Measured at this size: <= 1.8e-7
    for every case (the limit 1e-6) but the tile variant under
    three_tier, 1.3e-5 (the limit 1e-4), where a few fp8 far tiles round
    to neighbouring fp8 values (torch's and XLA's fp32 sums differ by
    ulps before the rounding).  A lo product run in fp32 without its
    rounding would sit ~1e-3 away."""
    if label == "paper_cpu2":
        request.getfixturevalue("jax_x64")
    jp, tp, _ = POLICIES[label]
    p, nb = 6, 16
    a = _matrix(label, p, nb, seed=40)
    cfg = dict(priority="critical_path", workers=3)
    mine, _ = scheduled_cholesky(a, nb, tp, SchedConfig(**cfg),
                                 variant=variant)
    ref, _ = jsched.scheduled_cholesky(jnp.asarray(a.numpy()), nb, jp,
                                       jsched.SchedConfig(**cfg),
                                       variant=variant)
    ref = {k: torch.from_numpy(np.asarray(v).astype(np.float64))
           for k, v in ref.items()}
    assert set(mine) == set(ref)
    for k, v in mine.items():
        assert v.dtype == tier_dtype(tp, storage_tier(tp, *k,
                                                      variant=variant)), k
    limit = 1e-4 if (variant, label) == ("tile", "three_tier13") else 1e-6
    assert _rel(_dense(mine, p, nb, tp.hi), _dense(ref, p, nb, tp.hi)) <= limit


def test_scheduled_tile_cholesky_vs_reference_engine_pair(jax_x64):
    """The pair's assembled factor against the reference's sequential
    tile_cholesky under x64 (which its scheduled path equals bit for bit),
    within 1e-6 (measured 1.1e-7: the fp32 off-band tiles round apart by
    fp32 ulps; the registry's factor bound for the pair is 1e-5)."""
    p, nb = 5, 16
    a = _matrix("paper_cpu2", p, nb, seed=3)
    l, _ = scheduled_tile_cholesky(a, nb, TP.paper_cpu(2),
                                   SchedConfig(workers=4))
    ref = torch.from_numpy(np.array(j_tile(jnp.asarray(a.numpy()), nb,
                                             JP.paper_cpu(2))))
    assert l.dtype == torch.float64 and _rel(l, ref) <= 1e-6


def test_values_released_once_read():
    """Only each tile's last writer outlives the run, and every initial
    tile is dropped once its last reader is dispatched."""
    alive = []

    class Tracked(TileKernels):
        def run(self, task, ops):
            out = super().run(task, ops)
            alive.append(weakref.ref(out))
            return out

    p, nb = 6, 16
    a = _matrix("tpu2", p, nb)
    kernels = Tracked(a, nb, TP.tpu(2))
    graph = build_graph("tile", p, TP.tpu(2))
    store, _ = execute(graph, SchedConfig(workers=3), kernels)
    assert len(alive) == graph.n and kernels.initial_store() == {}
    assert sum(r() is not None for r in alive) == len(store) == p * (p + 1) // 2


def test_stress_many_workers_short_switch_interval():
    """More worker threads than cores with a short interpreter switch
    interval: every task runs once, in an order that replays hazard-free,
    and the factor keeps its bits (a lost update of the ready queue or the
    counts would drop, repeat or misorder a task)."""
    import sys
    import threading
    p, nb, pol = 8, 8, TP.three_tier(1, 3)
    a = _matrix("three_tier13", p, nb)
    want, _ = scheduled_cholesky(a, nb, pol, SCHEDULES[0])
    out = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        th = threading.Thread(target=lambda: out.update(zip(
            ("store", "report"), scheduled_cholesky(
                a, nb, pol, SchedConfig(workers=16, seed=9)))))
        th.start()
        th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not th.is_alive() and "report" in out
    rep, graph = out["report"], build_graph("tile", p, pol)
    assert sorted(rep.dispatch_order) == list(range(graph.n))
    assert len({ev.worker for ev in rep.events}) > 1
    check_dag([graph.tasks[i] for i in rep.dispatch_order], p, pol, "tile")
    for tile, v in want.items():
        assert _same_bits(out["store"][tile], v), tile


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_union_ms():
    """chip_smoke's device busy time: the union of spans."""
    union_ms = _chip_smoke().union_ms
    assert union_ms([]) == 0.0
    assert union_ms([(0.0, 1000.0), (500.0, 1500.0), (3000.0, 4000.0),
                     (3100.0, 3200.0)]) == pytest.approx(2.5)


@pytest.mark.parametrize("spans, ms", (
    ([(2000.0, 2500.0), (0.0, 1000.0)], 1.5),                    # unsorted
    ([(0.0, 4000.0), (1000.0, 2000.0), (3000.0, 4000.0)], 4.0),  # nested
))
def test_union_ms_order_and_nesting(spans, ms):
    assert _chip_smoke().union_ms(spans) == pytest.approx(ms)


@pytest.mark.parametrize("backend", ("sim", "real"))
def test_cyclic_graph_raises_deadlock(backend):
    """Two tasks that wait on each other never become ready: both backends
    stop with an error once nothing else can run, instead of hanging."""
    graph = build_graph("tile", 3, TP.tpu(2))
    a_idx, b_idx = graph.n - 2, graph.n - 1
    deps = list(graph.deps)
    deps[a_idx] = deps[a_idx] + (b_idx,)
    deps[b_idx] = deps[b_idx] + (a_idx,)
    cyclic = dataclasses.replace(graph, deps=tuple(deps), succs=tuple(
        tuple(s) for s in successor_map([list(d) for d in deps])))
    with pytest.raises(RuntimeError, match="deadlock"):
        if backend == "sim":
            simulate(cyclic, SchedConfig(backend="sim", workers=2))
        else:
            execute(cyclic, SchedConfig(workers=3),
                    make_kernels("tile", _matrix("tpu2", 3, 16), 16,
                                 TP.tpu(2)))


def test_kernel_error_propagates():
    class Failing(TileKernels):
        def run(self, task, ops):
            if task.kind == "GEMM":
                raise FloatingPointError("injected")
            return super().run(task, ops)

    a = _matrix("tpu2", 6, 16)
    kernels = Failing(a, 16, TP.tpu(2))
    with pytest.raises(FloatingPointError, match="injected"):
        execute(build_graph("tile", 6, TP.tpu(2)), SchedConfig(workers=4),
                kernels)


def test_calibrated_without_table_raises(monkeypatch, tmp_path):
    """With no table (the committed one moved away) calibrated=True raises
    in the real backend and the simulator alike."""
    monkeypatch.setattr(tcost, "CALIBRATION_PATH", tmp_path / "missing.json")
    tcost.set_calibration(None)
    a = _matrix("tpu2", 4, 16)
    cfg = SchedConfig(priority="critical_path", calibrated=True)
    with pytest.raises(FileNotFoundError, match="calibration"):
        scheduled_tile_cholesky(a, 16, TP.tpu(2), cfg)
    with pytest.raises(FileNotFoundError):
        simulate_dag("tile", 4, TP.tpu(2), dataclasses.replace(
            cfg, backend="sim"))
    monkeypatch.undo()
    tcost.set_calibration(None)


def test_non_positive_definite_tile_is_nan():
    """A POTRF of a tile that is not positive definite gives NaN, which
    reaches every tile below it, as in the sequential engine."""
    a = _matrix("tpu2", 4, 16)
    a[16:32, 16:32] = -torch.eye(16)
    l, _ = scheduled_tile_cholesky(a, 16, TP.tpu(2), SchedConfig(workers=2))
    seq = tile_cholesky(a, 16, TP.tpu(2))
    assert l[:16, :16].isfinite().all()
    assert l[16:, 16:].diagonal().isnan().all()
    assert _same_bits(l, seq)


def test_rejects_sim_backend_and_ragged_n():
    a = _matrix("tpu2", 4, 16)
    with pytest.raises(ValueError, match="backend='real'"):
        scheduled_cholesky(a, 16, TP.tpu(2), SchedConfig(backend="sim"))
    with pytest.raises(ValueError, match="multiple of nb"):
        scheduled_cholesky(a[:60, :60], 16, TP.tpu(2), SchedConfig())
    with pytest.raises(ValueError, match="impl"):
        make_kernels("tile", a, 16, TP.tpu(2), impl="fast")


# ---------------------------------------------------------------------------
# the hook in tile_cholesky
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", sorted(POLICIES))
def test_tile_cholesky_schedule_hook(label):
    pol = POLICIES[label][1]
    a = _matrix(label, 4, 32)
    for cfg in SCHEDULES:
        l = tile_cholesky(a, 32, pol, schedule=cfg)
        want, _ = scheduled_tile_cholesky(a, 32, pol, cfg)
        assert _same_bits(l, want)
        assert _same_bits(l, tile_cholesky(a, 32, pol))
    for impl in ("kernel", "plain"):
        assert _same_bits(tile_cholesky(a, 32, pol, schedule=SCHEDULES[1],
                                        impl=impl), l)


def test_tile_cholesky_schedule_refuses_grad():
    a = _matrix("tpu2", 4, 16).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="schedule"):
        tile_cholesky(a, 16, TP.tpu(2), schedule=SchedConfig())
    with torch.no_grad():
        l = tile_cholesky(a, 16, TP.tpu(2), schedule=SchedConfig())
    assert not l.requires_grad and l.isfinite().all()
    with pytest.raises(ValueError, match="dst_cholesky"):
        tile_cholesky(a.detach(), 16, TP.dst(2), schedule=SchedConfig())


# ---------------------------------------------------------------------------
# traces and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_real_trace_validates_on_both(variant, tmp_path):
    from repro.analysis.concurrency.hb import verify_trace as j_verify_trace
    from repro_torch.analysis.concurrency import verify_trace
    pol = TP.tpu(2)
    a = _matrix("tpu2", 6, 16)
    path = tmp_path / "real.json"
    cfg = SchedConfig(workers=3, trace_path=str(path))
    _, rep = scheduled_cholesky(a, 16, pol, cfg, variant=variant)
    trace = load_and_validate(path)
    j_validate_trace(trace)
    validate_trace(chrome_trace(rep))
    assert trace["otherData"]["n_tasks"] == rep.n_tasks
    assert {e["args"]["worker"] for e in trace["traceEvents"]
            if e["ph"] == "X"} <= {f"sched-w{w}" for w in range(3)}
    assert verify_trace(trace).ok
    assert j_verify_trace(trace).ok
    json.dumps(trace)


def test_trace_validator_rejects_overlap():
    rep = simulate_dag("tile", 4, TP.tpu(2), SchedConfig(backend="sim",
                                                        workers=2))
    trace = chrome_trace(rep)
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X" and e["tid"] == 0]
    xs[1]["ts"] = xs[0]["ts"]
    with pytest.raises(ValueError, match="overlaps"):
        validate_trace(trace)
    with pytest.raises(ValueError):
        j_validate_trace(trace)


def test_summary_rows_equal_reference():
    from repro.sched.trace import summary_rows as j_rows
    from repro_torch.sched import format_summary, summary_rows
    kw = dict(priority="panel_first", workers=3, backend="sim")
    tr = simulate_dag("panel", 6, TP.tpu(2), SchedConfig(**kw))
    jr = jsched.simulate_dag("panel", 6, JP.tpu(2), jsched.SchedConfig(**kw))
    assert summary_rows(tr) == j_rows(jr)
    assert format_summary(tr) == jsched.format_summary(jr)
    other = chrome_trace(tr)["otherData"]
    assert other == jsched.chrome_trace(jr)["otherData"]


@pytest.mark.parametrize("backend", ("sim", "real"))
def test_cli_runs_on_cpu(backend, tmp_path, capsys):
    from repro_torch.sched.__main__ import main
    path = tmp_path / "cli.json"
    rc = main(["--variant", "tile", "--policy", "mixed", "--p", "4",
               "--workers", "3", "--backend", backend, "--device", "cpu",
               "--trace", str(path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"{backend} tile priority=critical_path W=3" in out
    assert "validated" in out
    load_and_validate(path)


def test_cli_real_without_card_raises():
    from repro_torch.sched.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--backend", "real", "--p", "2"])
