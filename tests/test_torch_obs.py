"""The port's telemetry layer (`repro_torch.obs`) on the CPU: a counterpart
of each test of `tests/test_obs.py` (recorder semantics, thread safety,
exporter round-trips, the merged Chrome trace, calibration, the
disabled-mode overhead guard), then parity with `repro.obs`: the same
inputs into both recorders give the same snapshots, the same Prometheus
text, the same summary rows and the same host-track layout.

The counterpart of the reference's `test_maybe_span_noops_under_jit` is the
port's `obs.traced()` region, and a guard tensor that requires grad."""

import json
import threading
import time

import pytest
import torch

from repro_torch import obs
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tile_cholesky import tile_cholesky
from repro_torch.launch import costmodel
from repro_torch.launch.costmodel import (
    load_calibration,
    set_calibration,
    task_virtual_cost,
)
from repro_torch.obs.calibrate import (
    cost_key,
    measure_kernel_times,
    write_calibration,
)
from repro_torch.sched.config import SchedConfig
from repro_torch.sched.runtime import build_graph, scheduled_tile_cholesky, simulate
from repro_torch.sched.trace import validate_trace
from repro_torch.verify.generators import spd_matrix

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

POLICY = PrecisionPolicy.tpu(2)


def _spd(seed, n, cond):
    return spd_matrix(seed, n, cond=cond, device="cpu")


# ---------------------------------------------------------------------------
# recorder: counters / gauges / histograms
# ---------------------------------------------------------------------------

def test_counters_and_gauges():
    rec = obs.Recorder()
    rec.inc("a")
    rec.inc("a", 2)
    rec.gauge("g", 3.5)
    rec.gauge("g", 4.5)          # gauges overwrite
    snap = rec.snapshot()
    assert snap["counters"]["a"] == 3
    assert snap["gauges"]["g"] == 4.5


def test_histogram_bucket_edges_le_semantics():
    h = obs.Histogram(edges=(1.0, 2.0, 4.0))
    # Prometheus `le`: a value equal to an edge lands IN that bucket
    for v in (0.5, 1.0, 2.0, 3.0, 4.0, 5.0):
        h.observe(v)
    assert h.counts == [2, 1, 2, 1]      # (<=1, <=2, <=4, +Inf overflow)
    assert h.count == 6
    assert h.min == 0.5 and h.max == 5.0
    assert h.total == pytest.approx(15.5)
    # bucket_rows are cumulative; the +Inf row equals the total count
    assert h.bucket_rows() == [(1.0, 2), (2.0, 3), (4.0, 5),
                               (float("inf"), 6)]


def test_histogram_rejects_unsorted_edges():
    with pytest.raises(ValueError):
        obs.Histogram(edges=(2.0, 1.0))


def test_observe_uses_default_buckets():
    rec = obs.Recorder()
    rec.observe("h", 0.5)
    h = rec.histograms["h"]
    assert tuple(h.edges) == obs.recorder.DEFAULT_BUCKETS


# ---------------------------------------------------------------------------
# spans: nesting, exception unwinding
# ---------------------------------------------------------------------------

def test_span_nesting_depths():
    rec = obs.Recorder()
    with rec.span("outer"):
        with rec.span("inner"):
            pass
        with rec.span("inner2"):
            pass
    by_name = {s.name: s for s in rec.spans}
    assert by_name["outer"].depth == 0
    assert by_name["inner"].depth == 1
    assert by_name["inner2"].depth == 1
    # children recorded before the parent closes
    assert [s.name for s in rec.spans] == ["inner", "inner2", "outer"]
    # span durations also feed a histogram of the same name
    assert rec.histograms["outer"].count == 1


def test_span_exception_unwinds_and_propagates():
    rec = obs.Recorder()
    with pytest.raises(RuntimeError):
        with rec.span("boom"):
            raise RuntimeError("x")
    (s,) = rec.spans
    assert s.status == "error"
    # depth stack unwound: a fresh span is a root again
    with rec.span("after"):
        pass
    assert rec.spans[-1].depth == 0


def test_span_attrs_recorded():
    rec = obs.Recorder()
    with rec.span("s", n=128, mode="mixed"):
        pass
    assert rec.spans[0].attrs == {"n": 128, "mode": "mixed"}


# ---------------------------------------------------------------------------
# global switch / maybe_span
# ---------------------------------------------------------------------------

def test_disabled_module_helpers_are_noops():
    assert not obs.enabled()
    assert obs.span("x") is obs.NULL_SPAN
    assert obs.maybe_span("x", torch.zeros(1)) is obs.NULL_SPAN
    before = obs.get_recorder().snapshot()
    obs.inc("c")
    obs.observe("h", 1.0)
    obs.gauge("g", 1.0)
    assert obs.get_recorder().snapshot() == before


def test_recording_restores_previous_state():
    assert not obs.enabled()
    with obs.recording() as rec:
        assert obs.enabled()
        assert obs.get_recorder() is rec
        obs.inc("c")
    assert not obs.enabled()
    assert rec.counters["c"] == 1


def test_maybe_span_noops_where_the_reference_traces():
    """The reference's jit-traced call records no span; the port's
    counterpart is a call inside `obs.traced()`, or on an `a` that
    requires grad (the reference's `a` is then a tracer of jax.grad)."""
    a = _spd(3, 64, 10.0)
    with obs.recording() as rec:
        tile_cholesky(a, 32, POLICY)                       # eager: records
        with obs.traced():
            tile_cholesky(a, 32, POLICY)                   # traced: no-op
            with obs.traced():                             # regions nest
                tile_cholesky(a, 32, POLICY)
            tile_cholesky(a, 32, POLICY)
        tile_cholesky(a.clone().requires_grad_(), 32, POLICY).sum().backward()
        with torch.no_grad():                              # no grad: eager
            tile_cholesky(a.clone().requires_grad_(), 32, POLICY)
    names = [s.name for s in rec.spans]
    assert names.count("core.tile_cholesky") == 2
    with obs.recording() as rec:
        with pytest.raises(ValueError):
            with obs.traced():
                raise ValueError("x")
        tile_cholesky(a, 32, POLICY)                       # region unwound
    assert [s.name for s in rec.spans] == ["core.tile_cholesky"]


# ---------------------------------------------------------------------------
# thread safety
# ---------------------------------------------------------------------------

def test_recorder_thread_safety_raw_threads():
    rec = obs.Recorder()
    n_threads, n_iter = 8, 200

    def work():
        for _ in range(n_iter):
            rec.inc("c")
            rec.observe("h", 1e-4)
            with rec.span("w"):
                pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = rec.snapshot()
    assert snap["counters"]["c"] == n_threads * n_iter
    assert snap["histograms"]["h"]["count"] == n_threads * n_iter
    assert len(snap["spans"]) == n_threads * n_iter
    # per-thread depth stacks never bled across threads
    assert all(s.depth == 0 for s in snap["spans"])


def test_recorder_under_threaded_executor():
    """The runtime's task metrics: one histogram sample and one counter
    increment per task, the t0 gauge, the sched.execute span; the factor
    is the same bits as the same schedule's without telemetry."""
    a = _spd(5, 128, 100.0)
    cfg = SchedConfig(backend="real", workers=4)
    with obs.recording() as rec:
        l, report = scheduled_tile_cholesky(a, 32, POLICY, cfg)
    snap = rec.snapshot()
    n_observed = sum(h["count"] for name, h in snap["histograms"].items()
                     if name.startswith("sched.task."))
    assert n_observed == report.n_tasks
    assert sum(v for k, v in snap["counters"].items()
               if k.startswith("sched.tasks.")) == report.n_tasks
    assert "sched.t0" in snap["gauges"]
    assert any(s.name == "sched.execute" for s in snap["spans"])
    # each (kind, tier) histogram sums its tasks' report durations
    for (kind, tier), want in _report_sums(report).items():
        h = snap["histograms"][f"sched.task.{kind}.{tier}"]
        assert h["count"] == want[0]
        assert h["total"] == pytest.approx(want[1], abs=1e-9 * want[0])
    # and the factorization itself is unchanged by telemetry
    l_off, _ = scheduled_tile_cholesky(a, 32, POLICY, cfg)
    assert torch.equal(l, l_off)


def _report_sums(report):
    """(kind, tier) -> (tasks, seconds summed from the report's events)."""
    out = {}
    for ev in report.events:
        n, s = out.get((ev.kind, ev.tier), (0, 0.0))
        out[(ev.kind, ev.tier)] = (n + 1, s + (ev.end - ev.start) * 1e-6)
    return out


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def _populated_recorder(mod=obs) -> "obs.Recorder":
    rec = mod.Recorder()
    with rec.span("alpha", n=1):
        time.sleep(0.001)
        with rec.span("beta"):
            pass
    try:
        with rec.span("beta"):
            raise ValueError("x")
    except ValueError:
        pass
    rec.inc("count.a", 3)
    rec.gauge("g", 2.5)
    rec.observe("lat", 0.02)
    return rec


def test_jsonl_round_trip(tmp_path):
    rec = _populated_recorder()
    path = tmp_path / "metrics.jsonl"
    n = obs.write_jsonl(rec, path)
    evs = obs.load_jsonl(path)
    assert len(evs) == n
    # aggregates rebuilt from the file match those from the live recorder
    assert obs.summary_from_events(evs) == obs.summary_rows(rec)
    by_type = {}
    for ev in evs:
        by_type.setdefault(ev["type"], []).append(ev)
    assert len(by_type["span"]) == 3
    assert {e["name"] for e in by_type["counter"]} == {"count.a"}
    hist_names = {e["name"] for e in by_type["histogram"]}
    assert {"alpha", "beta", "lat"} <= hist_names
    # every line is valid standalone JSON (append-friendly contract)
    for line in path.read_text().splitlines():
        json.loads(line)


def test_summary_rows_aggregate():
    rec = _populated_recorder()
    rows = {r["name"]: r for r in obs.summary_rows(rec)}
    assert rows["beta"]["count"] == 2
    assert rows["beta"]["errors"] == 1
    assert rows["alpha"]["count"] == 1
    assert rows["alpha"]["total"] >= 0.001


def test_summary_table_renders():
    table = obs.summary_table(_populated_recorder())
    assert "alpha" in table and "count.a" in table and "lat" in table
    assert obs.summary_table(obs.Recorder()) == "(recorder is empty)"


def test_prometheus_text():
    rec = obs.Recorder()
    rec.inc("tasks.done", 5)
    rec.gauge("t0", 1.5)
    h = obs.Histogram(edges=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0):
        h.observe(v)
    rec.histograms["lat"] = h
    text = obs.prometheus_text(rec)
    assert "# TYPE repro_tasks_done counter" in text
    assert "repro_tasks_done 5" in text
    assert "repro_t0 1.5" in text
    # cumulative le buckets + +Inf + sum/count
    assert 'repro_lat_bucket{le="0.1"} 1' in text
    assert 'repro_lat_bucket{le="1"} 2' in text
    assert 'repro_lat_bucket{le="+Inf"} 3' in text
    assert "repro_lat_count 3" in text


# ---------------------------------------------------------------------------
# merged Chrome trace
# ---------------------------------------------------------------------------

def test_merged_trace_validates_with_both_streams(tmp_path):
    a = _spd(7, 128, 100.0)
    cfg = SchedConfig(backend="real", workers=2)
    with obs.recording() as rec:
        with obs.span("host.outer"):
            with obs.span("host.inner"):
                _, report = scheduled_tile_cholesky(a, 32, POLICY, cfg)
    path = tmp_path / "merged.json"
    trace = obs.write_merged_trace(report, rec, path)
    validate_trace(trace)
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    pids = {e["pid"] for e in xs}
    assert pids == {0, 1}                      # scheduler tasks + host spans
    assert trace["otherData"]["host_spans"] == len(rec.spans)
    # nested host spans land on distinct depth tracks
    host = [e for e in xs if e["pid"] == 1]
    outer = next(e for e in host if e["name"] == "host.outer")
    inner = next(e for e in host if e["name"] == "host.inner")
    assert outer["tid"] != inner["tid"]
    # one timebase: every task lies inside the sched.execute span
    execute = next(e for e in host if e["name"] == "sched.execute")
    tasks = [e for e in xs if e["pid"] == 0]
    assert len(tasks) == report.n_tasks
    assert all(execute["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= execute["ts"] + execute["dur"] for e in tasks)
    validate_trace(json.loads(path.read_text()))


def test_merged_trace_without_spans_is_plain_sched_trace():
    rep = simulate(build_graph("tile", 4, POLICY),
                   SchedConfig(backend="sim", workers=2))
    trace = obs.merged_chrome_trace(rep, obs.Recorder())
    assert "host_spans" not in trace["otherData"]
    validate_trace(trace)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

# every execution pair the engines emit (lo2 is storage-only)
EXPECTED_KEYS = {"POTRF/hi", "TRSM/hi", "TRSM/lo", "SYRK/hi", "GEMM/hi",
                 "GEMM/lo", "CONVERT"}


def test_measure_kernel_times_covers_every_pair():
    costs, meta = measure_kernel_times(nb=16, p=4, reps=1, device="cpu")
    assert set(costs) == EXPECTED_KEYS
    assert all(v > 0 for v in costs.values())
    assert meta["units"] == "microseconds"
    assert meta["backend"] == "cpu" and meta["timing"] == "perf_counter"
    graph = build_graph("tile", 4, POLICY)
    assert {cost_key(t) for t in graph.tasks} == EXPECTED_KEYS
    assert meta["n_samples"] == {k: sum(cost_key(t) == k for t in graph.tasks)
                                 for k in sorted(EXPECTED_KEYS)}


def test_calibration_needs_the_card_unless_told_cpu():
    """`measure_kernel_times` and the CLI default to the card: without one
    they raise rather than measure the CPU."""
    from repro_torch.obs.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_kernel_times(nb=16, p=4, reps=1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["calibrate", "--nb", "16", "--p", "4"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["demo-trace"])


def test_write_calibration_round_trip(tmp_path):
    costs = {k: float(i + 1) for i, k in enumerate(sorted(EXPECTED_KEYS))}
    path = write_calibration(costs, {"units": "microseconds"},
                             tmp_path / "cal.json")
    loaded = load_calibration(path)
    assert loaded == {k: round(v, 3) for k, v in costs.items()}


class _FakeTask:
    def __init__(self, kind, tier):
        self.kind, self.tier = kind, tier


def test_task_virtual_cost_calibrated_table():
    table = {"GEMM/lo": 123.0, "CONVERT": 7.0}
    assert task_virtual_cost(_FakeTask("GEMM", "lo"), calibrated=True,
                             table=table) == 123.0
    assert task_virtual_cost(_FakeTask("CONVERT", "lo"), calibrated=True,
                             table=table) == 7.0
    # keys the table lacks fall back to the analytic weight
    analytic = task_virtual_cost(_FakeTask("POTRF", "hi"))
    assert task_virtual_cost(_FakeTask("POTRF", "hi"), calibrated=True,
                             table=table) == analytic


def test_task_virtual_cost_requires_some_table(monkeypatch, tmp_path):
    monkeypatch.setattr(costmodel, "CALIBRATION_PATH",
                        tmp_path / "missing.json")
    set_calibration(None)        # drop any cached table
    try:
        with pytest.raises(FileNotFoundError):
            task_virtual_cost(_FakeTask("GEMM", "lo"), calibrated=True)
    finally:
        set_calibration(None)    # re-read the real file next time


def test_simulator_responds_to_measured_weights():
    """Simulated makespans and ordering follow the measured table, not the
    analytic weights, when `calibrated=True`."""
    graph = build_graph("tile", 8, POLICY)
    cfg = SchedConfig(backend="sim", workers=4, priority="critical_path")
    base = simulate(graph, cfg)
    # invert the analytic world: CONVERTs and lo math dominate
    table = {"POTRF/hi": 1.0, "TRSM/hi": 1.0, "SYRK/hi": 1.0, "GEMM/hi": 1.0,
             "TRSM/lo": 50.0, "GEMM/lo": 80.0, "CONVERT": 200.0}
    set_calibration(table)
    try:
        cal = simulate(graph, SchedConfig(backend="sim", workers=4,
                                          priority="critical_path",
                                          calibrated=True))
    finally:
        set_calibration(None)
    assert cal.makespan != base.makespan
    # per-task durations in the calibrated schedule match the table
    ev = next(e for e in cal.events if e.kind == "CONVERT")
    assert ev.end - ev.start == pytest.approx(200.0)
    order_base = [e.index for e in sorted(base.events,
                                          key=lambda e: (e.start, e.index))]
    order_cal = [e.index for e in sorted(cal.events,
                                         key=lambda e: (e.start, e.index))]
    assert order_base != order_cal       # priorities reordered dispatch


def test_sched_config_validates_calibrated_flag():
    with pytest.raises(ValueError):
        SchedConfig(backend="sim", calibrated="yes")


# ---------------------------------------------------------------------------
# disabled-mode overhead guard
# ---------------------------------------------------------------------------

def test_disabled_overhead_under_five_percent(monkeypatch):
    """Telemetry off must cost < 5% on a p=8 tile factorization: per-call
    cost of a disabled maybe_span x 10 times the telemetry calls the
    factorization makes, against its measured wall time.  The reference
    budgets 1,200 calls (10 x its ~120 tile ops); the port's engine works
    a step at a time and makes one call (`core.tile_cholesky`), which is
    counted here rather than assumed."""
    assert not obs.enabled()
    a = _spd(9, 256, 100.0)

    tile_cholesky(a, 32, POLICY)                          # warm up
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        tile_cholesky(a, 32, POLICY)
    chol_s = (time.perf_counter() - t0) / reps

    calls = []
    for name in ("span", "maybe_span", "inc", "gauge", "observe", "enabled"):
        fn = getattr(obs, name)
        monkeypatch.setattr(obs, name, lambda *a, _fn=fn, **k: (
            calls.append(1), _fn(*a, **k))[1])
    tile_cholesky(a, 32, POLICY)
    monkeypatch.undo()
    assert len(calls) >= 1

    n_calls = 20_000
    t0 = time.perf_counter()
    for _ in range(n_calls):
        with obs.maybe_span("x", a):
            pass
    per_call = (time.perf_counter() - t0) / n_calls
    assert per_call < 5e-6, f"a disabled maybe_span took {per_call * 1e9:.0f} ns"

    overhead = per_call * 10 * len(calls)
    assert overhead < 0.05 * chol_s, (
        f"disabled-mode telemetry too expensive: {per_call * 1e9:.0f} ns/call"
        f" x {10 * len(calls)} calls = {overhead * 1e3:.3f} ms vs "
        f"factorization {chol_s * 1e3:.1f} ms")


# ---------------------------------------------------------------------------
# high contention: the single-lock recorder loses nothing
# ---------------------------------------------------------------------------

def test_recorder_contention_no_lost_updates():
    rec = obs.Recorder()
    n_threads, per_thread = 8, 500
    barrier = threading.Barrier(n_threads)

    def hammer(t):
        barrier.wait()          # maximize overlap
        for i in range(per_thread):
            rec.inc("hits")
            rec.observe("lat", (t * per_thread + i) % 7 * 1e-4)

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()

    total = n_threads * per_thread
    snap = rec.snapshot()
    assert snap["counters"]["hits"] == total
    h = rec.histograms["lat"]
    assert h.count == total
    assert sum(h.counts) == total                   # bucket partition
    assert h.bucket_rows()[-1] == (float("inf"), total)  # cumulative top
    assert h.min >= 0.0 and h.max <= 6.1e-4


def test_recorder_contention_spans_and_mixed_ops():
    rec = obs.Recorder()
    n_threads, per_thread = 6, 120
    barrier = threading.Barrier(n_threads)

    def hammer(t):
        barrier.wait()
        for i in range(per_thread):
            with rec.span("outer", t=t):
                with rec.span("inner"):
                    rec.inc("ops")
            rec.gauge(f"g{t}", float(i))

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()

    total = n_threads * per_thread
    snap = rec.snapshot()
    assert snap["counters"]["ops"] == total
    assert len(snap["spans"]) == 2 * total
    by_name = {}
    for s in snap["spans"]:
        by_name.setdefault(s.name, []).append(s)
    assert len(by_name["outer"]) == total
    assert len(by_name["inner"]) == total
    assert all(s.depth == 0 for s in by_name["outer"])
    assert all(s.depth == 1 for s in by_name["inner"])
    assert rec.histograms["outer"].count == total
    assert rec.histograms["inner"].count == total
    assert snap["gauges"] == {f"g{t}": float(per_thread - 1)
                              for t in range(n_threads)}


# ---------------------------------------------------------------------------
# parity with repro.obs
# ---------------------------------------------------------------------------

def _ref():
    from repro import obs as jobs
    return jobs


def test_public_names_are_the_references():
    jobs = _ref()
    assert obs.__all__ == jobs.__all__
    assert obs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS
    assert obs.export.HOST_PID == jobs.export.HOST_PID


# one sequence of metric calls and finished spans, fed to both recorders:
# spans on two threads, nested, one an error, attributes of each JSON type
_SPANS = [("core.tile_cholesky", 10.0, 10.5, 1, 1, "ok",
           {"n": 256, "nb": 32, "mode": "mixed"}),
          ("verify.cell", 9.9, 10.7, 1, 0, "ok",
           {"id": "chol/tile/full_f32/n128_weak", "kind": "cholesky"}),
          ("sched.execute", 11.0, 11.25, 2, 0, "error",
           {"variant": "tile", "p": 6, "workers": 4}),
          ("batch.loglik", 12.0, 12.000004, 1, 0, "ok",
           {"b": 4, "path": "panel", "flag": True, "none": None}),
          ("mle.fit", 8.0, 20.0, 3, 0, "ok", {"driver": "grid", "levels": 3}),
          ("core.tile_cholesky", 10.6, 10.65, 1, 1, "ok",
           {"n": 256, "nb": 32, "mode": "mixed"})]


def _feed(mod, rec):
    rec.inc("batch.candidates", 4)
    rec.inc("sched.tasks.GEMM")
    rec.inc("sched.tasks.GEMM", 2)
    rec.inc("mle.fits")
    rec.gauge("sched.t0", 9.5)
    rec.gauge("g", 1e-7)
    for v in (3e-6, 1e-5, 2e-4, 0.5, 1.0, 250.0):
        rec.observe("sched.task.GEMM.lo", v)
    rec.observe("custom", 0.3, buckets=(0.1, 0.2, 0.4))
    for name, s, e, th, depth, status, attrs in _SPANS:
        rec._finish(mod.SpanRecord(name=name, start=s, end=e, thread=th,
                                   depth=depth, status=status,
                                   attrs=dict(attrs)))
    return rec


def test_recorder_snapshot_parity():
    jobs = _ref()
    mine = _feed(obs, obs.Recorder()).snapshot()
    ref = _feed(jobs, jobs.Recorder()).snapshot()
    for key in ("counters", "gauges", "histograms"):
        assert mine[key] == ref[key], key
    assert [(s.name, s.start, s.end, s.thread, s.depth, s.status, s.attrs,
             s.duration) for s in mine["spans"]] == \
        [(s.name, s.start, s.end, s.thread, s.depth, s.status, s.attrs,
          s.duration) for s in ref["spans"]]


def test_exporters_parity(tmp_path):
    """prometheus_text and summary_table string for string, events equal,
    and the port's summary over a JSONL the reference wrote equal to the
    reference's rows."""
    jobs = _ref()
    mine, ref = _feed(obs, obs.Recorder()), _feed(jobs, jobs.Recorder())
    assert obs.prometheus_text(mine) == jobs.prometheus_text(ref)
    assert obs.summary_table(mine) == jobs.summary_table(ref)
    assert obs.events(mine) == jobs.events(ref)
    path = tmp_path / "ref.jsonl"
    jobs.write_jsonl(ref, path)
    assert obs.summary_from_events(obs.load_jsonl(path)) == \
        jobs.summary_rows(ref)
    for mod, rec in ((obs, mine), (jobs, ref)):     # live recorders agree
        assert mod.summary_rows(rec) == jobs.summary_rows(ref)
    assert obs.prometheus_text(obs.Recorder()) == \
        jobs.prometheus_text(jobs.Recorder()) == ""


def test_merged_trace_layout_parity():
    """The same spans merged into the same schedule (the port's and the
    reference's simulators agree event for event) give the same trace:
    pid 1, one tid per (thread, depth), the same metadata, the same
    shifted timestamps; only the process names say which package."""
    from repro.core.precision import PrecisionPolicy as JP
    from repro.sched import runtime as jrt
    from repro.sched.config import SchedConfig as JConfig
    jobs = _ref()
    mine_rep = simulate(build_graph("tile", 4, POLICY),
                        SchedConfig(backend="sim", workers=2))
    ref_rep = jrt.simulate(jrt.build_graph("tile", 4, JP.tpu(2)),
                           JConfig(backend="sim", workers=2))
    mine = obs.merged_chrome_trace(mine_rep, _feed(obs, obs.Recorder()))
    ref = jobs.merged_chrome_trace(ref_rep, _feed(jobs, jobs.Recorder()))

    def strip(trace):
        return [{k: v for k, v in e.items() if k != "args"}
                if e["name"] == "process_name" else e
                for e in trace["traceEvents"]]
    assert strip(mine) == strip(ref)
    assert mine["otherData"]["host_spans"] == ref["otherData"]["host_spans"]
    validate_trace(mine)
    host = [e for e in mine["traceEvents"] if e.get("pid") == 1]
    assert {e["tid"] for e in host if e["ph"] == "X"} == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 15 checks (the phase runs on the card only)
# ---------------------------------------------------------------------------

def _chip_smoke():
    from test_torch_mle_adam import _chip_smoke as load
    return load()


def test_chip_smoke_phase15_checks_hold_on_a_cpu_demo_trace(tmp_path):
    """The demo trace on the CPU passes the checks phase 15 (b) runs on
    the card, and each check fails on a tampered input."""
    import copy

    from repro_torch.obs.__main__ import demo_trace
    cs = _chip_smoke()
    rec, report, trace = demo_trace(p=6, nb=16, workers=2,
                                    out=tmp_path / "merged.json", device="cpu")
    graph = build_graph("tile", 6, POLICY)
    snap = rec.snapshot()
    assert cs.task_metric_failures(snap, report, graph) == []
    assert cs.tasks_outside_execute(trace, 0.0) == []
    pairs, kinds = cs.dag_pairs(graph)
    assert sum(pairs.values()) == sum(kinds.values()) == report.n_tasks

    bad = copy.deepcopy(snap)
    bad["counters"]["sched.tasks.GEMM"] -= 1
    bad["histograms"]["sched.task.GEMM.lo"]["total"] += 1e-6
    assert len(cs.task_metric_failures(bad, report, graph)) == 2
    late = copy.deepcopy(trace)
    task = next(e for e in late["traceEvents"]
                if e.get("ph") == "X" and e["pid"] == 0)
    execute = next(e for e in late["traceEvents"]
                   if e.get("ph") == "X" and e["name"] == "sched.execute")
    task["ts"] = execute["ts"] + execute["dur"] + 10.0
    assert cs.tasks_outside_execute(late, 5.0) == [task["name"]]
    assert cs.tasks_outside_execute(late, 10.0 + task["dur"]) == []
