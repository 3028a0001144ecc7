"""The port's happens-before checker (repro_torch.analysis.concurrency.hb)
against the reference's (repro.analysis.concurrency.hb): the same report
on the same recorded schedules, clean and mutated (a dropped dependency
edge, a consumer moved before its producer, concurrent same-slot writes),
and a clean check of the port's real executor on the CPU."""

import dataclasses
import json

import pytest
import torch

import repro.analysis.concurrency.hb as jhb
import repro.sched as jsched
from repro.core.precision import PrecisionPolicy as JP
from repro_torch.analysis.concurrency import hb
from repro_torch.analysis.dag import successor_map
from repro_torch.core.precision import PrecisionPolicy as TP
from repro_torch.sched import (SchedConfig, build_graph, chrome_trace,
                               scheduled_cholesky, simulate, write_trace)
from repro_torch.verify.generators import spd_matrix

torch.set_num_threads(1)

P = 6
CELLS = {
    "tile-full": ("tile", JP.full(), TP.full()),
    "tile-tpu2": ("tile", JP.tpu(2), TP.tpu(2)),
    "tile-three_tier12": ("tile", JP.three_tier(1, 2), TP.three_tier(1, 2)),
    "panel-tpu2": ("panel", JP.tpu(2), TP.tpu(2)),
    "dst-dst2": ("dst", JP.dst(2), TP.dst(2)),
}


def _sims(variant, jp, tp, p=P, mutate=None, **kw):
    """The reference's and the port's simulated report of one cell, each
    run on its graph (or on `mutate` of it), and the true graphs."""
    kw.setdefault("workers", 3)
    jg, tg = jsched.build_graph(variant, p, jp), build_graph(variant, p, tp)
    jm, tm = (jg, tg) if mutate is None else (mutate(jg), mutate(tg))
    return (jsched.simulate(jm, jsched.SchedConfig(backend="sim", **kw)), jg,
            simulate(tm, SchedConfig(backend="sim", **kw)), tg)


def _same(jrep, trep):
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    return trep


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_clean_schedule_same_report(cell):
    variant, jp, tp = CELLS[cell]
    for priority in ("fifo", "panel_first", "critical_path"):
        for seed in (0, 11):
            jr, jg, tr, tg = _sims(variant, jp, tp, priority=priority,
                                   seed=seed)
            rep = _same(jhb.verify_sched_report(jr, jg),
                        hb.verify_sched_report(tr, tg))
            assert rep.ok and rep.n_events == tg.n
            assert rep.n_dep_edges > 0 and rep.n_po_edges > 0
            assert hb.verify_sched_report(tr).ok   # graph from the report


def _drop_edge(graph, task, producer):
    deps = tuple(tuple(d for d in row if d != producer) if i == task else row
                 for i, row in enumerate(graph.deps))
    succs = tuple(tuple(s) for s in successor_map([list(r) for r in deps]))
    return dataclasses.replace(graph, deps=deps, succs=succs)


@pytest.mark.parametrize("policy", ("tpu1", "full"))
def test_dropped_edge_mutants_same_verdicts(policy):
    """A scheduler that lost one edge, checked against the true graph:
    the port names the same violations as the reference, and catches most
    mutants."""
    jp, tp = (JP.tpu(1), TP.tpu(1)) if policy == "tpu1" else (JP.full(),
                                                               TP.full())
    graph = build_graph("tile", 4, tp)
    caught = total = 0
    kinds = set()
    for task in range(graph.n):
        producers = sorted({d for d in graph.deps[task] if d >= 0})
        if not producers:
            continue
        total += 1
        cut = lambda g: _drop_edge(g, task, producers[0])
        jr, jg, tr, tg = _sims("tile", jp, tp, p=4, mutate=cut,
                               priority="fifo")
        rep = _same(jhb.verify_sched_report(jr, jg),
                    hb.verify_sched_report(tr, tg))
        caught += not rep.ok
        kinds |= {v.kind for v in rep.violations}
    assert total >= 10 and caught >= total // 2, (caught, total)
    assert kinds <= {"dep-order", "convert-order", "write-write"}
    if policy == "tpu1":
        assert "convert-order" in kinds


def _real_report(variant, workers=3, p=5, nb=16):
    pol = TP.tpu(2)
    a = spd_matrix(p, p * nb, cond=100.0, device="cpu")
    return scheduled_cholesky(a, nb, pol, SchedConfig(workers=workers),
                              variant=variant)[1]


@pytest.mark.parametrize("workers", (2, 4))
@pytest.mark.parametrize("variant", ("tile", "panel", "dst"))
def test_real_executor_verifies(variant, workers):
    report = _real_report(variant, workers)
    assert {ev.worker_name for ev in report.events} <= {
        f"sched-w{w}" for w in range(workers)}
    rep = hb.verify_sched_report(report)
    assert rep.ok, rep.render()
    trace = chrome_trace(report)
    assert hb.verify_trace(trace).ok
    assert _same(jhb.verify_trace(trace), hb.verify_trace(trace)).ok


@pytest.mark.parametrize("variant", ("tile", "panel", "dst"))
def test_consumer_moved_before_producer_fails(variant):
    """A trace of the real executor with one consumer moved to start before
    its producer ended fails the port's check (and the reference's), named
    as that pair."""
    report = _real_report(variant)
    graph = build_graph(variant, report.p, TP.tpu(2))
    trace = chrome_trace(report)
    xs = {e["args"]["index"]: e for e in trace["traceEvents"]
          if e["ph"] == "X"}
    task = max(i for i in range(graph.n) if any(d >= 0
                                                for d in graph.deps[i]))
    producer = max(d for d in graph.deps[task] if d >= 0)
    xs[task]["ts"] = xs[producer]["ts"] + 0.5 * xs[producer]["dur"]
    rep = _same(jhb.verify_trace(trace), hb.verify_trace(trace))
    assert not rep.ok
    assert any(v.kind in ("dep-order", "convert-order")
               and (v.index_a, v.index_b) == (producer, task)
               for v in rep.violations)


def test_atol_is_the_clock_slack():
    """A consumer that starts 0.5 us before its producer's recorded end
    fails with atol 0 and passes with the card's atol of 1 us."""
    report = _real_report("tile")
    graph = build_graph("tile", report.p, TP.tpu(2))
    by = {ev.index: ev for ev in report.events}
    task = next(i for i in range(graph.n) if any(d >= 0
                                                 for d in graph.deps[i]))
    producer = next(d for d in graph.deps[task] if d >= 0)
    events = [dataclasses.replace(ev, worker=99, start=by[producer].end - 0.5,
                                  end=by[producer].end + 1.0)
              if ev.index == task else ev for ev in report.events]
    shifted = dataclasses.replace(report, events=tuple(events))
    assert not hb.verify_sched_report(shifted, graph).ok
    assert hb.verify_sched_report(shifted, graph, atol=1.0).ok


def test_concurrent_same_slot_writes_caught():
    graph = build_graph("tile", 3, TP.full())
    jgraph = jsched.build_graph("tile", 3, JP.full())
    writers, pair = {}, None
    for i, t in enumerate(graph.tasks):
        if t.kind == "CONVERT":
            continue
        if t.target in writers:
            pair = (writers[t.target], i)
            break
        writers[t.target] = i
    a, b = pair
    events = [hb._Event(index=i, worker=1 if i == b else 0,
                        worker_name="w1" if i == b else "w0",
                        start=float(a if i == b else i),
                        end=float(a) + 0.5 if i == b else float(i) + 0.9)
              for i in range(graph.n)]
    jevents = [jhb._Event(**dataclasses.asdict(e)) for e in events]
    rep = _same(jhb.verify_events(jevents, jgraph),
                hb.verify_events(events, graph))
    assert any(v.kind == "write-write" for v in rep.violations)


def test_same_version_duplicate_converts_exempt():
    graph = build_graph("tile", 6, TP.tpu(2))
    seen, dup = {}, None
    for i, t in enumerate(graph.tasks):
        if t.kind == "CONVERT":
            key = (t.target, t.tier, tuple(sorted(set(graph.deps[i]))))
            dup = dup or (key in seen and (seen[key], i))
            seen[key] = i
    assert dup
    rep = hb.verify_sched_report(
        simulate(graph, SchedConfig(backend="sim", workers=6)), graph)
    assert rep.ok, rep.render()


def test_malformed_traces_rejected(tmp_path):
    graph = build_graph("tile", 3, TP.full())
    report = simulate(graph, SchedConfig(backend="sim", workers=2))
    path = tmp_path / "t.json"
    write_trace(report, path)
    assert hb.verify_trace_file(path).ok
    with pytest.raises(hb.HBError, match="otherData"):
        hb.verify_trace({"traceEvents": [], "otherData": {"variant": "tile"}})
    trace = json.loads(path.read_text())
    trace["traceEvents"] = [ev for ev in trace["traceEvents"]
                            if ev.get("args", {}).get("index") != 0]
    with pytest.raises(hb.HBError, match="missing task indices"):
        hb.verify_trace(trace)
    trace = json.loads(path.read_text())
    trace["traceEvents"].append(dict(next(
        ev for ev in trace["traceEvents"]
        if ev.get("args", {}).get("index") == 0)))
    with pytest.raises(hb.HBError, match="twice"):
        hb.verify_trace(trace)
    trace = json.loads(path.read_text())
    trace["otherData"]["policy"]["mode"] = "quad"
    with pytest.raises(hb.HBError, match="unknown policy mode"):
        hb.verify_trace(trace)
