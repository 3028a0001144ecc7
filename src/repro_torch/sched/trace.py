"""Observability: Chrome `trace_event` JSON + per-tier/worker summaries.

Counterpart of `repro.sched.trace`, in the same format: the reference's
`validate_trace` and happens-before checker accept the port's traces.  The
runtime records one `TaskEvent` per executed task (begin/end, tier,
worker).  This module turns that into

  * a Chrome trace (the JSON Array-with-metadata format both
    `chrome://tracing` and https://ui.perfetto.dev open directly): one
    complete "X" event per task on its worker's track, tier as the
    category so the UI colors hi/lo/lo2 lanes distinctly;

  * `validate_trace` -- the structural gate the tests and CI run over
    every emitted file: well-formed events, non-negative monotone
    timestamps, and no two tasks overlapping on one worker track;

  * plain-dict summary rows (per tier and per worker) for benchmark
    output and the CLI.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

if TYPE_CHECKING:                      # pragma: no cover - typing only
    from .runtime import SchedReport

_REQUIRED_KEYS = ("name", "ph", "ts", "dur", "pid", "tid")


def worker_names(report: "SchedReport") -> dict[int, str]:
    """Per-worker display name: the real OS thread name when the executor
    recorded one (`TaskEvent.worker_name`), else the legacy worker<N>."""
    names = {w: f"worker{w}" for w in range(report.workers)}
    for ev in report.events:
        if getattr(ev, "worker_name", ""):
            names[ev.worker] = ev.worker_name
    return names


def chrome_trace(report: "SchedReport") -> dict:
    """Render a report as a Chrome trace_event JSON object."""
    names = worker_names(report)
    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": f"repro_torch.sched {report.backend} "
                         f"{report.variant}/{report.priority}"},
    }]
    for w in range(report.workers):
        events.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": w,
                       "args": {"name": names[w]}})
    for ev in report.events:
        events.append({
            "name": f"{ev.kind}@k={ev.k}",
            "cat": ev.tier,
            "ph": "X",
            "ts": ev.start,
            "dur": ev.end - ev.start,
            "pid": 0,
            "tid": ev.worker,
            "args": {"task": ev.name, "kind": ev.kind, "tier": ev.tier,
                     "k": ev.k, "index": ev.index,
                     "worker": names[ev.worker]},
        })
    other = {
        "backend": report.backend,
        "variant": report.variant,
        "priority": report.priority,
        "workers": report.workers,
        "n_tasks": report.n_tasks,
        "makespan": report.makespan,
        "utilization": report.utilization,
        "overlap_fraction": report.overlap_fraction,
    }
    # graph identity: enough to rebuild the symbolic DAG so the
    # happens-before verifier can check a trace artifact standalone
    if getattr(report, "p", 0):
        other["p"] = report.p
        mode, d1, d2 = report.policy
        other["policy"] = {"mode": mode, "diag_thick": d1, "diag_thick2": d2}
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def write_trace(report: "SchedReport", path) -> None:
    with open(path, "w") as fh:
        json.dump(chrome_trace(report), fh, indent=1)


def validate_trace(trace: dict) -> None:
    """Raise ValueError unless `trace` is a well-formed, overlap-free trace.

    Checks: top-level shape, required keys on every complete event,
    non-negative timestamps/durations, and -- per worker track -- strictly
    monotone, non-overlapping task intervals.  Tracks may be keyed by a
    numeric tid or by a thread-name string (the named variant the real
    executor emits); anything else is malformed.
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a traceEvents list")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    # tracks are keyed on (pid, tid): merged traces put host spans on pid 1
    # with thread-local tids that may collide numerically with pid-0 worker
    # tids -- those are different tracks, not overlaps.
    per_track: dict[tuple, list[tuple[float, float, str]]] = {}
    for ev in events:
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"malformed event {ev!r}")
        if ev["ph"] != "X":
            continue
        for key in _REQUIRED_KEYS:
            if key not in ev:
                raise ValueError(f"event missing {key!r}: {ev!r}")
        ts, dur = ev["ts"], ev["dur"]
        if not (isinstance(ts, (int, float)) and ts >= 0):
            raise ValueError(f"non-finite/negative ts in {ev!r}")
        if not (isinstance(dur, (int, float)) and dur >= 0):
            raise ValueError(f"non-finite/negative dur in {ev!r}")
        if not isinstance(ev["tid"], (int, str)) or isinstance(ev["tid"], bool):
            raise ValueError(f"tid must be an int or a thread-name string, "
                             f"got {ev['tid']!r} in {ev!r}")
        per_track.setdefault((ev["pid"], ev["tid"]), []).append(
            (ts, ts + dur, str(ev["name"])))
    if not per_track:
        raise ValueError("trace has no complete ('X') events")
    for (pid, tid), spans in per_track.items():
        spans.sort()
        for (s0, e0, n0), (s1, _, n1) in zip(spans, spans[1:]):
            if s1 < e0:
                raise ValueError(
                    f"track pid={pid} tid={tid}: {n0!r} [{s0}, {e0}) "
                    f"overlaps {n1!r} starting at {s1}")


def load_and_validate(path) -> dict:
    with open(path) as fh:
        trace = json.load(fh)
    validate_trace(trace)
    return trace


def summary_rows(report: "SchedReport") -> list[dict]:
    """Per-tier and per-worker aggregate rows for tables/benchmarks."""
    rows: list[dict] = []
    by_tier: dict[str, list] = {}
    for ev in report.events:
        by_tier.setdefault(ev.tier, []).append(ev)
    for tier in sorted(by_tier):
        evs = by_tier[tier]
        rows.append({"scope": "tier", "name": tier, "tasks": len(evs),
                     "busy": sum(e.end - e.start for e in evs)})
    names = worker_names(report)
    for w, busy in enumerate(report.worker_busy):
        n = sum(1 for e in report.events if e.worker == w)
        util = busy / report.makespan if report.makespan > 0 else 1.0
        idle = max(report.makespan - busy, 0.0)
        rows.append({"scope": "worker", "name": names[w], "tasks": n,
                     "busy": busy, "util": util, "idle": idle,
                     "idle_frac": 1.0 - util})
    return rows


def format_summary(report: "SchedReport") -> str:
    lines = [
        f"{report.backend} {report.variant} priority={report.priority} "
        f"W={report.workers}: {report.n_tasks} tasks, "
        f"makespan={report.makespan:.3f}, "
        f"utilization={report.utilization:.3f}, "
        f"overlap={report.overlap_fraction:.3f}",
    ]
    for row in summary_rows(report):
        if row["scope"] == "tier":
            lines.append(f"  tier {row['name']:>4}: {row['tasks']:>5} tasks, "
                         f"busy {row['busy']:.3f}")
        else:
            lines.append(f"  {row['name']}: {row['tasks']:>5} tasks, "
                         f"busy {row['busy']:.3f}, util {row['util']:.3f}, "
                         f"idle {row['idle']:.3f} ({row['idle_frac']:.1%})")
    return "\n".join(lines)
