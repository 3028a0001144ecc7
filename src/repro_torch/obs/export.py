"""Exporters for the telemetry recorder.

Counterpart of `repro.obs.export`, in the same formats.  Four ways out of
one `Recorder`:

  * `write_jsonl` / `load_jsonl`     -- append-friendly JSONL event log:
    one line per finished span, then one line per counter/gauge/histogram
    at flush time.  The log is self-contained: `summary_from_events`
    rebuilds the per-span aggregate table from the file alone (the
    round-trip the tests gate on).
  * `prometheus_text`                -- Prometheus text exposition
    (counters, gauges, cumulative-`le` histogram buckets) for scraping a
    long-running benchmark or service loop.
  * `summary_table`                  -- the human-readable per-run table
    the CLI and chip_smoke.py print.
  * `merged_chrome_trace`            -- the bridge into the scheduler's
    Chrome trace: host-side spans become complete ("X") events on a
    second process track (pid 1), one tid per (thread, nesting depth) so
    nested spans never overlap on a single track and the merged file
    still passes `sched.trace.validate_trace`.  When the recorder holds
    the `sched.t0` gauge (written by the runtime's `execute`: on the card
    the host clock at the moment its t0 event was recorded on an idle
    stream, off by the launch latency), host spans and scheduler tasks
    share one timebase; otherwise both streams are aligned to their own
    earliest event.
"""

from __future__ import annotations

import json
import re

from .recorder import Recorder, SpanRecord

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _jsonable(value):
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


def _span_event(s: SpanRecord) -> dict:
    return {
        "type": "span",
        "name": s.name,
        "start": s.start,
        "end": s.end,
        "dur": s.duration,
        "thread": s.thread,
        "depth": s.depth,
        "status": s.status,
        "attrs": {k: _jsonable(v) for k, v in s.attrs.items()},
    }


def events(recorder: Recorder) -> list[dict]:
    """The recorder's contents as a flat list of JSON-serializable events."""
    snap = recorder.snapshot()
    out = [_span_event(s) for s in snap["spans"]]
    for name, value in sorted(snap["counters"].items()):
        out.append({"type": "counter", "name": name, "value": value})
    for name, value in sorted(snap["gauges"].items()):
        out.append({"type": "gauge", "name": name, "value": value})
    for name, h in sorted(snap["histograms"].items()):
        out.append({"type": "histogram", "name": name, **h})
    return out


def write_jsonl(recorder: Recorder, path) -> int:
    """Write the JSONL event log; returns the number of lines written."""
    evs = events(recorder)
    with open(path, "w") as fh:
        for ev in evs:
            fh.write(json.dumps(ev) + "\n")
    return len(evs)


def load_jsonl(path) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------

def summary_from_events(evs: list[dict]) -> list[dict]:
    """Per-span-name aggregate rows from a (possibly reloaded) event list."""
    agg: dict[str, dict] = {}
    for ev in evs:
        if ev.get("type") != "span":
            continue
        row = agg.setdefault(ev["name"], {
            "name": ev["name"], "count": 0, "total": 0.0, "max": 0.0,
            "errors": 0})
        row["count"] += 1
        row["total"] += ev["dur"]
        row["max"] = max(row["max"], ev["dur"])
        row["errors"] += ev["status"] == "error"
    for row in agg.values():
        row["mean"] = row["total"] / row["count"]
    return sorted(agg.values(), key=lambda r: -r["total"])


def summary_rows(recorder: Recorder) -> list[dict]:
    return summary_from_events(events(recorder))


def summary_table(recorder: Recorder) -> str:
    """Human-readable per-run summary: spans, counters, gauges, histograms."""
    snap = recorder.snapshot()
    lines: list[str] = []
    span_rows = summary_from_events([_span_event(s) for s in snap["spans"]])
    if span_rows:
        lines.append(f"{'span':<36} {'count':>7} {'total_s':>10} "
                     f"{'mean_s':>10} {'max_s':>10} {'err':>4}")
        for r in span_rows:
            lines.append(f"{r['name']:<36} {r['count']:>7} {r['total']:>10.4f} "
                         f"{r['mean']:>10.5f} {r['max']:>10.5f} "
                         f"{r['errors']:>4}")
    if snap["counters"]:
        lines.append("counters:")
        for name, value in sorted(snap["counters"].items()):
            lines.append(f"  {name} = {value:g}")
    if snap["gauges"]:
        lines.append("gauges:")
        for name, value in sorted(snap["gauges"].items()):
            lines.append(f"  {name} = {value:g}")
    hist_only = {k: h for k, h in snap["histograms"].items()
                 if k not in {r["name"] for r in span_rows}}
    if hist_only:
        lines.append("histograms:")
        for name, h in sorted(hist_only.items()):
            lines.append(
                f"  {name}: n={h['count']} mean={h['total'] / max(h['count'], 1):.5f}"
                f" min={h['min']} max={h['max']}")
    return "\n".join(lines) if lines else "(recorder is empty)"


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _prom_name(name: str) -> str:
    return "repro_" + _PROM_NAME_RE.sub("_", name)


def prometheus_text(recorder: Recorder) -> str:
    """Prometheus text-format exposition of counters, gauges, histograms."""
    snap = recorder.snapshot()
    lines: list[str] = []
    for name, value in sorted(snap["counters"].items()):
        pn = _prom_name(name)
        lines += [f"# TYPE {pn} counter", f"{pn} {value:g}"]
    for name, value in sorted(snap["gauges"].items()):
        pn = _prom_name(name)
        lines += [f"# TYPE {pn} gauge", f"{pn} {value:g}"]
    for name, h in sorted(snap["histograms"].items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for edge, count in zip(h["edges"], h["counts"]):
            cum += count
            lines.append(f'{pn}_bucket{{le="{edge:g}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{pn}_sum {h['total']:g}")
        lines.append(f"{pn}_count {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Chrome trace bridge
# ---------------------------------------------------------------------------

HOST_PID = 1   # scheduler tasks render under pid 0 (sched.trace), spans here


def merged_chrome_trace(report, recorder: Recorder) -> dict:
    """Scheduler tasks + host-side spans in ONE Chrome/Perfetto trace.

    `report` is a `sched.runtime.SchedReport` (real backend: timestamps in
    microseconds since its own t0, device times on the card).  Host spans land on pid 1, one tid per
    (thread, depth): sibling spans on a thread are sequential and parents
    sit on the track above their children, so no track ever has
    overlapping events and `validate_trace` accepts the merged file.
    """
    from ..sched.trace import chrome_trace

    trace = chrome_trace(report)
    snap = recorder.snapshot()
    spans: list[SpanRecord] = snap["spans"]
    if not spans:
        return trace

    t0 = snap["gauges"].get("sched.t0")   # executor start, perf_counter s
    base = min(s.start for s in spans)
    if t0 is not None:
        base = min(base, t0)
        shift = (t0 - base) * 1e6
        if shift:
            for ev in trace["traceEvents"]:
                if ev.get("ph") == "X":
                    ev["ts"] += shift

    events_out = trace["traceEvents"]
    events_out.append({"name": "process_name", "ph": "M", "pid": HOST_PID,
                       "tid": 0, "args": {"name": "repro_torch.obs host spans"}})
    threads = {th: i for i, th in
               enumerate(sorted({s.thread for s in spans}))}
    tracks: dict[tuple[int, int], int] = {}
    for s in sorted(spans, key=lambda s: (threads[s.thread], s.depth, s.start)):
        key = (s.thread, s.depth)
        tid = tracks.get(key)
        if tid is None:
            tid = tracks[key] = len(tracks)
            events_out.append({
                "name": "thread_name", "ph": "M", "pid": HOST_PID,
                "tid": tid,
                "args": {"name": f"host t{threads[s.thread]} depth{s.depth}"},
            })
        events_out.append({
            "name": s.name,
            "cat": "host",
            "ph": "X",
            "ts": (s.start - base) * 1e6,
            "dur": s.duration * 1e6,
            "pid": HOST_PID,
            "tid": tid,
            "args": {"status": s.status, "depth": s.depth,
                     **{k: _jsonable(v) for k, v in s.attrs.items()}},
        })
    trace["otherData"]["host_spans"] = len(spans)
    return trace


def write_merged_trace(report, recorder: Recorder, path) -> dict:
    trace = merged_chrome_trace(report, recorder)
    with open(path, "w") as fh:
        json.dump(trace, fh, indent=1)
    return trace
