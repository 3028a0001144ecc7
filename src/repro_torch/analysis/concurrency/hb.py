"""Happens-before trace verifier: vector clocks over recorded schedules.

Counterpart of `repro.analysis.concurrency.hb`.  The dynamic runtime
(`repro_torch.sched`) argues race freedom by construction: values are
write-once keyed by producer index, and the ready queue only releases a
task once every producer has published.  This module checks that claim
against evidence -- a recorded execution (a `SchedReport`, or the Chrome
trace JSON the runtime writes) -- the way a happens-before race detector
checks a real program.  On the card a report's times are device times
(CUDA events on the workers' streams), so a clean check says that no task
began on the device before a producer it depends on ended.

  1.  Rebuild the ground-truth dependency graph for the trace's
      (variant, p, policy) cell from `analysis.dag.task_dependencies` --
      the same edges the scheduler's ready queue enforces.
  2.  Reconstruct the execution's own ordering: per-worker program order
      (events on one worker track, sorted by time; `validate_trace`
      already guarantees they never overlap) plus every dependency edge
      the recorded timestamps actually respect.
  3.  Assign a vector clock to every task event over the worker tracks
      and verify three properties:

      * dependency order -- task B reading task A's output must start at
        or after A's end (a violation means the runtime released B while
        A was still in flight: a real race, or a dropped edge);
      * conversion order -- a cross-tier read must be fed by a CONVERT of
        the current version, and that CONVERT must happen-before the
        consumer (the paper's dlag2s/sconv2d discipline, dynamically);
      * write-write order -- any two writes to the same tile slot (the
        canonical tile for compute tasks, the (tile, tier) copy slot for
        CONVERTs) must be HB-ordered one way or the other.  Duplicate
        CONVERTs of the SAME source version (independent, bitwise-
        identical copies keyed by their own task index) need no mutual
        order, but CONVERTs of *different* versions of a tile into the
        same tier slot do.

Violations are reported as (task A, task B, tile, missing edge), naming
the workers by their recorded thread names.  With one event per task and
HB edges from program order + respected dependencies, `VC[b][track(a)] >=
VC[a][track(a)]` is equivalent to "a happens-before b", so a reported pair
is a genuine unordered pair under the recorded schedule.
"""

from __future__ import annotations

import dataclasses

from ..dag import Task, task_dependencies


@dataclasses.dataclass(frozen=True)
class _Event:
    """One recorded task execution, normalized from either input form."""
    index: int                 # task index in emission order
    worker: object             # track key (worker id or tid)
    worker_name: str
    start: float
    end: float


@dataclasses.dataclass(frozen=True)
class HBViolation:
    kind: str                  # "dep-order" | "convert-order" | "write-write"
    task_a: str                # producer / first writer (str(Task))
    task_b: str                # consumer / second writer
    index_a: int
    index_b: int
    tile: tuple | None         # tile slot in conflict (None: structural)
    missing_edge: str          # human-readable description of the gap

    def render(self) -> str:
        return (f"[{self.kind}] {self.task_a} (#{self.index_a}) vs "
                f"{self.task_b} (#{self.index_b}) on tile {self.tile}: "
                f"{self.missing_edge}")


class HBError(ValueError):
    """The trace cannot be checked at all (wrong cell, missing events)."""


@dataclasses.dataclass(frozen=True)
class HBReport:
    variant: str
    p: int
    n_events: int
    n_dep_edges: int           # ground-truth dependency edges checked
    n_po_edges: int            # per-worker program-order edges
    n_write_pairs: int         # same-slot write pairs checked for HB order
    violations: tuple[HBViolation, ...]

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        head = (f"hb {self.variant} p={self.p}: {self.n_events} events, "
                f"{self.n_dep_edges} dep edges + {self.n_po_edges} program-"
                f"order edges, {self.n_write_pairs} write pairs, "
                f"{len(self.violations)} violations")
        return "\n".join([head] + [f"  {v.render()}" for v in self.violations])


# ---------------------------------------------------------------------------
# event extraction
# ---------------------------------------------------------------------------

def _events_from_report(report) -> list[_Event]:
    return [_Event(index=ev.index, worker=ev.worker,
                   worker_name=getattr(ev, "worker_name", "") or
                   f"worker{ev.worker}",
                   start=ev.start, end=ev.end)
            for ev in report.events]


def _events_from_trace(trace: dict) -> list[_Event]:
    """Scheduler task events from a Chrome trace (pid 0, complete events
    carrying a task index; merged traces' host spans on pid 1 are ignored)."""
    raw = [ev for ev in trace.get("traceEvents", [])
           if isinstance(ev, dict) and ev.get("pid") == 0]
    names = {ev.get("tid"): ev.get("args", {}).get("name", "")
             for ev in raw
             if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
    out = []
    for ev in raw:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        if "index" not in args:
            continue
        tid = ev.get("tid")
        out.append(_Event(
            index=int(args["index"]), worker=tid,
            worker_name=args.get("worker") or names.get(tid) or str(tid),
            start=float(ev["ts"]), end=float(ev["ts"]) + float(ev["dur"])))
    return out


def graph_from_trace(trace: dict):
    """Rebuild the TaskGraph named by a trace's otherData (variant, p,
    policy mode/thresholds); raises HBError when the trace predates the
    metadata."""
    from ...core.precision import PrecisionPolicy
    from ...sched.runtime import build_graph

    other = trace.get("otherData", {})
    variant, p = other.get("variant"), other.get("p")
    pol = other.get("policy")
    if not variant or not p or not isinstance(pol, dict):
        raise HBError(
            "trace otherData lacks variant/p/policy -- re-emit the trace "
            "with `python -m repro_torch.sched`, or pass the graph "
            "explicitly")
    mode = pol.get("mode")
    d1, d2 = int(pol.get("diag_thick", 1)), int(pol.get("diag_thick2", 0))
    if mode == "full":
        policy = PrecisionPolicy.full()
    elif mode == "mixed":
        policy = PrecisionPolicy.tpu(d1)
    elif mode == "dst":
        policy = PrecisionPolicy.dst(d1)
    elif mode == "three_tier":
        policy = PrecisionPolicy.three_tier(d1, d2)
    else:
        raise HBError(f"trace names unknown policy mode {mode!r}")
    return build_graph(variant, int(p), policy)


# ---------------------------------------------------------------------------
# the verifier
# ---------------------------------------------------------------------------

def _write_slots(tasks) -> dict[object, list[int]]:
    """Slot key -> ordered writer task indices.

    Compute tasks write the canonical tile store slot `("tile", i, j)`;
    CONVERTs write the copy slot `("copy", i, j, dst_tier)` -- the same
    slot partitioning `analysis.dag.check_dag` replays.
    """
    slots: dict[object, list[int]] = {}
    for idx, t in enumerate(tasks):
        if t.kind == "CONVERT":
            key = ("copy", *t.target, t.tier)
        else:
            key = ("tile", *t.target)
        slots.setdefault(key, []).append(idx)
    return slots


def _same_version_copies(tasks, deps, a: int, b: int) -> bool:
    """True when two CONVERTs snapshot the same immutable source value
    (same producer), i.e. are bitwise-identical independent copies."""
    return (tasks[a].kind == "CONVERT" and tasks[b].kind == "CONVERT"
            and set(deps[a]) == set(deps[b]))


def verify_events(events: list[_Event], graph, *, atol: float = 0.0) -> HBReport:
    """Run the HB checks over normalized events against `graph`'s edges.

    `atol` is a timestamp slack for clock granularity: simulated traces
    are exact and CPU traces use one perf_counter, so 0.0 is right there;
    device times from CUDA events resolve to about half a microsecond, so
    a report from the card is checked with atol = 1 us.
    """
    tasks: tuple[Task, ...] = tuple(graph.tasks)
    n = len(tasks)
    by_index: dict[int, _Event] = {}
    for e in events:
        if e.index in by_index:
            raise HBError(f"task #{e.index} recorded twice in the trace")
        by_index[e.index] = e
    missing = [i for i in range(n) if i not in by_index]
    extra = sorted(set(by_index) - set(range(n)))
    if missing or extra:
        raise HBError(
            f"trace does not cover the graph: missing task indices "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}, unknown "
            f"indices {extra[:8]}")

    deps = graph.deps if hasattr(graph, "deps") else tuple(
        task_dependencies(list(tasks), graph.p, graph.policy, graph.variant))

    violations: list[HBViolation] = []

    def viol(kind, a, b, tile, msg):
        violations.append(HBViolation(
            kind=kind, task_a=str(tasks[a]), task_b=str(tasks[b]),
            index_a=a, index_b=b, tile=tile, missing_edge=msg))

    # --- 1. dependency order: producer must end before consumer starts ----
    n_dep_edges = 0
    respected: list[tuple[int, int]] = []    # HB edges the trace backs up
    for idx in range(n):
        ea = by_index[idx]
        for d in set(deps[idx]):
            if d < 0:
                continue
            n_dep_edges += 1
            ep = by_index[d]
            if ep.end <= ea.start + atol:
                respected.append((d, idx))
            else:
                kind = ("convert-order" if tasks[d].kind == "CONVERT"
                        else "dep-order")
                viol(kind, d, idx, tasks[d].target,
                     f"{ep.worker_name} ended #{d} at t={ep.end:.6g} but "
                     f"{ea.worker_name} started #{idx} at t={ea.start:.6g} "
                     f"(missing edge #{d} -> #{idx})")

    # --- 2. vector clocks from program order + respected dep edges --------
    tracks = sorted({e.worker for e in events}, key=str)
    track_of = {w: i for i, w in enumerate(tracks)}
    per_track: dict[object, list[_Event]] = {w: [] for w in tracks}
    for e in events:
        per_track[e.worker].append(e)
    n_po_edges = 0
    preds: list[list[int]] = [[] for _ in range(n)]
    for w, evs in per_track.items():
        evs.sort(key=lambda e: (e.start, e.end, e.index))
        for a, b in zip(evs, evs[1:]):
            preds[b.index].append(a.index)
            n_po_edges += 1
    for d, idx in respected:
        preds[idx].append(d)

    # events sorted by start time are a topological order of the HB graph:
    # every HB edge runs from an event that ended at or before its
    # successor's start (program order by non-overlap, dep edges by the
    # `respected` filter above)
    order = sorted(range(n), key=lambda i: (by_index[i].start,
                                            by_index[i].end, i))
    vc: list[list[int] | None] = [None] * n
    count_on_track = {w: 0 for w in tracks}
    for idx in order:
        e = by_index[idx]
        clock = [0] * len(tracks)
        for pidx in preds[idx]:
            pv = vc[pidx]
            if pv is None:      # predecessor starts later: not HB, skip
                continue
            for i, v in enumerate(pv):
                if v > clock[i]:
                    clock[i] = v
        t = track_of[e.worker]
        count_on_track[e.worker] += 1
        clock[t] = count_on_track[e.worker]
        vc[idx] = clock

    def hb(a: int, b: int) -> bool:
        ta = track_of[by_index[a].worker]
        return vc[b][ta] >= vc[a][ta]    # type: ignore[index]

    # --- 3. write-write order on every slot -------------------------------
    n_write_pairs = 0
    for slot, writers in _write_slots(tasks).items():
        for i, a in enumerate(writers):
            for b in writers[i + 1:]:
                if _same_version_copies(tasks, deps, a, b):
                    continue    # bitwise-identical duplicate copies
                n_write_pairs += 1
                if not (hb(a, b) or hb(b, a)):
                    viol("write-write", a, b, slot[1:3],
                         f"writes to slot {slot} on "
                         f"{by_index[a].worker_name} and "
                         f"{by_index[b].worker_name} are concurrent "
                         f"(no HB edge either way)")

    return HBReport(
        variant=graph.variant, p=graph.p, n_events=n,
        n_dep_edges=n_dep_edges, n_po_edges=n_po_edges,
        n_write_pairs=n_write_pairs, violations=tuple(violations))


def verify_sched_report(report, graph=None, *, atol: float = 0.0) -> HBReport:
    """Verify a `sched.runtime.SchedReport` directly (no file round-trip)."""
    if graph is None:
        graph = _graph_for_report(report)
    return verify_events(_events_from_report(report), graph, atol=atol)


def verify_trace(trace: dict, graph=None, *, atol: float = 0.0) -> HBReport:
    """Verify a Chrome trace dict (plain or merged); rebuilds the graph
    from otherData unless one is passed."""
    if graph is None:
        graph = graph_from_trace(trace)
    return verify_events(_events_from_trace(trace), graph, atol=atol)


def verify_trace_file(path, graph=None, *, atol: float = 0.0) -> HBReport:
    import json

    with open(path) as fh:
        return verify_trace(json.load(fh), graph, atol=atol)


def _graph_for_report(report):
    from ...sched.runtime import build_graph

    trace_shim = {"otherData": {
        "variant": report.variant, "p": getattr(report, "p", 0),
        "policy": dict(zip(("mode", "diag_thick", "diag_thick2"),
                           getattr(report, "policy", ()))),
    }}
    try:
        return graph_from_trace(trace_shim)
    except HBError:
        raise HBError(
            "report carries no (p, policy) metadata; pass the TaskGraph "
            "explicitly") from None
