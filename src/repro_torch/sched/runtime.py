"""StarPU-style dynamic tile-task runtime on CUDA streams.

Counterpart of `repro.sched.runtime`.  The static layer (`analysis.dag`)
extracts each engine's POTRF/TRSM/SYRK/GEMM/CONVERT task stream and proves
it hazard-free; this module executes that stream out of order, the way
StarPU executes ExaGeoStat's tile Cholesky (paper §4): a dependency-
counting ready queue, a pluggable priority policy, and two backends behind
one interface --

  * `simulate` -- virtual-time list scheduling: every task advances a
    deterministic clock by its `launch.costmodel.task_virtual_cost`.
    Reports makespan, per-worker utilization and overlap for W workers
    without touching a float; equal to the reference's, event for event.

  * `execute`  -- W OS threads pop ready tasks and run per-tile torch ops
    (`sched.kernels`).  On the card each worker enqueues on a CUDA stream
    of its own, and a dependency becomes a cross-stream event: a task
    records an event after its last op and publishes its value with it; a
    consumer's stream waits on its producers' events before it enqueues
    anything.  Publication is asynchronous: a worker does not wait for its
    task to finish on the device before it publishes, so the host issues
    ahead of the device on W streams at once; each worker keeps at most
    LOOKAHEAD of its tasks unfinished on the device, which bounds the
    memory in flight.  Task times are device times from CUDA events.

Every task output is a value keyed by producer index, written once, so any
dependency-respecting order computes the same bits.  A value is dropped
once every consumer of it has been dispatched, except each tile's last
writer (the factor); a tensor read on another stream than the one that
allocated it is marked with `record_stream`, so the caching allocator
never hands its block out while a reader is still queued.  Both backends
log their dispatch order, which `analysis.dag.check_dag` replays, and
record per-task events for `sched.trace` and `analysis.concurrency.hb`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import random
import threading
import time

import torch

from .. import obs
from ..analysis.dag import (
    Task,
    build_dag,
    successor_map,
    task_dependencies,
)
from ..launch.costmodel import task_virtual_cost
from .config import SchedConfig

_KIND_RANK = {"POTRF": 0, "CONVERT": 1, "TRSM": 2, "SYRK": 3, "GEMM": 4}

# tasks a worker may have enqueued on its stream and not yet finished on the
# device: the host runs at most this far ahead of each stream
LOOKAHEAD = 8


# ---------------------------------------------------------------------------
# task graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TaskGraph:
    """A task stream plus its dependency structure, ready to schedule."""
    variant: str
    p: int
    policy: object                     # PrecisionPolicy
    tasks: tuple[Task, ...]
    deps: tuple[tuple[int, ...], ...]  # per-task producer indices
    succs: tuple[tuple[int, ...], ...]

    @property
    def n(self) -> int:
        return len(self.tasks)

    def indegree(self) -> list[int]:
        return [len({d for d in row if d >= 0}) for row in self.deps]


def build_graph(variant: str, p: int, policy) -> TaskGraph:
    tasks = build_dag(variant, p, policy)
    deps = task_dependencies(tasks, p, policy, variant)
    succs = successor_map(deps)
    return TaskGraph(variant=variant, p=p, policy=policy,
                     tasks=tuple(tasks),
                     deps=tuple(tuple(d) for d in deps),
                     succs=tuple(tuple(s) for s in succs))


def downstream_cost(graph: TaskGraph, config: SchedConfig) -> list[float]:
    """Per-task critical-path-to-exit length under the virtual cost model:
    a task's own cost plus the heaviest chain hanging off it."""
    costs = [task_virtual_cost(t, convert_cost=config.convert_cost,
                               calibrated=config.calibrated)
             for t in graph.tasks]
    down = [0.0] * graph.n
    for idx in range(graph.n - 1, -1, -1):   # emission order is topological
        down[idx] = costs[idx] + max((down[s] for s in graph.succs[idx]),
                                     default=0.0)
    return down


def _tie_order(graph: TaskGraph, config: SchedConfig) -> list[int]:
    """Per-task tie-break rank: emission order (seed 0), or a permutation
    seeded by `config.seed`, so runs that differ only in equal-priority
    tie-breaking are reproducible from the config alone."""
    if config.seed == 0:
        return list(range(graph.n))
    order = list(range(graph.n))
    random.Random(config.seed).shuffle(order)
    rank = [0] * graph.n
    for r, idx in enumerate(order):
        rank[idx] = r
    return rank


def priority_keys(graph: TaskGraph, config: SchedConfig) -> list[tuple]:
    """Total-order ready-queue key per task (smaller pops first)."""
    if config.priority == "fifo":
        # fifo IS the emission order -- there are no ties for a seed to break
        return [(idx,) for idx in range(graph.n)]
    tie = _tie_order(graph, config)
    if config.priority == "panel_first":
        # right-looking lookahead: later panels outrank earlier trailing
        # updates, and within a step the factor ops outrank the updates
        return [(t.k, _KIND_RANK[t.kind], tie[idx], idx)
                for idx, t in enumerate(graph.tasks)]
    down = downstream_cost(graph, config)
    return [(-down[idx], tie[idx], idx) for idx in range(graph.n)]


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TaskEvent:
    """One executed task: who ran it, when, and what it was."""
    index: int
    name: str
    kind: str
    tier: str
    k: int
    worker: int
    start: float       # sim: virtual units; real: microseconds since t0
    end: float
    worker_name: str = ""   # real backend: the OS thread's name; sim: sim-w<N>


def policy_desc(policy) -> tuple:
    """(mode, diag_thick, diag_thick2) -- enough to rebuild the symbolic
    task graph (storage tiers ignore dtypes), carried through trace files
    so `analysis.concurrency.hb` can verify an artifact standalone."""
    return (policy.mode, int(policy.diag_thick), int(policy.diag_thick2))


@dataclasses.dataclass(frozen=True)
class SchedReport:
    backend: str
    variant: str
    priority: str
    workers: int
    n_tasks: int
    makespan: float
    worker_busy: tuple[float, ...]
    dispatch_order: tuple[int, ...]
    events: tuple[TaskEvent, ...]
    p: int = 0                         # tile-grid size (0 = unknown)
    policy: tuple = ()                 # policy_desc(...) of the graph's policy

    @property
    def utilization(self) -> float:
        denom = self.workers * self.makespan
        return sum(self.worker_busy) / denom if denom > 0 else 1.0

    @property
    def overlap_fraction(self) -> float:
        """Fraction of the makespan during which >= 2 workers are busy."""
        if self.makespan <= 0:
            return 0.0
        bounds = []
        for ev in self.events:
            bounds.append((ev.start, 1))
            bounds.append((ev.end, -1))
        bounds.sort()
        busy, last_t, overlapped = 0, 0.0, 0.0
        for t, delta in bounds:
            if busy >= 2:
                overlapped += t - last_t
            busy += delta
            last_t = t
        return overlapped / self.makespan


# ---------------------------------------------------------------------------
# simulated backend: deterministic virtual-time list scheduling
# ---------------------------------------------------------------------------

def simulate(graph: TaskGraph, config: SchedConfig) -> SchedReport:
    """Schedule `graph` on W virtual workers; no numerics, no wall clock.

    Deterministic by construction: ties break on (priority key, task
    index) in the ready heap and (finish time, worker id) in the event
    heap, and task durations come from the cost model -- the same config
    always yields the same makespan, bit for bit.
    """
    with obs.span("sched.simulate", variant=graph.variant, p=graph.p,
                  workers=config.workers, priority=config.priority,
                  calibrated=config.calibrated):
        return _simulate(graph, config)


def _simulate(graph: TaskGraph, config: SchedConfig) -> SchedReport:
    keys = priority_keys(graph, config)
    costs = [task_virtual_cost(t, convert_cost=config.convert_cost,
                               calibrated=config.calibrated)
             for t in graph.tasks]
    ndeps = graph.indegree()
    ready = [keys[i] for i in range(graph.n) if ndeps[i] == 0]
    heapq.heapify(ready)
    idle = list(range(config.workers))
    heapq.heapify(idle)
    running: list[tuple[float, int, int]] = []   # (end, worker, task)
    busy = [0.0] * config.workers
    dispatch: list[int] = []
    events: list[TaskEvent] = []
    t, done = 0.0, 0

    while done < graph.n:
        while ready and idle:
            idx = heapq.heappop(ready)[-1]
            w = heapq.heappop(idle)
            end = t + costs[idx]
            heapq.heappush(running, (end, w, idx))
            dispatch.append(idx)
            task = graph.tasks[idx]
            events.append(TaskEvent(
                index=idx, name=str(task), kind=task.kind, tier=task.tier,
                k=task.k, worker=w, start=t, end=end,
                worker_name=f"sim-w{w}"))
            busy[w] += costs[idx]
        if not running:
            raise RuntimeError("scheduler deadlock: no ready task and no "
                               "running task (cyclic or truncated DAG)")
        end, w, idx = heapq.heappop(running)
        t = end
        heapq.heappush(idle, w)
        done += 1
        for s in graph.succs[idx]:
            ndeps[s] -= 1
            if ndeps[s] == 0:
                heapq.heappush(ready, keys[s])

    return SchedReport(
        backend="sim", variant=graph.variant, priority=config.priority,
        workers=config.workers, n_tasks=graph.n, makespan=t,
        worker_busy=tuple(busy), dispatch_order=tuple(dispatch),
        events=tuple(events), p=graph.p, policy=policy_desc(graph.policy))


# ---------------------------------------------------------------------------
# real backend: threaded out-of-order execution of per-tile ops
# ---------------------------------------------------------------------------

def _last_writers(graph: TaskGraph) -> dict[tuple[int, int], int]:
    """Tile -> index of the task that writes its final (factored) value."""
    last = {}
    for idx, task in enumerate(graph.tasks):
        if task.kind != "CONVERT":
            last[task.target] = idx
    return last


def _operand_tiles(task: Task) -> tuple[tuple[int, int], ...]:
    return task.reads if task.kind != "CONVERT" else (task.target,)


class _ExecState:
    """Shared mutable state behind one lock; values are write-once.

    `uses[i]` counts the consumers of task i's value not yet dispatched,
    plus one for a tile's last writer (kept for the final store);
    `initial_uses[tile]` the same for the initial store's tiles.  A value
    whose count reaches 0 is dropped.  `published[i]` is the (stream, end
    event) that produced value i on the card; `last_end[w]` worker w's last
    end event.

    The ``# repro: guarded-by=cond`` annotations below are checked by
    `analysis.concurrency.lockguard`: any mutation of an annotated
    attribute outside a ``with <state>.cond:`` block (or a ``*_locked``
    function, whose caller holds it) is a lint finding.  `graph`, `keys`,
    `kernels`, `cuda`, `caller` and `clock0` are not changed after the
    workers start and are deliberately unannotated.
    """

    def __init__(self, graph: TaskGraph, keys: list[tuple], kernels,
                 workers: int, caller=None):
        self.graph = graph
        self.keys = keys
        self.kernels = kernels
        self.cuda = kernels.device.type == "cuda"
        self.caller = caller          # the caller's stream on the card
        self.clock0 = 0.0             # host origin of CPU task times
        self.ndeps = graph.indegree()                   # repro: guarded-by=cond
        self.ready = [keys[i] for i in range(graph.n)  # repro: guarded-by=cond
                      if self.ndeps[i] == 0]
        heapq.heapify(self.ready)
        self.values: list = [None] * graph.n            # repro: guarded-by=cond
        self.published: list = [None] * graph.n         # repro: guarded-by=cond
        self.uses = [len(s) for s in graph.succs]       # repro: guarded-by=cond
        for idx in _last_writers(graph).values():
            self.uses[idx] += 1
        self.initial_uses: dict = collections.Counter(  # repro: guarded-by=cond
            r for idx, task in enumerate(graph.tasks)
            for r, d in zip(_operand_tiles(task), graph.deps[idx]) if d < 0)
        self.done = 0                                   # repro: guarded-by=cond
        self.running = 0    # dispatched, unpublished  # repro: guarded-by=cond
        self.dispatch: list[int] = []                   # repro: guarded-by=cond
        self.events: list = []                          # repro: guarded-by=cond
        self.last_end: list = [None] * workers          # repro: guarded-by=cond
        self.error: BaseException | None = None         # repro: guarded-by=cond
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)


def _fetch_locked(state: _ExecState, idx: int) -> tuple[list, list]:
    """Operands of task idx and, for each, the (stream, event) that
    produced it (the caller's stream and no event for an initial tile);
    drops every value this was the last reader of.  The caller holds
    `state.cond`."""
    graph, kernels = state.graph, state.kernels
    ops, sources = [], []
    for r, producer in zip(_operand_tiles(graph.tasks[idx]), graph.deps[idx]):
        if producer < 0:
            ops.append(kernels.initial(r))
            sources.append((state.caller, None) if state.cuda else None)
            state.initial_uses[r] -= 1
            if state.initial_uses[r] == 0:
                kernels.release(r)
        else:
            ops.append(state.values[producer])
            sources.append(state.published[producer])
    for producer in set(graph.deps[idx]):
        if producer >= 0:
            state.uses[producer] -= 1
            if state.uses[producer] == 0:
                state.values[producer] = None
                state.published[producer] = None
    return ops, sources


def _run_task(state: _ExecState, stream, task: Task, ops, sources, pending):
    """Enqueue one task on this worker's stream (or run it on the CPU);
    returns (output, start, end) with start and end events or host
    microseconds.  An operand from another stream is waited for, and
    marked as read here for the caching allocator.  Outside the lock."""
    kernels = state.kernels
    if not state.cuda:
        start = time.perf_counter()
        out = kernels.run(task, ops)
        return (out, (start - state.clock0) * 1e6,
                (time.perf_counter() - state.clock0) * 1e6)
    for src, ev in sources:
        if src is not stream and ev is not None:
            stream.wait_event(ev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    out = kernels.run(task, ops)
    end.record(stream)
    for op, (src, _) in zip(ops, sources):
        if src is not stream:
            op.record_stream(stream)
    pending.append(end)
    if len(pending) > LOOKAHEAD:   # bound the host's lead on the device
        pending.popleft().synchronize()
    return out, start, end


def _publish_locked(state: _ExecState, w: int, stream, idx: int, out,
                    start, end) -> None:
    """Store a finished task's value and release its consumers; wakes one
    waiting worker per new ready task but the one this worker takes next,
    and all at the end.  The caller holds `state.cond`."""
    state.values[idx] = out
    state.published[idx] = (stream, end) if state.cuda else None
    state.done += 1
    state.running -= 1
    state.events.append((idx, w, start, end))
    if state.cuda:
        state.last_end[w] = end
    woken = 0
    for s in state.graph.succs[idx]:
        state.ndeps[s] -= 1
        if state.ndeps[s] == 0:
            heapq.heappush(state.ready, state.keys[s])
            woken += 1
    if state.done >= state.graph.n:
        state.cond.notify_all()
    elif woken > 1:
        state.cond.notify(woken - 1)


def _worker(state: _ExecState, w: int, stream, t0) -> None:
    """Worker w's loop: in one lock round, publish its last task and pop
    and fetch its next; enqueue that task outside the lock."""
    pending = collections.deque()
    n = state.graph.n
    # this worker's last task, published in the same lock round as its
    # next dispatch
    finished = None
    ctx = torch.cuda.stream(stream) if state.cuda \
        else contextlib.nullcontext()
    try:
        with ctx:
            if state.cuda:
                stream.wait_event(t0)
            while True:
                with state.cond:
                    if finished is not None:
                        _publish_locked(state, w, stream, *finished)
                        finished = None
                    while not state.ready:
                        if state.done >= n or state.error is not None:
                            return
                        if not state.running:
                            state.error = RuntimeError(
                                "scheduler deadlock: no ready task and "
                                "no running task (cyclic or truncated "
                                "DAG)")
                            state.cond.notify_all()
                            return
                        state.cond.wait()
                    if state.error is not None:
                        return
                    idx = heapq.heappop(state.ready)[-1]
                    state.running += 1
                    state.dispatch.append(idx)
                    ops, sources = _fetch_locked(state, idx)
                out, start, end = _run_task(state, stream, state.graph.tasks[idx],
                                            ops, sources, pending)
                finished = (idx, out, start, end)
                del ops, out
    except BaseException as e:          # propagate to the caller
        with state.cond:
            if state.error is None:
                state.error = e
            state.cond.notify_all()


def execute(graph: TaskGraph, config: SchedConfig, kernels) -> tuple[dict, SchedReport]:
    """Run the DAG on `config.workers` OS threads with real tile ops.

    `kernels` is a `sched.kernels.KernelSet`: it owns the initial tile
    storage and maps one task + its operand tensors to one output tensor.
    Every output is stored write-once under its task index, and every
    consumer fetches operands by producer index (`graph.deps`), so a late
    reader can never observe a newer tile version.

    On a CUDA matrix each worker runs on a stream of its own (see the
    module docstring); before its first task it waits on an event of the
    caller's current stream, where the matrix was produced, and at the end
    the caller's stream waits on every worker's last event.  Task times
    are device microseconds from an event recorded on the caller's stream
    before the first launch, read after a final synchronisation.  On a CPU
    matrix there are no streams and times are host microseconds.

    With telemetry on (`obs`), the gauge `sched.t0` is the host clock
    (`time.perf_counter()`) at the start of the report's timebase: on the
    card taken after a synchronization of the caller's stream, just before
    its t0 event is recorded there, so host spans and device task times
    share one timebase up to the launch latency.  Each task then lands in
    the histogram `sched.task.{kind}.{tier}` (seconds) and the counter
    `sched.tasks.{kind}`, fed from the report's times after the final
    synchronization: a read inside a worker would wait for the device per
    task and change the schedule.  With telemetry off nothing here
    synchronizes.

    Returns (final tile store, report).  The final store maps each tile to
    its last writer's output (its factored value).  A worker's exception
    stops the others and is raised here.
    """
    keys = priority_keys(graph, config)
    n = graph.n
    cuda = kernels.device.type == "cuda"
    telemetry = obs.enabled()
    caller = streams = t0 = None
    if cuda:
        caller = torch.cuda.current_stream(kernels.device)
        streams = [torch.cuda.Stream(kernels.device)
                   for _ in range(config.workers)]
        t0 = torch.cuda.Event(enable_timing=True)
    state = _ExecState(graph, keys, kernels, config.workers, caller)
    if cuda:
        if telemetry:   # t0 on an idle stream: it runs as it is recorded
            caller.synchronize()
            clock0 = time.perf_counter()
        t0.record(caller)
    else:
        clock0 = state.clock0 = time.perf_counter()
    if telemetry:
        # anchor for obs.export.merged_chrome_trace: host spans and the
        # report's per-task events share this perf_counter origin
        obs.gauge("sched.t0", clock0)

    threads = [threading.Thread(
        target=_worker, args=(state, w, streams[w] if cuda else None, t0),
        daemon=True, name=f"sched-w{w}") for w in range(config.workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if cuda:
        for ev in state.last_end:
            if ev is not None:
                caller.wait_event(ev)
        torch.cuda.synchronize(kernels.device)
    if state.error is not None:
        raise state.error

    store = {}
    for tile, idx in _last_writers(graph).items():
        store[tile] = state.values[idx]
        if cuda:   # read on the caller's stream from here on
            store[tile].record_stream(caller)

    names = [f"sched-w{w}" for w in range(config.workers)]
    events = []
    for idx, w, start, end in state.events:
        if cuda:
            start, end = t0.elapsed_time(start) * 1e3, t0.elapsed_time(end) * 1e3
        task = graph.tasks[idx]
        events.append(TaskEvent(
            index=idx, name=str(task), kind=task.kind, tier=task.tier,
            k=task.k, worker=w, start=start, end=end, worker_name=names[w]))
        if telemetry:
            # per-(kind, tier) task times -- the per-task profile the
            # summary and the Prometheus exposition report
            obs.observe(f"sched.task.{task.kind}.{task.tier}",
                        (end - start) * 1e-6)
            obs.inc(f"sched.tasks.{task.kind}")
    makespan = max((ev.end for ev in events), default=0.0)
    busy = [0.0] * config.workers
    for ev in events:
        busy[ev.worker] += ev.end - ev.start
    report = SchedReport(
        backend="real", variant=graph.variant, priority=config.priority,
        workers=config.workers, n_tasks=n, makespan=makespan,
        worker_busy=tuple(busy), dispatch_order=tuple(state.dispatch),
        events=tuple(events), p=graph.p,
        policy=policy_desc(graph.policy))
    return store, report


# ---------------------------------------------------------------------------
# high-level entry points
# ---------------------------------------------------------------------------

def _maybe_trace(report: SchedReport, config: SchedConfig) -> None:
    if config.trace_path:
        from .trace import write_trace
        write_trace(report, config.trace_path)


def simulate_dag(variant: str, p: int, policy,
                 config: SchedConfig | None = None) -> SchedReport:
    """Build + schedule one engine's DAG on the virtual backend."""
    config = config or SchedConfig(backend="sim")
    report = simulate(build_graph(variant, p, policy), config)
    _maybe_trace(report, config)
    return report


def scheduled_cholesky(a, nb: int, policy, config: SchedConfig, *,
                       variant: str = "tile", impl: str = "kernel"):
    """Factor SPD `a` (..., n, n) by executing the variant's task DAG out
    of order on `a`'s device.  Returns (tile store, report).  `a` is not
    modified."""
    from .kernels import make_kernels

    if config.backend != "real":
        raise ValueError("scheduled_cholesky needs backend='real'; use "
                         "simulate_dag for the virtual backend")
    n = a.shape[-1]
    if n % nb:
        raise ValueError(f"n={n} must be a multiple of nb={nb}")
    p = n // nb
    graph = build_graph(variant, p, policy)
    kernels = make_kernels(variant, a, nb, policy, impl=impl)
    with obs.span("sched.execute", variant=variant, p=p,
                  workers=config.workers, priority=config.priority):
        store, report = execute(graph, config, kernels)
    _maybe_trace(report, config)
    return store, report


def scheduled_tile_cholesky(a, nb: int, policy, config: SchedConfig, *,
                            impl: str = "kernel"):
    """Drop-in `tile_cholesky`: the factor assembled in hi, via the
    runtime.  Returns (L, report)."""
    from ..core.tile_cholesky import assemble_lower

    store, report = scheduled_cholesky(a, nb, policy, config, variant="tile",
                                       impl=impl)
    p = a.shape[-1] // nb
    return assemble_lower(store, p, nb, policy.hi), report
