"""Interleaving model checker: the executor's worker loop, step-controlled.

Counterpart of `repro.analysis.concurrency.interleave`.
`sched.runtime.execute` lets the OS scheduler pick which worker acquires
the lock next, so any single threaded run exercises ONE interleaving out
of exponentially many.  This module re-runs the same logical worker loop
under a deterministic cooperative stepper: each logical worker is a
three-phase state machine that calls the executor's own code --

    pop      (lock held)   pop the best ready task, record dispatch,
                           `runtime._fetch_locked` its operands;
    compute  (lock free)   `runtime._run_task`: enqueue the tile op on this
                           worker's stream (run it, on the CPU);
    publish  (lock held)   `runtime._publish_locked`: store the output,
                           decrement successor dependency counts, wake the
                           queue --

and a schedule strategy chooses which runnable worker advances at every
step.  Because the stepper controls the interleaving exactly, a run is
reproducible from (`SchedConfig.seed`, schedule name, salt) alone, and
adversarial schedules can force the orderings a stress test only hits by
luck:

    random            seeded uniform choice among runnable workers;
    reverse_priority  always advance the worker holding the WORST
                      priority-key task (delays critical-path publishes);
    convert_last      starve workers executing CONVERT tasks (stresses
                      cross-tier consumers waiting on dlag2s/sconv2d);
    starve0           worker 0 only advances when it is the sole runnable
                      worker (models an arbitrarily slow OS thread).

On a CUDA matrix each logical worker has a stream of its own, as in
`execute`: a task is enqueued there, and an operand from another stream is
waited on through its producer's end event (`_run_task`), so an
adversarial interleaving drives the port's stream-and-event protocol,
which the reference does not have.  A compute step does not wait for the
device; the host runs ahead of the streams as the executor's does.

Every run asserts the runtime's safety invariants at the exact point the
executor relies on them -- operands are published when fetched (no
use-before-publish, nor a read of a value the executor has already
dropped) and every task is published exactly once -- and, on the card, a
third: an operand produced on another stream carries its producer's end
event.  Every completed run must reproduce the in-order sequential replay
of the same tile ops bit for bit; for the tile variant the assembled
factor is also held to the port's sequential `core.tile_cholesky` within
the policy's registered factor bound (`verify.bounds`), not bit for bit:
the sequential engine solves a column of tiles in one call and updates the
trailing matrix with one SYRK per step, so its sums run in another order
(`sched/kernels.py`).  `run_matrix` sweeps the (variant x policy x p)
conformance matrix and counts DISTINCT explored interleavings by step
signature; the CLI gate requires >= 200 of them, all clean.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import random

import torch

from ...sched.config import SchedConfig
from ...sched.runtime import (
    _ExecState,
    _fetch_locked,
    _operand_tiles,
    _publish_locked,
    _run_task,
    TaskGraph,
    build_graph,
    priority_keys,
)

SCHEDULES = ("random", "reverse_priority", "convert_last", "starve0")

_POP, _COMPUTE, _PUBLISH = "pop", "compute", "publish"


class InterleaveViolation(AssertionError):
    """A runtime safety invariant broke under an explored interleaving."""


@dataclasses.dataclass
class _Worker:
    wid: int
    stream: object = None      # its CUDA stream (None on the CPU)
    phase: str = _POP          # _POP (idle) | _COMPUTE | _PUBLISH
    task: int = -1
    ops: list | None = None
    sources: list | None = None
    done: tuple | None = None  # (output, start, end) of its compute step
    pending: collections.deque = dataclasses.field(
        default_factory=collections.deque)


@dataclasses.dataclass(frozen=True)
class RunResult:
    schedule: str
    seed: int
    salt: int
    workers: int
    signature: tuple          # ((wid, action, task), ...) -- the interleaving
    dispatch: tuple[int, ...]
    values: tuple             # per-task outputs, emission-indexed

    @property
    def n_steps(self) -> int:
        return len(self.signature)


class _RunKernels:
    """One run's view of a `sched.kernels.KernelSet`: the executor drops
    an initial tile once its last reader is dispatched (`release`); here
    that drops it from this run's copy of the store, so the kernel set
    serves every run."""

    def __init__(self, kernels):
        self._kernels = kernels
        self.device = kernels.device
        self._store = dict(kernels.initial_store())

    def initial(self, tile):
        try:
            return self._store[tile]
        except KeyError:
            raise InterleaveViolation(
                f"initial tile {tile} read after the executor released "
                "it") from None

    def release(self, tile):
        del self._store[tile]

    def run(self, task, ops):
        return self._kernels.run(task, ops)


def _check_arity(graph: TaskGraph, idx: int) -> None:
    task = graph.tasks[idx]
    reads = _operand_tiles(task)
    if len(reads) != len(graph.deps[idx]):
        raise InterleaveViolation(
            f"operand arity mismatch: task #{idx} {task} reads "
            f"{len(reads)} operands but carries {len(graph.deps[idx])} "
            "dependency slots (truncated dependency row?)")


def _check_operands(graph: TaskGraph, idx: int, ops, sources, stream,
                    published: dict, cuda: bool) -> None:
    """The fetch's invariants: every producer published and its value still
    held, and on the card, an operand from another stream carrying its
    producer's end event."""
    task = graph.tasks[idx]
    for i, producer in enumerate(graph.deps[idx]):
        if producer < 0:
            continue
        if producer not in published:
            raise InterleaveViolation(
                f"use-before-publish: task #{idx} {task} fetched operand "
                f"{_operand_tiles(task)[i]} from unpublished producer "
                f"#{producer} {graph.tasks[producer]}")
        if ops[i] is None:
            raise InterleaveViolation(
                f"use-after-release: task #{idx} {task} fetched the value "
                f"of #{producer} {graph.tasks[producer]}, which the executor "
                "had already dropped")
        if cuda:
            src, ev = sources[i]
            want_stream, want_ev = published[producer]
            if src is not stream and (ev is None or ev is not want_ev
                                      or src is not want_stream):
                raise InterleaveViolation(
                    f"cross-stream operand without its producer's event: "
                    f"task #{idx} {task} reads #{producer} "
                    f"{graph.tasks[producer]} from another stream")


def explore(graph: TaskGraph, kernels, config: SchedConfig, *,
            schedule: str = "random", salt: int = 0) -> RunResult:
    """Run one complete interleaving of `graph` under `schedule`, through
    the executor's own fetch, run and publish on `kernels`' device.

    Raises InterleaveViolation on a use-before-publish, double-publish,
    a cross-stream operand without its producer's event, or a scheduler
    deadlock.  Deterministic: the schedule RNG is seeded from (config.seed,
    schedule, salt) only.  On the card the outputs are on the workers'
    streams when this returns, and the caller's stream waits for them.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULES}")
    keys = priority_keys(graph, config)
    # NB: no hash() here -- str hashing is per-process randomized and would
    # break reproducibility-from-config
    rng = random.Random((config.seed * 0x9E3779B1 + salt) * len(SCHEDULES)
                        + SCHEDULES.index(schedule))
    n = graph.n
    run_kernels = _RunKernels(kernels)
    cuda = kernels.device.type == "cuda"
    caller = torch.cuda.current_stream(kernels.device) if cuda else None
    state = _ExecState(graph, keys, run_kernels, config.workers, caller)
    workers = [_Worker(w) for w in range(config.workers)]
    if cuda:
        t0 = torch.cuda.Event()
        t0.record(caller)
        for w in workers:
            w.stream = torch.cuda.Stream(kernels.device)
            w.stream.wait_event(t0)
    outs: list = [None] * n
    published: dict = {}     # producer -> (stream, end event) it published
    dispatch: list[int] = []
    steps: list[tuple[int, str, int]] = []

    def task_key(w: _Worker):
        """Priority key of the task this worker's next step concerns."""
        if w.phase == _POP:
            return state.ready[0]      # the task a pop would take
        return keys[w.task]

    def runnable() -> list[_Worker]:
        return [w for w in workers
                if w.phase != _POP or (state.ready and state.done < n)]

    def pick(cands: list[_Worker]) -> _Worker:
        if schedule == "random":
            return cands[rng.randrange(len(cands))]
        if schedule == "reverse_priority":
            return max(cands, key=lambda w: (task_key(w), w.wid))
        if schedule == "convert_last":
            def is_convert(w):
                idx = state.ready[0][-1] if w.phase == _POP else w.task
                return graph.tasks[idx].kind == "CONVERT"
            return min(cands, key=lambda w: (is_convert(w), w.wid))
        # starve0: worker 0 advances only as the sole runnable worker
        rest = [w for w in cands if w.wid != 0]
        return min(rest or cands, key=lambda w: w.wid)

    guard = 0
    while state.done < n:
        cands = runnable()
        if not cands:
            raise InterleaveViolation(
                f"deadlock: {state.done}/{n} tasks done, ready queue empty, "
                "no worker in flight (cyclic or truncated dependencies)")
        w = pick(cands)
        if w.phase == _POP:
            with state.cond:                      # the worker's pop round
                idx = heapq.heappop(state.ready)[-1]
                _check_arity(graph, idx)
                state.running += 1
                state.dispatch.append(idx)
                ops, sources = _fetch_locked(state, idx)
            _check_operands(graph, idx, ops, sources, w.stream, published,
                            cuda)
            w.task, w.ops, w.sources = idx, ops, sources
            dispatch.append(idx)
            w.phase = _COMPUTE
            steps.append((w.wid, _POP, idx))
        elif w.phase == _COMPUTE:
            ctx = torch.cuda.stream(w.stream) if cuda \
                else contextlib.nullcontext()
            with ctx:
                w.done = _run_task(state, w.stream, graph.tasks[w.task],
                                   w.ops, w.sources, w.pending)
            w.ops = w.sources = None
            w.phase = _PUBLISH
            steps.append((w.wid, _COMPUTE, w.task))
        else:
            idx = w.task
            if idx in published:
                raise InterleaveViolation(
                    f"write-once violation: task #{idx} "
                    f"{graph.tasks[idx]} published twice")
            out, start, end = w.done
            with state.cond:                      # the worker's publish round
                _publish_locked(state, w.wid, w.stream, idx, out, start, end)
                negative = [s for s in graph.succs[idx] if state.ndeps[s] < 0]
            if negative:
                raise InterleaveViolation(
                    f"dependency count of task #{negative[0]} went negative "
                    "(double publish of a producer?)")
            published[idx] = (w.stream, end) if cuda else None
            outs[idx] = out
            w.done = None
            w.phase = _POP
            w.task = -1
            steps.append((w.wid, _PUBLISH, idx))
        guard += 1
        if guard > 3 * n * max(config.workers, 1) + 16:
            raise InterleaveViolation(
                f"stepper did not terminate after {guard} steps "
                f"({state.done}/{n} tasks done)")
    if cuda:
        for ev in state.last_end:
            if ev is not None:
                caller.wait_event(ev)

    return RunResult(schedule=schedule, seed=config.seed, salt=salt,
                     workers=config.workers, signature=tuple(steps),
                     dispatch=tuple(dispatch), values=tuple(outs))


def replay_inorder(graph: TaskGraph, kernels) -> tuple:
    """Sequential reference: execute the task stream in emission order on
    the caller's stream, every output kept."""
    values: list = [None] * graph.n
    for idx in range(graph.n):
        _check_arity(graph, idx)
        task = graph.tasks[idx]
        ops = [values[p] if p >= 0 else kernels.initial(r)
               for r, p in zip(_operand_tiles(task), graph.deps[idx])]
        values[idx] = kernels.run(task, ops)
    return tuple(values)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def bitwise_equal(a, b) -> bool:
    """Same dtype, shape and bits (so -0.0 differs from 0.0, and NaNs with
    the same payload are equal)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.device == b.device and torch.equal(_bits(a), _bits(b))


def values_bitwise_equal(got: tuple, want: tuple) -> list[int]:
    """Indices of tasks whose outputs differ bitwise (empty = equal)."""
    return [i for i, (g, w) in enumerate(zip(got, want))
            if not bitwise_equal(g, w)]


# ---------------------------------------------------------------------------
# the (variant x policy x p) matrix sweep
# ---------------------------------------------------------------------------

#: fast subset: enough concurrency per cell for schedules to diverge, small
#: enough that the CLI gate stays interactive.  The `concurrency` pytest
#: marker runs more (tests/test_torch_concurrency_interleave.py).
FAST_CELLS = (
    ("tile", "full", 3), ("tile", "full", 4),
    ("tile", "mixed", 3), ("tile", "mixed", 4),
    ("tile", "three_tier", 4),
    ("panel", "mixed", 4),
    ("dst", "mixed", 4),
)


def _policies():
    from ...core.precision import PrecisionPolicy
    return {
        "full": PrecisionPolicy.full(),
        "mixed": PrecisionPolicy.tpu(2),
        "three_tier": PrecisionPolicy.three_tier(1, 3),
    }


@dataclasses.dataclass(frozen=True)
class MatrixReport:
    rows: tuple                  # per-(cell, workers) summary dicts
    n_runs: int
    n_distinct: int              # distinct interleaving signatures, summed
    violations: tuple[str, ...]  # stepper invariant failures
    mismatches: tuple[str, ...]  # differences from the sequential replay
    #: per tile cell, the largest ||L - L_engine||_F / ||L_engine||_F of
    #: its runs against core.tile_cholesky, beside the registered bound
    engine_rel: tuple = ()

    @property
    def ok(self) -> bool:
        return not self.violations and not self.mismatches

    def render(self) -> str:
        lines = [(f"interleave: {self.n_runs} runs, {self.n_distinct} "
                  f"distinct interleavings, {len(self.violations)} "
                  f"violations, {len(self.mismatches)} mismatches")]
        for r in self.rows:
            lines.append(
                f"  {r['variant']}/{r['policy']} p={r['p']} W={r['workers']}: "
                f"{r['runs']} runs, {r['distinct']} distinct")
        for e in self.engine_rel:
            lines.append(
                f"  {e['variant']}/{e['policy']} p={e['p']}: max "
                f"{e['max_rel']:.3g} from core.tile_cholesky (bound "
                f"{e['bound']:g})")
        lines += [f"  VIOLATION: {v}" for v in self.violations]
        lines += [f"  MISMATCH: {m}" for m in self.mismatches]
        return "\n".join(lines)


def _frob_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want64 = want.double()
    return float(torch.linalg.norm(got.double() - want64)
                 / torch.linalg.norm(want64))


def run_matrix(cells=FAST_CELLS, *, device, nb: int = 4, seeds: int = 12,
               workers=(2, 3), priority: str = "critical_path",
               base_seed: int = 1) -> MatrixReport:
    """Explore seeded-random + adversarial schedules over `cells` on
    `device` ("cpu" or "cuda").

    Per (cell, worker count): every adversarial schedule once plus `seeds`
    seeded-random runs, each checked for stepper invariants and bitwise
    equality with the in-order sequential replay on the same device (tile
    cells additionally against `core.tile_cholesky` there, within the
    policy's registered factor bound; on the card at an nb mp_syrk cannot
    take, a multiple of 64, the engine runs its plain versions).
    Distinctness is counted on the full step signature within each (cell,
    workers) group.  The POTRF tasks of an fp32 band run the
    `blocked_potrf` kernel on the card.
    """
    device = torch.device(device)
    if device.type != "cpu":
        return _run_matrix(cells, device, nb, seeds, workers, priority,
                           base_seed)
    # the tile ops are a few elements wide: one intra-op thread (the pool's
    # fork and join cost many times the op on a shared host)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _run_matrix(cells, device, nb, seeds, workers, priority,
                           base_seed)
    finally:
        torch.set_num_threads(threads)


def _run_matrix(cells, device, nb, seeds, workers, priority,
                base_seed) -> MatrixReport:
    from ...core.tile_cholesky import assemble_lower, tile_cholesky
    from ...sched.kernels import make_kernels
    from ...verify.bounds import policy_bound
    from ...verify.generators import spd_matrix

    cuda = device.type == "cuda"
    policies = _policies()
    rows, engine_rel = [], []
    violations: list[str] = []
    mismatches: list[str] = []
    n_runs = n_distinct = 0

    for variant, plabel, p in cells:
        policy = policies[plabel]
        graph = build_graph(variant, p, policy)
        a = spd_matrix(p * 7 + nb, p * nb, cond=50.0, device=device)
        kernels = make_kernels(variant, a, nb, policy)
        reference = replay_inorder(graph, kernels)
        engine = bound = None
        worst = 0.0
        if variant == "tile":
            impl = "plain" if cuda and nb % 64 else "kernel"
            engine = tile_cholesky(a, nb, policy, impl=impl)
            bound = policy_bound(policy).factor_rel
        for nw in workers:
            signatures = set()
            runs_here = 0
            for schedule in SCHEDULES:
                salts = range(seeds) if schedule == "random" else range(1)
                for salt in salts:
                    config = SchedConfig(priority=priority, workers=nw,
                                         backend="sim",
                                         seed=base_seed + salt)
                    label = (f"{variant}/{plabel} p={p} W={nw} "
                             f"{schedule}#{salt}")
                    try:
                        res = explore(graph, kernels, config,
                                      schedule=schedule, salt=salt)
                    except InterleaveViolation as e:
                        violations.append(f"{label}: {e}")
                        continue
                    finally:
                        runs_here += 1
                    signatures.add(res.signature)
                    bad = values_bitwise_equal(res.values, reference)
                    if bad:
                        mismatches.append(
                            f"{label}: tasks {bad[:6]} differ from "
                            "sequential replay")
                    elif engine is not None:
                        store = dict(kernels.initial_store())
                        for idx, task in enumerate(graph.tasks):
                            if task.kind != "CONVERT":
                                store[task.target] = res.values[idx]
                        got = assemble_lower(store, p, nb, policy.hi)
                        rel = _frob_rel(got, engine)
                        worst = max(worst, rel)
                        if not rel <= bound:
                            mismatches.append(
                                f"{label}: assembled factor {rel:.3g} from "
                                f"core.tile_cholesky (bound {bound:g})")
            rows.append({"variant": variant, "policy": plabel, "p": p,
                         "workers": nw, "runs": runs_here,
                         "distinct": len(signatures)})
            n_runs += runs_here
            n_distinct += len(signatures)
        if engine is not None:
            engine_rel.append({"variant": variant, "policy": plabel, "p": p,
                               "max_rel": worst, "bound": bound})

    return MatrixReport(rows=tuple(rows), n_runs=n_runs,
                        n_distinct=n_distinct,
                        violations=tuple(violations),
                        mismatches=tuple(mismatches),
                        engine_rel=tuple(engine_rel))
