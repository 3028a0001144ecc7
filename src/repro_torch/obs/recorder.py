"""Thread-safe telemetry recorder: counters, gauges, histograms, spans.

Counterpart of `repro.obs.recorder`, the analogue of StarPU's per-task
profiling hooks (ExaGeoStat ships the same thing behind
`STARPU_PROFILING`): one global `Recorder` that every instrumented layer --
the tile and panel engines, the task runtime, the batch engine and the MLE
loop, the conformance sweep -- writes into when telemetry is on, and that
costs one global read per call site when it is off.

Design constraints:

  * Zero dependencies, stdlib only: torch is never imported here (a guard
    tensor is only asked for `requires_grad`).
  * Near-zero cost when disabled: the module-level `span`/`inc`/`observe`
    helpers check one module global and return a shared no-op object.
    Nothing allocates, nothing locks, nothing synchronizes the device.
  * Instrumentation lives at dispatch boundaries only.  The reference's
    `maybe_span` records nothing inside jit-, vmap- or grad-traced code,
    and the reference traces the batch engine's evaluations, `fit_mle`'s
    evaluation and `fit_mle_adam`'s step.  The port runs those eagerly, so
    it marks the same regions with `traced()`, a per-thread depth: a
    `maybe_span` inside one returns the no-op span.  A guard tensor that
    requires grad (with grad mode on) counts as traced too, as the
    reference's guard array is a tracer under `jax.grad`.  Each call then
    records the reference's spans, no more and no fewer.
  * Spans nest: each recorder keeps a per-thread stack so every finished
    span knows its depth (the Chrome-trace bridge lays depths out as
    separate tracks) and unwinds correctly through exceptions.

Everything the recorder holds is a plain value (floats, strings, dicts),
so exporters (`obs.export`) serialize without touching device tensors.
"""

from __future__ import annotations

import dataclasses
import threading
import time

# Default histogram bucket edges, seconds.  Log-spaced decades from 10 us
# to 100 s: wide enough for one tile op and for a full conformance sweep
# cell.  Prometheus "le" convention: bucket i counts observations with
# value <= edges[i]; one overflow bucket (+Inf) catches the rest.
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)


@dataclasses.dataclass
class Histogram:
    """Fixed-bucket histogram (Prometheus semantics: cumulative `le` edges)."""

    edges: tuple[float, ...] = DEFAULT_BUCKETS

    def __post_init__(self):
        if not self.edges or list(self.edges) != sorted(self.edges):
            raise ValueError(f"bucket edges must be sorted, got {self.edges}")
        self.counts = [0] * (len(self.edges) + 1)   # last = +Inf overflow
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        value = float(value)
        lo, hi = 0, len(self.edges)
        while lo < hi:                     # first edge with value <= edge
            mid = (lo + hi) // 2
            if value <= self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def bucket_rows(self) -> list[tuple[float, int]]:
        """(le_edge, cumulative_count) rows, Prometheus exposition order."""
        rows, cum = [], 0
        for edge, c in zip(self.edges, self.counts):
            cum += c
            rows.append((edge, cum))
        rows.append((float("inf"), self.count))
        return rows

    def as_dict(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "count": self.count, "total": self.total,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None}


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span: wall-clock interval + context."""
    name: str
    start: float               # time.perf_counter() seconds
    end: float
    thread: int                # threading.get_ident() of the running thread
    depth: int                 # nesting depth on that thread (0 = root)
    status: str                # "ok" | "error"
    attrs: dict

    @property
    def duration(self) -> float:
        return self.end - self.start


class _Span:
    """Context manager that records a SpanRecord into its recorder."""

    __slots__ = ("_rec", "name", "attrs", "_start", "_depth")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._depth = self._rec._push()
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        self._rec._pop()
        self._rec._finish(SpanRecord(
            name=self.name, start=self._start, end=end,
            thread=threading.get_ident(), depth=self._depth,
            status="error" if exc_type is not None else "ok",
            attrs=self.attrs))
        return False               # never swallow exceptions


class _NullSpan:
    """Shared no-op span: the entire disabled-mode cost is `with _NULL:`."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class Recorder:
    """Counters + gauges + histograms + spans behind one lock.

    All mutation goes through one `threading.Lock`; the runtime's worker
    threads and the host MLE loop can write concurrently.  Span nesting
    depth is tracked per thread in a `threading.local`, outside the lock
    (each thread only touches its own stack).

    The ``# repro: guarded-by=_lock`` annotations are the reference's, for
    its lockset linter (`analysis.concurrency.lockguard`): mutating an
    annotated attribute outside a ``with self._lock:`` block (or a
    ``*_locked`` method, whose contract is lock-held-by-caller) is a
    finding.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()   # per-thread span stack: lock-free
        self.counters: dict[str, float] = {}      # repro: guarded-by=_lock
        self.gauges: dict[str, float] = {}        # repro: guarded-by=_lock
        self.histograms: dict[str, Histogram] = {}  # repro: guarded-by=_lock
        self.spans: list[SpanRecord] = []         # repro: guarded-by=_lock

    # ---- span plumbing (thread-local, lock-free) -----------------------
    def _push(self) -> int:
        depth = getattr(self._tls, "depth", 0)
        self._tls.depth = depth + 1
        return depth

    def _pop(self) -> None:
        self._tls.depth = getattr(self._tls, "depth", 1) - 1

    def _finish(self, record: SpanRecord) -> None:
        with self._lock:
            self.spans.append(record)
            self._observe_locked(record.name, record.duration)

    # ---- public API ----------------------------------------------------
    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float,
                buckets: tuple[float, ...] | None = None) -> None:
        with self._lock:
            self._observe_locked(name, value, buckets)

    def _observe_locked(self, name, value, buckets=None):
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(buckets or DEFAULT_BUCKETS)
        h.observe(value)

    def snapshot(self) -> dict:
        """Plain-dict copy of everything (for exporters; lock held once)."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: h.as_dict()
                               for k, h in self.histograms.items()},
                "spans": list(self.spans),
            }

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self.spans.clear()


# ---------------------------------------------------------------------------
# global switch -- the one flag every instrumented call site checks
# ---------------------------------------------------------------------------

_ENABLED = False
_RECORDER = Recorder()


def enabled() -> bool:
    """Is telemetry on?  One global read -- safe to call anywhere, often."""
    return _ENABLED


def enable(recorder: Recorder | None = None) -> Recorder:
    """Turn telemetry on (optionally onto a caller-owned recorder)."""
    global _ENABLED, _RECORDER
    if recorder is not None:
        _RECORDER = recorder
    _ENABLED = True
    return _RECORDER


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def get_recorder() -> Recorder:
    return _RECORDER


class recording:
    """`with obs.recording() as rec:` -- enable onto a fresh recorder and
    restore the previous state on exit (benchmarks, tests, CLI runs)."""

    def __init__(self, recorder: Recorder | None = None):
        self._recorder = recorder or Recorder()

    def __enter__(self) -> Recorder:
        self._prev = (_ENABLED, _RECORDER)
        return enable(self._recorder)

    def __exit__(self, exc_type, exc, tb):
        global _ENABLED, _RECORDER
        _ENABLED, _RECORDER = self._prev
        return False


# ---------------------------------------------------------------------------
# traced regions: where the reference's code runs under jit / vmap / grad
# ---------------------------------------------------------------------------

_TRACED = threading.local()


class traced:
    """`with obs.traced():` -- this thread is in a region the reference
    traces (its batch engine's jitted evaluations, `fit_mle(jit=True)`'s
    evaluation, `fit_mle_adam`'s jitted step, a gradient through an
    engine): `maybe_span` records nothing inside.  Nests; costs one
    thread-local update on entry and exit, telemetry on or off."""

    __slots__ = ()

    def __enter__(self):
        _TRACED.depth = getattr(_TRACED, "depth", 0) + 1
        return self

    def __exit__(self, exc_type, exc, tb):
        _TRACED.depth -= 1
        return False


def _is_tracing(guards) -> bool:
    if getattr(_TRACED, "depth", 0):
        return True
    for g in guards:
        if getattr(g, "requires_grad", False):
            import torch   # only reached with telemetry on and a grad guard
            if torch.is_grad_enabled():
                return True
    return False


# ---------------------------------------------------------------------------
# module-level helpers: the instrumented layers call these, not the recorder
# ---------------------------------------------------------------------------

def span(name: str, **attrs):
    """Nestable wall-clock timer; no-op (shared singleton) when disabled."""
    if not _ENABLED:
        return NULL_SPAN
    return _RECORDER.span(name, **attrs)


def maybe_span(name: str, *guard_tensors, **attrs):
    """`span(...)` that degrades to the no-op where the reference's is
    traced: inside a `traced()` region, or when a guard tensor requires
    grad under grad mode (the reference's guard would be a tracer of
    `jax.grad`).  Spans therefore fire only at the reference's dispatch
    boundaries, with its names, attributes and counts."""
    if not _ENABLED:
        return NULL_SPAN
    if _is_tracing(guard_tensors):
        return NULL_SPAN
    return _RECORDER.span(name, **attrs)


def inc(name: str, n: float = 1) -> None:
    if _ENABLED:
        _RECORDER.inc(name, n)


def gauge(name: str, value: float) -> None:
    if _ENABLED:
        _RECORDER.gauge(name, value)


def observe(name: str, value: float,
            buckets: tuple[float, ...] | None = None) -> None:
    if _ENABLED:
        _RECORDER.observe(name, value, buckets)
