"""Concurrency soundness layer of the dynamic task runtime
(`repro_torch.sched`) and the telemetry recorder (`repro_torch.obs`).

Counterpart of `repro.analysis.concurrency`:

  * `hb`         -- vector-clock happens-before model over recorded
    schedules: every task must start after all of its dependencies end,
    CONVERTs must happen-before their cross-tier consumers, and any two
    writes to the same tile slot must be HB-ordered;
  * `lockguard`  -- AST lockset linter enforcing the
    ``# repro: guarded-by=<lock>`` annotation registry, wait-in-a-loop
    condition-variable discipline, and no work for the card (torch calls,
    kernel runs, stream and event calls, host syncs) under the
    scheduler's lock;
  * `interleave` -- deterministic interleaving model checker: the
    executor's own fetch / run / publish re-run under a step-controlled
    cooperative stepper (one CUDA stream per logical worker on the card)
    across seeded-random and adversarial schedules, asserting write-once
    discipline, publish-before-use, producer events on cross-stream
    operands, and bitwise equality with the in-order replay.

All three are wired into ``python -m repro_torch.analysis --check
--concurrency``.
"""

from .hb import (
    HBError,
    HBReport,
    HBViolation,
    verify_events,
    verify_sched_report,
    verify_trace,
    verify_trace_file,
)
from .interleave import (
    FAST_CELLS,
    InterleaveViolation,
    MatrixReport,
    RunResult,
    SCHEDULES,
    explore,
    replay_inorder,
    run_matrix,
)
from .lockguard import (
    LOCKGUARD_FILES,
    LOCKGUARD_RULES,
    lockguard_files,
    lockguard_source,
)

__all__ = [
    "FAST_CELLS",
    "HBError",
    "HBReport",
    "HBViolation",
    "InterleaveViolation",
    "LOCKGUARD_FILES",
    "LOCKGUARD_RULES",
    "MatrixReport",
    "RunResult",
    "SCHEDULES",
    "explore",
    "lockguard_files",
    "lockguard_source",
    "replay_inorder",
    "run_matrix",
    "verify_events",
    "verify_sched_report",
    "verify_trace",
    "verify_trace_file",
]
