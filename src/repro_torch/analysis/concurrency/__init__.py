"""Concurrency checks of the dynamic task runtime (`repro_torch.sched`).

Counterpart of `repro.analysis.concurrency`'s `hb`: a vector-clock
happens-before model over recorded schedules -- every task must start
after all of its dependencies end, CONVERTs must happen-before their
cross-tier consumers, and any two writes to the same tile slot must be
HB-ordered.  The reference's interleaving model checker and lockset linter
are not ported.
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

__all__ = [
    "HBError",
    "HBReport",
    "HBViolation",
    "verify_events",
    "verify_sched_report",
    "verify_trace",
    "verify_trace_file",
]
