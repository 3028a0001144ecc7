"""Scheduler configuration -- validated the way `PrecisionPolicy` is.

Counterpart of `repro.sched.config`.  A `SchedConfig` fully determines a
schedule given a task DAG: the priority policy orders the ready queue,
`workers` sets the worker pool (virtual workers, or OS threads, each with
its own CUDA stream on the card), and the cost knobs feed the simulated
backend's virtual clock.  Everything is validated eagerly in ``__post_init__`` so a typo'd
policy name fails at construction, not three layers down inside a worker
thread.
"""

from __future__ import annotations

import dataclasses

from ..launch.costmodel import CONVERT_COST_UNITS

#: ready-queue priority policies:
#:   fifo          -- emission order, the sequential engines' order
#:   panel_first   -- right-looking lookahead: factor panel k+1 before
#:                    draining step k's trailing updates (StarPU's
#:                    priority hint in ExaGeoStat)
#:   critical_path -- longest downstream weighted path first
PRIORITIES = ("fifo", "panel_first", "critical_path")

BACKENDS = ("sim", "real")


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    priority: str = "critical_path"   # one of PRIORITIES
    workers: int = 4                  # worker pool size W (>= 1)
    backend: str = "real"             # "real" threads | "sim" virtual time
    convert_cost: float = CONVERT_COST_UNITS  # sim CONVERT duration (units)
    trace_path: str | None = None     # write Chrome trace JSON here if set
    calibrated: bool = False          # price tasks with the measured
                                      # launch/calibration.json table
                                      # instead of the analytic weights
    seed: int = 0                     # deterministic tie-breaking seed:
                                      # 0 = emission-order ties (the
                                      # historical order); any other value
                                      # permutes equal-priority ties with a
                                      # seeded shuffle -- a run is
                                      # reproducible from the config alone

    def __post_init__(self):
        if not isinstance(self.seed, int) or isinstance(self.seed, bool) \
                or self.seed < 0:
            raise ValueError(
                f"seed must be a non-negative int, got {self.seed!r}")
        if not isinstance(self.calibrated, bool):
            raise ValueError(
                f"calibrated must be a bool, got {self.calibrated!r}")
        if self.priority not in PRIORITIES:
            raise ValueError(
                f"unknown scheduler priority {self.priority!r}; "
                f"expected one of {PRIORITIES}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown scheduler backend {self.backend!r}; "
                f"expected one of {BACKENDS}")
        if not isinstance(self.workers, int) or self.workers < 1:
            raise ValueError(f"workers must be an int >= 1, got {self.workers!r}")
        if not (self.convert_cost >= 0.0):   # also rejects NaN
            raise ValueError(
                f"convert_cost must be >= 0, got {self.convert_cost!r}")
