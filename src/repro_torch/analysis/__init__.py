"""Static and trace analysis of the port and its tile Cholesky's task graphs.

Counterpart of `repro.analysis`.  Layer 1 (`lint`): the precision-flow
linter -- dtype discipline over src/repro_torch/ (its Python and
csrc/*.cu) as named, suppressable rules, with a committed `baseline`.
Layer 2 (`dag`): symbolic tile-DAG extraction with RAW/WAR/WAW hazard and
precision-edge checking plus per-tier FLOP / critical-path reports.
Layer 3 (`concurrency`): the lock-discipline linter, the happens-before
checker of recorded schedules, and the interleaving model checker of the
runtime (`repro_torch.sched`).  `python -m repro_torch.analysis --check
[--concurrency]` is the gate.
"""

from .dag import (  # noqa: F401
    DagReport,
    HazardError,
    Task,
    analyze,
    build_dag,
    check_dag,
    dst_dag,
    flop_report,
    generations,
    panel_dag,
    storage_tier,
    successor_map,
    task_dependencies,
    tile_dag,
)
from .lint import Finding, lint_source, lint_tree  # noqa: F401
