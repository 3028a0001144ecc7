"""Static and trace analysis of the tile Cholesky's task graphs.

Counterpart of `repro.analysis`: `dag` extracts each engine variant's
symbolic task DAG and checks it for RAW/WAR/WAW and precision-edge hazards,
with per-tier FLOP and critical-path reports; `concurrency.hb` checks a
recorded schedule of the runtime (`repro_torch.sched`) for happens-before
order.  The reference's precision-flow linter is not ported.
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
