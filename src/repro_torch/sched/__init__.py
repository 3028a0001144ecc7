"""Dynamic tile-task runtime: out-of-order Cholesky scheduling.

Counterpart of `repro.sched`, the StarPU layer: consumes the symbolic task
DAGs `analysis.dag` extracts from the tile/panel/DST engines and executes
them with a dependency-counting ready-queue scheduler -- a simulated
virtual-time backend for makespan/utilization studies and a real backend
of worker threads, each on a CUDA stream of its own on the card, whose
factor is the same bit for bit under every schedule.
`python -m repro_torch.sched` schedules one cell and writes a Chrome
trace; `core.tile_cholesky(..., schedule=SchedConfig(...))` is the opt-in
engine hook.
"""

from .config import BACKENDS, PRIORITIES, SchedConfig  # noqa: F401
from .runtime import (  # noqa: F401
    SchedReport,
    TaskEvent,
    TaskGraph,
    build_graph,
    downstream_cost,
    execute,
    policy_desc,
    priority_keys,
    scheduled_cholesky,
    scheduled_tile_cholesky,
    simulate,
    simulate_dag,
)
from .kernels import (  # noqa: F401
    DstKernels,
    KernelSet,
    PanelKernels,
    TileKernels,
    make_kernels,
    tier_dtype,
)
from .trace import (  # noqa: F401
    chrome_trace,
    format_summary,
    load_and_validate,
    summary_rows,
    validate_trace,
    worker_names,
    write_trace,
)
