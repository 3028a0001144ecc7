"""Per-task virtual cost of the tile Cholesky's tasks.

Counterpart of the part of `repro.launch.costmodel` that the runtime
(`repro_torch.sched`) reads: the simulated backend's clock and the
critical_path priority price every task with `task_virtual_cost`.

The analytic weights are the reference's model units -- tile-op FLOPs in
nb^3 units scaled by a per-tier throughput weight (fp32 ~6x bf16, fp8
~0.5x) of a TPU's matrix unit -- not a measurement of the H100.  They only
order the ready queue and drive the simulated backend.  A measured table
("KIND/tier" -> microseconds) is read from CALIBRATION_PATH when
`calibrated=True`: the committed one holds the card's task times, measured
with CUDA events by `python -m repro_torch.obs calibrate --nb 1024 --p 6`
(its `meta` names the card and its power limit).  Without a table (a
missing file and none injected with `set_calibration`) that raises
FileNotFoundError.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..analysis.dag import _FLOP_UNITS

# the reference's matrix-unit throughput weights relative to bf16
TIER_WEIGHT = {"hi": 6.0, "lo": 1.0, "lo2": 0.5}

# measured per-(kind, tier) task times of the card, written by
# `repro_torch.obs.calibrate`
CALIBRATION_PATH = Path(__file__).resolve().parent / "calibration.json"

_UNSET = object()
_calibration_cache: object = _UNSET   # dict | None once resolved


def load_calibration(path=None) -> dict | None:
    """Read a calibration table; returns its costs dict or None if absent.

    With no `path`, reads (and caches) the CALIBRATION_PATH table.  Costs
    map "KIND/tier" ("CONVERT" flat) -> measured microseconds; any key a
    DAG emits that the table lacks falls back to the analytic weight
    inside `task_virtual_cost`.
    """
    global _calibration_cache
    if path is not None:
        return json.loads(Path(path).read_text())["costs"]
    if _calibration_cache is _UNSET:
        if CALIBRATION_PATH.exists():
            _calibration_cache = json.loads(
                CALIBRATION_PATH.read_text())["costs"]
        else:
            _calibration_cache = None
    return _calibration_cache


def set_calibration(costs: dict | None) -> None:
    """Inject a cost table (tests / sweeps); None drops back to the file."""
    global _calibration_cache
    _calibration_cache = _UNSET if costs is None else dict(costs)


# Default virtual duration of a CONVERT (dlag2s/sconv2d) in the same
# bf16-equivalent nb^3 units as the compute weights: an nb x nb tile moves
# ~nb^2 bytes against ~nb^3-scale math, so a quarter unit keeps it visible
# on the critical path without dominating it.
CONVERT_COST_UNITS = 0.25


def task_virtual_cost(task, *, convert_cost: float = CONVERT_COST_UNITS,
                      calibrated: bool = False,
                      table: dict | None = None) -> float:
    """Virtual duration of one `analysis.dag.Task`.

    Analytic path (default): tile-op FLOP units (POTRF 1/3, TRSM/SYRK 1,
    GEMM 2) scaled by TIER_WEIGHT; CONVERTs cost a flat `convert_cost`.

    Calibrated path (`calibrated=True`): measured microseconds from the
    CALIBRATION_PATH table (or an injected `table`).  Keys the table lacks
    fall back to the analytic weight.  Raises FileNotFoundError when no
    table exists at all rather than silently pricing an "analytically
    calibrated" schedule.
    """
    if calibrated:
        costs = table if table is not None else load_calibration()
        if costs is None:
            raise FileNotFoundError(
                f"calibrated=True but no calibration table at "
                f"{CALIBRATION_PATH} (inject one via set_calibration)")
        key = "CONVERT" if task.kind == "CONVERT" \
            else f"{task.kind}/{task.tier}"
        if key in costs:
            return float(costs[key])
    if task.kind == "CONVERT":
        return float(convert_cost)
    return _FLOP_UNITS[task.kind] * TIER_WEIGHT[task.tier]
