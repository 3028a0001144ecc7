"""Loads what a run needs by the names in BENCHMARK.json: the cell, its
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), its limits (limits/<cell>.json) and the readers
of its metrics (e2e/<metric>.py for the end-to-end ones, metrics/<metric>.py
for the per-layer ones; `reader`).  A later cell or metric is added by
adding files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json entries reported by --trace 0
    per_layer: list       # ... and by --trace 1


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether the cell reports this metric: it is listed in the metric's
    workloads or, without that key, reports the metric it moves (an
    end-to-end metric without the key is every cell's)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(root / cfg_entry["file"]),
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if _applies(m, name, reported)])


def reader(kind: str, name: str):
    """The `read` function of <kind>/<name>.py (kind "e2e" or
    "metrics")."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"geobench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
