"""One run of one cell: set-up, the measured window, the trace's reduction,
the comparison with the reference, the result line.

    run = measure(cell, seed=..., seconds=..., trace=..., device=...,
                  t_start=..., make_entry=program.entry)

`measure` is what run.py drives on the card; the tests drive it on the CPU
at a small configuration, and the control (control.py) with the reference
put in the program's place.
"""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from . import callers, check, data, spec
from . import trace as tracing

# top-level module names no run may hold once its window has closed: JAX,
# and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    answered: int
    failed: int
    peak_bytes: int
    trace: object            # trace.Reduced, or None with --trace 0
    correct: bool
    checks: dict
    phases: dict             # seconds of each step of the run


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def measure(cell: spec.Cell, *, seed: int, seconds: float, trace: bool,
            device, t_start: float, make_entry) -> Run:
    cfg, mix = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False   # IEEE fp32 products
    torch.backends.cudnn.allow_tf32 = False
    phases = {}
    tick = time.perf_counter()
    locs32, z32 = data.make(seed, cfg, device)
    _free(device)
    _sync(device)
    phases["data"] = time.perf_counter() - tick
    dtype = getattr(torch, cfg["locations_dtype"])
    locs, z = locs32.to(dtype), z32.to(dtype)
    thetas = callers.thetas(mix, cfg["theta0"], seed)
    entry = make_entry(cfg, mix, locs, z)
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tick = time.perf_counter()
    entry([float(v) for v in cfg["theta0"]])     # warm-up: every shape
    _sync(device)
    setup_s = time.perf_counter() - t_start
    phases["warm_up"] = time.perf_counter() - tick

    answers = []
    prof = tracing.Profiled() if trace else None
    if prof:
        prof.__enter__()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        answers.append(entry(thetas[len(answers)]))
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tick = time.perf_counter()
    reduced = None
    if prof:
        prof.__exit__(None, None, None)
        reduced = tracing.reduce(prof.events())
    phases["trace"] = time.perf_counter() - tick
    del entry, locs, z, prof
    _free(device)

    # an evaluation whose value is not a number failed, sampled or not:
    # the run is not correct with one (the limit 0 beside the gaps)
    failed = sum(1 for a in answers if not math.isfinite(a[0]))
    sample = callers.check_sample(mix, seed, len(answers))
    tick = time.perf_counter()
    values = check.numbers(cfg, locs32, z32, thetas, answers, sample,
                           cell.limits)
    phases["reference"] = time.perf_counter() - tick
    correct, checks = check.judge(dict(values, failed=failed),
                                  dict(cell.limits, failed=0))
    return Run(cell=cell.name, config=cfg, traffic=mix, setup_s=setup_s,
               window_s=window_s, answered=len(answers), failed=failed,
               peak_bytes=int(peak), trace=reduced,
               correct=correct and bool(sample), checks=checks,
               phases=phases)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result(run: Run, cell: spec.Cell, trace: bool, card: str) -> dict:
    """The result line: the cell's end-to-end metrics (--trace 0) or its
    per-layer ones (--trace 1), each reader's value where it has one."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader("metrics" if trace else "e2e", m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": run.correct, "attempted": run.answered,
           "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.window_s
        out["breakdown"] = tracing.breakdown(run.trace)
    out["card"] = card
    out["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                     for k, c in run.checks.items()}
    return out
