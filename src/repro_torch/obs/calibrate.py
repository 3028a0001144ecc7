"""Kernel-time calibration: measure per-(kind, tier) tile-task times.

Counterpart of `repro.obs.calibrate`.  The simulated scheduler backend
prices every task with `launch.costmodel.task_virtual_cost` -- analytic
matrix-unit weights of a TPU (fp32 ~6x bf16, fp8 ~0.5x), not the card the
port runs on.  The StarPU move: measure the per-kind task times once,
persist them, and let the simulator consume measured durations instead.

Measurement strategy (the reference's): replay one engine task graph in
order with the runtime's own per-task ops (`sched.kernels.KernelSet`,
exactly the math `execute()` runs per task), so the operands are real
factorization intermediates at their real dtypes and every (kind, tier)
pair the DAG emits shows up with its true operand mix.  One warm-up
replay builds and caches everything; `reps` timed replays follow; the
table stores the per-pair median in microseconds.

How a task is timed depends on the device:

  * on the card, by a pair of CUDA events recorded on the current stream
    around the task's ops, read after a synchronization that follows every
    task.  The reference times the XLA CPU backend's compute on the host
    clock around `block_until_ready`; on the card a host clock would add
    the launch latency (5-20 us) to tasks of tens of microseconds.  On a
    stream left idle by that synchronization the events would still count
    the host's time to enqueue the task's ops, so a spin kernel
    (`torch.cuda._sleep`, SPIN_US) holds the stream first: the host
    enqueues the start event, the ops and the end event behind it, and
    the events bracket device work only.  `meta` records the longest
    enqueue, which must stay under the spin.  The simulated backend prices
    device work, and the runtime's real backend reports CUDA-event times
    too, so the table is in the same units as the schedules it is compared
    with;
  * on the CPU, by `time.perf_counter()` around the task, as the reference.

The default cell (tile variant, mixed {fp32, bf16} policy tpu(2), p = 6)
emits every execution pair the three engines use: POTRF/hi, TRSM/hi,
TRSM/lo, SYRK/hi, GEMM/hi, GEMM/lo, and CONVERT.  (lo2 is a storage tier
only; `task_virtual_cost` keeps the analytic weight for any key a table
lacks.)

The persisted table lives at `launch/calibration.json`, next to the cost
model that reads it (`task_virtual_cost(..., calibrated=True)`).  The one
committed there was measured on the card with `python -m repro_torch.obs
calibrate --nb 1024 --p 6`; its `meta` names the card and its power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from pathlib import Path

from . import recorder as obs

# device time the spin kernel holds the stream before each timed task
SPIN_US = 10_000.0


def cost_key(task) -> str:
    """Calibration-table key for one `analysis.dag.Task`."""
    return "CONVERT" if task.kind == "CONVERT" else f"{task.kind}/{task.tier}"


def _spin_cycles(device) -> int:
    """SM clock cycles of SPIN_US at the card's peak clock."""
    import torch

    khz = torch.cuda.get_device_properties(device).clock_rate
    return int(SPIN_US * khz / 1e3)


def _replay_timed(graph, kernels, samples: dict[str, list[float]] | None,
                  enqueue_us: list | None = None):
    """In-order replay of `graph`, timing each task; mirrors `execute()`'s
    operand fetch so every op sees the tensors the executor would.  On the
    card `enqueue_us` collects the host's time to enqueue each task."""
    import torch

    cuda = kernels.device.type == "cuda"
    if cuda:
        spin = _spin_cycles(kernels.device)
    values: list = [None] * graph.n
    for idx, task in enumerate(graph.tasks):
        reads = task.reads if task.kind != "CONVERT" else (task.target,)
        ops = [values[prod] if prod >= 0 else kernels.initial(r)
               for r, prod in zip(reads, graph.deps[idx])]
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)     # the host enqueues behind it
            t0 = time.perf_counter()
            start.record()
            out = kernels.run(task, ops)
            end.record()
            if enqueue_us is not None:
                enqueue_us.append((time.perf_counter() - t0) * 1e6)
            end.synchronize()
            us = start.elapsed_time(end) * 1e3
        else:
            t0 = time.perf_counter()
            out = kernels.run(task, ops)
            us = (time.perf_counter() - t0) * 1e6
        values[idx] = out
        if samples is not None:
            samples.setdefault(cost_key(task), []).append(us)


def _card_meta(device) -> dict:
    """The card's name and what `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints for it."""
    import torch

    index = torch.device(device).index or 0
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(index), "nvidia_smi": smi}


def measure_kernel_times(*, nb: int = 32, p: int = 6, reps: int = 3,
                         variant: str = "tile", policy=None, seed: int = 0,
                         device="cuda") -> tuple[dict[str, float], dict]:
    """Measure per-(kind, tier) tile-task times; returns (costs_us, meta).

    costs_us maps "KIND/tier" (CONVERT: flat "CONVERT") to the median
    measured microseconds across `reps` in-order replays of the cell's task
    graph (one unmeasured warm-up replay first), on `device`: the card by
    default, which must be there (a missing card raises).
    """
    import torch

    from ..core.precision import PrecisionPolicy
    from ..sched.kernels import make_kernels
    from ..sched.runtime import build_graph
    from ..verify.generators import spd_matrix

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("measure_kernel_times: no CUDA device (pass "
                           "device='cpu' to calibrate the CPU)")
    policy = policy or PrecisionPolicy.tpu(2)
    n = p * nb
    a = spd_matrix(seed, n, cond=100.0, device=device)
    graph = build_graph(variant, p, policy)
    kernels = make_kernels(variant, a, nb, policy)

    with obs.span("obs.calibrate", variant=variant, p=p, nb=nb, reps=reps):
        _replay_timed(graph, kernels, None)          # warm-up
        samples: dict[str, list[float]] = {}
        enqueue: list[float] = []
        for _ in range(reps):
            _replay_timed(graph, kernels, samples, enqueue)

    costs = {k: statistics.median(v) for k, v in sorted(samples.items())}
    meta = {
        "units": "microseconds",
        "variant": variant,
        "policy_mode": policy.mode,
        "p": p,
        "nb": nb,
        "reps": reps,
        "backend": device.type,
        "n_samples": {k: len(v) for k, v in sorted(samples.items())},
    }
    if device.type == "cuda":
        meta.update(_card_meta(device), timing="cuda events behind a spin",
                    spin_us=SPIN_US, max_enqueue_us=round(max(enqueue), 1))
    else:
        meta["timing"] = "perf_counter"
    return costs, meta


def write_calibration(costs: dict[str, float], meta: dict,
                      path=None) -> Path:
    """Persist the measured cost table where the cost model reads it."""
    from ..launch.costmodel import CALIBRATION_PATH, set_calibration

    path = Path(path) if path is not None else CALIBRATION_PATH
    payload = {"meta": meta, "costs": {k: round(v, 3)
                                       for k, v in costs.items()}}
    path.write_text(json.dumps(payload, indent=2) + "\n")
    if path == CALIBRATION_PATH:
        set_calibration(None)    # drop the cache so the new table is read
    return path


def calibrate(*, nb: int = 32, p: int = 6, reps: int = 3,
              variant: str = "tile", policy=None, path=None,
              device="cuda") -> Path:
    """Measure + persist in one call (the `python -m repro_torch.obs
    calibrate` entry point).  Returns the path written."""
    costs, meta = measure_kernel_times(nb=nb, p=p, reps=reps,
                                       variant=variant, policy=policy,
                                       device=device)
    return write_calibration(costs, meta, path)
