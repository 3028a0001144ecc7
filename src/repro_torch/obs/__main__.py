"""CLI for the telemetry layer.

    python -m repro_torch.obs calibrate [--nb 32 --p 6 --reps 3] [--out PATH]
                                        [--device cuda|cpu]
        Measure per-(kind, tier) tile-task times by replaying an engine
        task graph with the runtime's ops, and persist the table to
        launch/calibration.json (or --out).  After this,
        `SchedConfig(calibrated=True)` prices simulated schedules with
        measured durations instead of analytic weights.  The committed
        table is the card's, at --nb 1024 --p 6.

    python -m repro_torch.obs demo-trace [--out merged-trace.json]
                                         [--device cuda|cpu]
        Run a factorization through the eager tile engine and then the
        task runtime with telemetry on, merge the host-side spans into the
        runtime's Chrome trace, validate it, and print the telemetry
        summary.  Open the file in chrome://tracing or ui.perfetto.dev.

`--device` defaults to cuda, the card; without one the commands raise
rather than run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

# NB: `from . import calibrate` would yield the *function* the package
# __init__ re-exports, not the submodule -- import the function directly.
from . import export, recorder
from .calibrate import calibrate as _calibrate


def _device(name):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("python -m repro_torch.obs: no CUDA device (use "
                           "--device cpu)")
    return device


def _cmd_calibrate(args) -> int:
    path = _calibrate(nb=args.nb, p=args.p, reps=args.reps,
                      variant=args.variant, path=args.out,
                      device=_device(args.device))
    payload = json.loads(path.read_text())
    print(f"calibration: wrote {path}")
    width = max(len(k) for k in payload["costs"])
    for key, us in payload["costs"].items():
        print(f"  {key:<{width}}  {us:>10.1f} us")
    meta = payload["meta"]
    print(f"  ({meta['variant']} variant, p={meta['p']}, nb={meta['nb']}, "
          f"{meta['reps']} reps, backend={meta['backend']}"
          + (f", {meta['nvidia_smi']}" if "nvidia_smi" in meta else "") + ")")
    return 0


def demo_trace(*, p: int = 6, nb: int = 16, workers: int = 4,
               out="merged-trace.json", device="cuda"):
    """The eager tile engine, then the task runtime (critical_path, W =
    `workers`), on an SPD matrix of n = p nb, both under tpu(2) with
    telemetry on; writes the merged Chrome trace to `out` and validates
    it.  Returns (recorder, the runtime's report, the merged trace)."""
    from ..core.precision import PrecisionPolicy
    from ..core.tile_cholesky import tile_cholesky
    from ..sched.config import SchedConfig
    from ..sched.runtime import scheduled_tile_cholesky
    from ..sched.trace import validate_trace
    from ..verify.generators import spd_matrix

    policy = PrecisionPolicy.tpu(2)
    a = spd_matrix(0, p * nb, cond=100.0, device=_device(device))
    config = SchedConfig(priority="critical_path", workers=workers,
                         backend="real")
    with recorder.recording() as rec:
        with recorder.span("demo.engine_pass"):
            tile_cholesky(a, nb, policy)        # eager engine spans
        with recorder.span("demo.scheduled_pass", workers=workers):
            _, report = scheduled_tile_cholesky(a, nb, policy, config)
        trace = export.write_merged_trace(report, rec, out)
        validate_trace(trace)
    return rec, report, trace


def _cmd_demo_trace(args) -> int:
    rec, _, trace = demo_trace(p=args.p, nb=args.nb, workers=args.workers,
                               out=args.out, device=args.device)
    print(export.summary_table(rec))
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    sched_n = sum(1 for e in xs if e["pid"] == 0)
    host_n = sum(1 for e in xs if e["pid"] == export.HOST_PID)
    print(f"demo-trace: wrote + validated {args.out} "
          f"({sched_n} scheduler tasks, {host_n} host spans)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Telemetry: kernel-time calibration + merged-trace demo")
    sub = parser.add_subparsers(dest="cmd", required=True)

    cal = sub.add_parser("calibrate",
                         help="measure + persist per-(kind, tier) task "
                              "times for the scheduler cost model")
    cal.add_argument("--nb", type=int, default=32, help="tile edge")
    cal.add_argument("--p", type=int, default=6, help="tile-grid size")
    cal.add_argument("--reps", type=int, default=3,
                     help="timed replays (median is persisted)")
    cal.add_argument("--variant", default="tile",
                     choices=("tile", "panel", "dst"))
    cal.add_argument("--out", default=None, metavar="PATH",
                     help="write here instead of launch/calibration.json")
    cal.add_argument("--device", default="cuda",
                     help="cuda (the card, default) or cpu")
    cal.set_defaults(fn=_cmd_calibrate)

    demo = sub.add_parser("demo-trace",
                          help="run a scheduled factorization with telemetry "
                               "on and write a merged Chrome trace")
    demo.add_argument("--out", default="merged-trace.json", metavar="PATH")
    demo.add_argument("--p", type=int, default=6)
    demo.add_argument("--nb", type=int, default=16)
    demo.add_argument("--workers", type=int, default=4)
    demo.add_argument("--device", default="cuda",
                      help="cuda (the card, default) or cpu")
    demo.set_defaults(fn=_cmd_demo_trace)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
