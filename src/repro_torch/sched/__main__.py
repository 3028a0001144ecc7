"""CLI: schedule one (variant, policy, p) cell and optionally emit a trace.

    python -m repro_torch.sched --variant tile --policy mixed --p 8 \
        --workers 4 --priority critical_path --trace sched-trace.json

Defaults to the simulated backend (no numerics); `--backend real` runs the
executor on a synthetic SPD problem of n = p * nb
(`verify.generators.spd_matrix`) on `--device` (default cuda: the card,
whose kernels take nb a multiple of 64; `--device cpu` runs the plain
versions).  With no card, `--backend real` raises rather than run on the
CPU.
"""

from __future__ import annotations

import argparse
import sys

from .config import PRIORITIES, SchedConfig
from .runtime import scheduled_tile_cholesky, simulate_dag
from .trace import format_summary, load_and_validate


def _policies():
    from ..core.precision import PrecisionPolicy
    return {
        "full": PrecisionPolicy.full(),
        "mixed": PrecisionPolicy.tpu(2),
        "three_tier": PrecisionPolicy.three_tier(1, 3),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.sched",
        description="Dynamic tile-Cholesky scheduler: run one cell, "
                    "print the summary, optionally write a Chrome trace")
    parser.add_argument("--variant", default="tile",
                        choices=("tile", "panel", "dst"))
    parser.add_argument("--policy", default="mixed",
                        choices=sorted(_policies()))
    parser.add_argument("--p", type=int, default=8, help="tile-grid size")
    parser.add_argument("--nb", type=int, default=None,
                        help="tile edge (real backend problem size = p*nb); "
                             "default 16 on the CPU, 64 on the card")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--priority", default="critical_path",
                        choices=PRIORITIES)
    parser.add_argument("--backend", default="sim", choices=("sim", "real"))
    parser.add_argument("--device", default="cuda",
                        help="real backend: the device of the problem")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="write (and validate) Chrome trace JSON here; "
                             "open in chrome://tracing or ui.perfetto.dev")
    args = parser.parse_args(argv)

    policy = _policies()[args.policy]
    config = SchedConfig(priority=args.priority, workers=args.workers,
                         backend=args.backend, trace_path=args.trace)
    if args.backend == "sim":
        report = simulate_dag(args.variant, args.p, policy, config)
    else:
        import torch

        from ..verify.generators import spd_matrix

        if args.variant != "tile":
            print("real backend CLI supports --variant tile", file=sys.stderr)
            return 2
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("python -m repro_torch.sched --backend real: "
                               "no CUDA device (use --device cpu)")
        nb = args.nb or (64 if device.type == "cuda" else 16)
        a = spd_matrix(0, args.p * nb, cond=100.0, device=device)
        _, report = scheduled_tile_cholesky(a, nb, policy, config)
    print(format_summary(report))
    if args.trace:
        load_and_validate(args.trace)
        print(f"trace: wrote + validated {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
