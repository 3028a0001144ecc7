"""The benchmark of the PyTorch / CUDA port, one run of one cell.

    python3 geobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port under src/.  It draws the
cell's data and requests from the seed on the card, warms up, calls the
cell's entry in a closed loop for the given seconds, checks a sample of the
answers against the plain reference, and prints the result as one JSON
line last on standard output, after the compared numbers and their limits
last on standard error.  With --trace 1 the window runs under the profiler
and the line carries the per-layer metrics.  It exits non-zero, with no
result, without CUDA or with fewer cards than the cell asks for, or when
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# every cache of the program and of the libraries it loads at fixed paths
# inside the checkout (the kernels build into build/repro_torch_kernels/,
# which the program fixes there itself)
CACHE = ROOT / "build" / "geobench"
CACHE_DIRS = {"TRITON_CACHE_DIR": CACHE / "triton",
              "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
              "CUDA_CACHE_PATH": CACHE / "cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHE_DIRS.items():
        os.environ[key] = str(path)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from geobench import harness, program, spec

    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"geobench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = harness.card_line()
    run = harness.measure(cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda:0",
                          t_start=T_START, make_entry=program.entry)
    line = harness.result(run, cell, bool(args.trace), card)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"geobench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(f"geobench: {args.workload} seed {args.seed}: {run.answered} "
          f"evaluations in {run.window_s:.3f} s, {run.failed} failed, "
          f"card {card}; seconds: setup {run.setup_s:.3f}, "
          + ", ".join(f"{k} {v:.3f}" for k, v in run.phases.items()),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
