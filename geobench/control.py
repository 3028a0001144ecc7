"""The control of the comparison, and the readings its limits are set from.

The control is the plain reference put in the program's place and computed
one precision step below what the configuration states (`control_entry`):
  the paper pair (fp64 band, IEEE fp32 off-band): the dense reference
    (reference/gaussian.py) in fp32 with TF32 products;
  tpu (IEEE fp32 band, bf16 off-band): the configuration's tile algorithm
    with its bf16 off-band (reference/mixed.py), its fp32 in TF32 products.
A comparison that passes the control cannot tell a program that took that
step from a sound one.

    python3 geobench/control.py --workload <cell> --entry <program|control> \
        --seconds <s> --seeds <n> [<n> ...] [--out <file>]

runs the cell's set-up, a short window and the comparison once for each
seed in one process, with the program's entry or the control's in the
program's place, and prints one JSON line a seed: the compared numbers,
the answers' count and the seconds of each step.  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_kind(cfg: dict) -> str:
    """"dense" (the pair: fp64 -> fp32, IEEE fp32 -> TF32) or "tiled"
    (tpu: IEEE fp32 -> TF32, the bf16 off-band as stated)."""
    if cfg["hi"] == "float64" and cfg["lo"] == "float32":
        return "dense"
    if cfg["hi"] == "float32" and cfg["ieee_fp32"] and cfg["lo"] == "bfloat16":
        return "tiled"
    raise ValueError(f"no control for ({cfg['hi']}, {cfg['lo']})")


def control_entry(cfg: dict, mix: dict, locs, z):
    """The control in the program's place: call(theta) -> (l, l of the
    first t nb observations, or None where the control reads no factor
    by tiles), from the fp32 data in fp32 with TF32 products."""
    import torch
    from geobench.reference import gaussian, mixed
    locs, z = locs.float(), z.float()
    kw = dict(nu=cfg["nu"], jitter=cfg["jitter"], dtype=torch.float32)
    kind = control_kind(cfg)

    def call(theta):
        with gaussian.precision(True):
            if kind == "dense":
                return gaussian.loglik(locs, z, theta, **kw)[0], None
            ll, _, first, _ = mixed.loglik(
                locs, z, theta, nb=cfg["nb"], t=cfg["diag_thick"],
                lo=getattr(torch, cfg["lo"]), **kw)
            return ll, first
    return call


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--entry", required=True, choices=("program", "control"))
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from geobench import harness, program, spec
    if not torch.cuda.is_available():
        print("geobench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload, ROOT)
    make = program.entry if args.entry == "program" else control_entry
    card = harness.card_line()
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            run = harness.measure(cell, seed=seed, seconds=args.seconds,
                                  trace=False, device="cuda:0",
                                  t_start=t_start, make_entry=make)
            line = dict(workload=cell.name, entry=args.entry, seed=seed,
                        card=card, answered=run.answered, failed=run.failed,
                        setup_s=run.setup_s, window_s=run.window_s,
                        peak_gib=run.peak_bytes / 2 ** 30, phases=run.phases,
                        numbers={k: c["value"] for k, c in run.checks.items()})
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
            t_start = time.perf_counter()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
