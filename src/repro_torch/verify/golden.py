"""Golden accuracy artifacts: drift fails CI loudly instead of silently.

Counterpart of `repro.verify.golden`.  One committed file per device type
records the conformance sweep's measured metrics:

  golden/accuracy_cpu.json   the default grid (SIZES, nb = 32) on the CPU,
                             where every kernel is its plain version;
  golden/accuracy_cuda.json  chip_smoke.py phase 11 (a)'s grid on the card
                             (CARD_SIZES, nb = 64), through the kernels.

The gate compares a fresh sweep against the file with a slack factor
(default 2x) plus per-metric absolute floors, so

  * genuine accuracy regressions (a kernel edit that doubles factor error)
    fail even while still inside the registry's ~30x envelope, and
  * BLAS/compiler reassociation noise across machines does not flake.

Update flow (after an INTENDED numerical change):

    PYTHONPATH=src python -m repro_torch.verify.golden --update --device cpu
    PYTHONPATH=src python -m repro_torch.verify.golden --update  # the card

then commit the regenerated JSON together with the change that moved the
numbers -- the diff is the reviewable accuracy impact.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

GOLDEN_DIR = Path(__file__).parent / "golden"
# the card's grid: mp_syrk takes nb % 64 == 0, so (128, 256, 384) at nb = 64
# has the default grid's p in {2, 4, 6}
CARD_SIZES = (128, 256, 384)
CARD_NB = 64

# Comparison slack: fresh metric must stay below max(golden * SLACK, floor).
SLACK = 2.0
FLOORS = {
    "factor_rel": 1e-6,
    "backward_rel": 1e-6,
    "loglik_drift": 1e-6,
    "pmse_rel": 1e-4,
    "max_rel": 1e-6,
    "max_abs": 1e-5,
}
_METRICS = tuple(FLOORS)


def golden_path(device="cuda") -> Path:
    """The committed golden file of a device type ("cpu" or "cuda")."""
    return GOLDEN_DIR / f"accuracy_{str(device).split(':')[0]}.json"


def _metric_view(record: dict) -> dict:
    return {k: float(record[k]) for k in _METRICS if k in record}


def save_golden(records, path=None, *, device="cuda") -> Path:
    """Write the sweep's metrics as the new golden artifact."""
    path = golden_path(device) if path is None else Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "format": 1,
        "slack": SLACK,
        "records": {r["id"]: _metric_view(r) for r in records},
    }
    path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    return path


def load_golden(path=None, *, device="cuda") -> dict:
    path = golden_path(device) if path is None else Path(path)
    return json.loads(Path(path).read_text())


def compare_to_golden(records, golden: dict = None, *, slack: float = SLACK,
                      device="cuda") -> list[tuple[str, str]]:
    """(record id, message) for every drift vs the golden artifact (that of
    `device` if none is given).

    Flags three failure classes: a metric exceeding its golden value by
    more than `slack` (accuracy regression), a sweep record missing from
    the golden file (gate doesn't cover it -- regenerate), and a golden
    record missing from the sweep (coverage silently lost).  A non-finite
    metric drifts unless the golden value is non-finite too, and a finite
    one where the golden value is not is a change as well.
    """
    golden = load_golden(device=device) if golden is None else golden
    gold_records = golden["records"]
    drifts = []
    seen = set()
    for rec in records:
        rid = rec["id"]
        seen.add(rid)
        gold = gold_records.get(rid)
        if gold is None:
            drifts.append((rid, "not in golden file -- run --update"))
            continue
        for name, value in _metric_view(rec).items():
            if name not in gold:
                drifts.append((rid, f"metric {name} not in golden file"))
                continue
            if not math.isfinite(gold[name]):
                # a recorded NaN (a policy's known failure on a problem)
                # must stay non-finite; a finite value is a change too
                if math.isfinite(value):
                    drifts.append((rid, f"{name}={value:.3e} is finite, "
                                        f"golden {gold[name]} -- run --update"))
                continue
            limit = max(gold[name] * slack, FLOORS[name])
            if not value <= limit:
                drifts.append((rid, f"{name}={value:.3e} drifted past "
                                    f"golden {gold[name]:.3e} (limit "
                                    f"{limit:.3e})"))
    for rid in gold_records:
        if rid not in seen:
            drifts.append((rid, "golden record missing from sweep -- "
                                "coverage lost"))
    return drifts


def device_grid(device="cuda"):
    """The sweep's problems for a device type: the default grid on the CPU,
    CARD_SIZES at CARD_NB on the card."""
    from .generators import cholesky_problems
    if str(device).startswith("cuda"):
        return cholesky_problems(CARD_SIZES, nb=CARD_NB, device=device)
    return cholesky_problems(device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Golden accuracy gate for the port's conformance sweep.")
    parser.add_argument("--update", action="store_true",
                        help="run the sweep and rewrite the golden file")
    parser.add_argument("--check", action="store_true",
                        help="run the sweep and fail on drift (default)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card, the default) or cpu")
    parser.add_argument("--path", default=None,
                        help="override the golden file location")
    args = parser.parse_args(argv)

    from .conformance import check_records, run_conformance

    records = run_conformance(problems=device_grid(args.device),
                              device=args.device)
    violations = check_records(records)
    for rid, msg in violations:
        print(f"BOUND  {rid}: {msg}", file=sys.stderr)

    if args.update:
        path = save_golden(records, args.path, device=args.device)
        print(f"wrote {len(records)} golden records to {path}")
        return 1 if violations else 0

    golden = load_golden(args.path, device=args.device)
    drifts = compare_to_golden(records, golden)
    for rid, msg in drifts:
        print(f"DRIFT  {rid}: {msg}", file=sys.stderr)
    ok = not violations and not drifts
    print(f"{len(records)} records, {len(violations)} bound violations, "
          f"{len(drifts)} golden drifts")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
