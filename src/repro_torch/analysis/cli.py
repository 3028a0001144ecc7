"""CLI gate: `python -m repro_torch.analysis --check`.

Counterpart of `repro.analysis.cli`.  Runs the analysis layers and exits
non-zero on any violation:

  1. the precision-flow linter over src/repro_torch/ (its Python and
     csrc/*.cu; findings must be fixed, pragma-suppressed, or baselined
     with a reason);
  2. the tile-DAG hazard checker over every (variant x policy x p) cell of
     the conformance matrix -- tile/panel/dst at p in {1, 4, 8} under the
     full / mixed / three_tier policies -- and the scheduler's simulated
     dispatch orders replayed through it;
  3. with ``--concurrency`` (or ``--concurrency-only``), the concurrency
     soundness layer: the lock-discipline linter over the runtime/recorder
     sources (findings share the lint baseline), the happens-before
     verifier over freshly emitted p=8 schedules plus a Chrome-trace
     round-trip, and the interleaving model checker's fast matrix (>= 200
     distinct interleavings, all bit for bit equal to the in-order replay)
     on ``--device``.

Only the interleaving matrix touches tensors; every other layer is
host-only.  ``--device`` defaults to cuda, the card, and without one the
CLI raises rather than run on the CPU; ``--device cpu`` runs the matrix
there.

Stale baseline entries -- entries no active rule reproduces -- FAIL the
check (someone fixed the finding; the suppression must be removed with
it).  ``--allow-stale-baseline`` downgrades that to a note for transition
windows.  Entries belonging to rules of a layer that did not run (e.g.
lockguard rules without ``--concurrency``) are never counted stale.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .baseline import BASELINE_PATH, load_baseline, split_baselined, update_baseline
from .dag import HazardError, analyze, check_dag
from .lint import RULES as LINT_RULES
from .lint import lint_tree

SRC_ROOT = Path(__file__).resolve().parents[1]   # .../src/repro_torch

DAG_PS = (1, 4, 8)
DAG_VARIANTS = ("tile", "panel", "dst")


def _dag_policies():
    from ..core.precision import PrecisionPolicy
    return {
        "full": PrecisionPolicy.full(),
        "mixed": PrecisionPolicy.tpu(2),
        "three_tier": PrecisionPolicy.three_tier(1, 3),
    }


def _device(name):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("python -m repro_torch.analysis: no CUDA device "
                           "(use --device cpu)")
    return device


def run_lint(root: Path, *, update: bool = False, concurrency: bool = False,
             allow_stale: bool = False) -> int:
    from .concurrency.lockguard import LOCKGUARD_RULES, lockguard_files

    findings = lint_tree(root)
    active_rules = set(LINT_RULES)
    if concurrency:
        findings = findings + lockguard_files(SRC_ROOT)
        active_rules |= set(LOCKGUARD_RULES)
    if update:
        n = update_baseline(findings)
        print(f"baseline: wrote {n} entries to {BASELINE_PATH} "
              "(fill in any TODO reasons before committing)")
        return 0
    try:
        entries = load_baseline()
    except ValueError as e:
        print(f"BASELINE ERROR: {e}")
        return 1
    new, old, unused = split_baselined(findings, entries)
    for f in new:
        print(f"LINT: {f.render()}")
    # An unused entry is stale only if its rule actually ran this
    # invocation -- lockguard entries are not stale in a lint-only run.
    stale = [e for e in unused if e["rule"] in active_rules]
    for e in stale:
        print(f"{'note' if allow_stale else 'STALE BASELINE'}: entry no "
              f"finding reproduces (fixed? remove it): "
              f"{e['rule']} {e['path']} {e['code']!r}")
    print(f"lint: {len(findings)} findings "
          f"({len(old)} baselined, {len(new)} new), "
          f"{len(stale)} stale baseline entries over {root}")
    return 1 if new or (stale and not allow_stale) else 0


def run_dag(*, verbose: bool = False, as_json: bool = False) -> int:
    rows, failures = [], 0
    for variant in DAG_VARIANTS:
        for label, policy in _dag_policies().items():
            for p in DAG_PS:
                try:
                    rep = analyze(variant, p, policy, label=label)
                except HazardError as e:
                    print(f"DAG HAZARD: {e}")
                    failures += 1
                    continue
                fr = rep.tier_fractions()
                rows.append({
                    "variant": variant, "policy": label, "p": p,
                    "tasks": rep.n_tasks, "converts": rep.n_converts,
                    "hi_frac": round(fr.get("hi", 0.0), 4),
                    "lo_frac": round(fr.get("lo", 0.0), 4),
                    "lo2_frac": round(fr.get("lo2", 0.0), 4),
                    "critical_path_tasks": rep.critical_path_tasks,
                    "critical_path_flops_nb3": round(
                        rep.critical_path_flops, 3),
                })
    if as_json:
        print(json.dumps(rows, indent=2))
    elif verbose:
        hdr = ("variant", "policy", "p", "tasks", "converts",
               "hi_frac", "lo_frac", "lo2_frac", "critical_path_tasks")
        print(" ".join(f"{h:>12}" for h in hdr))
        for r in rows:
            print(" ".join(f"{r[h]!s:>12}" for h in hdr))
    checked = len(rows) + failures
    print(f"dag: {checked} (variant, policy, p) cells checked, "
          f"{failures} hazard/policy violations")
    return 1 if failures else 0


def run_sched_replay() -> int:
    """Replay dynamic-scheduler dispatch orders through the hazard checker.

    For every matrix cell and every ready-queue priority, run the
    simulated scheduler (pure Python, no numerics) and feed the actual
    dispatch order -- a dependency-respecting permutation of the emission
    order -- back through `check_dag`'s protocol state machine.  An
    out-of-order execution the runtime would perform must itself be
    hazard-free and precision-consistent, worker count notwithstanding.
    """
    from ..sched.config import PRIORITIES, SchedConfig
    from ..sched.runtime import build_graph, simulate

    checked, failures = 0, 0
    for variant in DAG_VARIANTS:
        for label, policy in _dag_policies().items():
            for p in DAG_PS:
                graph = build_graph(variant, p, policy)
                for priority in PRIORITIES:
                    cfg = SchedConfig(priority=priority, workers=4,
                                      backend="sim")
                    rep = simulate(graph, cfg)
                    reordered = [graph.tasks[i] for i in rep.dispatch_order]
                    checked += 1
                    try:
                        check_dag(reordered, p, policy, variant,
                                  label=f"{label}/sched:{priority}")
                    except HazardError as e:
                        print(f"SCHED REPLAY HAZARD: {e}")
                        failures += 1
    print(f"sched-replay: {checked} (variant, policy, p, priority) dispatch "
          f"orders replayed, {failures} hazard violations")
    return 1 if failures else 0


#: HB gate cells: every variant under a representative policy pack, at the
#: conformance sweep's largest p.  dst graphs only exist under a dst policy.
HB_P = 8
HB_PRIORITIES = ("fifo", "critical_path")
HB_SEEDS = (0, 7)

#: floor on distinct interleavings the model checker must explore
INTERLEAVE_DISTINCT_MIN = 200


def _hb_cells():
    from ..core.precision import PrecisionPolicy
    return (
        ("tile", "full", PrecisionPolicy.full()),
        ("tile", "mixed", PrecisionPolicy.tpu(2)),
        ("tile", "three_tier", PrecisionPolicy.three_tier(1, 3)),
        ("panel", "mixed", PrecisionPolicy.tpu(2)),
        ("dst", "dst", PrecisionPolicy.dst(2)),
    )


def run_concurrency(*, device, verbose: bool = False) -> int:
    """Concurrency soundness gate: HB-verify fresh schedules + one trace
    round-trip (host-only), then the interleaving model checker's fast
    matrix on `device`."""
    from ..sched.config import SchedConfig
    from ..sched.runtime import build_graph, simulate
    from ..sched.trace import chrome_trace, validate_trace
    from .concurrency.hb import verify_sched_report, verify_trace
    from .concurrency.interleave import run_matrix

    failures = 0

    # --- happens-before over freshly emitted schedules --------------------
    checked = 0
    for variant, plabel, policy in _hb_cells():
        graph = build_graph(variant, HB_P, policy)
        for priority in HB_PRIORITIES:
            for seed in HB_SEEDS:
                cfg = SchedConfig(priority=priority, workers=4,
                                  backend="sim", seed=seed)
                rep = verify_sched_report(simulate(graph, cfg), graph)
                checked += 1
                if verbose:
                    print(f"  {variant}/{plabel}/{priority}/seed={seed}: "
                          f"{rep.n_events} events, {rep.n_dep_edges} dep + "
                          f"{rep.n_po_edges} po edges, "
                          f"{rep.n_write_pairs} write pairs")
                if not rep.ok:
                    print(f"HB VIOLATION ({variant}/{plabel}/{priority}/"
                          f"seed={seed}):\n{rep.render()}")
                    failures += 1
    # round-trip one cell through the Chrome-trace JSON path the artifact
    # check uses (otherData metadata -> graph reconstruction)
    graph = build_graph("tile", HB_P, _hb_cells()[1][2])
    trace = chrome_trace(simulate(graph, SchedConfig(workers=4)))
    validate_trace(trace)
    rep = verify_trace(trace)     # graph rebuilt from otherData
    checked += 1
    if not rep.ok:
        print(f"HB VIOLATION (trace round-trip):\n{rep.render()}")
        failures += 1
    print(f"hb: {checked} recorded schedules verified "
          f"(p={HB_P}, {len(_hb_cells())} cells x priorities x seeds + "
          f"trace round-trip), {failures} with violations")

    # --- interleaving model checker ---------------------------------------
    matrix = run_matrix(device=device)
    if verbose or not matrix.ok:
        print(matrix.render())
    else:
        print(f"interleave: {matrix.n_runs} runs, {matrix.n_distinct} "
              f"distinct interleavings on {device}, all bitwise-equal to "
              f"sequential replay")
    if not matrix.ok:
        failures += 1
    if matrix.n_distinct < INTERLEAVE_DISTINCT_MIN:
        print(f"INTERLEAVE: only {matrix.n_distinct} distinct interleavings "
              f"explored (< {INTERLEAVE_DISTINCT_MIN}); raise seeds/cells")
        failures += 1
    return 1 if failures else 0


def run_hb_trace(path: Path) -> int:
    """Verify one recorded Chrome trace file (the artifact gate)."""
    from .concurrency.hb import HBError, verify_trace_file

    try:
        rep = verify_trace_file(path)
    except (HBError, OSError, ValueError, KeyError) as e:
        print(f"HB TRACE ERROR: {path}: {e}")
        return 1
    print(rep.render())
    return 0 if rep.ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Precision-flow linter + tile-DAG hazard checker "
                    "(+ concurrency soundness layer)")
    parser.add_argument("--check", action="store_true",
                        help="run both layers, exit non-zero on violations "
                             "(default action)")
    parser.add_argument("--lint-only", action="store_true")
    parser.add_argument("--dag-only", action="store_true")
    parser.add_argument("--sched-replay-only", action="store_true",
                        help="only replay scheduler dispatch orders through "
                             "the hazard checker")
    parser.add_argument("--concurrency", action="store_true",
                        help="also run the concurrency soundness layer "
                             "(lockguard + happens-before + interleavings)")
    parser.add_argument("--concurrency-only", action="store_true",
                        help="run only the concurrency soundness layer")
    parser.add_argument("--hb-trace", type=Path, metavar="PATH",
                        help="verify one recorded Chrome trace file with the "
                             "happens-before checker and exit")
    parser.add_argument("--root", type=Path, default=SRC_ROOT,
                        help="package root to lint (default: src/repro_torch)")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite baseline.json from current findings "
                             "(keeps existing reasons)")
    parser.add_argument("--allow-stale-baseline", action="store_true",
                        help="downgrade stale baseline entries from a "
                             "failure to a note")
    parser.add_argument("--verbose", action="store_true",
                        help="print the per-cell DAG report table")
    parser.add_argument("--json", action="store_true",
                        help="emit the DAG report as JSON")
    parser.add_argument("--device", default="cuda",
                        help="where the interleaving matrix runs: cuda (the "
                             "card, the default; raises without one) or cpu")
    args = parser.parse_args(argv)
    device = _device(args.device)

    if args.hb_trace is not None:
        return run_hb_trace(args.hb_trace)

    rc = 0
    if args.sched_replay_only:
        rc = run_sched_replay()
        if rc == 0:
            print("static analysis: OK")
        return rc
    if args.concurrency_only:
        # lockguard findings gate through the shared lint baseline
        rc = run_lint(args.root, update=args.update_baseline,
                      concurrency=True,
                      allow_stale=args.allow_stale_baseline)
        if not args.update_baseline:
            rc |= run_concurrency(device=device, verbose=args.verbose)
        if rc == 0:
            print("static analysis: OK")
        return rc
    if not args.dag_only:
        rc |= run_lint(args.root, update=args.update_baseline,
                       concurrency=args.concurrency,
                       allow_stale=args.allow_stale_baseline)
    if not args.lint_only and not args.update_baseline:
        rc |= run_dag(verbose=args.verbose, as_json=args.json)
        rc |= run_sched_replay()
        if args.concurrency:
            rc |= run_concurrency(device=device, verbose=args.verbose)
    if rc == 0:
        print("static analysis: OK")
    return rc
