"""Full geostatistics workflow: DP vs mixed-precision vs DST tapering.

The port of `examples/geostat_mle.py`: simulate, order, estimate with each
precision policy, validate prediction accuracy.  Estimation runs on the
batched evaluation engine (core/batch_engine.py): a coarse batched grid
search (every refinement level is one engine call over the whole candidate
grid) seeds a speculative batched Nelder-Mead polish.

    python -m repro_torch.geostat_mle [--n 256] [--level medium]   # card
    python -m repro_torch.geostat_mle --device cpu                 # plain
"""

from __future__ import annotations

import argparse

import torch

from .core import (BatchEngine, BatchPlan, PrecisionPolicy, fit_mle,
                   fit_mle_grid, kfold_pmse)
from .covariance import CORRELATION_LEVELS, make_dataset
from .quickstart import resolve_nb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--nb", type=int, default=None,
                    help="tile size (default 32 on the CPU, 64 on the card)")
    ap.add_argument("--level", choices=list(CORRELATION_LEVELS),
                    default="medium")
    ap.add_argument("--ordering", choices=["morton", "hilbert", "none"],
                    default="morton")
    ap.add_argument("--grid", type=int, default=8,
                    help="grid-search resolution per parameter (batch = grid^2)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="engine chunk size (bounds peak memory; None = one "
                    "batch)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    nb = resolve_nb(args.nb, args.device)

    theta0 = CORRELATION_LEVELS[args.level]
    gen = torch.Generator(device=args.device).manual_seed(1)
    ds = make_dataset(gen, args.n, theta0, nu_static=0.5,
                      ordering=args.ordering)
    p = args.n // nb

    policies = {
        "DP(100%)            ": PrecisionPolicy.full(torch.float32),
        "DP(10%)-SP(90%)     ": PrecisionPolicy.from_dp_percent(p, 0.10),
        "DP(40%)-SP(60%)     ": PrecisionPolicy.from_dp_percent(p, 0.40),
        "three-tier fp32/bf16/fp8": PrecisionPolicy.three_tier(1, max(2, p // 2)),
        "DST DP(70%)-Zero    ": PrecisionPolicy.dst(
            PrecisionPolicy.from_dp_percent(p, 0.70).diag_thick),
    }

    print(f"n={args.n} level={args.level} true theta=({theta0[0]}, "
          f"{theta0[1]}, {theta0[2]}) ordering={args.ordering}")
    print(f"{'variant':28s} {'var_hat':>8s} {'range_hat':>10s} "
          f"{'loglik':>10s} {'evals':>6s} {'pmse':>8s}")
    for name, pol in policies.items():
        engine = BatchEngine(ds.locs, ds.z,
                             BatchPlan(policy=pol, nb=nb, nu_static=0.5,
                                       chunk_size=args.chunk))
        # stage 1: batched grid search over (variance, range); the engine
        # appends the pinned nu column to (B, 2) candidates itself
        coarse = fit_mle_grid(engine.loglik, [(0.2, 5.0), (0.02, 0.6)],
                              num=args.grid, refine=2)
        # stage 2: speculative batched Nelder-Mead polish from the incumbent
        res = fit_mle(None, coarse.theta, max_iters=50,
                      batched_loglik_fn=engine.loglik)
        n_evals = coarse.n_evals + res.n_evals
        score, _ = kfold_pmse(ds.locs, ds.z, [res.theta[0], res.theta[1], 0.5],
                              pol if pol.mode != "dst"
                              else PrecisionPolicy.full(torch.float32),
                              k=4, nb=nb, nu_static=0.5)
        print(f"{name:28s} {res.theta[0]:8.3f} {res.theta[1]:10.4f} "
              f"{res.loglik:10.2f} {n_evals:6d} {score:8.4f}")


if __name__ == "__main__":
    main()
