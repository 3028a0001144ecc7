"""Wind-speed kriging over the Arabian-Peninsula-like domain (paper
Table I workflow): simulate a region's field from its Table-I Matern
parameters (general nu, haversine distance), re-estimate them, and
cross-validate the prediction.

The port of `examples/wind_prediction.py`:

    python -m repro_torch.wind_prediction --region R2          # card
    python -m repro_torch.wind_prediction --device cpu         # plain
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .core import PrecisionPolicy, fit_mle, kfold_pmse, krige, make_loglik
from .covariance import WIND_REGIONS, wind_like_dataset
from .quickstart import resolve_nb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--region", choices=list(WIND_REGIONS), default="R2")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--nb", type=int, default=None,
                    help="tile size (default 32 on the CPU, 64 on the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    nb = resolve_nb(args.nb, args.device)

    gen = torch.Generator(device=args.device).manual_seed(5)
    ds = wind_like_dataset(gen, args.region, args.n)
    theta0 = ds.theta0.cpu().numpy().astype(np.float64)
    print(f"region {args.region}: n={args.n}, true theta = "
          f"({theta0[0]:.3f}, {theta0[1]:.3f}, {theta0[2]:.3f}) "
          f"[haversine degrees]")

    pol = PrecisionPolicy.from_dp_percent(args.n // nb, 0.10)
    ll = make_loglik(ds.locs, ds.z, pol, nb=nb, metric="haversine")
    res = fit_mle(ll, theta0 * np.array([0.8, 0.8, 1.0]), max_iters=50)
    print(f"MP DP(10%)-SP(90%) estimate: ({res.theta[0]:.3f}, "
          f"{res.theta[1]:.3f}, {res.theta[2]:.3f})  "
          f"[{res.n_evals} likelihood evaluations]")

    score, folds = kfold_pmse(ds.locs, ds.z, res.theta, pol, k=4, nb=nb,
                              metric="haversine")
    print(f"4-fold PMSE = {score:.4f} (per fold: "
          f"{', '.join(f'{s:.4f}' for s in folds)})")

    # predict on a small grid for a "map"
    obs = slice(0, (args.n // nb - 1) * nb)
    lo, hi = ds.locs.min(0).values.cpu(), ds.locs.max(0).values.cpu()
    gx, gy = np.meshgrid(np.linspace(float(lo[0]), float(hi[0]), 8),
                         np.linspace(float(lo[1]), float(hi[1]), 8))
    grid = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1),
                           dtype=torch.float32, device=ds.locs.device)
    mu = krige(ds.locs[obs], ds.z[obs], grid, res.theta, pol, nb=nb,
               metric="haversine")
    print("kriged field (8x8 grid):")
    for row in mu.reshape(8, 8).cpu().numpy():
        print("  " + " ".join(f"{v:6.2f}" for v in row))


if __name__ == "__main__":
    main()
