"""Quickstart: fit a Matern field with the mixed-precision tile Cholesky
and predict held-out values -- the paper's pipeline in a few steps.

The port of `examples/quickstart.py`:

    python -m repro_torch.quickstart                 # on the card
    python -m repro_torch.quickstart --device cpu    # plain versions

The tile size defaults to the example's 32 on the CPU and to 64 on the
card, whose SYRK kernel takes multiples of 64 only.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .core import PrecisionPolicy, fit_mle, krige, make_loglik, pmse
from .covariance import make_dataset

N = 256


def resolve_nb(nb: int | None, device: str) -> int:
    """The tile size of an entry point: the example's 32 on the CPU, 64 on
    the card, where any other value must be a multiple of 64."""
    on_card = torch.device(device).type == "cuda"
    if nb is None:
        return 64 if on_card else 32
    if on_card and nb % 64:
        raise SystemExit(f"--nb {nb}: on the card nb must be a multiple of "
                         "64 (the mp_syrk kernel's tile)")
    return nb


def pipeline(locs, z, *, nb: int):
    """The example's steps on N locations and observations: hold out every
    8th point, fit (theta1, theta2) by maximum likelihood under the
    {fp32 band, bf16 off-band} policy, krige the held-out points.
    Returns (MLEResult, mu, var, held-out PMSE)."""
    new = np.arange(7, N, 8)
    obs = np.setdiff1d(np.arange(N), new)[:(224 // nb) * nb]
    new = torch.as_tensor(new, device=locs.device)
    obs = torch.as_tensor(obs, device=locs.device)

    # maximum-likelihood fit with the paper's mixed-precision factorization
    # (hi=fp32 band around the diagonal, lo=bf16 off-band)
    policy = PrecisionPolicy.tpu(diag_thick=2)
    loglik = make_loglik(locs[obs], z[obs], policy, nb=nb, nu_static=0.5)
    res = fit_mle(lambda th: loglik([th[0], th[1], 0.5]),
                  theta0=[0.7, 0.15], max_iters=60)

    # kriging prediction at unseen locations through the same factorization
    theta_hat = [res.theta[0], res.theta[1], 0.5]
    mu, var = krige(locs[obs], z[obs], locs[new], theta_hat, policy, nb=nb,
                    nu_static=0.5, return_var=True)
    return res, mu, var, float(pmse(mu, z[new]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nb", type=int, default=None,
                    help="tile size (default 32 on the CPU, 64 on the card)")
    args = ap.parse_args(argv)
    nb = resolve_nb(args.nb, args.device)

    # synthetic Matern field (medium correlation), Morton-ordered locations
    gen = torch.Generator(device=args.device).manual_seed(0)
    ds = make_dataset(gen, N, theta0=[1.0, 0.1, 0.5], nu_static=0.5,
                      ordering="morton")
    res, mu, var, score = pipeline(ds.locs, ds.z, nb=nb)
    print(f"theta_hat = ({res.theta[0]:.3f}, {res.theta[1]:.4f})  "
          f"true = (1.0, 0.1)   loglik = {res.loglik:.2f}  "
          f"[{res.n_evals} evaluations]")
    print(f"prediction MSE = {score:.4f}  "
          f"(mean kriging var = {float(var.mean()):.4f})")


if __name__ == "__main__":
    main()
