"""The system under test: `repro_torch`'s panel engine, called as a fit's
caller calls it.  The only module of the benchmark that imports the
program.

One call is `geostat_loglik_step(impl="kernel")`'s three layers in its
order, the covariance built into (band, off) storage, factored in place,
and l read from the factor, so that the comparison can also read the
factor's first t tile rows: the band alone computes them (`lead`)."""

from __future__ import annotations

import math

import torch


def policy(cfg: dict):
    """The configuration's precision policy, held to the dtypes the
    configuration states."""
    from repro_torch.core import PrecisionPolicy
    pol = getattr(PrecisionPolicy, cfg["policy"])(cfg["diag_thick"])
    got = {"hi": pol.hi, "lo": pol.lo, "accum": pol.accum_dtype,
           "solve": pol.solve_dtype}
    for key, dtype in got.items():
        if dtype != getattr(torch, cfg[key]):
            raise ValueError(f"{cfg['policy']}({cfg['diag_thick']}): {key} "
                             f"is {dtype}, the configuration states "
                             f"{cfg[key]}")
    return pol


def lead(band: torch.Tensor, z: torch.Tensor, t: int) -> torch.Tensor:
    """l of the first t nb observations alone, read in fp64 from the
    factored band storage (band[i, d] = tile (i, i - d)): its first t tile
    rows hold no off-band tile, so no low-precision value reaches them."""
    p, _, nb, _ = band.shape
    t = min(t, p)
    ws, logdet = [], 0.0
    for i in range(t):
        acc = z[i * nb:(i + 1) * nb].double()
        for d in range(1, i + 1):
            acc = acc - band[i, d].double() @ ws[i - d]
        lii = band[i, 0].double()
        ws.append(torch.linalg.solve_triangular(lii, acc[:, None],
                                                upper=False)[:, 0])
        logdet = logdet + torch.log(lii.diagonal()).sum()
    w = torch.cat(ws)
    return -0.5 * t * nb * math.log(2.0 * math.pi) - logdet - 0.5 * (w @ w)


def entry(cfg: dict, mix: dict, locs: torch.Tensor, z: torch.Tensor):
    """call(theta) -> (l, l of the first t nb observations), both on the
    host, for the mix's entry ("value")."""
    from repro_torch.core.panel_cholesky import (
        banded_loglik, build_banded_covariance, panel_cholesky_banded)
    if mix["entry"] != "value":
        raise ValueError(f"unknown entry {mix['entry']!r}")
    pol = policy(cfg)
    t = cfg["diag_thick"]

    def call(theta):
        band, off = build_banded_covariance(
            locs, theta, nb=cfg["nb"], policy=pol, nu_static=cfg["nu"],
            metric=cfg["metric"], jitter=cfg["jitter"], impl="kernel")
        band, off, failed = panel_cholesky_banded(
            band, off, pol, off_update=cfg["off_update"], impl="kernel")
        ll = banded_loglik(band, off, z, min(t, band.shape[0]), failed)
        first = lead(band, z, t)
        return float(ll), float(first)
    return call
