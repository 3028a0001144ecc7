"""Synthetic geostatistical data generation (ExaGeoStat's generator).

Counterpart of `repro.covariance.generator`:

  1. irregular 2-D locations: a sqrt(n) x sqrt(n) grid in (0, 1)^2 perturbed
     by uniform jitter;
  2. measurements Z = L eps with Sigma(theta0) = L L^T from the Matern
     kernel and eps ~ N(0, I).

Randomness comes from an explicit `torch.Generator`; tensors are made on
the generator's device.  The bits differ from `jax.random`'s, so parity
tests hand both packages the same numpy inputs instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .matern import matern_covariance
from .ordering import ORDERINGS, apply_ordering

# simulate_field builds the covariance this many rows at a time
ROWS_PER_CHUNK = 1024


class Dataset(NamedTuple):
    locs: torch.Tensor    # (n, 2)
    z: torch.Tensor       # (n,)
    theta0: torch.Tensor  # generating parameters (3,)
    metric: str


def random_locations(gen: torch.Generator, n: int, *, lo: float = 0.0,
                     hi: float = 1.0, dtype=torch.float32):
    """Irregular perturbed-grid locations in (lo, hi)^2 (ExaGeoStat style)."""
    m = math.ceil(math.sqrt(n))
    dev = gen.device
    xs, ys = torch.meshgrid(torch.arange(m, device=dev),
                            torch.arange(m, device=dev), indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(dtype)
    jitter = torch.rand((m * m, 2), generator=gen, dtype=dtype,
                        device=dev) * 0.8 - 0.4
    locs = (grid + 0.5 + jitter) / m  # in (0, 1)^2
    locs = locs[:n]
    return lo + locs * (hi - lo)


def simulate_field(gen: torch.Generator, locs, theta0, *, nu_static=None,
                   metric="euclidean", nugget: float = 0.0,
                   jitter: float = 1e-8):
    """Draw Z ~ N(0, Sigma(theta0)) exactly via dense Cholesky.

    The covariance is built `ROWS_PER_CHUNK` rows at a time, so the
    pairwise-distance temporaries stay a few rows of the matrix (at
    n = 65536 the whole-matrix temporaries would be several times the
    matrix's 17 GB); the jitter is added to its diagonal in place.
    """
    n = locs.shape[0]
    theta0 = torch.as_tensor(theta0, dtype=locs.dtype, device=locs.device)
    cov = torch.empty((n, n), dtype=locs.dtype, device=locs.device)
    for r0 in range(0, n, ROWS_PER_CHUNK):
        r1 = min(n, r0 + ROWS_PER_CHUNK)
        cov[r0:r1] = matern_covariance(locs[r0:r1], locs, theta0,
                                       nu_static=nu_static, metric=metric)
    if nugget:
        cov.diagonal().add_(nugget)
    cov.diagonal().add_(jitter)
    chol = torch.linalg.cholesky(cov)
    del cov
    eps = torch.randn((n,), generator=gen, dtype=chol.dtype, device=chol.device)
    return chol @ eps


def make_dataset(gen: torch.Generator, n: int, theta0, *, nu_static=None,
                 ordering: str = "morton", metric: str = "euclidean",
                 nugget: float = 0.0) -> Dataset:
    """Locations + field draw + space-filling-curve ordering, one call."""
    locs = random_locations(gen, n)
    theta0 = torch.as_tensor(theta0, dtype=torch.float32, device=gen.device)
    z = simulate_field(gen, locs, theta0, nu_static=nu_static, metric=metric,
                       nugget=nugget)
    perm = ORDERINGS[ordering](locs)
    locs, z = apply_ordering(locs, z, perm)
    return Dataset(locs=locs, z=z, theta0=theta0, metric=metric)


# Paper Sec. VIII-D1: three correlation levels for the synthetic study.
CORRELATION_LEVELS = {
    "weak": (1.0, 0.03, 0.5),
    "medium": (1.0, 0.10, 0.5),
    "strong": (1.0, 0.30, 0.5),
}


# Table-I Matern parameters per wind-speed region (theta1, theta2, theta3).
# R1's row is unreadable in the paper scan; its values are interpolated from
# R2-R4.  theta2 is on the haversine-degrees scale.
WIND_REGIONS = {
    "R1": (11.1, 24.0, 1.30),
    "R2": (12.533, 27.603, 1.270),
    "R3": (10.813, 19.196, 1.417),
    "R4": (12.441, 19.733, 1.119),
}

# (lon_lo, lon_hi, lat_lo, lat_hi) quadrants of [30, 60] x [10, 35]
WIND_BOXES = {
    "R1": (30.0, 45.0, 22.5, 35.0),
    "R2": (45.0, 60.0, 22.5, 35.0),
    "R3": (30.0, 45.0, 10.0, 22.5),
    "R4": (45.0, 60.0, 10.0, 22.5),
}


def wind_like_dataset(gen: torch.Generator, region: str, n: int, *,
                      ordering: str = "morton") -> Dataset:
    """WRF-like wind-speed field for one Arabian-Peninsula subregion.

    Locations are drawn on a lon/lat box roughly matching one quadrant of
    the paper's Fig. 3 domain; distances are haversine (degrees), and the
    smoothness is the region's general nu.
    """
    theta0 = torch.tensor(WIND_REGIONS[region], dtype=torch.float32,
                          device=gen.device)
    lon_lo, lon_hi, lat_lo, lat_hi = WIND_BOXES[region]
    unit = random_locations(gen, n)
    locs = torch.stack([lon_lo + unit[:, 0] * (lon_hi - lon_lo),
                        lat_lo + unit[:, 1] * (lat_hi - lat_lo)], dim=-1)
    z = simulate_field(gen, locs, theta0, metric="haversine", jitter=1e-6)
    # order on the unit-normalized coords
    lmin, lmax = locs.min(0).values, locs.max(0).values
    perm = ORDERINGS[ordering]((locs - lmin) / (lmax - lmin))
    locs, z = apply_ordering(locs, z, perm)
    return Dataset(locs=locs, z=z, theta0=theta0, metric="haversine")
