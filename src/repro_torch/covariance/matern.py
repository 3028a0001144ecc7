"""Matern covariance function (paper Eq. 1) in plain PyTorch.

C(r; theta) = theta1 * 2^(1-nu)/Gamma(nu) * (r/theta2)^nu * K_nu(r/theta2)

with theta = (theta1: variance, theta2: spatial range, theta3 = nu).

Counterpart of `repro.covariance.matern`.  Only the closed forms for the
half-integer smoothnesses nu in {0.5, 1.5, 2.5} are here; the general-nu
Bessel K_nu is still to be ported.
"""

from __future__ import annotations

import math

import torch

HALF_INTEGER_NUS = (0.5, 1.5, 2.5)


def _matern_half_integer(x, nu: float):
    """Closed-form 2^(1-nu)/Gamma(nu) x^nu K_nu(x) for half-integer nu."""
    if nu == 0.5:
        return torch.exp(-x)
    if nu == 1.5:
        return (1.0 + x) * torch.exp(-x)
    if nu == 2.5:
        return (1.0 + x + x * x / 3.0) * torch.exp(-x)
    raise ValueError(f"no closed form for nu={nu}")


def matern(r, theta, *, nu_static: float | None = None):
    """Matern covariance C(r; theta), paper Eq. (1).

    r: distances (any shape); theta = (theta1, theta2, theta3) or a stacked
      (..., 3) batch of parameter vectors whose leading axes broadcast
      against r, giving one covariance per candidate theta.
    nu_static: one of HALF_INTEGER_NUS; the closed form is used and
      theta[..., 2] is ignored.
    """
    if nu_static is None:
        raise NotImplementedError("general-nu kv: ROADMAP A2")
    theta = torch.as_tensor(theta, dtype=r.dtype, device=r.device)
    batch = theta.shape[:-1]

    def param(i):
        return theta[..., i].reshape(batch + (1,) * r.ndim)

    theta1, theta2 = param(0), param(1)
    x = r / theta2
    corr = _matern_half_integer(x, float(nu_static))
    return theta1 * torch.where(r == 0.0, 1.0, corr)


def pairwise_distance(locs_a, locs_b, *, metric: str = "euclidean"):
    """Pairwise distances between (..., n_a, 2) and (..., n_b, 2) locations.

    metric: "euclidean" (synthetic study, unit square) or "haversine"
    (lon/lat degrees; great-circle distance reported in degrees).
    """
    if metric == "euclidean":
        diff = locs_a[..., :, None, :] - locs_b[..., None, :, :]
        d2 = torch.sum(diff ** 2, dim=-1)
        return torch.sqrt(torch.clamp(d2, min=0.0))
    if metric == "haversine":
        lon_a, lat_a = torch.deg2rad(locs_a[..., 0]), torch.deg2rad(locs_a[..., 1])
        lon_b, lat_b = torch.deg2rad(locs_b[..., 0]), torch.deg2rad(locs_b[..., 1])
        dlat = lat_a[..., :, None] - lat_b[..., None, :]
        dlon = lon_a[..., :, None] - lon_b[..., None, :]
        h = (torch.sin(dlat / 2.0) ** 2
             + torch.cos(lat_a)[..., :, None] * torch.cos(lat_b)[..., None, :]
             * torch.sin(dlon / 2.0) ** 2)
        h = torch.clamp(h, 0.0, 1.0)
        # 2 R asin(sqrt(h)) with R = 180/pi: distances in "degrees"
        return 2.0 * (180.0 / math.pi) * torch.arcsin(torch.sqrt(h))
    raise ValueError(f"unknown metric {metric!r}")


def matern_covariance(locs_a, locs_b, theta, *, nu_static: float | None = None,
                      metric: str = "euclidean", nugget: float = 0.0):
    """Dense covariance block Sigma_ab with optional nugget on the diagonal.

    theta may carry leading batch axes (see `matern`); the result is then a
    (..., n_a, n_b) stack of covariance blocks.
    """
    d = pairwise_distance(locs_a, locs_b, metric=metric)
    cov = matern(d, theta, nu_static=nu_static)
    if nugget:
        cov.diagonal(dim1=-2, dim2=-1).add_(nugget)
    return cov
