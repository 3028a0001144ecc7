"""Matern covariance function (paper Eq. 1) in plain PyTorch.

C(r; theta) = theta1 * 2^(1-nu)/Gamma(nu) * (r/theta2)^nu * K_nu(r/theta2)

with theta = (theta1: variance, theta2: spatial range, theta3 = nu).

Counterpart of `repro.covariance.matern`.  K_nu is the modified Bessel
function of the second kind; torch has only K_0 and K_1, so it is computed
here:

  * closed forms for the half-integer smoothnesses nu in {0.5, 1.5, 2.5}
    (exponential x polynomial), which the CUDA kernel also computes;
  * a general-nu path (the real-data regime, nu-hat ~ 1.1-1.4) following
    Numerical Recipes `bessik`: Temme's series for x <= 2 and Steed's CF2
    continued fraction for x > 2, then masked upward recurrence.  Every
    loop has the reference's fixed trip count and runs elementwise over
    the whole tensor.
"""

from __future__ import annotations

import math

import torch

HALF_INTEGER_NUS = (0.5, 1.5, 2.5)

# Static bounds: series/CF iteration counts and max smoothness.
_MAXIT = 80
_NU_MAX_RECURRENCE = 12  # supports nu < 11.5; geostatistics uses nu < 5

# Chebyshev coefficients (Numerical Recipes `beschb`) for
#   gam1(mu) ~ (1/Gamma(1-mu) - 1/Gamma(1+mu)) / (2 mu)
#   gam2(mu) ~ (1/Gamma(1-mu) + 1/Gamma(1+mu)) / 2        for |mu| <= 1/2.
_C1 = (
    -1.142022680371168e0,
    6.5165112670737e-3,
    3.087090173086e-4,
    -3.4706269649e-6,
    6.9437664e-9,
    3.67795e-11,
    -1.356e-13,
)
_C2 = (
    1.843740587300905e0,
    -7.68528408447867e-2,
    1.2719271366546e-3,
    -4.9717367042e-6,
    -3.31261198e-8,
    2.423096e-10,
    -1.702e-13,
    -1.49e-15,
)


def _chebev(coeffs: tuple, x):
    """Chebyshev series evaluation on [-1, 1] (Clenshaw), at x's dtype."""
    d = torch.zeros_like(x)
    dd = torch.zeros_like(x)
    x2 = 2.0 * x
    for c in coeffs[::-1][:-1]:
        d, dd = x2 * d - dd + c, d
    return x * d - dd + 0.5 * coeffs[0]


def _beschb(mu):
    """gam1, gam2, gampl=1/Gamma(1+mu), gammi=1/Gamma(1-mu) for |mu|<=0.5."""
    xx = 8.0 * mu * mu - 1.0
    gam1 = _chebev(_C1, xx)
    gam2 = _chebev(_C2, xx)
    gampl = gam2 - mu * gam1
    gammi = gam2 + mu * gam1
    return gam1, gam2, gampl, gammi


def _kv_temme_series(nu_frac, x):
    """K_mu(x), K_{mu+1}(x) for x <= 2, mu = nu_frac in [-0.5, 0.5]."""
    mu = nu_frac
    x = torch.clamp(x, max=2.0)  # branch-safe clamp (selection is outside)
    pimu = math.pi * mu
    tiny = torch.abs(pimu) < 1e-7
    fact = torch.where(tiny, 1.0, pimu / torch.sin(torch.where(tiny, 1.0, pimu)))
    d = -torch.log(x / 2.0)
    e = mu * d
    tiny = torch.abs(e) < 1e-7
    fact2 = torch.where(tiny, 1.0, torch.sinh(e) / torch.where(tiny, 1.0, e))
    gam1, gam2, gampl, gammi = _beschb(mu)
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    ssum = ff
    e = torch.exp(e)
    p = 0.5 * e / gampl
    q = 0.5 / (e * gammi)
    c = torch.ones_like(x)
    dd = x * x / 4.0
    sum1 = p
    for i in range(1, _MAXIT + 1):
        fi = float(i)
        ff = (fi * ff + p + q) / (fi * fi - mu * mu)
        c = c * dd / fi
        p = p / (fi - mu)
        q = q / (fi + mu)
        ssum = ssum + c * ff
        sum1 = sum1 + c * (p - fi * ff)
    return ssum, sum1 * (2.0 / x)


def _kv_cf2(nu_frac, x):
    """K_mu(x), K_{mu+1}(x) for x > 2 via Steed's CF2 (NR bessik)."""
    mu = nu_frac
    x = torch.clamp(x, min=2.0)  # branch-safe clamp
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    a1 = 0.25 - mu * mu
    ones = torch.ones_like(x)
    q = a1 * ones
    c = a1 * ones
    a = -a1 * ones
    s = 1.0 + q * delh
    eps = torch.finfo(x.dtype).eps
    done = torch.zeros_like(x, dtype=torch.bool)
    for i in range(2, _MAXIT + 1):
        fi = float(i)
        a_n = a - 2.0 * (fi - 1.0)
        c_n = -a_n * c / fi
        qnew = (q1 - b * q2) / a_n
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        dels = q_n * delh_n
        s_n = s + dels
        # freeze all state after convergence: running a fixed-trip-count
        # loop past convergence overflows q1/q2 in fp32 (NR breaks instead)
        keep = done
        a, b, c, d = (torch.where(keep, o, n) for o, n in
                      ((a, a_n), (b, b_n), (c, c_n), (d, d_n)))
        h, delh, q = (torch.where(keep, o, n) for o, n in
                      ((h, h_n), (delh, delh_n), (q, q_n)))
        q1, q2 = torch.where(keep, q1, q2), torch.where(keep, q2, qnew)
        s = torch.where(keep, s, s_n)
        done = done | (torch.abs(dels) < torch.abs(s_n) * eps)
    h = a1 * h
    rkmu = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x) / s
    rk1 = rkmu * (mu + x + 0.5 - h) / x
    return rkmu, rk1


def kv(nu, x):
    """Modified Bessel function of the second kind K_nu(x), elementwise.

    nu: number or tensor broadcastable against x, 0 <= nu <
        _NU_MAX_RECURRENCE - 0.5.  x: tensor, x > 0.  Computed in the
    promoted dtype of nu and x, at least fp32.
    """
    x = torch.as_tensor(x)
    nu = torch.as_tensor(nu, device=x.device)
    dtype = torch.promote_types(torch.promote_types(nu.dtype, x.dtype),
                                torch.float32)
    nu = nu.to(dtype)
    x = torch.clamp(x.to(dtype), min=torch.finfo(dtype).tiny)

    nl = torch.floor(nu + 0.5)  # number of upward-recurrence steps
    mu = nu - nl  # fractional part in [-0.5, 0.5]

    small = x <= 2.0
    rkmu_s, rk1_s = _kv_temme_series(mu, x)
    rkmu_l, rk1_l = _kv_cf2(mu, x)
    rkmu = torch.where(small, rkmu_s, rkmu_l)
    rk1 = torch.where(small, rk1_s, rk1_l)

    # masked upward recurrence K_{mu+i+1} = 2(mu+i)/x K_{mu+i} + K_{mu+i-1}
    xi2 = 2.0 / x
    for i in range(1, _NU_MAX_RECURRENCE):
        take = float(i) <= nl
        rktemp = (mu + float(i)) * xi2 * rk1 + rkmu
        rkmu, rk1 = (torch.where(take, rk1, rkmu),
                     torch.where(take, rktemp, rk1))
    return rkmu


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
    nu_static: if one of HALF_INTEGER_NUS, the closed form is used and
      theta[..., 2] is ignored (the caller promises theta3 == nu_static);
      None takes the general Bessel path with nu = theta[..., 2].
    """
    theta = torch.as_tensor(theta, dtype=r.dtype, device=r.device)
    batch = theta.shape[:-1]

    def param(i):
        return theta[..., i].reshape(batch + (1,) * r.ndim)

    theta1, theta2 = param(0), param(1)
    x = r / theta2
    if nu_static is not None:
        corr = _matern_half_integer(x, float(nu_static))
        return theta1 * torch.where(r == 0.0, 1.0, corr)

    nu = param(2)
    xs = torch.clamp(x, min=1e-30)  # keep kv's domain valid at r == 0
    lognorm = (1.0 - nu) * math.log(2.0) - torch.lgamma(nu)
    corr = torch.exp(lognorm + nu * torch.log(xs)) * kv(nu, xs)
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
