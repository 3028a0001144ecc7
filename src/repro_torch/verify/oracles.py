"""fp64 reference answers and error metrics for the verification stack.

Counterpart of `repro.verify.oracles`, in torch fp64 on the input's device.

Oracle convention: every oracle upcasts the SAME fp32 input matrix the
mixed-precision path factors (rather than rebuilding the covariance in
fp64), so the measured error isolates the factorization/solve chain from
covariance-build rounding.  All metrics are computed in fp64 and returned
as host floats.

Metrics (the quantities the tolerance registry bounds):

  rel_frobenius(l, l_ref)   forward factor error ||L - L_ref||_F / ||L_ref||_F
  backward_error(l, a)      reconstruction error ||L L^T - A||_F / ||A||_F
  loglik_drift(ll, ll_ref)  |ll - ll_ref| / max(1, |ll_ref|)
  pmse_drift(p, p_ref)      |pmse - pmse_ref| / pmse_ref

From n = BLOCKED_N on, `rel_frobenius` and `backward_error` work over row
blocks of BLOCK_ROWS: at n = 40,960 one more n x n fp64 temporary would be
13.4 GB.  The blocked `backward_error` reads the lower triangle of A and
of L L^T and counts each strictly lower block twice, so it takes A
symmetric (a covariance is, bit for bit).
"""

from __future__ import annotations

import math

import torch

BLOCKED_N = 8_192
BLOCK_ROWS = 2_048

_F64 = torch.float64
_TINY = torch.finfo(torch.float64).tiny


# ---------------------------------------------------------------------------
# fp64 reference answers
# ---------------------------------------------------------------------------


def exact_factor(cov):
    """fp64 dense lower Cholesky of (the upcast of) `cov`, on its device;
    all NaN where it is not positive definite (the reference's
    `jnp.linalg.cholesky` convention)."""
    l, info = torch.linalg.cholesky_ex(torch.as_tensor(cov).to(_F64))
    return l.masked_fill_((info != 0)[..., None, None], torch.nan)


def loglik_of_factor(l, z) -> float:
    """Gaussian log-likelihood (paper Eq. 2) in fp64 from an fp64 factor."""
    zz = torch.as_tensor(z, device=l.device).to(_F64)
    n = zz.shape[-1]
    w = torch.linalg.solve_triangular(l, zz[:, None], upper=False)[:, 0]
    return float(-0.5 * n * math.log(2.0 * math.pi)
                 - torch.sum(torch.log(torch.diagonal(l)))
                 - 0.5 * torch.sum(w * w))


def exact_loglik(cov, z) -> float:
    """Exact Gaussian log-likelihood (paper Eq. 2) in fp64."""
    return loglik_of_factor(exact_factor(cov), z)


def exact_kriging_pmse(cov_oo, z_obs, sigma_no, y_true) -> float:
    """Exact kriging PMSE in fp64, independent of the policy machinery.

    cov_oo: (n, n) observed-observed covariance (jitter included);
    sigma_no: (m, n) cross covariance; y_true: (m,) held-out truth.
    """
    a = torch.as_tensor(cov_oo).to(_F64)
    dev = a.device
    z = torch.as_tensor(z_obs, device=dev).to(_F64)
    c = torch.as_tensor(sigma_no, device=dev).to(_F64)
    y = torch.as_tensor(y_true, device=dev).to(_F64)
    mu = c @ torch.linalg.solve(a, z)
    return float(torch.mean((mu - y) ** 2))


# ---------------------------------------------------------------------------
# error metrics
# ---------------------------------------------------------------------------


def _rows(n):
    """Row-block size at n, or None for one dense pass."""
    return BLOCK_ROWS if n >= BLOCKED_N else None


def _rel_dense(a64, r64) -> float:
    num, den = torch.linalg.norm(a64 - r64), torch.linalg.norm(r64)
    return float(num / max(float(den), _TINY))


def rel_frobenius(a, ref) -> float:
    """Relative Frobenius distance ||a - ref||_F / ||ref||_F in fp64 (over
    row blocks from n = BLOCKED_N on)."""
    a, ref = torch.as_tensor(a), torch.as_tensor(ref)
    ref = ref.to(a.device)
    rows = _rows(ref.shape[0])
    if rows is None:
        return _rel_dense(a.to(_F64), ref.to(_F64))
    num = den = 0.0
    for r0 in range(0, ref.shape[0], rows):
        r64 = ref[r0:r0 + rows].to(_F64)
        num += float(torch.sum((a[r0:r0 + rows].to(_F64) - r64) ** 2))
        den += float(torch.sum(r64 ** 2))
    return math.sqrt(num) / max(math.sqrt(den), _TINY)


def backward_error(l, a) -> float:
    """Reconstruction (backward) error ||L L^T - A||_F / ||A||_F in fp64
    (over row blocks from n = BLOCKED_N on, A symmetric there)."""
    l, a = torch.as_tensor(l), torch.as_tensor(a)
    a = a.to(l.device)
    n = l.shape[-1]
    rows = _rows(n)
    if rows is None:
        l64 = l.to(_F64)
        return _rel_dense(l64 @ l64.T, a.to(_F64))
    num = den = 0.0
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        li = l[r0:r1, :r1].to(_F64)                 # row block, lower part
        for c0 in range(0, r1, rows):
            c1 = min(r1, c0 + rows)
            # (L L^T)[r0:r1, c0:c1] sums over k < c1: L is lower triangular
            lj = li if c0 == r0 else l[c0:c1, :c1].to(_F64)
            d = li[:, :c1] @ lj.T
            ab = a[r0:r1, c0:c1].to(_F64)
            w = 1.0 if c0 == r0 else 2.0        # a strictly lower block twice
            num += w * float(torch.sum((d - ab) ** 2))
            den += w * float(torch.sum(ab ** 2))
    return math.sqrt(num) / max(math.sqrt(den), _TINY)


def loglik_drift(ll, ll_ref) -> float:
    """Log-likelihood drift, normalized so it reads like a relative error
    but stays meaningful when ll_ref crosses zero."""
    ll = float(ll)
    ll_ref = float(ll_ref)
    return abs(ll - ll_ref) / max(1.0, abs(ll_ref))


def pmse_drift(p, p_ref) -> float:
    """Relative PMSE drift vs the fp64 exact predictor."""
    return abs(float(p) - float(p_ref)) / max(float(p_ref), _TINY)
