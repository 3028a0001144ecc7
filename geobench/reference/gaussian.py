"""The plain reference: the Gaussian log-likelihood of a Matern field,
dense, in plain PyTorch.

    l(theta) = -n/2 log(2 pi) - 1/2 log det S - 1/2 z^T S^-1 z,
    S = C(theta) + jitter I,  C_ij = theta1 f_nu(|x_i - x_j| / theta2),

with the closed forms f_nu of nu in {0.5, 1.5, 2.5}, and the scale of the
terms it sums, n/2 log(2 pi) + 1/2 sum_i |log L_ii^2| + 1/2 |L^-1 z|^2
(S = L L^T): l cancels them to a small part at this field's sizes, so a
gap in l is measured against them.

S is rebuilt here from the locations and theta and factored by a blocked
right-looking Cholesky in place (one n x n buffer: 34 GB in fp64 at
n = 65,536).  Everything runs in `dtype` on the locations' device; matrix
products follow torch's TF32 setting, which the caller sets
(`precision`).  Nothing here reads the program under test.
"""

from __future__ import annotations

import contextlib
import math

import torch

BLOCK = 4096   # rows of a block of S and of its factorization


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 matrix products in TF32 (tf32=True) or IEEE fp32 inside the
    block; the previous setting after it."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _shape(x: torch.Tensor, nu: float) -> torch.Tensor:
    """The closed form f_nu(x), f(0) = 1."""
    e = torch.exp(-x)
    if nu == 0.5:
        return e
    if nu == 1.5:
        return (1.0 + x) * e
    if nu == 2.5:
        return (1.0 + x + x * x / 3.0) * e
    raise ValueError(f"the reference has closed forms for nu 0.5, 1.5, 2.5, "
                     f"not {nu}")


def _distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances between 2-D locations, from the coordinates'
    differences."""
    dx = a[:, 0, None] - b[None, :, 0]
    dy = a[:, 1, None] - b[None, :, 1]
    return torch.sqrt(dx * dx + dy * dy)


def covariance(locs, theta, nu, jitter, dtype):
    """S (n, n) in dtype, built BLOCK rows at a time."""
    locs = locs.to(dtype)
    n = locs.shape[0]
    s = torch.empty((n, n), dtype=dtype, device=locs.device)
    for r0 in range(0, n, BLOCK):
        r1 = min(n, r0 + BLOCK)
        s[r0:r1] = theta[0] * _shape(
            _distances(locs[r0:r1], locs) / theta[1], nu)
        s[r0:r1, r0:r1].diagonal().add_(jitter)
    return s


def cholesky_(a: torch.Tensor) -> bool:
    """The lower Cholesky factor of a's lower triangle, in place (the
    strict upper triangle is left as it was); False where a block was not
    positive definite."""
    n = a.shape[0]
    for k0 in range(0, n, BLOCK):
        k1 = min(n, k0 + BLOCK)
        lkk, info = torch.linalg.cholesky_ex(a[k0:k1, k0:k1])
        if int(info):
            return False
        a[k0:k1, k0:k1] = lkk
        if k1 == n:
            break
        x = torch.linalg.solve_triangular(lkk.mT, a[k1:, k0:k1], upper=True,
                                          left=False)
        a[k1:, k0:k1] = x
        for j0 in range(k1, n, BLOCK):   # the trailing lower block columns
            j1 = min(n, j0 + BLOCK)
            a[j0:, j0:j1] -= x[j0 - k1:] @ x[j0 - k1:j1 - k1].mT
    return True


def forward_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L^-1 b for the lower triangle of l, by blocks."""
    n = l.shape[0]
    w = torch.empty_like(b)
    for k0 in range(0, n, BLOCK):
        k1 = min(n, k0 + BLOCK)
        acc = b[k0:k1] - l[k0:k1, :k0] @ w[:k0]
        w[k0:k1] = torch.linalg.solve_triangular(
            l[k0:k1, k0:k1], acc[:, None], upper=False)[:, 0]
    return w


def terms(l, z):
    """(l, the scale of its terms) from the factor's lower triangle, and
    w = L^-1 z."""
    n = l.shape[0]
    w = forward_solve(l, z)
    logs = 2.0 * torch.log(l.diagonal())
    const = 0.5 * n * math.log(2.0 * math.pi)
    quad = 0.5 * (w @ w)
    ll = -const - 0.5 * logs.sum() - quad
    return float(ll), float(const + 0.5 * logs.abs().sum() + quad), w


def loglik(locs, z, theta, *, nu, jitter, dtype=torch.float64):
    """(l(theta), the scale of its terms) in dtype; NaNs where S is not
    positive definite in it."""
    s = covariance(locs, theta, nu, jitter, dtype)
    if not cholesky_(s):
        return math.nan, math.nan
    ll, scale, _ = terms(s, z.to(dtype))
    return ll, scale
