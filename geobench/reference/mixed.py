"""The configuration's tile algorithm with its stated rounding points, in
plain PyTorch, for a configuration whose off-band is kept in a lower
precision: in fp64 the reference of `ll_gap_tiled` (check.py), in fp32
with TF32 products the control that control.py puts in the program's
place.

S is cut into nb x nb tiles.  Tiles i - j >= t (the off-band) are held in
`lo`: S's values are rounded to `lo` once built, and every value written
to such a tile afterwards is rounded to `lo` as the configuration states:

  step k   L_kk = chol(S_kk);
           band panel tiles (k < i < k + t): S_ik L_kk^-T;
           off-band panel tiles: S_ik (L_kk rounded to lo)^-T, rounded;
           trailing band tiles (i - j < t): S_ij -= L_ik L_jk^T;
           trailing off-band tiles: S_ij -= (lo(L_ik) lo(L_jk)^T rounded
           to lo), the difference rounded to lo.

Everything else runs in `dtype`, with matrix products as torch's TF32
setting has them.  The factor's first t tile rows hold no off-band tile,
so the band's arithmetic alone makes them.  Nothing here reads the
program under test.
"""

from __future__ import annotations

import math

import torch

from . import gaussian


def _lo(x: torch.Tensor, lo) -> torch.Tensor:
    """x rounded to lo, in x's dtype."""
    return x.to(lo).to(x.dtype)


def factor_(a: torch.Tensor, *, nb: int, t: int, lo) -> bool:
    """a's lower triangle replaced by its factor under the stated rounding
    points, in place (the strict upper triangle is left as it was); False
    where a diagonal tile was not positive definite."""
    n = a.shape[0]
    if n % nb:
        raise ValueError(f"n={n} is not a multiple of nb={nb}")
    p = n // nb
    t = min(t, p)
    for i in range(t, p):                     # S's off-band tiles, stored
        row = a[i * nb:(i + 1) * nb, :(i - t + 1) * nb]
        row.copy_(row.to(lo))
    for k in range(p):
        k0, k1 = k * nb, (k + 1) * nb
        lkk, info = torch.linalg.cholesky_ex(a[k0:k1, k0:k1])
        if int(info):
            return False
        a[k0:k1, k0:k1] = lkk
        if k1 == n:
            break
        b1 = min(p, k + t) * nb               # the panel's band tiles end
        a[k1:b1, k0:k1] = torch.linalg.solve_triangular(
            lkk.mT, a[k1:b1, k0:k1], upper=True, left=False)
        if b1 < n:
            x = torch.linalg.solve_triangular(
                _lo(lkk, lo).mT, a[b1:, k0:k1], upper=True, left=False)
            a[b1:, k0:k1] = x.to(lo)
            del x
        c = a[k1:, k0:k1]                     # tiles (k+1 .., k)
        c_lo = _lo(c, lo)
        for i in range(k + 1, p):
            r0, r1 = i * nb, (i + 1) * nb
            j0 = max(k + 1, i - t + 1) * nb   # the row's band tiles begin
            a[r0:r1, j0:r1] -= c[r0 - k1:r1 - k1] @ c[j0 - k1:r1 - k1].mT
            if j0 > k1:
                u = (c_lo[r0 - k1:r1 - k1] @ c_lo[:j0 - k1].mT).to(lo)
                row = a[r0:r1, k1:j0]
                row.copy_((row - u).to(lo))
                del u
        del c, c_lo
    return True


def loglik(locs, z, theta, *, nu, jitter, nb, t, lo, dtype=torch.float64):
    """(l(theta), the scale of its terms, l of the first t nb observations
    alone, the scale of its terms) by the tile algorithm in dtype with the
    off-band in lo, read from its one factor; NaNs where a diagonal tile is
    not positive definite.  Matrix products follow torch's TF32 setting,
    which the caller sets (gaussian.precision)."""
    s = gaussian.covariance(locs, theta, nu, jitter, dtype)
    if not factor_(s, nb=nb, t=t, lo=lo):
        return (math.nan,) * 4
    z = z.to(dtype)
    m = min(t * nb, s.shape[0])
    return (*gaussian.terms(s, z)[:2], *gaussian.terms(s[:m, :m], z[:m])[:2])
