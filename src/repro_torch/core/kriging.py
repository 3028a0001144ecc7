"""Kriging prediction + PMSE + k-fold cross validation (paper Sec. VIII-D).

Counterpart of `repro.core.kriging`.  Given observations Z at locations
S_obs and estimated theta-hat, the conditional (kriging) predictor at new
locations S_new is

  mu    = Sigma_no Sigma_oo^{-1} Z
  var   = diag(Sigma_nn - Sigma_no Sigma_oo^{-1} Sigma_on)

computed through the (mixed-precision) Cholesky factor of Sigma_oo.
PMSE over held-out truth y: mean((mu - y)^2), evaluated with k-fold CV
(k = 10 in the paper).  Computed on the device of the locations.
"""

from __future__ import annotations

import numpy as np
import torch

from .likelihood import _theta, make_factor_fn, matern_block
from .precision import PrecisionPolicy


def krige_from_factor(l, z_obs, sigma_no, *, sigma_nn_diag=None):
    """Kriging mean (and variance) given a precomputed Cholesky factor.

    l: (..., n, n) lower factor of Sigma_oo; sigma_no: (..., m, n) cross
    covariance.  Sharing `l` lets callers that already factored Sigma_oo
    for the log-likelihood (the batch engine) skip the second O(n^3)
    factorization.  Returns mu, or (mu, var) when sigma_nn_diag is given.
    """
    # mu = Sigma_no Sigma_oo^{-1} Z  via two triangular solves
    zb = z_obs.to(l.dtype).expand(l.shape[:-2] + z_obs.shape[-1:])
    w = torch.linalg.solve_triangular(l, zb[..., None], upper=False)
    v = torch.linalg.solve_triangular(l, sigma_no.to(l.dtype).mT, upper=False)
    mu = (v.mT @ w)[..., 0]                                   # (..., m)
    if sigma_nn_diag is None:
        return mu
    var = sigma_nn_diag - torch.sum(v * v, dim=-2)
    return mu, var


def krige(locs_obs, z_obs, locs_new, theta, policy: PrecisionPolicy, *,
          nb: int = 128, nu_static=None, metric="euclidean", nugget=0.0,
          jitter=1e-6, use_tiles=None, return_var: bool = False,
          impl: str = "kernel"):
    """Kriging mean (and optionally variance) at locs_new.

    theta may be a single (3,) vector or a stacked (..., 3) batch of
    candidates; the mean (and variance) then carry the same leading axes
    (one mixed-precision factorization per candidate).  `nugget` is added
    to Sigma_oo's diagonal only (never the cross covariance), matching the
    likelihood's observation model.  `use_tiles` overrides the tiled/dense
    factor choice exactly like `make_loglik`'s flag (None = auto), and
    `impl` picks kernels or plain versions as there.
    """
    theta = _theta(theta, locs_obs, "cpu")
    if policy.mode == "dst":
        # DST has no kriging variant; predict densely in hi precision (the
        # same convention the batch engine documents)
        policy, use_tiles = PrecisionPolicy.full(policy.hi), None
    factor = make_factor_fn(locs_obs, policy, nb=nb, nu_static=nu_static,
                            metric=metric, nugget=nugget, jitter=jitter,
                            use_tiles=use_tiles, impl=impl)
    l = factor(theta)
    # Sigma_no: one (m, n) block per candidate
    sigma_no = matern_block(locs_new, locs_obs, theta, nu_static=nu_static,
                            metric=metric, dtype=policy.hi, impl=impl)
    if not return_var:
        return krige_from_factor(l, z_obs, sigma_no)
    sigma_nn_diag = theta[..., 0:1].to(l.device, policy.hi) * torch.ones(
        locs_new.shape[0], dtype=policy.hi, device=l.device)
    return krige_from_factor(l, z_obs, sigma_no, sigma_nn_diag=sigma_nn_diag)


def pmse(mu, y_true):
    """Mean squared prediction error; batched over leading axes of mu."""
    y_true = torch.as_tensor(y_true, device=mu.device).to(mu.dtype)
    return torch.mean((mu - y_true) ** 2, dim=-1)


def krige_pmse(locs_obs, z_obs, locs_new, y_true, theta,
               policy: PrecisionPolicy, *, nb: int = 128, nu_static=None,
               metric="euclidean", nugget=0.0, jitter=1e-6, use_tiles=None,
               impl: str = "kernel"):
    """PMSE of the kriging predictor at locs_new against held-out y_true.

    Batched over leading axes of theta; this is the per-candidate scoring
    function of the batch engine.
    """
    mu = krige(locs_obs, z_obs, locs_new, theta, policy, nb=nb,
               nu_static=nu_static, metric=metric, nugget=nugget,
               jitter=jitter, use_tiles=use_tiles, impl=impl)
    return pmse(mu, y_true)


def kfold_pmse(locs, z, theta, policy: PrecisionPolicy, *, k: int = 10,
               nb: int = 128, nu_static=None, metric="euclidean", seed: int = 0):
    """k-fold cross-validated PMSE (paper uses k=10).

    The folds are the reference's: the same `np.random.default_rng(seed)`
    permutation.  Each training set is trimmed to a multiple of nb for the
    tile path (up to nb - 1 points dropped).
    """
    n = locs.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    fold_size = n // k
    scores = []
    for f in range(k):
        test_idx = perm[f * fold_size:(f + 1) * fold_size]
        train_mask = np.ones(n, dtype=bool)
        train_mask[test_idx] = False
        train_idx = np.nonzero(train_mask)[0]
        m = (len(train_idx) // nb) * nb
        if m == 0:
            raise ValueError("fold too small for tile size")
        tr = torch.as_tensor(train_idx[:m], device=locs.device)
        te = torch.as_tensor(test_idx, device=locs.device)
        mu = krige(locs[tr], z[tr], locs[te], theta, policy, nb=nb,
                   nu_static=nu_static, metric=metric)
        scores.append(float(pmse(mu, z[te])))
    return float(np.mean(scores)), scores
