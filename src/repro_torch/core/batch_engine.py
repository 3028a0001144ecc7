"""Batched mixed-precision likelihood engine.

Counterpart of `repro.core.batch_engine`.  The paper's hot path is repeated
evaluation of the Gaussian log-likelihood: one mixed-precision tile
Cholesky per candidate parameter vector theta.  Evaluating many candidate
thetas at once lets every tile op (POTRF/TRSM/SYRK/GEMM) run with a leading
batch axis, so the device never drains between factorizations.

  * `BatchPlan`   -- what one batch looks like: ONE `PrecisionPolicy` for the
                     whole batch, tile size, evaluation path ("tile" = the
                     faithful Algorithm-1 engine, "panel" = the banded
                     performance path), and an optional chunk size that bounds
                     peak memory (a loop over chunks of batched work).
  * `BatchEngine` -- batched log-likelihood and batched kriging PMSE over a
                     (B, 3) stack of candidate thetas.
  * `BatchResult` -- per-candidate log-likelihoods (+ optional PMSE) and the
                     batch argmax.

The tile path uses the native leading-batch support of
`covariance/matern.py`, `core/tile_cholesky.py`, `core/likelihood.py` and
`core/kriging.py`; the panel path evaluates `geostat_loglik_step` once per
candidate, since its banded storage is factored in place.

Telemetry (`obs`): each public entry point is a `batch.*` span, and
`batch.candidates` counts the candidates evaluated.  The reference jits
its evaluations, so the engines record no span inside them; the port runs
them in `obs.traced()` regions to the same effect.  A live span
synchronizes the device before it closes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .kriging import krige_from_factor, krige_pmse, pmse
from .likelihood import _theta, loglik_from_factor, make_factor_fn, \
    make_loglik, matern_block
from .. import obs
from .mle import _host, _traced
from .panel_cholesky import geostat_loglik_step
from .precision import PrecisionPolicy


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """How a batch of candidate thetas is evaluated.

    One policy per batch: all candidates share the precision policy,
    matching the paper's setup where the precision variant is fixed for a
    whole optimization run.

    `chunk_size` bounds the device memory of the tile path: a chunk holds
    its candidates' Sigma, the factor's storage, one candidate's SYRK
    square U and the factors L, in the policy's dtypes.  On one 80 GB card
    the fp64 policies (full(fp64), the paper_cpu pair) at n = 40,960 take
    chunk_size=1: Sigma alone is 13.4 GB in fp64, so three candidates'
    Sigma with their U and L pass 80 GB.
    """
    policy: PrecisionPolicy
    nb: int = 128                     # tile size
    chunk_size: Optional[int] = None  # None = the whole batch at once
    path: str = "tile"                # "tile" | "panel"
    nu_static: Optional[float] = None
    metric: str = "euclidean"
    nugget: float = 0.0
    jitter: float = 1e-6
    profiled: bool = False
    use_tiles: Optional[bool] = None  # tile path only
    off_update: str = "square"        # panel path only

    def __post_init__(self):
        if self.path not in ("tile", "panel"):
            raise ValueError(f"unknown path {self.path!r}")
        if self.path == "panel" and self.policy.mode == "dst":
            raise ValueError("panel path has no DST variant")
        if self.path == "panel" and (self.nugget or self.profiled
                                     or self.use_tiles is not None):
            raise ValueError(
                "panel path supports neither nugget, profiled, nor "
                "use_tiles -- use path='tile' for those")
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")


@dataclasses.dataclass
class BatchResult:
    """Per-candidate outputs of one batched evaluation."""
    thetas: np.ndarray                 # (B, d)
    logliks: np.ndarray                # (B,)
    pmse: Optional[np.ndarray] = None  # (B,) if the plan scored kriging

    @property
    def best_index(self) -> int:
        finite = np.isfinite(self.logliks)
        if not np.any(finite):
            raise ValueError(
                "every candidate log-likelihood in the batch is non-finite; "
                "the covariance is likely not SPD anywhere in the candidate "
                "set -- there is no meaningful best_theta")
        ll = np.where(finite, self.logliks, -np.inf)
        return int(np.argmax(ll))

    @property
    def best_theta(self) -> np.ndarray:
        return self.thetas[self.best_index]

    @property
    def best_loglik(self) -> float:
        return float(self.logliks[self.best_index])


def chunked(fn: Callable, chunk_size: Optional[int] = None) -> Callable:
    """Wrap a batched fn (leading axis B) to process B in fixed-size chunks.

    The batch is padded (repeating the last element) to a chunk multiple and
    evaluated one chunk at a time, so peak memory is one chunk's worth while
    each chunk stays fully batched; outputs (a tensor or a tuple of them)
    are concatenated and the padding dropped.  With chunk_size=None (or
    >= B) this is `fn` itself.
    """
    if chunk_size is None:
        return fn

    def run(x):
        b = x.shape[0]
        if b <= chunk_size:
            return fn(x)
        pad = (-b) % chunk_size
        if pad:
            x = torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
        outs = [fn(x[i:i + chunk_size]) for i in range(0, x.shape[0],
                                                       chunk_size)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts)[:b] for parts in zip(*outs))
        return torch.cat(outs)[:b]

    return run


class BatchEngine:
    """Batched log-likelihood (+ kriging PMSE) over candidate thetas.

    >>> engine = BatchEngine(locs, z, BatchPlan(policy, nb=64, nu_static=0.5))
    >>> ll = engine.loglik(thetas)          # (B,) from (B, 3)
    >>> res = engine.evaluate(thetas)       # BatchResult with argmax

    Prediction scoring is enabled by passing held-out locations/truth:

    >>> engine = BatchEngine(locs, z, plan, locs_new=s_new, y_true=y)
    >>> res = engine.evaluate(thetas)       # res.pmse per candidate

    Everything computes on the device of `locs`.
    """

    def __init__(self, locs, z, plan: BatchPlan, *, locs_new=None, y_true=None):
        self.plan = plan
        self.locs = locs
        self.z = z
        self.locs_new = locs_new
        self.y_true = y_true

        # the reference's jitted evaluations: no engine span inside
        single = self._build_single_loglik()
        self._loglik_single = _traced(single)
        self._loglik_batch = _traced(chunked(self._batch(single),
                                             plan.chunk_size))

        self._pmse_batch = None
        self._eval_batch = None
        if self.locs_new is not None:
            if self.y_true is None:
                raise ValueError("y_true is required when locs_new is given")
            if plan.profiled:
                raise ValueError(
                    "profiled plans take (theta2, theta3) candidates with "
                    "the variance profiled out, which kriging cannot score; "
                    "use a non-profiled plan (full thetas) with locs_new")
            p = plan
            pol = p.policy if p.policy.mode != "dst" \
                else PrecisionPolicy.full(p.policy.hi)  # DST predicts densely
            # DST's dense fallback must not inherit the tiled override
            pmse_use_tiles = p.use_tiles if p.policy.mode != "dst" else None

            # kriging always factors Sigma_oo through the tile-path
            # selection (krige -> make_factor_fn), also for path="panel"
            # plans: the same covariance model through another numerical
            # path, as in the reference
            def single_pmse(theta):
                return krige_pmse(self.locs, self.z, self.locs_new,
                                  self.y_true, theta, pol, nb=p.nb,
                                  nu_static=p.nu_static, metric=p.metric,
                                  nugget=p.nugget, jitter=p.jitter,
                                  use_tiles=pmse_use_tiles)

            self._pmse_batch = _traced(
                chunked(self._batch(single_pmse), p.chunk_size))
            if p.path == "tile" and p.policy.mode != "dst":
                # the loglik factorization is reused for the kriging
                # solves: one factorization per candidate instead of two
                self._eval_batch = _traced(
                    chunked(self._build_single_eval(), p.chunk_size))

    # ---- plumbing ------------------------------------------------------
    def _build_single_loglik(self) -> Callable:
        p = self.plan
        if p.path == "panel":
            def single(theta):
                return geostat_loglik_step(
                    self.locs, self.z, theta, nb=p.nb, policy=p.policy,
                    nu_static=p.nu_static, metric=p.metric, jitter=p.jitter,
                    off_update=p.off_update)
            return single
        return make_loglik(self.locs, self.z, p.policy, nb=p.nb,
                           nu_static=p.nu_static, metric=p.metric,
                           nugget=p.nugget, jitter=p.jitter,
                           profiled=p.profiled, use_tiles=p.use_tiles)

    def _build_single_eval(self) -> Callable:
        """(.., 3) theta -> (loglik, pmse) sharing ONE factorization."""
        p = self.plan
        pol = p.policy
        # the same factor builder make_loglik uses, so engine.loglik and
        # the fused evaluation never select different paths for one plan
        factor = make_factor_fn(self.locs, pol, nb=p.nb,
                                nu_static=p.nu_static, metric=p.metric,
                                nugget=p.nugget, jitter=p.jitter,
                                use_tiles=p.use_tiles)

        def single(theta):
            l = factor(theta)
            ll = loglik_from_factor(l, self.z)
            sigma_no = matern_block(self.locs_new, self.locs, theta,
                                    nu_static=p.nu_static, metric=p.metric,
                                    dtype=pol.hi)
            mu = krige_from_factor(l, self.z, sigma_no)
            return ll, pmse(mu, self.y_true)

        return single

    def _batch(self, single: Callable) -> Callable:
        # tile-path functions are natively batched over theta's leading
        # axes; the panel path factors its banded storage in place, one
        # candidate at a time
        if self.plan.path == "panel":
            return lambda thetas: torch.stack([single(t) for t in thetas])
        return single

    def _prepare(self, thetas) -> torch.Tensor:
        """Normalize candidates to a (B, 3) stack on the CPU (the kernels
        take theta as launch arguments), in the precision of the locations
        (`likelihood._theta`).  When the plan pins the smoothness
        (`nu_static`, non-profiled), (B, 2) candidates over (variance,
        range) get the pinned nu column appended here."""
        thetas = _theta(thetas, self.locs, "cpu")
        thetas = torch.atleast_2d(thetas)
        if (thetas.shape[-1] == 2 and self.plan.nu_static is not None
                and not self.plan.profiled):
            nu = torch.full(thetas.shape[:-1] + (1,), self.plan.nu_static,
                            dtype=thetas.dtype)
            thetas = torch.cat([thetas, nu], dim=-1)
        return thetas

    # ---- public API ----------------------------------------------------
    # Every public entry point is a dispatch boundary (the host hands a
    # candidate batch to the device and waits for the answer), so each gets
    # a telemetry span + a candidates-evaluated counter when obs is on.
    def loglik(self, thetas) -> torch.Tensor:
        """(B, d) candidate thetas -> (B,) log-likelihoods."""
        thetas = self._prepare(thetas)
        with obs.span("batch.loglik", b=int(thetas.shape[0]),
                      path=self.plan.path) as sp:
            out = self._loglik_batch(thetas)
            if sp is not obs.NULL_SPAN:
                obs.inc("batch.candidates", int(thetas.shape[0]))
                _sync(out)
            return out

    def loglik_sequential(self, thetas) -> np.ndarray:
        """Reference path: one evaluation per candidate with a host sync
        after each, like an optimizer loop calling `float(fn(p))` per
        candidate.  Kept for benchmarks and parity tests."""
        thetas = self._prepare(thetas)
        with obs.span("batch.loglik_sequential", b=int(thetas.shape[0])):
            return np.array([float(self._loglik_single(t)) for t in thetas])

    def krige_pmse(self, thetas) -> torch.Tensor:
        """(B, d) candidate thetas -> (B,) held-out kriging PMSE."""
        if self._pmse_batch is None:
            raise ValueError("engine was built without locs_new/y_true")
        thetas = self._prepare(thetas)
        with obs.span("batch.krige_pmse", b=int(thetas.shape[0])) as sp:
            out = self._pmse_batch(thetas)
            if sp is not obs.NULL_SPAN:
                _sync(out)
            return out

    def evaluate(self, thetas, *, with_pmse: Optional[bool] = None) -> BatchResult:
        """One planned batch: log-likelihoods (+ PMSE when available).

        When the plan allows it, this reuses the likelihood's Cholesky
        factor for the kriging solves (one factorization per candidate
        instead of two)."""
        thetas = self._prepare(thetas)
        if with_pmse is None:
            with_pmse = self._pmse_batch is not None
        with obs.span("batch.evaluate", b=int(thetas.shape[0]),
                      fused=bool(with_pmse and self._eval_batch is not None)):
            if with_pmse and self._eval_batch is not None:
                obs.inc("batch.candidates", int(thetas.shape[0]))
                ll, scores = self._eval_batch(thetas)
                return BatchResult(thetas=_host(thetas), logliks=_host(ll),
                                   pmse=_host(scores))
            ll = _host(self.loglik(thetas))
            scores = _host(self.krige_pmse(thetas)) if with_pmse else None
            return BatchResult(thetas=_host(thetas), logliks=ll, pmse=scores)


def _sync(out):
    """Wait for a live span's result on the card (time the math, not the
    launches)."""
    if out.is_cuda:
        torch.cuda.synchronize(out.device)


def evaluate_batch(locs, z, thetas, plan: BatchPlan, *, locs_new=None,
                   y_true=None) -> BatchResult:
    """One-shot convenience wrapper around `BatchEngine.evaluate`."""
    engine = BatchEngine(locs, z, plan, locs_new=locs_new, y_true=y_true)
    return engine.evaluate(thetas)
