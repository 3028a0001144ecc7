"""Maximum likelihood estimation driver (paper Sec. IV-C).

Counterpart of `repro.core.mle`: Nelder-Mead in log-parameter space, a
host loop around the likelihood evaluation.  The evaluation count is kept
so that the paper's "MP needs more iterations on strongly-correlated data"
observation can be reproduced.  `fit_mle_adam` is the gradient path: Adam
on the negative log-likelihood, its gradient from torch.autograd through
the whole evaluation.

`neldermead` and `fit_mle` also accept a batched function that evaluates
the initial simplex, the speculative reflection/expansion/contraction
triple and shrink steps in single calls; `fit_mle_grid` is the batched
iterative grid search.  A batched function may return a tensor on any
device.

Telemetry (`obs`): each fit is an `mle.fit` span and counts in
`mle.fits`; with telemetry on, each evaluation lands one sample in the
`mle.eval_seconds` (`mle.eval_batch_seconds` for a batched call)
histogram and its `.calls` counter.  Where the reference jits the
evaluation (`fit_mle(jit=True)`, `fit_mle_adam`'s step), the port runs it
in an `obs.traced()` region: the engines record no span inside it.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import obs


def _host(values) -> np.ndarray:
    """Values of a batched evaluation (a tensor on any device, or array
    like) as a float64 numpy array."""
    if isinstance(values, torch.Tensor):
        values = values.detach().to("cpu", torch.float64)
    return np.asarray(values, dtype=np.float64)


def _traced(fn: Callable) -> Callable:
    """fn run in an `obs.traced()` region: where the reference calls its
    jitted counterpart, which records no engine span."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with obs.traced():
            return fn(*args, **kwargs)
    return run


def _timed_eval(fn: Callable | None, metric: str) -> Callable | None:
    """Wrap an optimizer's (host-side, blocking) evaluation function so each
    call lands one latency sample in the `metric` histogram.  Identity when
    telemetry is off -- the optimizer hot loop pays nothing."""
    if fn is None or not obs.enabled():
        return fn

    def timed(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        obs.observe(metric, time.perf_counter() - t0)
        obs.inc(metric + ".calls")
        return out

    return timed


@dataclass
class MLEResult:
    theta: np.ndarray
    loglik: float
    n_evals: int
    n_iters: int
    converged: bool
    history: list


def neldermead(fn: Callable, x0, *, xtol: float = 1e-3, ftol: float = 1e-6,
               max_iters: int = 200, scale: float = 0.25,
               fn_batch: Callable | None = None):
    """Minimize fn, a host function of a numpy vector.

    Returns (x_best, f_best, n_evals, n_iters, converged, history).

    fn_batch: optional (B, d) -> (B,) batched version of fn.  When given,
    the initial simplex and shrink steps run as single batched calls, and
    each iteration evaluates the reflection, expansion and contraction
    candidates together in one call.  That spends 3 evaluations per
    iteration where the sequential path often needs 1, so it pays off only
    when per-call overhead dominates.  The accepted point is the sequential
    algorithm's either way.
    """
    x0 = np.asarray(x0, dtype=np.float64)
    # per-evaluation latency histograms (mle.eval_seconds /
    # mle.eval_batch_seconds): each fn call returns a host value, the
    # paper's "time per iteration" unit
    fn = _timed_eval(fn, "mle.eval_seconds")
    fn_batch = _timed_eval(fn_batch, "mle.eval_batch_seconds")
    d = x0.size
    pts = [x0] + [x0 + scale * np.eye(d)[i] for i in range(d)]
    simplex = np.stack(pts)
    if fn_batch is not None:
        fvals = np.asarray(fn_batch(simplex), dtype=np.float64)
    else:
        fvals = np.array([float(fn(p)) for p in simplex])
    n_evals = d + 1
    history = []

    alpha, gamma, rho, sigma = 1.0, 2.0, 0.5, 0.5
    converged = False
    it = 0
    for it in range(1, max_iters + 1):
        order = np.argsort(fvals)
        simplex, fvals = simplex[order], fvals[order]
        history.append((simplex[0].copy(), fvals[0]))
        if (np.max(np.abs(simplex[1:] - simplex[0])) < xtol
                and np.max(np.abs(fvals[1:] - fvals[0])) < ftol):
            converged = True
            break
        centroid = simplex[:-1].mean(axis=0)
        xr = centroid + alpha * (centroid - simplex[-1])
        xe = centroid + gamma * (xr - centroid)
        xc = centroid + rho * (simplex[-1] - centroid)
        if fn_batch is not None:
            fr, fe, fc = np.asarray(
                fn_batch(np.stack([xr, xe, xc])), dtype=np.float64)
            n_evals += 3
        else:
            fr = float(fn(xr)); n_evals += 1
            fe = fc = None
        if fvals[0] <= fr < fvals[-2]:
            simplex[-1], fvals[-1] = xr, fr
        elif fr < fvals[0]:
            if fe is None:
                fe = float(fn(xe)); n_evals += 1
            if fe < fr:
                simplex[-1], fvals[-1] = xe, fe
            else:
                simplex[-1], fvals[-1] = xr, fr
        else:
            if fc is None:
                fc = float(fn(xc)); n_evals += 1
            if fc < fvals[-1]:
                simplex[-1], fvals[-1] = xc, fc
            else:  # shrink
                if fn_batch is not None:
                    simplex[1:] = simplex[0] + sigma * (simplex[1:] - simplex[0])
                    fvals[1:] = np.asarray(fn_batch(simplex[1:]),
                                           dtype=np.float64)
                    n_evals += d
                else:
                    for i in range(1, d + 1):
                        simplex[i] = simplex[0] + sigma * (simplex[i] - simplex[0])
                        fvals[i] = float(fn(simplex[i])); n_evals += 1
    order = np.argsort(fvals)
    return simplex[order][0], fvals[order][0], n_evals, it, converged, history


def fit_mle(loglik_fn: Callable | None, theta0, *, xtol: float = 1e-3,
            max_iters: int = 200, jit: bool = True,
            batched_loglik_fn: Callable | None = None) -> MLEResult:
    """Derivative-free MLE: maximize loglik over positive theta.

    loglik_fn: theta (numpy float64 vector) -> log-likelihood (a float or a
    0-d tensor on any device).  theta0: initial (theta1, theta2, theta3).
    Optimization runs on log(theta) so positivity is free; a non-finite
    log-likelihood (a factorization that failed) counts as 1e10.

    jit: the reference's flag for jitting loglik_fn; here each evaluation
    runs in an `obs.traced()` region, so telemetry records the engine spans
    the reference records (none) -- the values are the same either way.

    batched_loglik_fn: optional (B, d) thetas -> (B,) log-likelihoods; it
    enables the speculative batched Nelder-Mead (see `neldermead`), and then
    loglik_fn may be None.
    """
    theta0 = np.asarray(theta0, dtype=np.float64)

    neg_batch = None
    if batched_loglik_fn is not None:
        def neg_batch(xs):
            v = _host(batched_loglik_fn(np.exp(np.asarray(xs))))
            return np.where(np.isfinite(v), -v, 1e10)

    if loglik_fn is None:
        if neg_batch is None:
            raise ValueError("need loglik_fn or batched_loglik_fn")

        def neg_ll_log(x):  # scalar evaluation through the batched fn
            return float(neg_batch(np.asarray(x)[None])[0])
    else:
        ll = _traced(loglik_fn) if jit else loglik_fn

        def neg_ll_log(x):
            v = float(ll(np.exp(np.asarray(x))))
            return 1e10 if not np.isfinite(v) else -v

    with obs.span("mle.fit", driver="neldermead",
                  batched=neg_batch is not None):
        x, f, n_evals, n_iters, conv, hist = neldermead(
            neg_ll_log, np.log(theta0), xtol=xtol, max_iters=max_iters,
            fn_batch=neg_batch)
    obs.inc("mle.fits")
    return MLEResult(theta=np.exp(x), loglik=-f, n_evals=n_evals,
                     n_iters=n_iters, converged=conv,
                     history=[(np.exp(h[0]), -h[1]) for h in hist])


def fit_mle_grid(batched_loglik_fn: Callable, bounds, *, num: int = 12,
                 refine: int = 3, shrink: float = 0.4) -> MLEResult:
    """Batched iterative grid search: maximize loglik over positive theta.

    Every refinement level evaluates the FULL `num**d` candidate grid in one
    batched call (`batched_loglik_fn`: (B, d) -> (B,)), then recenters a
    log-space grid of `shrink` x the previous span on the incumbent: `refine`
    host round-trips in all (one per level) instead of one per candidate.

    bounds: sequence of (lo, hi) per parameter, in theta space (positive);
    the grid is laid out in log space like the NM driver.
    """
    bounds = np.asarray(bounds, dtype=np.float64)
    if bounds.ndim != 2 or bounds.shape[1] != 2 or np.any(bounds <= 0.0):
        raise ValueError("bounds must be (d, 2) with positive entries")
    batched_loglik_fn = _timed_eval(batched_loglik_fn,
                                    "mle.eval_batch_seconds")
    d = bounds.shape[0]
    lo0, hi0 = np.log(bounds[:, 0]), np.log(bounds[:, 1])
    lo, hi = lo0.copy(), hi0.copy()
    best_x, best_f = None, -np.inf
    n_evals = 0
    history = []
    with obs.span("mle.fit", driver="grid", levels=refine):
        for _ in range(refine):
            axes = [np.linspace(lo[i], hi[i], num) for i in range(d)]
            mesh = np.stack(np.meshgrid(*axes, indexing="ij"),
                            axis=-1).reshape(-1, d)
            # the reference hands the engine float32 candidates
            ll = _host(batched_loglik_fn(np.exp(mesh).astype(np.float32)))
            ll = np.where(np.isfinite(ll), ll, -np.inf)
            n_evals += mesh.shape[0]
            k = int(np.argmax(ll))
            if ll[k] > best_f:
                best_f, best_x = float(ll[k]), mesh[k].copy()
            if best_x is None:
                raise ValueError(
                    "fit_mle_grid: every candidate log-likelihood in the "
                    f"first {mesh.shape[0]}-point grid level was non-finite; "
                    "widen or shift `bounds` (the covariance is likely not "
                    "SPD there)")
            history.append((np.exp(best_x), best_f))
            # recenter on the incumbent, clamped so refined grids (and
            # hence the returned theta) never leave the caller's bounds box
            span = (hi - lo) * shrink
            lo = np.clip(best_x - span / 2.0, lo0, hi0)
            hi = np.clip(best_x + span / 2.0, lo0, hi0)
    obs.inc("mle.fits")
    return MLEResult(theta=np.exp(best_x), loglik=best_f, n_evals=n_evals,
                     n_iters=refine, converged=True, history=history)


def fit_mle_adam(loglik_fn: Callable, theta0, *, steps: int = 150,
                 lr: float = 0.05) -> MLEResult:
    """Gradient MLE: Adam on -loglik(exp(x)) with the gradient from autograd
    through the factorization (beyond-paper path; needs a differentiable
    evaluation: `make_loglik`, dense or through the tile engine, whose
    kernels have backwards on the card; not `geostat_loglik_step`).

    loglik_fn: theta (an fp32 tensor that requires grad) -> log-likelihood
    (a 0-d tensor on any device).  x starts at log(theta0) in fp32 on the
    host, as the reference's; Adam's constants (0.9, 0.999, 1e-8, bias
    correction), the history every 10 steps (theta after the step, the
    log-likelihood before it) and the final value evaluation are the
    reference's.

    The whole fit runs in an `obs.traced()` region: the reference jits its
    step and its final evaluation, which record no engine span.
    """
    with obs.traced():
        return _fit_mle_adam(loglik_fn, theta0, steps=steps, lr=lr)


def _fit_mle_adam(loglik_fn, theta0, *, steps, lr):
    x = torch.log(torch.as_tensor(np.asarray(theta0), dtype=torch.float32))

    def value_and_grad(x):
        x = x.detach().requires_grad_(True)
        f = -loglik_fn(torch.exp(x))
        (g,) = torch.autograd.grad(f, x)
        return f.detach(), g

    m, v = torch.zeros_like(x), torch.zeros_like(x)
    history = []
    for i in range(1, steps + 1):
        f, g = value_and_grad(x)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1 - 0.9 ** i)
        vhat = v / (1 - 0.999 ** i)
        x = x - lr * mhat / (torch.sqrt(vhat) + 1e-8)
        if i % 10 == 0:
            history.append((np.exp(x.numpy()), -float(f)))
    with torch.no_grad():
        ll_final = float(loglik_fn(torch.exp(x)))
    return MLEResult(theta=np.exp(x.numpy()), loglik=ll_final,
                     n_evals=steps, n_iters=steps, converged=True,
                     history=history)
