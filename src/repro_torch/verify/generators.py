"""Problem generators for the accuracy-oracle subsystem.

Counterpart of `repro.verify.generators`.  One place produces every matrix
the verification stack consumes, so tests, the conformance sweep and the
card's accuracy phase measure error on the SAME distributions:

  * `spd_matrix`        -- random SPD with an exact log-spaced spectrum
                           (condition number is a parameter, not an accident);
  * `matern_problem`    -- a synthetic geostatistical problem at one of the
                           paper's correlation strengths (weak/medium/strong
                           theta settings, Sec. VIII-D1), curve-ordered, with
                           the fp32 covariance the mixed-precision paths
                           factor;
  * `cholesky_problems` -- the canonical sweep grid: >= 3 sizes x 3
                           conditioning regimes.

Randomness comes from explicit `torch.Generator`s on the device the tensors
are made on, so the bits differ from `jax.random`'s and between devices;
`interop.problem_from_numpy` carries a reference problem across bit for
bit.  Entry points make tensors on `device`, the card unless asked.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.likelihood import build_covariance
from ..covariance import CORRELATION_LEVELS, make_dataset

# Canonical sweep grid: p = n / nb stays <= 6, as the reference's.  On the
# card mp_syrk takes nb % 64 == 0, so its grid is (128, 256, 384) at nb = 64:
# the same p in {2, 4, 6}.
SIZES = (64, 128, 192)
REGIMES = ("weak", "medium", "strong")
CHOLESKY_NB = 32

# Explicit condition numbers for the synthetic-SPD generators (kernel
# conformance; covariance problems get their conditioning from REGIMES).
CONDITIONS = {"well": 1e2, "moderate": 1e4, "ill": 1e6}

# Per-regime jitter: identical for all variants of one problem so error
# comparisons are apples-to-apples.
_JITTER = 1e-6


def spd_matrix(seed_or_gen, n: int, *, cond: float = 100.0,
               dtype=torch.float32, device="cuda"):
    """Random SPD matrix with eigenvalues log-spaced on [1, cond].

    seed_or_gen: an int or a torch.Generator (then its device is used).
    The spectrum is exact (Q diag(eigs) Q^T with orthonormal Q), so `cond`
    is the true 2-norm condition number -- the knob the tolerance registry
    keys on.
    """
    gen = (seed_or_gen if isinstance(seed_or_gen, torch.Generator) else
           torch.Generator(device=device).manual_seed(int(seed_or_gen)))
    a = torch.randn((n, n), generator=gen, dtype=torch.float32,
                    device=gen.device)
    q, _ = torch.linalg.qr(a)
    eigs = torch.logspace(0.0, math.log10(cond), n, dtype=torch.float32,
                          device=gen.device)
    return ((q * eigs) @ q.T).to(dtype)


class CholeskyProblem(NamedTuple):
    """One conditioned covariance-factorization problem.

    `cov` is the fp32 matrix (jitter included) that every factorization
    variant under test receives; oracles upcast THIS matrix to fp64, so
    forward/backward error measures the factorization alone, not the
    covariance build.
    """
    name: str             # e.g. "n128_medium"
    n: int
    nb: int
    regime: str           # "weak" | "medium" | "strong"
    theta: tuple          # (3,) generating parameters, host floats
    locs: torch.Tensor    # (n, 2) Morton-ordered locations
    z: torch.Tensor       # (n,) field draw
    cov: torch.Tensor     # (n, n) fp32 covariance incl. jitter

    @property
    def p(self) -> int:
        return self.n // self.nb


def problem_seed(n: int, regime: str, seed: int = 0) -> int:
    """One deterministic seed per (n, regime, seed), as the reference's key
    (`repro/verify/generators.py:92-93`), so golden metrics are stable."""
    return seed * 7919 + n * 31 + REGIMES.index(regime)


def matern_problem(n: int, regime: str, *, nb: int = CHOLESKY_NB,
                   seed: int = 0, jitter: float = _JITTER,
                   device="cuda") -> CholeskyProblem:
    """One synthetic problem at a paper correlation level, Morton ordered,
    made on `device` (Sigma through `build_covariance`: the matern_cov
    kernel on the card)."""
    if regime not in CORRELATION_LEVELS:
        raise ValueError(f"unknown regime {regime!r}; "
                         f"expected one of {sorted(CORRELATION_LEVELS)}")
    theta = tuple(float(v) for v in CORRELATION_LEVELS[regime])
    gen = torch.Generator(device=device).manual_seed(
        problem_seed(n, regime, seed))
    ds = make_dataset(gen, n, theta, nu_static=0.5, ordering="morton")
    cov = build_covariance(ds.locs, theta, nu_static=0.5, jitter=jitter,
                           dtype=torch.float32)
    return CholeskyProblem(name=f"n{n}_{regime}", n=n, nb=nb, regime=regime,
                           theta=theta, locs=ds.locs, z=ds.z, cov=cov)


def cholesky_problems(sizes=SIZES, regimes=REGIMES, *, nb: int = CHOLESKY_NB,
                      seed: int = 0, device="cuda") -> list[CholeskyProblem]:
    """The canonical >= 3 sizes x 3 conditioning-regimes sweep grid."""
    return [matern_problem(n, r, nb=nb, seed=seed, device=device)
            for n in sizes for r in regimes]


def attention_problem(seed: int, b: int, g: int, d: int, sn: int, sf: int,
                      *, scale: float = 1.0, dtype=torch.float32,
                      device="cuda"):
    """Inputs for the banded-precision decode-attention kernel pair:
    (q, k_near, v_near, k_far, v_far).

    `scale` multiplies Q: larger logits sharpen the softmax, the attention
    analogue of conditioning (quantization error concentrates on fewer
    tokens).
    """
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    q = scale * normal(b, g, d)
    return q, normal(b, sn, d), normal(b, sn, d), normal(b, sf, d), \
        normal(b, sf, d)
