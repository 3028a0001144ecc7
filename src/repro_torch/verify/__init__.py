"""Accuracy-oracle verification subsystem of the port.

Counterpart of `repro.verify`: the paper's central accuracy claim --
band-limited mixed precision accelerates the tile Cholesky "without any
deterioration of the numerical accuracy" of likelihood evaluation and
kriging -- as executable, regression-gated checks, on the CPU and on the
card:

  generators.py   SPD / Matern covariance problem generators with controlled
                  condition number, correlation strength (the paper's
                  weak/medium/strong theta settings) and curve ordering.
  oracles.py      fp64 reference answers (factor, log-likelihood, kriging
                  PMSE) plus forward/backward error metrics, in torch fp64
                  on the input's device (row-blocked from n = 8,192 on).
  bounds.py       the reference's tolerance registry, keyed by (policy mode,
                  dtype pair, diag_thick, conditioning regime); torch
                  policies map to the reference's dtype-pair labels.
  conformance.py  the sweep: every kernel pair (kernels/*/ops.py vs ref.py)
                  and the three Cholesky variants (tile / panel / dst)
                  through the generators, checked against the registry and
                  the paper's claims.
  golden.py       committed golden accuracy artifacts, one per device type,
                  and the --update flow, so accuracy drift fails loudly.

Entry points that make tensors take `device=` (the card by default).  Each
sweep record's computation is a `verify.cell` span of `repro_torch.obs`
(with telemetry on), with the reference's `id` and `kind`.
"""

from .generators import (
    CHOLESKY_NB,
    CONDITIONS,
    REGIMES,
    SIZES,
    CholeskyProblem,
    attention_problem,
    cholesky_problems,
    matern_problem,
    spd_matrix,
)
from .oracles import (
    backward_error,
    exact_factor,
    exact_kriging_pmse,
    exact_loglik,
    loglik_drift,
    pmse_drift,
    rel_frobenius,
)
from .bounds import (
    AccuracyBound,
    dtype_pair,
    lookup_bound,
    policy_bound,
    registry_table,
)
from .conformance import (
    check_records,
    claim_failures,
    default_policies,
    run_conformance,
    sweep_cholesky,
    sweep_kernels,
    sweep_kriging,
)
from .golden import (
    CARD_NB,
    CARD_SIZES,
    compare_to_golden,
    golden_path,
    load_golden,
    save_golden,
)

__all__ = [
    "CHOLESKY_NB", "CONDITIONS", "REGIMES", "SIZES",
    "CholeskyProblem", "attention_problem", "cholesky_problems",
    "matern_problem", "spd_matrix",
    "backward_error", "exact_factor", "exact_kriging_pmse", "exact_loglik",
    "loglik_drift", "pmse_drift", "rel_frobenius",
    "AccuracyBound", "dtype_pair", "lookup_bound", "policy_bound",
    "registry_table",
    "check_records", "claim_failures", "default_policies", "run_conformance",
    "sweep_cholesky", "sweep_kernels", "sweep_kriging",
    "CARD_NB", "CARD_SIZES", "compare_to_golden", "golden_path",
    "load_golden", "save_golden",
]
