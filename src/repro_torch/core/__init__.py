from .precision import PrecisionPolicy, lo_matmul
from .panel_cholesky import (
    assemble_from_banded,
    banded_forward_solve,
    banded_loglik,
    build_banded_covariance,
    geostat_loglik_step,
    panel_cholesky_banded,
)
from .mle import MLEResult, fit_mle, neldermead

__all__ = [
    "PrecisionPolicy", "lo_matmul",
    "assemble_from_banded", "banded_forward_solve", "banded_loglik",
    "build_banded_covariance", "geostat_loglik_step", "panel_cholesky_banded",
    "MLEResult", "fit_mle", "neldermead",
]
