from .precision import PrecisionPolicy, lo_matmul
from .tile_cholesky import (
    assemble_lower,
    dst_assemble,
    dst_cholesky,
    reference_cholesky,
    split_tiles,
    tile_cholesky,
)
from .panel_cholesky import (
    assemble_from_banded,
    banded_forward_solve,
    banded_loglik,
    build_banded_covariance,
    geostat_loglik_step,
    panel_cholesky_banded,
)
from .likelihood import (
    build_covariance,
    dst_loglik,
    loglik_from_factor,
    make_factor_fn,
    make_loglik,
    profiled_loglik_from_factor,
)
from .mle import MLEResult, fit_mle, fit_mle_adam, fit_mle_grid, neldermead
from .kriging import kfold_pmse, krige, krige_pmse, pmse
from .batch_engine import (
    BatchEngine,
    BatchPlan,
    BatchResult,
    chunked,
    evaluate_batch,
)

__all__ = [
    "PrecisionPolicy", "lo_matmul",
    "assemble_lower", "dst_assemble", "dst_cholesky", "reference_cholesky",
    "split_tiles", "tile_cholesky",
    "assemble_from_banded", "banded_forward_solve", "banded_loglik",
    "build_banded_covariance", "geostat_loglik_step", "panel_cholesky_banded",
    "build_covariance", "dst_loglik", "loglik_from_factor", "make_factor_fn",
    "make_loglik", "profiled_loglik_from_factor",
    "MLEResult", "fit_mle", "fit_mle_adam", "fit_mle_grid", "neldermead",
    "kfold_pmse", "krige", "krige_pmse", "pmse",
    "BatchEngine", "BatchPlan", "BatchResult", "chunked", "evaluate_batch",
]
