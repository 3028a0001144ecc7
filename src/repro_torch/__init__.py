"""PyTorch / CUDA port of the mixed-precision tile Cholesky geostatistics code.

The JAX package `repro` is the reference; this package keeps its layout so
that each module has a counterpart there, and imports nothing of it.

Entry points that create tensors default to ``device="cuda"``; functions
that take tensors compute on the tensors' device.  The three hot operations
of one likelihood evaluation (`covariance generation`, the diagonal-tile
POTRF and the banded mixed-precision SYRK) run as hand-written CUDA kernels
on a CUDA tensor (`repro_torch.kernels`) and as their plain PyTorch
versions on a CPU tensor.
"""

from .configs.geostat import GEOSTAT_CONFIGS, GeostatConfig
from .core.precision import PrecisionPolicy, lo_matmul

__all__ = ["GEOSTAT_CONFIGS", "GeostatConfig", "PrecisionPolicy", "lo_matmul"]
