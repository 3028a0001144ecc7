"""matern_cov: the covariance written into the split storage; t + 1
launches an evaluation: band sub-diagonal d (p - d tiles in hi) for each
d < t, and the off-band's lower tiles i - j >= t in lo in one launch.

Copied from chip_smoke.py's `check_matern` bounds: 9 operations per
element (2 sub, 2 mul, add, sqrt, div, exp, mul) in the locations'
precision (fp32 on the CUDA cores, fp64 outside the tensor cores), the
locations of the launch read once and the tiles written once.  Only the
tiles the factorization reads count: the off-band launch also writes the
zeros of its square storage (chip_smoke counted those), which the
algorithm does not need."""

from .. import peaks
from . import geometry, summed_least_seconds


def _ops_key(cfg):
    return "float32" if cfg["locations_dtype"] == "float32" else "float64_simt"


def launches(cfg: dict):
    p, t, nb = geometry(cfg)
    loc_b = 2 * peaks.BYTES[cfg["locations_dtype"]]
    key = _ops_key(cfg)
    out = []
    for d in range(t):
        elems = (p - d) * nb * nb
        out.append(({key: 9 * elems},
                    elems * peaks.BYTES[cfg["hi"]] + 2 * (p - d) * nb * loc_b))
    n_off = (p - t) * (p - t + 1) // 2
    if n_off:
        elems = n_off * nb * nb
        out.append(({key: 9 * elems},
                    elems * peaks.BYTES[cfg["lo"]] + p * nb * loc_b))
    return out


def least_seconds(cfg: dict) -> float:
    return summed_least_seconds(launches(cfg))
