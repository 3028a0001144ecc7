"""blocked_potrf: the Cholesky factor of one diagonal nb x nb tile; p
launches an evaluation where the band is fp32 (an fp64 band's tiles go to
cuSOLVER, and none to this kernel).

Copied from chip_smoke.py's bound of the kernel (PERF.md's table: nb^3 / 3
operations in fp32, 0.00534 ms a 1024^2 tile): the tile read once and its
factor written once, in fp32."""

from .. import peaks
from . import geometry, summed_least_seconds


def launches(cfg: dict):
    p, _, nb = geometry(cfg)
    if cfg["hi"] != "float32":
        return []
    return [({"float32": nb ** 3 / 3}, 2 * nb * nb * peaks.BYTES["float32"])
            for _ in range(p)]


def least_seconds(cfg: dict) -> float:
    return summed_least_seconds(launches(cfg))
