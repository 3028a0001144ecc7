"""The paper's own workload: mixed-precision tile Cholesky MLE.

Production cells of the reference (`repro.configs.geostat`):
  geostat_500k : n=524288, nb=8192 (p=64 panels), band t=8 -> DP(~22%)
  geostat_1m   : n=1048576 (multi-pod), nb=16384 (p=64), band t=8

geostat_65k keeps geostat_500k's structure (p=64 panels, band t=8, nu=0.5,
square off-band update) and cuts n to 65536 so that the split storage and
the step-0 trailing update fit one 80 GB card: geostat_500k's bf16 off-band
alone is 550 GB.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GeostatConfig:
    name: str
    n: int
    nb: int
    diag_thick: int
    nu: float = 0.5
    off_update: str = "square"


GEOSTAT_CONFIGS = {
    "geostat_500k": GeostatConfig("geostat_500k", 524_288, 8_192, 8),
    "geostat_1m": GeostatConfig("geostat_1m", 1_048_576, 16_384, 8),
    "geostat_65k": GeostatConfig("geostat_65k", 65_536, 1_024, 8),
    "geostat_smoke": GeostatConfig("geostat_smoke", 512, 64, 2),
}
