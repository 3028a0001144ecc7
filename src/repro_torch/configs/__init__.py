from .geostat import GEOSTAT_CONFIGS, GeostatConfig

__all__ = ["GEOSTAT_CONFIGS", "GeostatConfig"]
