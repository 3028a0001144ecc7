from . import (grok_1_314b, jamba_v0_1_52b, llama3_2_1b, qwen3_moe_30b_a3b,
               xlstm_1_3b)
from .geostat import GEOSTAT_CONFIGS, GeostatConfig
from .shapes import SHAPES, ShapeSpec, cell_applicable

# the model zoo's architectures ported so far; the others come with their
# families (ROADMAP A)
_MODULES = (llama3_2_1b, qwen3_moe_30b_a3b, grok_1_314b, xlstm_1_3b,
            jamba_v0_1_52b)
LM_CONFIGS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
LM_SMOKE_CONFIGS = {m.CONFIG.name: m.SMOKE for m in _MODULES}

__all__ = ["GEOSTAT_CONFIGS", "GeostatConfig", "LM_CONFIGS",
           "LM_SMOKE_CONFIGS", "SHAPES", "ShapeSpec", "cell_applicable"]
