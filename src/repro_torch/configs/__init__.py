from . import (grok_1_314b, h2o_danube_1_8b, jamba_v0_1_52b, llama3_2_1b,
               llava_next_34b, qwen3_32b, qwen3_4b, qwen3_moe_30b_a3b,
               whisper_tiny, xlstm_1_3b)
from .geostat import GEOSTAT_CONFIGS, GeostatConfig
from .shapes import SHAPES, ShapeSpec, cell_applicable, input_specs

# the model zoo, every architecture of the reference's ALL_ARCHS, in its order
_MODULES = (qwen3_moe_30b_a3b, grok_1_314b, whisper_tiny, qwen3_4b,
            llama3_2_1b, qwen3_32b, h2o_danube_1_8b, xlstm_1_3b,
            llava_next_34b, jamba_v0_1_52b)
LM_CONFIGS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
LM_SMOKE_CONFIGS = {m.CONFIG.name: m.SMOKE for m in _MODULES}

__all__ = ["GEOSTAT_CONFIGS", "GeostatConfig", "LM_CONFIGS",
           "LM_SMOKE_CONFIGS", "SHAPES", "ShapeSpec", "cell_applicable",
           "input_specs"]
