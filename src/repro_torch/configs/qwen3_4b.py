"""qwen3-4b [hf:Qwen/Qwen3-4B]: 36L d=2560 32H (kv=8) d_ff=9728
vocab 151936, qk_norm."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6,
))

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=512, remat=False)
