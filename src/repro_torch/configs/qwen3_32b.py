"""qwen3-32b [hf:Qwen/Qwen3-32B]: 64L d=5120 64H (kv=8) d_ff=25600
vocab 151936, qk_norm."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=25600, vocab=151936, qk_norm=True, rope_theta=1e6,
))

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=512, remat=False)
