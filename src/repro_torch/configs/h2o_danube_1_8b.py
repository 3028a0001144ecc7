"""h2o-danube-1.8b [arXiv:2401.16818]: 24L d=2560 32H (kv=8) d_ff=6912
vocab 32000, llama+mistral mix with sliding-window attention."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_head=80,
    d_ff=6912, vocab=32000, swa_window=4096, rope_theta=1e4,
))

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=512, swa_window=8,
                      remat=False)
