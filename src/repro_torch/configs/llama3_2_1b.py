"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B]: 16L d=2048 32H (kv=8)
d_ff=8192 vocab 128256, tied embeddings, rope theta 5e5."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
    d_ff=8192, vocab=128256, rope_theta=5e5, tie_embeddings=True,
))

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=512, remat=False)
