"""llava-next-34b [hf:llava-hf/llava-v1.6-*]: 60L d=7168 56H (kv=8)
d_ff=20480 vocab 64000; anyres vision frontend stubbed as precomputed
patch embeddings (n_patches=2880 ~ 5x576 anyres tiles)."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000, frontend="vision_stub", n_patches=2880,
    rope_theta=1e6,
))

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=512, n_patches=8,
                      remat=False)
