"""grok-1-314b [hf:xai-org/grok-1; unverified]: 64L d=6144 48H (kv=8)
MoE 8 experts top-2, expert d_ff=32768, vocab 131072."""
from ..models.config import ArchConfig, MoESpec, register_arch

CONFIG = register_arch(ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=0, vocab=131072, rope_theta=1e4,
    moe=MoESpec(n_experts=8, top_k=2, d_expert=32768),
))

SMOKE = CONFIG.scaled(n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                      d_head=16, vocab=512,
                      moe=MoESpec(n_experts=4, top_k=2, d_expert=64),
                      remat=False)
