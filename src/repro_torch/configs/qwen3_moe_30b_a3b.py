"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (kv=4)
MoE 128 experts top-8, expert d_ff=768, vocab 151936, qk_norm."""
from ..models.config import ArchConfig, MoESpec, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=0, vocab=151936, qk_norm=True, rope_theta=1e6,
    moe=MoESpec(n_experts=128, top_k=8, d_expert=768),
))

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, vocab=512,
                      moe=MoESpec(n_experts=8, top_k=2, d_expert=32),
                      remat=False)
