"""jamba-v0.1-52b [arXiv:2403.19887]: 32L d=4096 32H (kv=8) d_ff=14336,
Mamba:attention 7:1 interleave, MoE 16 experts top-2 on every other layer."""
from ..models.config import ArchConfig, MoESpec, register_arch

CONFIG = register_arch(ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=65536, rope_theta=1e4,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe=MoESpec(n_experts=16, top_k=2, d_expert=14336, every=2, rem=1),
    ssm_expand=2, ssm_d_state=16, mamba_chunk=256,
))

SMOKE = CONFIG.scaled(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=512, mamba_chunk=8,
                      moe=MoESpec(n_experts=4, top_k=2, d_expert=64,
                                  every=2, rem=1),
                      remat=False)
