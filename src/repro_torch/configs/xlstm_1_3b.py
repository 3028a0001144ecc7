"""xlstm-1.3b [arXiv:2405.04517]: 48L d=2048 4H, alternating
sLSTM + mLSTM blocks, vocab 50304, no separate MLP (d_ff=0)."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_head=512,
    d_ff=0, vocab=50304, block_pattern=("mlstm", "slstm"),
    ssm_expand=2,
))

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_head=16, vocab=512, remat=False)
