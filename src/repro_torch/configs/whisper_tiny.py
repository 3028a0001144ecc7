"""whisper-tiny [arXiv:2212.04356]: enc-dec 4L d=384 6H d_ff=1536
vocab 51865; conv frontend stubbed (precomputed frame embeddings)."""
from ..models.config import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_head=64,
    d_ff=1536, vocab=51865, enc_dec=True, n_enc_layers=4,
    n_enc_frames=1500, frontend="audio_stub", rope_theta=1e4,
))

SMOKE = CONFIG.scaled(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=4, d_head=16, d_ff=128, vocab=512,
                      n_enc_frames=32, remat=False)
