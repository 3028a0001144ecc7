from .config import ArchConfig, MoESpec, get_arch, register_arch
from .decode import decode_step, init_cache, prefill
from .transformer import forward_lm, init_lm, lm_loss

__all__ = ["ArchConfig", "MoESpec", "get_arch", "register_arch",
           "decode_step", "init_cache", "prefill", "forward_lm", "init_lm",
           "lm_loss"]
