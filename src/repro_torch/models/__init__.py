from .config import ArchConfig, MoESpec, get_arch, register_arch
from .decode import decode_step, init_cache, prefill
from .transformer import encode, forward_lm, init_lm, lm_axes, lm_loss

__all__ = ["ArchConfig", "MoESpec", "get_arch", "register_arch",
           "decode_step", "init_cache", "prefill", "encode", "forward_lm",
           "init_lm", "lm_axes", "lm_loss"]
