from . import adamw
from .adamw import cosine_schedule, global_norm

__all__ = ["adamw", "cosine_schedule", "global_norm"]
