from . import checkpoint
from .checkpoint import latest_step, restore, save

__all__ = ["checkpoint", "latest_step", "restore", "save"]
