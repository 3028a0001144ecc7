"""Public tile POTRF: plain version on a CPU tensor, the kernel on a CUDA one."""

from __future__ import annotations

from . import ref
from .blocked_potrf import launch


def potrf(a):
    """Lower Cholesky factor(s) of (nb, nb) or (B, nb, nb) SPD tiles.

    Returns (l, info): info has shape a.shape[:-2]; info != 0 marks a tile
    that is not positive definite, whose factor is all NaN.
    """
    if not a.is_cuda:
        return ref.potrf(a)
    l, info = launch(a.reshape((-1,) + a.shape[-2:]))
    return l.reshape(a.shape), info.reshape(a.shape[:-2])
