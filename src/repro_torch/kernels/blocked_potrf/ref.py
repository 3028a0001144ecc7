"""Plain PyTorch version of the tile POTRF kernel."""

from __future__ import annotations

import torch


def potrf(a):
    """Lower Cholesky factor(s) of (..., nb, nb) SPD tiles, computed in fp32.

    Returns (l, info) in the kernel's convention: info = 0, or the 1-based
    column of the first non-positive pivot, and then the factor is all NaN.
    """
    l, info = torch.linalg.cholesky_ex(a.to(torch.float32))
    l = torch.where((info != 0)[..., None, None], torch.nan, l)
    return l.to(a.dtype), info
