"""Launch wrapper of the CUDA tile POTRF kernel (csrc/blocked_potrf.cu).

Replaces the Pallas TPU kernel `repro.kernels.blocked_potrf.blocked_potrf`.
One thread block per fp32 tile, nb <= MAX_NB.  Larger tiles raise: there is
no fallback to a library Cholesky.
"""

from __future__ import annotations

import torch

from .. import LAUNCHES
from .._build import check, library

MAX_NB = 1024


def launch(a):
    """Lower Cholesky factors of a (B, nb, nb) fp32 CUDA tensor.

    Returns (l, info): info[b] = 0, or the 1-based column of the first
    non-positive pivot of tile b, whose factor is then all NaN.
    """
    if not a.is_cuda or a.dtype != torch.float32:
        raise ValueError("potrf kernel: a must be a float32 CUDA tensor")
    if a.ndim != 3 or a.shape[1] != a.shape[2] or not a.is_contiguous():
        raise ValueError("potrf kernel: a must be contiguous (B, nb, nb)")
    batch, nb, _ = a.shape
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"potrf kernel: nb={nb} is outside 1..{MAX_NB}")
    if not 1 <= batch < 2 ** 31:
        raise ValueError(f"potrf kernel: batch={batch}")
    out = torch.empty_like(a)
    info = torch.empty((batch,), dtype=torch.int32, device=a.device)
    status = library().blocked_potrf_launch(
        a.data_ptr(), out.data_ptr(), info.data_ptr(), batch, nb,
        torch.cuda.current_stream(a.device).cuda_stream)
    check(status, "blocked_potrf")
    LAUNCHES["blocked_potrf"] += 1
    return out, info
