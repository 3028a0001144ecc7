"""Launch wrapper of the CUDA tile POTRF kernel (csrc/blocked_potrf.cu).

Replaces the Pallas TPU kernel `repro.kernels.blocked_potrf.blocked_potrf`.
Tiles with nb <= SMEM_TILE_MAX take one thread block each; larger ones (up
to MAX_NB) are factored one after the other, each by a cooperative grid of
blocks in panels of PANEL columns (one device launch per call either way).
Larger tiles raise: there is no fallback to a library Cholesky.
"""

from __future__ import annotations

import torch

from .. import count_launch
from .._build import check, library

MAX_NB = 1024
SMEM_TILE_MAX = 128   # nb up to this: one block per tile, in shared memory
PANEL = 64            # panel width and output tile of the grid path


def plan(nb: int) -> dict:
    """The grid path's schedule of one nb x nb tile.

    panels[k] = (k0, w, row_chunks, update_tiles): panel k covers columns
    [k0, k0 + w); its solve splits the rows below into row_chunks chunks of
    PANEL rows (one block each), and its trailing update into update_tiles
    lower-triangle output tiles of PANEL x PANEL (one block each).  `blocks`
    is the most any phase can use, which the kernel caps at the blocks that
    can be resident at once.
    """
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"potrf kernel: nb={nb} is outside 1..{MAX_NB}")
    panels = []
    for k0 in range(0, nb, PANEL):
        w = min(PANEL, nb - k0)
        chunks = -(-(nb - k0 - w) // PANEL)
        panels.append((k0, w, chunks, chunks * (chunks + 1) // 2))
    blocks = max(max(c, t) for _, _, c, t in panels)
    return dict(panel=PANEL, panels=panels, blocks=max(blocks, 1),
                grid_path=nb > SMEM_TILE_MAX)


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
    blocks = plan(nb)["blocks"]
    if not 1 <= batch < 2 ** 31:
        raise ValueError(f"potrf kernel: batch={batch}")
    out = torch.empty_like(a)
    info = torch.empty((batch,), dtype=torch.int32, device=a.device)
    status = library().blocked_potrf_launch(
        a.data_ptr(), out.data_ptr(), info.data_ptr(), batch, nb, blocks,
        torch.cuda.current_stream(a.device).cuda_stream)
    check(status, "blocked_potrf")
    count_launch("blocked_potrf")
    return out, info
