"""Launch wrapper of the CUDA Matern covariance kernel (csrc/matern_cov.cu).

Replaces the Pallas TPU kernel `repro.kernels.matern_cov.matern_cov`.
Euclidean distance with nu in {0.5, 1.5, 2.5}, written directly by the
kernel in one of two precisions: fp32 locations give fp32 or bf16 output
computed in fp32; fp64 locations give fp64 output computed in fp64, or
that value rounded once to fp32 (the panel path's fp32 off-band of the
paper pair).  `launch_grad` runs its backward: the gradient in theta of
sum G * C for one tile, G in the locations' precision.

Both kernels work in BLOCK x BLOCK blocks of a tile.  Where a call's row
and column tiles are the same tiles (`symmetric`), each tile is
symmetric, and both compute only its lower blocks (`lower_pair`), the
forward writing each with its mirror, the backward reading G's two
mirrored blocks against one evaluation (`grad_plan`).
"""

from __future__ import annotations

import functools
import math

import torch

from .. import count_launch
from .._build import check, library

BLOCK = 64  # side of the kernels' square blocks (kB)
# the backward's first pass has at most this many blocks (two fp64 partial
# sums each); the C entry cuts its grid to what fits on the card at once
GRAD_MAX_GRID = 4096
# (locations dtype, out dtype) -> the C entry's `dtypes` code
_DTYPES = {(torch.float32, torch.float32): 0,
           (torch.float32, torch.bfloat16): 1,
           (torch.float64, torch.float64): 2,
           (torch.float64, torch.float32): 3}


def symmetric(locs_i, locs_j):
    """Whether the row and column tiles of a call are the same tiles: one
    data pointer and one shape.  Then every tile C(locs_i[b], locs_i[b]) is
    symmetric and the kernels compute its lower blocks only."""
    return (locs_i.data_ptr() == locs_j.data_ptr()
            and locs_i.shape == locs_j.shape
            and locs_i.stride() == locs_j.stride())


def blocks(n):
    """BLOCK-wide blocks along n elements, the last one ragged."""
    return -(-n // BLOCK)


def lower_pair(k):
    """The k-th block (I, J), I >= J, of a lower triangle of blocks, row by
    row: k = I (I + 1) / 2 + J (csrc/matern_cov.cu: lower_pair)."""
    i = int((math.sqrt(8.0 * k + 1.0) - 1.0) * 0.5)
    while i * (i + 1) // 2 > k:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= k:
        i += 1
    return i, k - i * (i + 1) // 2


def sym_blocks(n):
    """Blocks the symmetric forward computes for one (n, n) tile (its grid.x):
    the lower triangle of blocks with its diagonal."""
    t = blocks(n)
    return t * (t + 1) // 2


def outer_order(n_ti, n_tj, min_lag):
    """The outer form's tiles in the order its grid.z takes them: (ti, tj,
    zero) for every tile once, computed where ti - tj >= min_lag, else
    zero, with the zero tiles spread evenly among the computed ones (item i
    is a zero tile where floor(i nz / n) steps), so that their stores run
    beside the arithmetic.  Every 64 x 64 block of an item's tile is one
    block of the grid, which computes it or writes it zero."""
    tiles = [(i, j) for i in range(n_ti) for j in range(n_tj)]
    computed = [(i, j, 0) for i, j in tiles if i - j >= min_lag]
    zero = [(i, j, 1) for i, j in tiles if i - j < min_lag]
    n, nz = len(tiles), len(zero)
    return [zero[z] if (i + 1) * nz // n > z else computed[i - z]
            for i, z in ((i, i * nz // n) for i in range(n))]


@functools.lru_cache(maxsize=32)
def outer_plan(n_ti, n_tj, min_lag, device):
    """`outer_order` as the kernel reads it: an (n_ti n_tj, 3) int32 tensor
    on `device`, built once per shape and kept (the kernel only reads
    it)."""
    return torch.tensor(outer_order(n_ti, n_tj, min_lag), dtype=torch.int32,
                        device=device)


def grad_plan(rows, cols, sym):
    """(blocks of G the backward evaluates, fp64 partials to allocate): every
    block of G in the general form, the lower ones in the symmetric form
    (rows == cols), walked by at most GRAD_MAX_GRID blocks of the first
    pass, two partial sums each."""
    if sym and rows != cols:
        raise ValueError(f"a symmetric G is square, got ({rows}, {cols})")
    n_blocks = sym_blocks(rows) if sym else blocks(rows) * blocks(cols)
    return n_blocks, 2 * min(n_blocks, GRAD_MAX_GRID)


def _check_locs(locs, name):
    if not locs.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if locs.ndim != 3 or locs.shape[-1] != 2 or not locs.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (tiles, rows, 2) tensor")


def _two_nu(nu, metric):
    if metric != "euclidean":
        raise NotImplementedError(
            "matern_cov kernel: haversine distance is not ported (ROADMAP A 5)")
    if nu not in (0.5, 1.5, 2.5):
        raise NotImplementedError(
            f"matern_cov kernel: nu={nu} has no closed form; a general nu "
            "goes to the plain Bessel path (matern_cov.ops)")
    return int(round(2 * nu))


def launch(locs_i, locs_j, theta, *, nu, out, outer, min_lag=0,
           metric="euclidean"):
    """Write Matern covariance tiles into `out` with one kernel launch.

    zip   (outer=False): out[b] = C(locs_i[b], locs_j[b]); `out` is
          (B, rows, cols) with contiguous tiles and any tile stride.
    outer (outer=True):  out[i, j] = C(locs_i[i], locs_j[j]) where
          i - j >= min_lag, else 0; `out` is contiguous (Ti, Tj, rows, cols).
    A zip call whose locs_i and locs_j are `symmetric` launches the
    symmetric form, with the same bits.
    theta: host floats (theta1, theta2, ...); theta[2] is not read.  The
    kernel computes in the locations' precision, theta rounded to it.
    """
    two_nu = _two_nu(nu, metric)
    dtypes = _DTYPES.get((locs_i.dtype, out.dtype))
    if locs_j.dtype != locs_i.dtype or dtypes is None:
        raise ValueError(
            f"matern_cov kernel: locations {locs_i.dtype}/{locs_j.dtype} with "
            f"out {out.dtype}; it takes fp32 locations with fp32 or bf16 out "
            "and fp64 locations with fp64 or fp32 out")
    _check_locs(locs_i, "locs_i")
    _check_locs(locs_j, "locs_j")
    if out.device != locs_i.device or locs_j.device != locs_i.device:
        raise ValueError("locs_i, locs_j and out must be on one device")
    ti, rows, _ = locs_i.shape
    tj, cols, _ = locs_j.shape
    if outer:
        if out.shape != (ti, tj, rows, cols) or not out.is_contiguous():
            raise ValueError("outer: out must be contiguous (Ti, Tj, rows, cols)")
        n_pairs, n_cols_j, stride = ti * tj, tj, rows * cols
        if min_lag < 0:
            raise ValueError(f"outer: min_lag must be >= 0, got {min_lag}")
    else:
        if ti != tj or out.shape != (ti, rows, cols):
            raise ValueError("zip: locs_i, locs_j and out need one tile count")
        if out.stride(1) != cols or out.stride(2) != 1:
            raise ValueError("zip: each out tile must be contiguous")
        n_pairs, n_cols_j, stride = ti, 0, out.stride(0)
    sym = not outer and symmetric(locs_i, locs_j)
    if not 0 < n_pairs <= 65535:
        raise ValueError(f"matern_cov kernel: {n_pairs} tiles, at most 65535")
    th1, th2 = float(theta[0]), float(theta[1])
    plan = (outer_plan(ti, tj, min_lag, out.device).data_ptr() if outer
            else None)
    status = library().matern_cov_launch(
        locs_i.data_ptr(), locs_j.data_ptr(), out.data_ptr(), plan, n_pairs,
        n_cols_j, rows, cols, stride, th1, th2, two_nu, dtypes, int(sym),
        torch.cuda.current_stream(out.device).cuda_stream)
    check(status, "matern_cov")
    count_launch("matern_cov")
    return out


def launch_grad(locs_a, locs_b, theta, grad_out, *, nu, metric="euclidean"):
    """sum_ij G_ij dC_ij/dtheta_k for k = 1, 2, C = C(locs_a, locs_b): one
    backward launch (and its one-block second pass) for the (m, n) tile
    G = grad_out, fp32 or fp64 as the locations are.  theta: host floats
    (theta1, theta2, ...), rounded to the locations' precision as `launch`
    rounds them.  Returns a (2,) tensor in that precision on the device.
    `symmetric` locations launch the symmetric form (G need not be
    symmetric); its sums differ from the general form's in their order.
    Haversine distance raises here (`_two_nu`), before any build, until
    ROADMAP A 5; the plain version (ref.matern_cov_grad) takes it."""
    two_nu = _two_nu(nu, metric)
    dtype = locs_a.dtype
    if (dtype not in (torch.float32, torch.float64) or locs_b.dtype != dtype
            or grad_out.dtype != dtype):
        raise ValueError(
            f"matern_cov_grad kernel: locations {locs_a.dtype}/{locs_b.dtype}"
            f" with G {grad_out.dtype}; it takes all fp32 or all fp64")
    _check_locs(locs_a[None], "locs_a")
    _check_locs(locs_b[None], "locs_b")
    rows, cols = locs_a.shape[0], locs_b.shape[0]
    if grad_out.shape != (rows, cols) or not grad_out.is_contiguous():
        raise ValueError(f"matern_cov_grad kernel: G must be contiguous "
                         f"({rows}, {cols}), got {tuple(grad_out.shape)}")
    if locs_b.device != locs_a.device or grad_out.device != locs_a.device:
        raise ValueError("locs_a, locs_b and G must be on one device")
    sym = symmetric(locs_a, locs_b)
    _, n_partials = grad_plan(rows, cols, sym)
    partials = torch.empty(n_partials, dtype=torch.float64,
                           device=locs_a.device)
    out = torch.empty(2, dtype=torch.float64, device=locs_a.device)
    status = library().matern_cov_grad_launch(
        locs_a.data_ptr(), locs_b.data_ptr(), grad_out.data_ptr(),
        partials.data_ptr(), n_partials, out.data_ptr(), rows, cols,
        float(theta[0]), float(theta[1]), two_nu, int(dtype == torch.float64),
        int(sym), torch.cuda.current_stream(locs_a.device).cuda_stream)
    check(status, "matern_cov_grad")
    count_launch("matern_cov_grad")
    return out.to(dtype)
