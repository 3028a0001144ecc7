"""Mixed-precision tile Cholesky factorization -- paper Algorithm 1, faithful.

Counterpart of `repro.core.tile_cholesky`, the numerical reference engine:
a right-looking tile Cholesky in which every tile op runs in the dtype
Algorithm 1 prescribes:

  line  8  dpotrf   : diagonal tile, hi
  line  9  dlag2s   : hi->lo copy of the factored diagonal tile (tmp)
  line 12  dtrsm    : panel tile inside the band, hi
  line 14  strsm    : panel tile outside the band, lo (using the lo tmp tile)
  line 15  sconv2d  : lo->hi refresh of the hi copy (the update's operand)
  line 19  dsyrk    : diagonal-tile update, always hi
  line 25  dgemm    : in-band trailing tile, hi
  line 27  sgemm    : off-band trailing tile, lo math AND lo storage

Off-band tiles are stored in `policy.lo` (`lo2` from `diag_thick2` tiles
off for three_tier), band tiles in `policy.hi`.  Leading axes of the matrix
are a batch of factorizations (one per candidate theta); every op batches
over them.

Where the reference loops over tiles, this engine works a step at a time:

  * storage: tile row i is up to three runs of consecutive tiles, one per
    storage dtype (lo2 | lo | hi from left to right), each one tensor, so
    a tile is a view and a run's share of an update is one op;
  * line 8 factors the diagonal tiles of the whole batch in one POTRF;
  * lines 12 and 14 solve each dtype class of the panel column in one
    batched triangular solve per candidate (`torch.linalg.solve_triangular`);
  * lines 19, 25 and 27 are one SYRK per candidate: U = P P^T of the
    gathered panel column P = [tile (i, k) in hi for i > k] with
    `band_blocks = diag_thick` and `tile = round_k = nb`, in hi inside the
    band and, outside it, with P rounded to lo, the products summed in
    fp32 and the sum rounded once to lo.  That is what the reference's
    per-tile `lo_matmul` computes (`core/precision.py`): both operands
    cast to lo, one fp32 sum over nb, one rounding.  Each run then
    subtracts its block of U: in hi inside the band, and outside it as
    line 27 does, (tile in lo - U block in lo), stored to the tile's tier.

`impl` picks who computes POTRF and the SYRK, as in `core/panel_cholesky`:
"kernel" calls the kernels' `ops` functions (the CUDA kernels on a CUDA
tensor, their plain versions on a CPU tensor), "plain" their plain
versions on any device.  POTRF is chosen by the band's dtype up front
(`panel_cholesky._potrf`): an fp32 band goes to `blocked_potrf`, an fp64
band to `torch.linalg.cholesky_ex`.  The SYRK kernel takes the pairs
(hi, lo) = (fp32, bf16), (fp32, fp32), (fp64, fp32) and (fp64, fp64), and
nb a multiple of 64; other inputs raise on a CUDA tensor with
impl="kernel".  A factor tile that is not positive definite comes back all
NaN from either POTRF, and the NaN reaches the log-likelihood.

A matrix that requires grad (with grad mode on) is differentiated through
the same forward: `blocked_potrf` through `Potrf` (each tile's Cholesky
backward in torch ops), the plain POTRF and `cholesky_ex` through autograd,
and the SYRK through `MpSyrk`, whose backward is the
`mp_syrk_grad` kernel on a CUDA tensor with impl="kernel" and its plain
version otherwise.  The values and launches of the forward are those
without autograd.
"""

from __future__ import annotations

import torch

from .. import obs
from .panel_cholesky import _cholesky, _impl, _potrf
from .precision import PrecisionPolicy, require_ieee_fp32


def _trsm_right_lt(l_kk, a_ik, exec_dtype, out_dtype):
    """A_ik <- A_ik L_kk^{-T} executed in exec_dtype, stored as out_dtype:
    l_kk (B, nb, nb), a_ik (B, rows, nb, nb).

    One batched solve per candidate: torch picks its cuBLAS loop, cuBLAS
    batched or MAGMA path by the batch count, so solving all candidates in
    one call would make a candidate's factor depend on the batch it is in.
    """
    return torch.stack([
        torch.linalg.solve_triangular(l.to(exec_dtype).mT, a.to(exec_dtype),
                                      upper=True, left=False).to(out_dtype)
        for l, a in zip(l_kk, a_ik)])


def split_tiles(a, nb: int):
    """(..., n, n) -> dict[(i, j)] -> (..., nb, nb) lower-triangle tiles.

    Leading axes of `a` are treated as a batch of matrices.
    """
    n = a.shape[-1]
    assert n % nb == 0, f"n={n} must be a multiple of nb={nb}"
    p = n // nb
    return {
        (i, j): a[..., i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
        for i in range(p) for j in range(i + 1)
    }, p


def assemble_lower(tiles, p: int, nb: int, dtype):
    """Lower-triangle tiles -> full (..., n, n) lower-triangular matrix."""
    n = p * nb
    first = tiles[(0, 0)]
    out = torch.zeros(first.shape[:-2] + (n, n), dtype=dtype,
                      device=first.device)
    for (i, j), t in tiles.items():
        out[..., i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = t.to(dtype)
    return out.tril_()


def _row_runs(policy: PrecisionPolicy, i: int):
    """Tile row i's runs [(j0, j1, dtype)]: tiles j0 <= j < j1 share the
    storage dtype Algorithm 1 gives them (policy.tile_dtype)."""
    if policy.mode == "full":
        return [(0, i + 1, policy.hi)]
    band0 = max(0, i - policy.diag_thick + 1)
    lo0 = 0
    runs = []
    if policy.mode == "three_tier":
        lo0 = min(band0, max(0, i - policy.diag_thick2 + 1))
        runs.append((0, lo0, policy.lo2))
    runs += [(lo0, band0, policy.lo), (band0, i + 1, policy.hi)]
    return [r for r in runs if r[0] < r[1]]


def _column_runs(policy: PrecisionPolicy, k: int, p: int):
    """Panel column k's runs [(i0, i1, dtype)] of rows k < i < p by storage
    dtype: the band's rows first, then lo, then lo2."""
    if policy.mode == "full":
        return [(k + 1, p, policy.hi)]
    band1 = min(p, k + policy.diag_thick)
    lo1 = p
    if policy.mode == "three_tier":
        lo1 = min(p, k + policy.diag_thick2)
    runs = [(k + 1, band1, policy.hi), (band1, lo1, policy.lo),
            (lo1, p, policy.lo2)]
    return [r for r in runs if r[0] < r[1]]


class _Cut(torch.autograd.Function):
    """x's blocks [(r0, r1, c0, c1)] over its last two axes, each a view of
    x or, where dtypes gives one, a copy in that dtype; differentiable in x.
    The backward writes every block's gradient into one zero tensor of x's
    shape.  A slice per block would give a zero tensor of all of x per
    block instead, and a split per axis a tensor per row besides.

        _Cut.apply(x, blocks, dtypes)
    """

    @staticmethod
    def forward(ctx, x, blocks, dtypes):
        ctx.blocks, ctx.like, ctx.shape = blocks, x.new_empty(0), x.shape
        return tuple(
            x[..., r0:r1, c0:c1] if dt is None
            else x[..., r0:r1, c0:c1].to(dt, copy=True)
            for (r0, r1, c0, c1), dt in zip(blocks,
                                            dtypes or [None] * len(blocks)))

    @staticmethod
    def backward(ctx, *grads):
        g = ctx.like.new_zeros(ctx.shape)
        for (r0, r1, c0, c1), gr in zip(ctx.blocks, grads):
            g[..., r0:r1, c0:c1].copy_(gr)
        return g, None, None


class _Assemble(torch.autograd.Function):
    """A zero tensor of `shape` in `dtype` with each piece written into its
    block [(r0, r1, c0, c1)] over the last two axes; differentiable in the
    pieces, each of whose gradients is a view of the output's.

        _Assemble.apply(shape, dtype, blocks, *pieces)
    """

    @staticmethod
    def forward(ctx, shape, dtype, blocks, *pieces):
        ctx.blocks, ctx.dtypes = blocks, [x.dtype for x in pieces]
        out = pieces[0].new_zeros(shape, dtype=dtype)
        for (r0, r1, c0, c1), x in zip(blocks, pieces):
            out[..., r0:r1, c0:c1] = x
        return out

    @staticmethod
    def backward(ctx, g):
        return (None, None, None) + tuple(
            g[..., r0:r1, c0:c1].to(dt)
            for (r0, r1, c0, c1), dt in zip(ctx.blocks, ctx.dtypes))


def _check_card(a, nb, impl):
    """mp_syrk takes nb % 64 == 0; say so before any work instead of deep
    inside a step."""
    if a.is_cuda and impl == "kernel" and nb % 64:
        raise ValueError(f"tile_cholesky on the card: nb={nb} must be a "
                         "multiple of 64 (mp_syrk's tile)")


def tile_cholesky(a, nb: int, policy: PrecisionPolicy, *, schedule=None,
                  impl: str = "kernel"):
    """Factor SPD `a` (..., n, n) -> lower-triangular L in policy.hi dtype.

    Faithful Algorithm 1.  For mode="full" every tile is hi (reference DP
    path).  For mode="dst" use dst_cholesky instead.  Leading axes of `a`
    are a batch of independent factorizations (one per candidate theta).
    `a` is not modified.

    `schedule` opts into the dynamic task runtime: pass a
    `repro_torch.sched.SchedConfig` and the same Algorithm 1 runs as a DAG
    of per-tile tasks, out of order on a pool of worker threads (each on a
    CUDA stream of its own on the card); its factor is the same bit for bit
    under every schedule.  It has no backward: an `a` that requires grad
    (with grad mode on) raises.
    """
    if policy.mode == "dst":
        raise ValueError("use dst_cholesky for the DST baseline")
    _, _, syrk = _impl(impl)
    _check_card(a, nb, impl)
    if schedule is not None:
        if a.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "tile_cholesky(schedule=...) has no backward: autograd does "
                "not follow the runtime's worker threads; call it without "
                "schedule to differentiate")
        from ..sched.runtime import scheduled_tile_cholesky
        return scheduled_tile_cholesky(a, nb, policy, schedule, impl=impl)[0]
    # telemetry at the dispatch boundary only: none where the reference's
    # call is traced (obs.traced(), or an `a` that requires grad)
    with obs.maybe_span("core.tile_cholesky", a, n=a.shape[-1], nb=nb,
                        mode=policy.mode) as sp:
        l = _tile_cholesky_eager(a, nb, policy, syrk, impl)
        if sp is not obs.NULL_SPAN and l.is_cuda:
            torch.cuda.synchronize(l.device)  # time the math, not the launches
        return l


def _tile_cholesky_eager(a, nb, policy, syrk, impl):
    require_ieee_fp32()
    hi, lo = policy.hi, policy.lo
    potrf = _potrf(impl, hi)
    n = a.shape[-1]
    assert n % nb == 0, f"n={n} must be a multiple of nb={nb}"
    p = n // nb
    batch = a.shape[:-2]
    a = a.reshape((-1, n, n))
    b_count = a.shape[0]

    # initial storage conversion (lines 2-6, dlag2s on off-band tiles):
    # runs[i] = [(j0, j1, dtype, (B, nb, (j1 - j0) nb) tensor)]
    spans = [(i, j0, j1, dt) for i in range(p)
             for j0, j1, dt in _row_runs(policy, i)]
    pieces = _Cut.apply(a, [(i * nb, (i + 1) * nb, j0 * nb, j1 * nb)
                            for i, j0, j1, _ in spans],
                        [dt for *_, dt in spans])
    runs = [[] for _ in range(p)]
    for (i, j0, j1, dt), piece in zip(spans, pieces):
        runs[i].append((j0, j1, dt, piece))
    del pieces

    def tile(i, j):
        for j0, j1, _, run in runs[i]:
            if j0 <= j < j1:
                return run[:, :, (j - j0) * nb:(j - j0 + 1) * nb]
        raise AssertionError((i, j))

    for k in range(p):
        diag = tile(k, k)
        l_kk = potrf(diag.contiguous())[0]          # line 8: dpotrf
        diag.copy_(l_kk)
        if k == p - 1:
            break
        l_kk_lo = l_kk.to(lo)                       # line 9: dlag2s -> tmp

        # panel TRSMs, one batched solve per storage class of column k
        cols = []
        for r0, r1, dt in _column_runs(policy, k, p):
            panel = torch.stack([tile(i, k) for i in range(r0, r1)], dim=1)
            if dt == hi:                            # line 12: dtrsm
                x = _trsm_right_lt(l_kk, panel, hi, hi)
            else:                                   # line 14: strsm
                x = _trsm_right_lt(l_kk_lo, panel.to(lo),
                                   policy.solve_dtype, dt)
            # unbind, not an index per tile: under autograd an index's
            # backward is a zero tensor of all of x
            for i, x_i in zip(range(r0, r1), x.unbind(1)):
                tile(i, k).copy_(x_i)
            cols.append(x.to(hi))                   # line 15: sconv2d

        # trailing update (lines 19, 25, 27): one SYRK per candidate over
        # the gathered panel column, then each run subtracts its block
        m_t = p - k - 1
        col = torch.cat(cols, dim=1).reshape(b_count, m_t * nb, nb)
        band = min(policy.diag_thick, m_t)
        for b, col_b in enumerate(col.unbind(0)):
            u = syrk(col_b, tile=nb, round_k=nb, band_blocks=band, hi=hi,
                     lo=lo, accum=policy.accum_dtype)
            # each run's share of tiles k + 1 .. i of U's row i
            spans = [(i, j0, dt, run, max(j0, k + 1), min(j1, i + 1))
                     for i in range(k + 1, p) for j0, j1, dt, run in runs[i]]
            spans = [sp for sp in spans if sp[4] < sp[5]]
            blks = _Cut.apply(
                u, [((i - k - 1) * nb, (i - k) * nb, (js - k - 1) * nb,
                     (je - k - 1) * nb) for i, _, _, _, js, je in spans],
                None)
            for (i, j0, dt, run, js, je), blk in zip(spans, blks):
                dst = run[b, :, (js - j0) * nb:(je - j0) * nb]
                if dt == hi:                        # lines 19, 25
                    dst.sub_(blk)
                elif dt == lo:                      # line 27, lo storage
                    dst.sub_(blk.to(lo))
                else:                               # line 27, lo2 storage
                    dst.copy_(dst.to(lo) - blk.to(lo))
            del u, blks

    spans = [(i, j0, j1, run) for i in range(p) for j0, j1, _, run in runs[i]]
    out = _Assemble.apply((b_count, n, n), hi,
                          [(i * nb, (i + 1) * nb, j0 * nb, j1 * nb)
                           for i, j0, j1, _ in spans],
                          *[run for *_, run in spans])
    return out.tril_().reshape(batch + (n, n))


def dst_cholesky(a, nb: int, diag_thick: int, hi=torch.float32):
    """DST / independent-blocks baseline (paper Sec. V-B, Fig. 1b).

    The matrix is replaced by its block-diagonal of "super-tiles" of
    diag_thick x diag_thick tiles (off-super-tile entries = zero), and each
    independent block is factored in full precision.  Returns the list of
    (block slice, factor) pairs.  Leading axes of `a` batch over
    independent matrices.
    """
    n = a.shape[-1]
    assert n % nb == 0
    super_nb = diag_thick * nb
    blocks = []
    for start in range(0, n, super_nb):
        sl = slice(start, min(start + super_nb, n))
        blocks.append((sl, _cholesky(a[..., sl, sl], hi)[0]))
    return blocks


def dst_assemble(blocks, n: int, dtype=torch.float32):
    """Assemble the block-diagonal factor into a dense (n, n) matrix."""
    dev = blocks[0][1].device
    out = torch.zeros((n, n), dtype=dtype, device=dev)
    for sl, l in blocks:
        out[sl, sl] = l.to(dtype)
    return out


def reference_cholesky(a, hi=torch.float32):
    """Plain dense Cholesky in hi precision (DP(100%) reference); all NaN
    where `a` is not positive definite, as the reference's."""
    return _cholesky(a, hi)[0]

