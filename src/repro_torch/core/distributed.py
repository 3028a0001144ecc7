"""Distributed mixed-precision panel Cholesky on a process grid.

Counterpart of `repro.core.distributed`, the reference's SPMD engine.  The
storage is the reference's:

  off  : (n, n) lo -- the tiles with i - j >= t; the band region and the
         upper triangle are exactly 0;
  band : (p, t, nb, nb) hi -- band[i, d] = tile (i, i - d), the paper's DP
         band; jitter on d = 0.

Without a grid (or on `make_smoke_grid()`) every function works on the
whole storage in one process, as the reference does without a mesh.  On a
`launch.mesh.Grid` each rank holds a slab (`Layout`), whole tiles, the first
slabs a tile larger where the grid does not divide p:

  masked_full, aligned : off[rows_r, cols_c] at grid position (r, c)
                         (rows over "data", columns over "model");
  fori                 : off[rows_q, :] at rank q (rows over both);
  band                 : the tile rows of the rank's off rows; under
                         masked_full and aligned, of each of their tiles
                         only the rank's share of the nb rows, split over
                         the grid columns as `slab_bounds` splits tiles
                         (the reference's constrain(band,
                         "geo_rows . geo_cols .")): a local band of
                         (rb - ra, t, nb_c, nb).  Under fori the rows
                         already go over every rank and there is one
                         column slab: each rank holds whole tiles, 1/(r m)
                         of the band;
  locations, z         : whole on every rank.

Per step k (the reference's numerics, `version` picks the lo rows):
  1. the ranks of tile row k's row slab gather band[k, 0]'s row shares
     along their grid row (nb^2 hi); the slab's owner factors it in hi (the
     blocked_potrf kernel for an fp32 band, cuSOLVER for fp64) and
     broadcasts L_kk;
  2. the ranks of band rows k+1 .. k+t-1 solve their rows of the band panel
     tiles in hi (X L_kk^T = A row by row); the ranks holding off's column
     k solve their rows >= k+t of it in solve_dtype with L_kk rounded to lo;
  3. the panel column c_lo (n, nb) in lo -- the band panel tiles rounded to
     lo (a reference quirk: the hi band updates below see them through lo),
     the off rows, zero elsewhere -- reaches every rank: the band panel
     tiles' row shares are gathered along each grid row (up to t - 1 tiles
     of nb^2), each row slab's piece is broadcast along its grid row from
     the holder of column k, then the pieces are gathered along each grid
     column;
  4. each rank subtracts c_t[i][its rows] c_t[i-d]^T (c_t = c_lo in hi)
     from its band rows, and U = c_lo c_lo^T (`lo_product`: fp32 sums
     rounded once to lo) from its off slab, under the mask (i - j >= t) &
     (j > k) & (i > k) on tile indices, as a subtract in lo.  masked_full
     and fori compute U for every row of the slab, aligned from the 16-tile
     boundary at or above k less a 16-tile fringe (the rows it skips are
     all masked).  U is computed in row chunks: no (n, n) temporary exists.

The solve stays in the factor's layout: per block j, the ranks of its row
slab gather band row j's row shares along their grid row (up to t tiles of
nb^2 hi a block, the whole band once over the solve; nothing is kept from
the factorization, which would hold p nb^2 hi a rank) and reduce their
partial residuals to the slab's owner, which solves w_j; w_j and its
log-determinant share are broadcast, and each rank pushes its off slab's
column j into its partial residual.

Collectives run over the grid's groups: NCCL for CUDA tensors, gloo for CPU
ones; a tensor whose device does not match the backend raises.  Under
`launch.roofline.count_collectives()` each collective adds the bytes it
moves on this rank to COLLECTIVE_COUNT (off, one None check a call).  `impl`
picks the kernels ("kernel": `matern_cov` and `blocked_potrf` through their
`ops`, the CUDA kernels on a CUDA tensor) or their plain versions
("plain"), as the panel engine's does.

The engine differentiates in theta and z as the reference does under
`jax.value_and_grad`: `geostat_loglik_distributed` with a theta (or z) that
requires grad builds the slabs through `DistributedMaternCov`, factors them
in place through `DistributedCholesky` and solves through
`DistributedLoglik`, three reverse sweeps on the same slabs:
  * the solve's (`loglik_distributed_backward`): v = L^-T wbar, wbar = -w,
    a transposed substitution from block p - 1 down (each rank pushes its
    rows of L^T v into its partial cotangent of w, reduced to block j's
    owner, which solves v_j and broadcasts it); z's cotangent is v, L_jj's
    -tril(v_j w_j^T) less the log-determinant's 1 / diag, band[j, d]'s
    -v_j w_{j-d}^T in each rank's row share, off's -v_i w_j^T on the tiles
    i - j >= t, rounded to lo;
  * the factorization's (`panel_cholesky_distributed_backward`), from step
    p - 1 down, reading only the final factor: the panel column c_lo
    rebuilt as the forward gathered it; C's cotangent from the hi band
    updates (in hi) and from the masked lo update (its plain products
    D c_lo and D^T c_lo, D = -off's cotangent under the step's mask, summed
    in the accumulator), summed over the grid and rounded to lo, so that
    the band panel X takes its share through lo as its hi updates read it
    (ROADMAP C 18); the two TRSMs' and L_kk's Cholesky backward, L_kk's
    cotangent reduced to its owner;
  * the build's (`build_covariance_distributed_backward`): theta's from the
    `matern_cov_grad` kernel over the off slab (its tiles i - j < t masked)
    and over each band sub-diagonal, all-reduced over the grid.
One backward serves the three versions (each the gradient of its own
factor).  Locations that require grad raise: the covariance's backward
gives theta's gradient only (the reference's is NaN, ROADMAP C 26).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.distributed as dist

from ..covariance.matern import HALF_INTEGER_NUS
from ..kernels.blocked_potrf import ops as potrf_ops
from ..launch.mesh import GRID_DIMS, LAYOUT_RULES, Grid, make_smoke_grid
from .panel_cholesky import (_host_theta, _impl, _potrf, _requires_grad,
                             _trsm_right_lt)
from .precision import PrecisionPolicy, require_ieee_fp32

VERSIONS = ("masked_full", "aligned", "fori")
# logical dimensions of off's rows and columns in each version
_OFF_AXES = {"masked_full": ("geo_rows", "geo_cols"),
             "aligned": ("geo_rows", "geo_cols"),
             "fori": ("geo_rows2d", None)}
# elements of one row chunk of U (2^28: 512 MiB in bf16, 1 GiB in fp32)
U_CHUNK_ELEMS = 1 << 28
# the active count of `launch.roofline.count_collectives` (None: off)
COLLECTIVE_COUNT: list = [None]


def _count(kind: str, group, *tensors):
    """Add the bytes of `tensors` (a collective's result on this rank) to
    the active count, where `group` spans more than this rank (a group of
    one, which a 1-wide grid dimension has, moves nothing)."""
    out = COLLECTIVE_COUNT[0]
    if out is not None and dist.get_world_size(group) > 1:
        out[kind] += sum(x.numel() * x.element_size() for x in tensors)
        out["count"] += 1


def slab_bounds(p: int, parts: int) -> tuple:
    """(a, b) tile ranges of `parts` slabs of p tiles, the first p % parts
    slabs a tile larger."""
    if parts > p:
        raise ValueError(f"{p} tiles over {parts} slabs: a slab would be empty")
    q, r = divmod(p, parts)
    bounds, a = [], 0
    for s in range(parts):
        b = a + q + (s < r)
        bounds.append((a, b))
        a = b
    return tuple(bounds)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the storage's tiles lie on a grid: the row and column slabs of
    off (`row_bounds`, `col_bounds`, in tiles), this rank's (ir, ic), and
    for each grid position its slab indices."""
    p: int
    grid: Grid
    row_bounds: tuple
    col_bounds: tuple
    parts: tuple          # (ir, ic) of each grid position, r * model + c

    @property
    def ir(self) -> int:
        return self.parts[self.grid.rank][0]

    @property
    def ic(self) -> int:
        return self.parts[self.grid.rank][1]

    @property
    def rows(self) -> tuple:
        return self.row_bounds[self.ir]

    @property
    def cols(self) -> tuple:
        return self.col_bounds[self.ic]

    def row_part(self, i: int) -> int:
        return next(s for s, (a, b) in enumerate(self.row_bounds) if a <= i < b)

    def col_part(self, j: int) -> int:
        return next(s for s, (a, b) in enumerate(self.col_bounds) if a <= j < b)

    def band_rows(self, nb: int) -> tuple:
        """(a, b): this rank's share of the nb rows of each band tile."""
        return slab_bounds(nb, len(self.col_bounds))[self.ic]

    def owner(self, ir: int, ic: int = 0) -> int:
        """The global rank of the first grid position holding slab (ir, ic)."""
        return self.grid.ranks[self.parts.index((ir, ic))]

    def _group(self, positions):
        g = self.grid
        if g.group is None:
            return None
        if len(positions) == g.size:
            return g.group
        for r in range(g.data):
            if positions == [r * g.model + c for c in range(g.model)]:
                return g.row_groups[r]
        for c in range(g.model):
            if positions == [r * g.model + c for r in range(g.data)]:
                return g.col_groups[c]
        if len(positions) == 1:
            return None
        raise ValueError(f"no process group for grid positions {positions}")

    def row_group(self):
        """The group of the ranks holding this rank's row slab."""
        return self._group([q for q, s in enumerate(self.parts)
                            if s[0] == self.ir])

    def row_members(self):
        """(group, column slab of each member in group order) of the ranks
        holding this rank's row slab."""
        pos = [q for q, s in enumerate(self.parts) if s[0] == self.ir]
        order = sorted(pos, key=lambda q: self.grid.ranks[q])
        return self._group(pos), [self.parts[q][1] for q in order]

    def col_members(self):
        """(group, row slab of each member in group order) of the ranks
        holding this rank's column slab."""
        pos = [q for q, s in enumerate(self.parts) if s[1] == self.ic]
        order = sorted(pos, key=lambda q: self.grid.ranks[q])
        return self._group(pos), [self.parts[q][0] for q in order]


def layout(p: int, grid: Grid | None = None,
           version: str = "masked_full") -> Layout:
    """The slabs of p tiles on `grid` (one process where None) that
    `version` stores off in (LAYOUT_RULES)."""
    if version not in VERSIONS:
        raise ValueError(f"version must be one of {VERSIONS}, got {version!r}")
    grid = grid if grid is not None else make_smoke_grid()
    sizes = dict(zip(GRID_DIMS, (grid.data, grid.model)))
    dims = [LAYOUT_RULES[axis] for axis in _OFF_AXES[version]]

    def index(pos, ds):  # slab index of a grid position over dimensions ds
        out = 0
        for d in ds:
            out = out * sizes[d] + pos[d]
        return out
    parts = tuple(
        tuple(index(dict(zip(GRID_DIMS, divmod(q, grid.model))), ds)
              for ds in dims) for q in range(grid.size))
    counts = [math.prod(sizes[d] for d in ds) for ds in dims]
    return Layout(p=p, grid=grid, row_bounds=slab_bounds(p, counts[0]),
                  col_bounds=slab_bounds(p, counts[1]), parts=parts)


def _lo_dtype(policy: PrecisionPolicy):
    return policy.lo if policy.mode != "full" else policy.hi


def _half_integer_nu(nu_static):
    if nu_static not in HALF_INTEGER_NUS:
        raise ValueError("distributed cov-gen uses half-integer nu, got "
                         f"{nu_static!r}")
    return nu_static


def _order(band, grid, n):
    """n, the whole matrix's order: given, or the band's rows in one
    process."""
    if n is None and grid is not None and grid.size > 1:
        raise ValueError("n (the whole matrix's order) is needed with a grid")
    return n if n is not None else band.shape[0] * band.shape[-1]


def _refuse_locs_grad(locs):
    if _requires_grad(locs):
        raise NotImplementedError(
            "the distributed panel engine does not differentiate in the "
            "locations: the covariance's backward gives theta's gradient "
            "only (the reference's locations gradient is NaN, ROADMAP C 26)")


# ----------------------------------------------------------------------
# storage construction
# ----------------------------------------------------------------------

def build_covariance_distributed(locs, theta, *, nb: int,
                                 policy: PrecisionPolicy, nu_static=0.5,
                                 jitter: float = 1e-6, grid: Grid | None = None,
                                 version: str = "masked_full",
                                 impl: str = "kernel"):
    """(off, band) from the Matern kernel: this rank's slab of each (the
    whole storage without a grid).

    The locations (n, 2), whole on every rank, are cast to hi first, as the
    reference's coordinates follow the band tier.  off is one matern_cov
    call over the slab (the symmetric form where its rows and columns are
    the same locations), rounded once to lo, then its band region and
    upper triangle set to 0; the band one call per sub-diagonal d over the
    rank's tile rows and its share of their nb rows, jitter added to d = 0.
    """
    _refuse_locs_grad(locs)
    nu = _half_integer_nu(nu_static)
    matern = _impl(impl)[0]
    n = locs.shape[0]
    if n % nb:
        raise ValueError(f"n={n} is not a multiple of nb={nb}")
    p = n // nb
    t = min(policy.diag_thick, p)
    hi, lo = policy.hi, _lo_dtype(policy)
    lay = layout(p, grid, version)
    lay.grid.check_device(locs, "locs")
    theta = _host_theta(theta)
    locs_hi = locs.to(hi).contiguous()
    (ra, rb), (ca, cb) = lay.rows, lay.cols

    rows_l = locs_hi[ra * nb:rb * nb]
    cols_l = rows_l if (ca, cb) == (ra, rb) else locs_hi[ca * nb:cb * nb]
    # written through a view into a tensor of its own (autograd's in-place
    # factorization may not take a view)
    off = torch.empty((rows_l.shape[0], cols_l.shape[0]), dtype=lo,
                      device=locs.device)
    matern.matern_cov_tiles(rows_l[None], cols_l[None], theta, nu=nu,
                            out_dtype=lo, out=off[None])
    for i in range(ra, rb):     # zero j > i - t: the band region and above
        j0 = max(i - t + 1, ca)
        if j0 < cb:
            off[(i - ra) * nb:(i - ra + 1) * nb, (j0 - ca) * nb:] = 0

    locs_t = locs_hi.view(p, nb, locs.shape[-1])
    s0, s1 = lay.band_rows(nb)
    band = torch.zeros((rb - ra, t, s1 - s0, nb), dtype=hi, device=locs.device)
    for d in range(t):
        i0 = max(ra, d)
        if i0 < rb:
            matern.matern_cov_tiles(locs_t[i0:rb, s0:s1].contiguous(),
                                    locs_t[i0 - d:rb - d], theta, nu=nu,
                                    out_dtype=hi, out=band[i0 - ra:, d])
    band[:, 0, :, s0:s1].diagonal(dim1=-2, dim2=-1).add_(jitter)
    return off, band


# ----------------------------------------------------------------------
# the factorization
# ----------------------------------------------------------------------

def lo_product(a, b, policy: PrecisionPolicy):
    """U = a b^T in lo for a: (m, nb), b: (n, nb) in lo: the reference's
    lo_matmul, products summed in fp32 and rounded once to lo.  On a CUDA
    tensor under a bf16 lo and an fp32 accumulator, a bf16-operand product
    whose sum stays fp32 (call it under `_fp32_reductions`); otherwise the
    operands are upcast to the accumulator."""
    lo, acc = policy.lo, policy.accum_dtype
    if a.is_cuda and lo == torch.bfloat16 and acc == torch.float32:
        # bf16 operands: every caller holds _fp32_reductions() (in
        # panel_cholesky_distributed, `with guard:`), so the sums stay fp32
        return (a.to(lo)  # repro: disable=accum-dtype -- under _fp32_reductions()
                @ b.to(lo).mT)
    return (a.to(lo).to(acc) @ b.to(lo).to(acc).mT).to(lo)


@contextlib.contextmanager
def _fp32_reductions():
    """bf16 products whose split sums stay fp32 (cuBLAS otherwise may
    reduce split-K partials in bf16)."""
    m = torch.backends.cuda.matmul
    old = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = (
            old)  # repro: disable=accum-dtype -- restores the caller's setting


def _bcast(group, tensor, src):
    if group is not None:
        dist.broadcast(tensor, src=src, group=group)
        _count("broadcast", group, tensor)


def _gather_rows(lay: Layout, x, nb):
    """Whole band tiles (..., nb, nb) from this rank's row shares x (...,
    nb_c, nb): gathered along the grid row (x itself where the rows are
    not split).  Every rank of the row slab calls it."""
    bounds = slab_bounds(nb, len(lay.col_bounds))
    if len(bounds) == 1:
        return x
    group, members = lay.row_members()
    share = bounds[0][1] - bounds[0][0]     # the first share is the largest
    buf = x.new_zeros(x.shape[:-2] + (share, x.shape[-1]))
    buf[..., :x.shape[-2], :] = x
    pieces = [torch.empty_like(buf) for _ in members]
    dist.all_gather(pieces, buf, group=group)
    _count("all-gather", group, *pieces)
    out = x.new_empty(x.shape[:-2] + (nb, x.shape[-1]))
    for c, got in zip(members, pieces):
        a, b = bounds[c]
        out[..., a:b, :] = got[..., :b - a, :]
    return out


def _panel_column(lay: Layout, piece, p, nb):
    """c_lo (p nb, nb) on every rank from this rank's row-slab `piece`
    (padded to the largest slab; filled on the holder of column k): along
    the grid row from that holder, then gathered along the grid column."""
    group, members = lay.col_members()
    if group is None:
        pieces = [piece]
    else:
        pieces = [torch.empty_like(piece) for _ in members]
        dist.all_gather(pieces, piece, group=group)
        _count("all-gather", group, *pieces)
    out = torch.empty((p * nb, nb), dtype=piece.dtype, device=piece.device)
    for s, got in zip(members, pieces):
        a, b = lay.row_bounds[s]
        out[a * nb:b * nb] = got[:(b - a) * nb]
    return out


def _panel_column_at(lay: Layout, off, band, k, t, pad, row_group):
    """Step k's panel column c_lo (p nb, nb) in lo on every rank, from this
    rank's slabs once step k's TRSMs have run: the band panel tiles (rows
    k+1 .. k+t-1, rounded to lo) and off's column k (rows >= k+t), zero
    elsewhere.  The band panel's row shares are gathered along each grid
    row, each row slab's piece is broadcast along its grid row from the
    holder of column k, then the pieces are gathered along each grid
    column.  Every rank calls it."""
    nb = band.shape[-1]
    p = lay.p
    (ra, rb), (ca, cb) = lay.rows, lay.cols
    bp_rows = range(max(ra, k + 1), min(rb, k + min(t - 1, p - k - 1) + 1))
    bp = (_gather_rows(lay, torch.stack(
        [band[i - ra, i - k] for i in bp_rows]), nb) if bp_rows else None)
    piece = torch.zeros((pad, nb), dtype=off.dtype, device=off.device)
    if ca <= k < cb:
        for i in bp_rows:
            piece[(i - ra) * nb:(i - ra + 1) * nb] = bp[i - bp_rows[0]]
        r0 = max(ra, k + t)
        if r0 < rb:
            piece[(r0 - ra) * nb:(rb - ra) * nb] = off[
                (r0 - ra) * nb:, (k - ca) * nb:(k - ca + 1) * nb]
    del bp
    _bcast(row_group, piece, lay.owner(lay.ir, lay.col_part(k)))
    return _panel_column(lay, piece, p, nb)


def _lo_rows(version, k, p, ra, align):
    """The first tile row of U that `version` computes at step k."""
    if version != "aligned":
        return ra
    start = min(-(-(k + 1) // align) * align, p)
    return max(start - align, ra, 0)


def panel_cholesky_distributed(off, band, policy: PrecisionPolicy, *,
                               version: str = "masked_full", align: int = 16,
                               grid: Grid | None = None, n: int | None = None,
                               impl: str = "kernel"):
    """Factor in place; returns (off, band) with L in the same layout.

    off, band: this rank's slabs (`build_covariance_distributed`,
    `interop.distributed_from_numpy`); n, the order of the whole matrix, is
    needed with a grid of more than one rank.
    version:
      masked_full : p full-width masked steps (U over every slab row);
      aligned     : U's rows pruned to the 16-tile boundary at or above k,
                    less a 16-tile fringe;
      fori        : masked_full's numerics on the fori layout (row slabs
                    over every rank, columns whole).
    """
    require_ieee_fp32()
    _, t, _, nb = band.shape
    p = _order(band, grid, n) // nb
    lay = layout(p, grid, version)
    g = lay.grid
    g.check_device(off, "off")
    (ra, rb), (ca, cb) = lay.rows, lay.cols
    s0, s1 = lay.band_rows(nb)
    if (band.shape[:3] != (rb - ra, t, s1 - s0)
            or off.shape != ((rb - ra) * nb, (cb - ca) * nb)):
        raise ValueError(
            f"band {tuple(band.shape)} and off {tuple(off.shape)} are not the "
            f"slabs of rows {lay.rows} and columns {lay.cols} of {p} tiles "
            f"(band rows {s0}:{s1} of each tile)")
    hi, lo, sd = policy.hi, off.dtype, policy.solve_dtype
    potrf = _potrf(impl, hi)
    row_group = lay.row_group()
    pad = max(b - a for a, b in lay.row_bounds) * nb
    chunk = max(1, U_CHUNK_ELEMS // (nb * nb * (cb - ca)))
    lkk = torch.empty((nb, nb), dtype=hi, device=band.device)
    guard = _fp32_reductions() if band.is_cuda else contextlib.nullcontext()
    with guard:
        for k in range(p):
            owner = lay.owner(lay.row_part(k))
            if ra <= k < rb:
                akk = _gather_rows(lay, band[k - ra, 0], nb)
                if g.ranks[g.rank] == owner:
                    lkk.copy_(potrf(akk)[0])
                del akk
            _bcast(g.group, lkk, owner)
            if ra <= k < rb:
                band[k - ra, 0] = lkk[s0:s1]
            m_t = p - k - 1
            if m_t == 0:
                break
            n_bp = min(t - 1, m_t)

            # panel TRSMs: this rank's rows of the hi band tiles, the lo
            # column (rows >= k+t)
            bp_rows = range(max(ra, k + 1), min(rb, k + n_bp + 1))
            for i in bp_rows:
                band[i - ra, i - k] = _trsm_right_lt(lkk, band[i - ra, i - k],
                                                     hi, hi)
            holds_k = ca <= k < cb
            kc = slice((k - ca) * nb, (k - ca + 1) * nb)
            r0 = max(ra, k + t)
            if holds_k and r0 < rb:
                off[(r0 - ra) * nb:, kc] = _trsm_right_lt(
                    lkk.to(lo), off[(r0 - ra) * nb:, kc], sd, lo)

            # the panel column in lo on every rank
            c_lo = _panel_column_at(lay, off, band, k, t, pad, row_group)

            # hi sub-diagonal updates of this rank's band rows from the
            # lo-rounded panel
            lo_t = max(k + 1, ra - t + 1)
            c_t = c_lo[lo_t * nb:rb * nb].view(-1, nb, nb).to(hi)
            for d in range(min(t, m_t)):
                i0 = max(ra, k + 1 + d)
                if i0 < rb:
                    band[i0 - ra:, d] -= (c_t[i0 - lo_t:rb - lo_t, s0:s1]
                                          @ c_t[i0 - d - lo_t:rb - d - lo_t].mT)
            del c_t

            # lo trailing update under the mask, a row chunk of U at a time
            c_cols = c_lo[ca * nb:cb * nb]
            for c0 in range(_lo_rows(version, k, p, ra, align), rb, chunk):
                c1 = min(c0 + chunk, rb)
                u = lo_product(c_lo[c0 * nb:c1 * nb], c_cols, policy)
                for i in range(max(c0, k + 1 + t), c1):
                    j0, j1 = max(k + 1, ca), min(i - t + 1, cb)
                    if j0 < j1:
                        off[(i - ra) * nb:(i - ra + 1) * nb,
                            (j0 - ca) * nb:(j1 - ca) * nb] -= (
                            u[(i - c0) * nb:(i - c0 + 1) * nb,
                              (j0 - ca) * nb:(j1 - ca) * nb])
                del u
            del c_lo, c_cols
    return off, band


# ----------------------------------------------------------------------
# solve / likelihood
# ----------------------------------------------------------------------

def loglik_distributed(off, band, z, t: int, *, grid: Grid | None = None,
                       version: str = "masked_full", n: int | None = None):
    """Blocked forward solve and log-determinant on the factor's layout.

    Column-wise substitution, as the reference's: block j's residual (the
    sum of its row slab's partial residuals, z on the slab's first column
    rank), less band[j, d] w_{j-d}, is solved with L_jj = band[j, 0]; band
    row j's row shares are gathered along the grid row for it; w_j and log
    det L_jj go to every rank, which push their off slab's column j into
    their partial residuals (off read into hi).  The log-determinant sums in
    block order on every rank: all ranks return the same value.
    """
    return _solve(off, band, z, t, grid=grid, version=version, n=n)[0]


def _solve(off, band, z, t, *, grid, version, n):
    """(ll, w) of `loglik_distributed`: w = L^-1 z (n,) in hi, whole on
    every rank."""
    require_ieee_fp32()
    nb = band.shape[-1]
    n = _order(band, grid, n)
    p = n // nb
    lay = layout(p, grid, version)
    g = lay.grid
    g.check_device(off, "off")
    hi = band.dtype
    (ra, rb), (ca, cb) = lay.rows, lay.cols
    row_group = lay.row_group()
    part = torch.zeros(((rb - ra) * nb,), dtype=hi, device=band.device)
    if lay.ic == 0:
        part += z.to(hi)[ra * nb:rb * nb]
    w = torch.zeros((n,), dtype=hi, device=band.device)
    logdet = torch.zeros((), dtype=hi, device=band.device)
    buf = torch.empty((nb + 1,), dtype=hi, device=band.device)
    for j in range(p):
        ir_j = lay.row_part(j)
        owner = lay.owner(ir_j)
        if lay.ir == ir_j:
            bj = _gather_rows(lay, band[j - ra, :min(j + 1, t)], nb)
            rhs = part[(j - ra) * nb:(j - ra + 1) * nb].clone()
            if row_group is not None:
                dist.reduce(rhs, dst=owner, op=dist.ReduceOp.SUM,
                            group=row_group)
                _count("reduce", row_group, rhs)
        if g.ranks[g.rank] == owner:
            for d in range(1, min(j + 1, t)):
                rhs = rhs - bj[d] @ w[(j - d) * nb:(j - d + 1) * nb]
            ljj = bj[0]
            buf[:nb] = torch.linalg.solve_triangular(ljj, rhs[:, None],
                                                     upper=False)[:, 0]
            buf[nb] = torch.sum(torch.log(torch.diagonal(ljj)))
        _bcast(g.group, buf, owner)
        w[j * nb:(j + 1) * nb] = buf[:nb]
        logdet = logdet + buf[nb]
        r0 = max(ra, j + t)
        if ca <= j < cb and r0 < rb:
            col = off[(r0 - ra) * nb:, (j - ca) * nb:(j - ca + 1) * nb]
            part[(r0 - ra) * nb:] -= col.to(hi) @ buf[:nb]
    ll = -0.5 * n * math.log(2.0 * math.pi) - logdet - 0.5 * torch.sum(w * w)
    return ll, w


# ----------------------------------------------------------------------
# the gradient: reverse sweeps on the slabs
# ----------------------------------------------------------------------

def _reduce(group, tensor, dst):
    """Sum `tensor` over `group` onto rank dst (nothing without a group)."""
    if group is not None:
        dist.reduce(tensor, dst=dst, op=dist.ReduceOp.SUM, group=group)
        _count("reduce", group, tensor)


def _all_reduce(group, tensor):
    """Sum `tensor` over `group` on every member (nothing without a group)."""
    if group is not None:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
        _count("all-reduce", group, tensor)


def loglik_distributed_backward(off, band, w, g_ll, t: int, *,
                                grid: Grid | None = None,
                                version: str = "masked_full",
                                n: int | None = None, storage: bool = True):
    """The reverse sweep of `loglik_distributed` from the factor (off, band),
    the forward's w and the cotangent g_ll of ll: (g_off, g_band, v), v =
    L^-T wbar the cotangent of z in hi (whole on every rank), wbar = -g_ll
    w, and with `storage` the cotangents of this rank's slabs (else None):

      L_jj = band[j, 0]: -tril(v_j w_j^T) - g_ll diag(1 / L_jj), in each
                         rank's share of the tile's rows;
      band[j, d], d > 0: -v_j w_{j-d}^T, likewise;
      off tile (i, j):   -v_i w_j^T where i - j >= t, rounded to lo (the
                         forward reads off into hi); 0 elsewhere.

    The transposed substitution runs from block p - 1 down: block j's
    cotangent (wbar_j, less what the rows below have pushed) is reduced to
    its owner, which gathers L_jj, solves v_j = L_jj^-T and broadcasts it;
    each rank then pushes its rows of block row j of L^T v (its share of
    the band tiles (j, j - d), its off slab's tiles (j, c), c <= j - t)
    into its partial cotangent of w."""
    require_ieee_fp32()
    nb = band.shape[-1]
    n = _order(band, grid, n)
    p = n // nb
    lay = layout(p, grid, version)
    g = lay.grid
    g.check_device(off, "off")
    hi, lo = band.dtype, off.dtype
    (ra, rb), (ca, cb) = lay.rows, lay.cols
    s0, s1 = lay.band_rows(nb)
    me = g.ranks[g.rank]
    g_ll = g_ll.to(hi)
    wbar = -g_ll * w
    part = torch.zeros((n,), dtype=hi, device=band.device)
    v = torch.zeros((n,), dtype=hi, device=band.device)
    g_off = torch.zeros_like(off) if storage else None
    g_band = torch.zeros_like(band) if storage else None
    ljj = torch.empty((nb, nb), dtype=hi, device=band.device)
    for j in reversed(range(p)):
        jb = slice(j * nb, (j + 1) * nb)
        owner = lay.owner(lay.row_part(j))
        acc = part[jb].clone()
        _reduce(g.group, acc, owner)
        mine = ra <= j < rb
        if mine:
            whole = _gather_rows(lay, band[j - ra, 0], nb)
            if me == owner:
                ljj.copy_(whole)
            del whole
        if me == owner:
            v[jb] = torch.linalg.solve_triangular(
                ljj.mT, (wbar[jb] + acc)[:, None], upper=True)[:, 0]
        _bcast(g.group, v[jb], owner)
        if not mine:
            continue
        vj = v[jb]
        bj = band[j - ra]
        for d in range(1, min(j + 1, t)):
            part[(j - d) * nb:(j - d + 1) * nb] -= bj[d].mT @ vj[s0:s1]
        c1 = min(j - t + 1, cb)
        row = slice((j - ra) * nb, (j - ra + 1) * nb)
        if ca < c1:
            part[ca * nb:c1 * nb] -= off[row, :(c1 - ca) * nb].mT.to(hi) @ vj
        if not storage:
            continue
        gl = -vj[s0:s1, None] * w[jb][None, :]
        g_band[j - ra, 0] = gl.tril(s0)
        diag = torch.diagonal(g_band[j - ra, 0], offset=s0)
        diag -= g_ll / torch.diagonal(bj[0], offset=s0)
        for d in range(1, min(j + 1, t)):
            g_band[j - ra, d] = (-vj[s0:s1, None]
                                 * w[(j - d) * nb:(j - d + 1) * nb][None, :])
        if ca < c1:
            g_off[row, :(c1 - ca) * nb] = (
                -vj[:, None] * w[ca * nb:c1 * nb][None, :]).to(lo)
    return g_off, g_band, v


def _acc_product(a, b, policy: PrecisionPolicy):
    """a @ b for a: (m, K), b: (K, nb) in lo, summed in the accumulator and
    returned in it, as the transpose of the reference's lo_matmul sums C's
    cotangent: on a CUDA tensor under a bf16 lo and an fp32 accumulator a
    bf16-operand product whose fp32 sums are rounded once to lo (call it
    under `_fp32_reductions`; on a grid of one rank the reference's
    rounding, since its cotangents are rounded to C's dtype), otherwise the
    operands upcast to the accumulator."""
    acc = policy.accum_dtype
    if a.is_cuda and a.dtype == torch.bfloat16 and acc == torch.float32:
        # bf16 operands: every caller holds _fp32_reductions()
        return (a @ b).to(acc)  # repro: disable=accum-dtype -- under _fp32_reductions()
    return a.to(acc) @ b.to(acc)


def panel_cholesky_distributed_backward(off, band, g_off, g_band,
                                        policy: PrecisionPolicy, *,
                                        version: str = "masked_full",
                                        grid: Grid | None = None,
                                        n: int | None = None):
    """The reverse sweep of `panel_cholesky_distributed`: from this rank's
    factored slabs (off, band) and the cotangents (g_off in lo, g_band in
    hi) of the factor, the cotangents of the slabs it factored, written in
    place into g_off and g_band and returned.  The same for every version
    (each the gradient of its own factor) and either impl: no kernel runs
    in this sweep.

    Step k, from the last, reads only the final factor:
      * the panel column c_lo, rebuilt on every rank as the forward built
        it (the same gathers and broadcasts), and c_t = c_lo in hi;
      * the hi band updates band[i, d] -= c_t[i] c_t[i-d]^T (this rank's
        share of tile row i's rows): their cotangents G give c_t's, -G
        c_t[i-d] and -G^T c_t[i], in hi;
      * the lo update off -= U under the mask (i - j >= t) & (j > k) &
        (i > k), U = c_lo c_lo^T: with D = -g_off there, -(D c_lo) per
        tile row and -(D^T c_lo) per tile column of the slab, each one
        product summed in the accumulator (`_acc_product`);
      * the three summed in the accumulator over the grid (an all-reduce,
        the adjoint of the panel column's gathers), each rounded to lo and
        added in lo, as the reference's casts pass them back: the band panel
        X = band[k+d, d] takes its share through lo (ROADMAP C 18), the lo
        column Y = off[rows >= k+t, k] adds it to its own in lo;
      * the hi TRSM X = B L_kk^-T: B's cotangent Xbar L_kk^-1 (each row
        share alone) and -Bbar^T X into L_kk's; the lo TRSM, solved in
        solve_dtype with L_kk rounded to lo: the same in solve_dtype, B's
        cotangent stored in lo, L_kk's share rounded to lo and back to hi
        once summed;
      * L_kk's cotangent (its row shares and the TRSMs' shares) reduced to
        its owner, which runs `cholesky_backward` and broadcasts the result
        along the grid row, each rank keeping its share.
    A NaN factor gives NaN cotangents."""
    require_ieee_fp32()
    _, t, _, nb = band.shape
    p = _order(band, grid, n) // nb
    n = p * nb
    lay = layout(p, grid, version)
    g = lay.grid
    g.check_device(off, "off")
    (ra, rb), (ca, cb) = lay.rows, lay.cols
    s0, s1 = lay.band_rows(nb)
    hi, lo, sd = policy.hi, off.dtype, policy.solve_dtype
    acc = torch.promote_types(policy.accum_dtype, lo)
    me = g.ranks[g.rank]
    row_group = lay.row_group()
    pad = max(b - a for a, b in lay.row_bounds) * nb
    lkk = torch.empty((nb, nb), dtype=hi, device=band.device)
    ga = torch.empty((nb, nb), dtype=hi, device=band.device)
    guard = _fp32_reductions() if band.is_cuda else contextlib.nullcontext()
    with guard:
        for k in reversed(range(p)):
            owner = lay.owner(lay.row_part(k))
            mine_k = ra <= k < rb
            if mine_k:
                whole = _gather_rows(lay, band[k - ra, 0], nb)
                if me == owner:
                    lkk.copy_(whole)
                del whole
            _bcast(g.group, lkk, owner)
            gl = torch.zeros((nb, nb), dtype=hi, device=band.device)
            gl_sd = torch.zeros((nb, nb), dtype=sd, device=band.device)
            if mine_k:
                gl[s0:s1] = g_band[k - ra, 0]
            m_t = p - k - 1
            if m_t:
                c_lo = _panel_column_at(lay, off, band, k, t, pad, row_group)
                # C's cotangent from the lo product's two operands and from
                # the band updates, rows k+1 .. p-1, summed apart: the
                # reference rounds each to lo before it adds them
                gc = torch.zeros((3, m_t * nb, nb), dtype=acc,
                                 device=band.device)
                base = (k + 1) * nb

                # the hi band updates: c_t's cotangent, this rank's share
                lo_t = max(k + 1, ra - t + 1)
                if lo_t < rb:
                    c_t = c_lo[lo_t * nb:rb * nb].view(-1, nb, nb).to(hi)
                    g_t = torch.zeros_like(c_t)
                    for d in range(min(t, m_t)):
                        i0 = max(ra, k + 1 + d)
                        if i0 < rb:
                            gd = g_band[i0 - ra:, d]
                            g_t[i0 - lo_t:rb - lo_t, s0:s1] -= (
                                gd @ c_t[i0 - d - lo_t:rb - d - lo_t])
                            g_t[i0 - d - lo_t:rb - d - lo_t] -= (
                                gd.mT @ c_t[i0 - lo_t:rb - lo_t, s0:s1])
                    gc[2, lo_t * nb - base:rb * nb - base] = g_t.view(-1, nb)
                    del c_t, g_t

                # the lo update under the mask: -(D c_lo) by tile row,
                # -(D^T c_lo) by tile column of this rank's slab
                for i in range(max(ra, k + 1 + t), rb):
                    j0, j1 = max(k + 1, ca), min(i - t + 1, cb)
                    if j0 < j1:
                        gc[0, i * nb - base:(i + 1) * nb - base] -= _acc_product(
                            g_off[(i - ra) * nb:(i - ra + 1) * nb,
                                  (j0 - ca) * nb:(j1 - ca) * nb],
                            c_lo[j0 * nb:j1 * nb], policy)
                for j in range(max(k + 1, ca), cb):
                    i0 = max(ra, j + t)
                    if i0 < rb:
                        gc[1, j * nb - base:(j + 1) * nb - base] -= _acc_product(
                            g_off[(i0 - ra) * nb:,
                                  (j - ca) * nb:(j - ca + 1) * nb].mT,
                            c_lo[i0 * nb:rb * nb], policy)
                _all_reduce(g.group, gc)
                gc_lo = (gc[0].to(lo) + gc[1].to(lo)) + gc[2].to(lo)
                del gc

                # the band panel's hi TRSM, each row share alone
                n_bp = min(t - 1, m_t)
                for i in range(max(ra, k + 1), min(rb, k + n_bp + 1)):
                    d = i - k
                    gx = g_band[i - ra, d] + gc_lo[
                        i * nb - base + s0:i * nb - base + s1].to(hi)
                    gb = torch.linalg.solve_triangular(lkk, gx, upper=False,
                                                       left=False)
                    gl -= gb.mT @ band[i - ra, d]
                    g_band[i - ra, d] = gb
                # the lo column's TRSM, on the holders of column k
                r0 = max(ra, k + t)
                if ca <= k < cb and r0 < rb:
                    kc = slice((k - ca) * nb, (k - ca + 1) * nb)
                    gy = (g_off[(r0 - ra) * nb:, kc]
                          + gc_lo[r0 * nb - base:rb * nb - base]).to(sd)
                    go = torch.linalg.solve_triangular(
                        lkk.to(lo).to(sd), gy, upper=False, left=False)
                    gl_sd -= go.mT @ off[(r0 - ra) * nb:, kc].to(sd)
                    g_off[(r0 - ra) * nb:, kc] = go.to(lo)
                    # the column's two sd buffers would live into the next
                    # step's band updates (8 bytes an element of it)
                    del gy, go
                del c_lo, gc_lo

            # L_kk's cotangent on its owner, then A_kk's row shares
            _reduce(g.group, gl, owner)
            _reduce(g.group, gl_sd, owner)
            if me == owner:
                ga.copy_(potrf_ops.cholesky_backward(
                    gl + gl_sd.to(lo).to(hi), lkk))
            if mine_k:
                _bcast(row_group, ga, owner)
                g_band[k - ra, 0] = ga[s0:s1]
    return g_off, g_band


def build_covariance_distributed_backward(locs, theta, g_off, g_band, *,
                                          nb: int, policy: PrecisionPolicy,
                                          nu_static=0.5,
                                          grid: Grid | None = None,
                                          version: str = "masked_full",
                                          matern=None, impl: str = "kernel"):
    """The gradient in (theta1, theta2) of sum(g_off * off) + sum(g_band *
    band) for the slabs `build_covariance_distributed` builds: a (2,) fp64
    tensor, the same on every rank (all-reduced over the grid).

    The off slab's backward is one `matern_cov_grad_tiles` call over the
    slab as it lies (the form its forward was computed in: the symmetric
    one where its rows and columns are the same locations and G is in
    their precision), after g_off's tiles j > i - t -- the band region and
    the upper triangle, which the forward set to 0 -- are set to 0 in
    place; each band sub-diagonal d one call over the rank's rows of
    g_band[:, d].  `matern` is the module whose functions run (this impl's:
    the kernel on a CUDA tensor, or its plain version)."""
    nu = _half_integer_nu(nu_static)
    matern = matern if matern is not None else _impl(impl)[0]
    n = locs.shape[0]
    p = n // nb
    t = g_band.shape[1]
    hi = policy.hi
    lay = layout(p, grid, version)
    theta = _host_theta(theta)
    locs_hi = locs.to(hi).contiguous()
    (ra, rb), (ca, cb) = lay.rows, lay.cols
    for i in range(ra, rb):     # the tiles the forward set to 0
        j0 = max(i - t + 1, ca)
        if j0 < cb:
            g_off[(i - ra) * nb:(i - ra + 1) * nb, (j0 - ca) * nb:] = 0
    rows_l = locs_hi[ra * nb:rb * nb]
    cols_l = rows_l if (ca, cb) == (ra, rb) else locs_hi[ca * nb:cb * nb]
    grad = matern.matern_cov_grad_tiles(rows_l[None], cols_l[None], theta,
                                        g_off[None], nu=nu)
    locs_t = locs_hi.view(p, nb, locs.shape[-1])
    s0, s1 = lay.band_rows(nb)
    for d in range(t):
        i0 = max(ra, d)
        if i0 < rb:
            grad = grad + matern.matern_cov_grad_tiles(
                locs_t[i0:rb, s0:s1].contiguous(), locs_t[i0 - d:rb - d],
                theta, g_band[i0 - ra:, d], nu=nu)
    _all_reduce(lay.grid.group, grad)
    return grad


class DistributedMaternCov(torch.autograd.Function):
    """(off, band) = build(theta) on this rank's slabs, differentiable in the
    tensor theta (theta1, theta2[, theta3]): `build` is the forward
    (`build_covariance_distributed` with everything but theta bound, handed
    theta without its graph), the backward
    `build_covariance_distributed_backward` with the module `matern`;
    theta3 gets a zero gradient (a half-integer nu ignores it).  It saves
    the locations only, so the engine factors the slabs in place.

        DistributedMaternCov.apply(locs, theta, build, backward_kw, matern)
    """

    @staticmethod
    def forward(ctx, locs, theta, build, backward_kw, matern):
        off, band = build(theta.detach())
        ctx.save_for_backward(locs)
        ctx.th = [float(v) for v in theta.detach().reshape(-1).tolist()]
        ctx.kw, ctx.matern = backward_kw, matern
        ctx.theta_dtype, ctx.theta_device = theta.dtype, theta.device
        ctx.theta_shape = theta.shape
        return off, band

    @staticmethod
    def backward(ctx, g_off, g_band):
        (locs,) = ctx.saved_tensors
        grad = build_covariance_distributed_backward(
            locs, ctx.th, g_off.contiguous(), g_band.contiguous(),
            matern=ctx.matern, **ctx.kw)
        d_theta = torch.zeros(len(ctx.th), dtype=ctx.theta_dtype,
                              device=ctx.theta_device)
        d_theta[:2] = grad.to(ctx.theta_device)
        return None, d_theta.reshape(ctx.theta_shape), None, None, None


class DistributedCholesky(torch.autograd.Function):
    """(off, band) = panel_cholesky_distributed(off, band), in place on this
    rank's slabs, differentiable in both: the forward marks them dirty and
    saves the factor only; the backward is
    `panel_cholesky_distributed_backward`, in place on the cotangents the
    solve's backward hands it.

        DistributedCholesky.apply(off, band, policy, version, grid, n, impl)
    """

    @staticmethod
    def forward(ctx, off, band, policy, version, grid, n, impl):
        off, band = panel_cholesky_distributed(off, band, policy,
                                               version=version, grid=grid,
                                               n=n, impl=impl)
        ctx.mark_dirty(off, band)
        ctx.save_for_backward(off, band)
        ctx.args = (policy, version, grid, n)
        return off, band

    @staticmethod
    def backward(ctx, g_off, g_band):
        off, band = ctx.saved_tensors
        policy, version, grid, n = ctx.args
        g_off, g_band = panel_cholesky_distributed_backward(
            off, band, g_off.contiguous(), g_band.contiguous(), policy,
            version=version, grid=grid, n=n)
        return g_off, g_band, None, None, None, None, None


class DistributedLoglik(torch.autograd.Function):
    """ll = loglik_distributed(off, band, z), differentiable in the factor's
    slabs and z: the forward keeps w, the backward is
    `loglik_distributed_backward` (the slabs' cotangents only where they
    are needed); z's cotangent is v, whole on every rank.

        DistributedLoglik.apply(off, band, z, t, grid, version, n)
    """

    @staticmethod
    def forward(ctx, off, band, z, t, grid, version, n):
        ll, w = _solve(off, band, z, t, grid=grid, version=version, n=n)
        ctx.save_for_backward(off, band, w)
        ctx.args = (t, grid, version, n)
        ctx.z_dtype = z.dtype
        return ll

    @staticmethod
    def backward(ctx, g_ll):
        off, band, w = ctx.saved_tensors
        t, grid, version, n = ctx.args
        storage = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        g_off, g_band, v = loglik_distributed_backward(
            off, band, w, g_ll, t, grid=grid, version=version, n=n,
            storage=storage)
        g_z = v.to(ctx.z_dtype) if ctx.needs_input_grad[2] else None
        return g_off, g_band, g_z, None, None, None, None


def geostat_loglik_distributed(locs, z, theta, *, nb: int,
                               policy: PrecisionPolicy, nu_static=0.5,
                               version: str = "masked_full",
                               grid: Grid | None = None, impl: str = "kernel"):
    """One likelihood evaluation: build, factor and solve on the grid's
    slabs (one process without a grid).  A 0-d tensor in hi on the device
    of `locs`, the same value on every rank; NaN where a diagonal tile was
    not positive definite.

    A theta tensor that requires grad (grad mode on) builds, factors and
    solves through `DistributedMaternCov`, `DistributedCholesky` and
    `DistributedLoglik`; a z that requires grad through the last.  Every
    rank of a grid then calls the backward (it runs collectives) and gets
    the same gradient in theta (theta3 0 under a half-integer nu) and z.
    ll has the same bits with and without autograd.  Locations that
    require grad raise."""
    _refuse_locs_grad(locs)
    n = locs.shape[0]
    kw = dict(nb=nb, policy=policy, nu_static=nu_static, grid=grid,
              version=version)
    grad_theta = _requires_grad(theta)
    if grad_theta:
        build = functools.partial(build_covariance_distributed, locs,
                                  impl=impl, **kw)
        off, band = DistributedMaternCov.apply(
            locs, theta, build, dict(kw, impl=impl), _impl(impl)[0])
        off, band = DistributedCholesky.apply(off, band, policy, version,
                                              grid, n, impl)
    else:
        off, band = build_covariance_distributed(locs, theta, impl=impl, **kw)
        off, band = panel_cholesky_distributed(off, band, policy,
                                               version=version, grid=grid,
                                               n=n, impl=impl)
    t = band.shape[1]
    if grad_theta or _requires_grad(z):
        return DistributedLoglik.apply(off, band, z, t, grid, version, n)
    return loglik_distributed(off, band, z, t, grid=grid, version=version, n=n)
