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
("plain"), as the panel engine's does.  The engine is not differentiable:
a theta or locations that require grad raise (ROADMAP A 16).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from ..covariance.matern import HALF_INTEGER_NUS
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


def _refuse_grad(*values):
    if _requires_grad(*values):
        raise NotImplementedError(
            "the distributed panel engine is not differentiable (ROADMAP "
            "A 16): theta and the locations must not require grad; "
            "geostat_loglik_step differentiates in theta")


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
    _refuse_grad(locs, theta)
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
    off = matern.matern_cov_tiles(rows_l[None], cols_l[None], theta, nu=nu,
                                  out_dtype=lo)[0]
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
            bp = (_gather_rows(lay, torch.stack(
                [band[i - ra, i - k] for i in bp_rows]), nb)
                  if bp_rows else None)
            piece = torch.zeros((pad, nb), dtype=lo, device=off.device)
            if holds_k:
                for i in bp_rows:
                    piece[(i - ra) * nb:(i - ra + 1) * nb] = bp[i - bp_rows[0]]
                if r0 < rb:
                    piece[(r0 - ra) * nb:(rb - ra) * nb] = off[(r0 - ra) * nb:, kc]
            _bcast(row_group, piece, lay.owner(lay.ir, lay.col_part(k)))
            c_lo = _panel_column(lay, piece, p, nb)
            del piece, bp

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
    return (-0.5 * n * math.log(2.0 * math.pi) - logdet
            - 0.5 * torch.sum(w * w))


def geostat_loglik_distributed(locs, z, theta, *, nb: int,
                               policy: PrecisionPolicy, nu_static=0.5,
                               version: str = "masked_full",
                               grid: Grid | None = None, impl: str = "kernel"):
    """One likelihood evaluation: build, factor and solve on the grid's
    slabs (one process without a grid).  A 0-d tensor in hi on the device
    of `locs`, the same value on every rank; NaN where a diagonal tile was
    not positive definite."""
    n = locs.shape[0]
    off, band = build_covariance_distributed(
        locs, theta, nb=nb, policy=policy, nu_static=nu_static, grid=grid,
        version=version, impl=impl)
    t = band.shape[1]
    off, band = panel_cholesky_distributed(off, band, policy, version=version,
                                           grid=grid, n=n, impl=impl)
    return loglik_distributed(off, band, z, t, grid=grid, version=version, n=n)
