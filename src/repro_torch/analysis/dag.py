"""Tile-DAG hazard checker: the StarPU-dependency-tracker guarantee, statically.

Counterpart of `repro.analysis.dag`, on the port's `PrecisionPolicy`.  It
rebuilds each engine variant's task graph symbolically (POTRF / TRSM /
SYRK / GEMM / CONVERT over tile indices -- no numerics executed) and
proves three properties of an emitted order:

  1. hazard freedom -- every tile obeys the Cholesky dataflow protocol
     (updates for k in increasing order with no gap, factor op exactly
     once at step j, strictly read-only afterwards).  Any RAW (read of a
     not-yet-produced panel/update), WAW (duplicate or out-of-order
     write), or WAR (write into a tile already consumed as factored
     output) is reported with the offending task;

  2. precision-edge consistency -- a task never consumes a tile stored in
     a different tier without an explicit CONVERT (the paper's `dlag2s`
     demote / `sconv2d` promote) of the *current* version; conversions of
     stale versions do not count;

  3. a cost report -- per-tier FLOP totals, conversion traffic, and the
     critical path (longest RAW/WAW chain).

The task streams are those of the reference's engines (`tile_dag` is
Algorithm 1's tile loop nest, `panel_dag` the banded split-storage engine,
`dst_dag` the dense super-blocks): the dynamic runtime (`repro_torch.sched`)
executes exactly these tasks, one tile op each, and its dispatch order is
replayed here.  Pure Python; no device.
"""

from __future__ import annotations

import dataclasses

from ..core.precision import PrecisionPolicy

HI, LO, LO2 = "hi", "lo", "lo2"

# FLOPs per tile op, in units of nb^3 (nb = tile edge).  POTRF is nb^3/3,
# TRSM nb^3, SYRK nb^3 (symmetric rank-nb update), GEMM 2 nb^3.
_FLOP_UNITS = {"POTRF": 1.0 / 3.0, "TRSM": 1.0, "SYRK": 1.0, "GEMM": 2.0}


@dataclasses.dataclass(frozen=True)
class Task:
    kind: str                      # POTRF | TRSM | SYRK | GEMM | CONVERT
    k: int                         # panel step the task belongs to
    target: tuple[int, int]        # tile written (CONVERT: tile copied)
    reads: tuple[tuple[int, int], ...] = ()
    tier: str = HI                 # execution tier (CONVERT: dst tier)
    src_tier: str | None = None    # CONVERT only: tier of the source value

    def __str__(self):
        rd = ",".join(f"({i},{j})" for i, j in self.reads)
        extra = f" {self.src_tier}->{self.tier}" if self.kind == "CONVERT" \
            else f" [{self.tier}]"
        return f"{self.kind}{self.target}@k={self.k}{extra}" + (
            f" reads {rd}" if rd else "")


class HazardError(AssertionError):
    """A RAW/WAR/WAW or precision-consistency violation in a task stream."""


# ---------------------------------------------------------------------------
# storage-tier maps (mirror PrecisionPolicy.tile_dtype / the panel split)
# ---------------------------------------------------------------------------

def storage_tier(policy: PrecisionPolicy, i: int, j: int, *,
                 variant: str = "tile") -> str | None:
    """Tier the engine stores tile (i, j) in.  None = dropped (DST)."""
    d = abs(i - j)
    if variant == "dst":
        # independent super-blocks of diag_thick tiles: tiles whose row and
        # column fall in the same block are hi, everything else is dropped
        return HI if i // policy.diag_thick == j // policy.diag_thick else None
    if policy.mode == "full" or d < policy.diag_thick:
        return HI
    if variant == "panel":
        # the banded engine's off storage is single-tier policy.lo even for
        # three_tier (build_banded_covariance line "lo = policy.lo")
        return LO
    if policy.mode == "three_tier" and d >= policy.diag_thick2:
        return LO2
    return LO


# ---------------------------------------------------------------------------
# generators: transliterations of the three engines' loop nests
# ---------------------------------------------------------------------------

def tile_dag(p: int, policy: PrecisionPolicy) -> list[Task]:
    """Task stream of core/tile_cholesky.py's unrolled Algorithm 1."""
    if policy.mode == "dst":
        raise ValueError("use dst_dag for the DST baseline")
    tasks: list[Task] = []
    emit = tasks.append
    tier = lambda i, j: storage_tier(policy, i, j, variant="tile")

    for k in range(p):
        emit(Task("POTRF", k, (k, k), reads=((k, k),), tier=HI))
        if any(tier(i, k) != HI for i in range(k + 1, p)):
            # line 9 dlag2s: lo tmp copy of the factored diagonal tile
            emit(Task("CONVERT", k, (k, k), tier=LO, src_tier=HI))

        for i in range(k + 1, p):                     # panel TRSMs
            t_ik = tier(i, k)
            if t_ik == HI:                            # line 12 dtrsm
                emit(Task("TRSM", k, (i, k), reads=((k, k), (i, k)), tier=HI))
            else:                                     # line 14 strsm
                if t_ik == LO2:   # store[(i,k)].astype(lo) promotes far tiles
                    emit(Task("CONVERT", k, (i, k), tier=LO, src_tier=LO2))
                emit(Task("TRSM", k, (i, k), reads=((k, k), (i, k)), tier=LO))

        for j in range(k + 1, p):                     # trailing update
            if tier(j, k) != HI:                      # line 15 sconv2d
                emit(Task("CONVERT", k, (j, k), tier=HI, src_tier=tier(j, k)))
            emit(Task("SYRK", k, (j, j), reads=((j, k), (j, j)), tier=HI))
            for i in range(j + 1, p):
                if tier(i, j) == HI:                  # line 25 dgemm
                    if tier(i, k) != HI:
                        emit(Task("CONVERT", k, (i, k), tier=HI,
                                  src_tier=tier(i, k)))
                    emit(Task("GEMM", k, (i, j),
                              reads=((i, k), (j, k), (i, j)), tier=HI))
                else:                                 # line 27 sgemm
                    for (r, c) in ((i, k), (j, k)):
                        if tier(r, c) != LO:   # lo_matmul's astype(lo):
                            # demotes hi band-panel tiles, promotes lo2
                            emit(Task("CONVERT", k, (r, c), tier=LO,
                                      src_tier=tier(r, c)))
                    if tier(i, j) == LO2:  # store[(i,j)].astype(lo)
                        emit(Task("CONVERT", k, (i, j), tier=LO, src_tier=LO2))
                    emit(Task("GEMM", k, (i, j),
                              reads=((i, k), (j, k), (i, j)), tier=LO))
    return tasks


def panel_dag(p: int, policy: PrecisionPolicy) -> list[Task]:
    """Task stream of core/panel_cholesky.py's banded split-storage engine."""
    if policy.mode == "dst":
        raise ValueError("use dst_dag for the DST baseline")
    t = min(policy.diag_thick, p)
    tasks: list[Task] = []
    emit = tasks.append
    tier = lambda i, j: storage_tier(policy, i, j, variant="panel")

    for k in range(p):
        emit(Task("POTRF", k, (k, k), reads=((k, k),), tier=HI))
        m_t = p - k - 1
        if m_t == 0:
            break
        if k + t <= p - 1:
            emit(Task("CONVERT", k, (k, k), tier=LO, src_tier=HI))  # lkk_lo

        n_band_panel = min(t - 1, m_t)
        for d in range(1, n_band_panel + 1):          # dtrsm on band panel
            emit(Task("TRSM", k, (k + d, k), reads=((k, k), (k + d, k)),
                      tier=HI))
        for i in range(k + t, p):                     # batched strsm
            emit(Task("TRSM", k, (i, k), reads=((k, k), (i, k)), tier=LO))

        # gather c_hi: off rows promoted lo -> hi (off[k+t:, k].astype(hi))
        for i in range(k + t, p):
            emit(Task("CONVERT", k, (i, k), tier=HI, src_tier=LO))

        # hi band updates, sub-diagonals d = 0..t-1 (dsyrk / dgemm)
        for d in range(0, min(t, m_t)):
            for r in range(k + 1 + d, p):             # target tile (r, r-d)
                c = r - d
                kind = "SYRK" if d == 0 else "GEMM"
                emit(Task(kind, k, (r, c), reads=((r, k), (c, k), (r, c)),
                          tier=HI))

        # demote the gathered panel: c_lo = c_hi.astype(lo) -- band rows
        # need an explicit hi -> lo copy (off rows are already stored lo)
        has_off_targets = any(i - j >= t
                              for j in range(k + 1, p) for i in range(j, p))
        if has_off_targets:
            for d in range(1, n_band_panel + 1):
                emit(Task("CONVERT", k, (k + d, k), tier=LO, src_tier=HI))

        # lo off-band update (sgemm over the masked trapezoid)
        for j in range(k + 1, p):
            for i in range(j + t, p):
                emit(Task("GEMM", k, (i, j), reads=((i, k), (j, k), (i, j)),
                          tier=LO))
    return tasks


def dst_dag(p: int, policy: PrecisionPolicy) -> list[Task]:
    """Task stream of the DST baseline: dense Cholesky per super-block.

    Any policy's diag_thick defines the super-block size (the engine takes
    it as a bare int); all math is hi, off-block tiles are dropped.
    """
    bs = min(policy.diag_thick, p)
    tasks: list[Task] = []
    emit = tasks.append
    start = 0
    while start < p:
        stop = min(start + bs, p)
        for k in range(start, stop):                  # dense right-looking
            emit(Task("POTRF", k, (k, k), reads=((k, k),), tier=HI))
            for i in range(k + 1, stop):
                emit(Task("TRSM", k, (i, k), reads=((k, k), (i, k)), tier=HI))
            for j in range(k + 1, stop):
                emit(Task("SYRK", k, (j, j), reads=((j, k), (j, j)), tier=HI))
                for i in range(j + 1, stop):
                    emit(Task("GEMM", k, (i, j),
                              reads=((i, k), (j, k), (i, j)), tier=HI))
        start = stop
    return tasks


VARIANTS = {"tile": tile_dag, "panel": panel_dag, "dst": dst_dag}


def build_dag(variant: str, p: int, policy: PrecisionPolicy) -> list[Task]:
    return VARIANTS[variant](p, policy)


# ---------------------------------------------------------------------------
# dependency structure (shared by the checker and the runtime, sched/)
# ---------------------------------------------------------------------------

def task_dependencies(tasks: list[Task], p: int, policy: PrecisionPolicy,
                      variant: str) -> list[tuple[int, ...]]:
    """Per-task producer indices, aligned with each task's operand list.

    For a compute task, entry m is the index of the task whose output
    operand ``reads[m]`` consumes: the tile's last writer, or -- when the
    read crosses storage tiers -- the CONVERT that produced the copy being
    read.  For a CONVERT task the single entry is the producer of the
    source value.  ``-1`` marks an initial-storage operand (no producing
    task).  This is the one dependency computation shared by `check_dag`'s
    critical-path DP and the dynamic scheduler (`sched.runtime`): an edge
    here IS an edge in the runtime's ready-queue graph.

    Permissive by design: on a corrupted stream a missing producer
    degrades to the tile's last writer / -1, so `check_dag`'s protocol
    state machine (not this helper) reports the violation.
    """
    tier_of = lambda i, j: storage_tier(policy, i, j, variant=variant)
    last_writer: dict[tuple[int, int], int] = {}
    copies: dict[tuple[tuple[int, int], str], int] = {}
    deps: list[tuple[int, ...]] = []
    for idx, task in enumerate(tasks):
        tile = task.target
        if task.kind == "CONVERT":
            if task.src_tier == tier_of(*tile):
                src = last_writer.get(tile, -1)
            else:            # chained copy: source is itself a conversion
                src = copies.get((tile, task.src_tier),
                                 last_writer.get(tile, -1))
            deps.append((src,))
            copies[(tile, task.tier)] = idx
        else:
            row = []
            for r in task.reads:
                if tier_of(*r) in (task.tier, None):
                    row.append(last_writer.get(r, -1))
                else:        # cross-tier read goes through the current copy
                    # (in-place operands too: an lo2-stored tile consumed in
                    # lo reads its CONVERT product, exactly like the
                    # engine's astype(lo) of the accumulator)
                    row.append(copies.get((r, task.tier),
                                          last_writer.get(r, -1)))
            deps.append(tuple(row))
            last_writer[tile] = idx
            for key in [c for c in copies if c[0] == tile]:
                del copies[key]  # a write invalidates stale copies
    return deps


def successor_map(deps: list[tuple[int, ...]]) -> list[list[int]]:
    """Inverse of `task_dependencies`: per-task list of dependent tasks."""
    succs: list[list[int]] = [[] for _ in deps]
    for idx, row in enumerate(deps):
        for d in set(row):
            if d >= 0:
                succs[d].append(idx)
    return succs


def generations(deps: list[tuple[int, ...]]) -> list[list[int]]:
    """Bucket task indices by longest-dependency-chain depth.

    Generation g holds every task whose longest producer chain has g
    tasks before it -- the maximal wavefronts a dependency-respecting
    runtime may execute concurrently.  Emission order is topological, so
    a single forward pass suffices.
    """
    depth = [0] * len(deps)
    for idx, row in enumerate(deps):
        depth[idx] = max((depth[d] + 1 for d in row if d >= 0), default=0)
    gens: list[list[int]] = [[] for _ in range(max(depth, default=-1) + 1)]
    for idx, d in enumerate(depth):
        gens[d].append(idx)
    return gens


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _TileState:
    next_update: int       # next expected update step k
    factor_step: int       # step at which the factor op lands (== column j)
    factored: bool = False
    version: int = 0       # bumped on every write
    copies: dict = dataclasses.field(default_factory=dict)  # tier -> version


@dataclasses.dataclass
class DagReport:
    variant: str
    p: int
    policy_label: str
    n_tasks: int
    n_converts: int
    tier_flops: dict[str, float]         # units of nb^3, per exec tier
    convert_tiles: dict[str, int]        # "src->dst" -> tile count
    critical_path_flops: float           # units of nb^3 along longest chain
    critical_path_tasks: int

    @property
    def total_flops(self) -> float:
        return sum(self.tier_flops.values())

    def tier_fractions(self) -> dict[str, float]:
        tot = self.total_flops or 1.0
        return {t: f / tot for t, f in self.tier_flops.items()}


def check_dag(tasks: list[Task], p: int, policy: PrecisionPolicy,
              variant: str, *, label: str | None = None) -> DagReport:
    """Verify hazard freedom + precision-edge consistency; return the report.

    Raises HazardError naming the first offending task otherwise.
    """
    tier_of = lambda i, j: storage_tier(policy, i, j, variant=variant)

    live: dict[tuple[int, int], _TileState] = {}
    for i in range(p):
        for j in range(i + 1):
            st = tier_of(i, j)
            if st is None:
                continue
            if variant == "dst":
                first_k = (j // policy.diag_thick) * policy.diag_thick
            else:
                first_k = 0
            live[(i, j)] = _TileState(next_update=first_k, factor_step=j)

    def fail(task, why):
        raise HazardError(f"{variant} p={p} {label or policy.mode}: "
                          f"{why} at task {task}")

    # --- replay: protocol state machine + conversion-copy tracking ---------
    # dependency edges come from the shared helper so the checker's critical
    # path and the dynamic scheduler (sched.runtime) see the same graph
    deps_list = task_dependencies(tasks, p, policy, variant)
    cp_flops: list[float] = []
    cp_tasks: list[int] = []
    tier_flops: dict[str, float] = {}
    convert_tiles: dict[str, int] = {}

    for idx, task in enumerate(tasks):
        tile = task.target
        if tile not in live:
            fail(task, f"touches dropped/out-of-range tile {tile}")
        st = live[tile]

        if task.kind == "CONVERT":
            if task.src_tier == task.tier:
                fail(task, "no-op conversion")
            src_store = tier_of(*tile)
            if task.src_tier != src_store \
                    and st.copies.get(task.src_tier) != st.version:
                fail(task, f"CONVERT from {task.src_tier} but tile is stored "
                           f"as {src_store} with no current {task.src_tier} "
                           "copy")
            # a copy snapshots the CURRENT canonical version
            st.copies[task.tier] = st.version
            key = f"{task.src_tier}->{task.tier}"
            convert_tiles[key] = convert_tiles.get(key, 0) + 1
            flops = 0.0
        else:
            # 1. precision-edge consistency on every read
            for r in task.reads:
                if r not in live:
                    fail(task, f"reads dropped tile {r}")
                rst = live[r]
                r_store = tier_of(*r)
                if r == tile:
                    pass           # in-place operand: storage tier by def.
                elif r_store != task.tier:
                    cv = rst.copies.get(task.tier)
                    if cv != rst.version:
                        fail(task, f"consumes {r_store}-stored tile {r} in "
                                   f"{task.tier} without a current CONVERT "
                                   "(missing dlag2s/sconv2d)")
                # 2. RAW: panel operands (column == task.k) must be factored
                if r != tile and r[1] == task.k and task.kind in ("SYRK", "GEMM"):
                    if not rst.factored:
                        fail(task, f"RAW: reads unfactored panel tile {r}")
                if r[1] == task.k and task.kind == "TRSM" and r == (task.k, task.k):
                    if not rst.factored:
                        fail(task, f"RAW: TRSM before POTRF of {r}")

            # 3. protocol / WAR / WAW on the written tile
            i, j = tile
            if task.kind in ("SYRK", "GEMM"):
                if st.factored:
                    fail(task, f"WAR: update of already-factored tile {tile}")
                if task.k != st.next_update:
                    if task.k < st.next_update:
                        fail(task, f"WAW: duplicate/out-of-order update "
                                   f"k={task.k} (expected k={st.next_update})")
                    fail(task, f"RAW: update k={task.k} skips pending "
                               f"update k={st.next_update}")
                st.next_update += 1
            elif task.kind in ("POTRF", "TRSM"):
                if st.factored:
                    fail(task, f"WAW: tile {tile} factored twice")
                if task.k != st.factor_step:
                    fail(task, f"factor op at step {task.k}, tile belongs "
                               f"to column {st.factor_step}")
                if st.next_update != st.factor_step:
                    fail(task, f"RAW: factor before update "
                               f"k={st.next_update} was applied")
                if task.kind == "POTRF" and i != j:
                    fail(task, "POTRF off the diagonal")
                if task.kind == "TRSM" and i == j:
                    fail(task, "TRSM on the diagonal")
                st.factored = True
            else:
                fail(task, f"unknown task kind {task.kind}")
            st.version += 1
            st.copies.clear()      # a write invalidates every stale copy
            flops = _FLOP_UNITS[task.kind]
            tier_flops[task.tier] = tier_flops.get(task.tier, 0.0) + flops

        # critical path DP over RAW/WAW edges (emission order = topo order);
        # flops-longest and tasks-longest chains are tracked independently
        deps = deps_list[idx]
        best_f = max((cp_flops[d] for d in deps if d >= 0), default=0.0)
        best_t = max((cp_tasks[d] for d in deps if d >= 0), default=0)
        cp_flops.append(best_f + flops)
        cp_tasks.append(best_t + (0 if task.kind == "CONVERT" else 1))

    # --- completeness: every live tile fully updated and factored ----------
    for tile, st in live.items():
        if not st.factored:
            raise HazardError(f"{variant} p={p} {label or policy.mode}: tile "
                              f"{tile} never factored (missing POTRF/TRSM)")
        if st.next_update != st.factor_step:
            raise HazardError(f"{variant} p={p} {label or policy.mode}: tile "
                              f"{tile} missing update k={st.next_update}")

    return DagReport(
        variant=variant, p=p, policy_label=label or policy.mode,
        n_tasks=sum(1 for t in tasks if t.kind != "CONVERT"),
        n_converts=sum(1 for t in tasks if t.kind == "CONVERT"),
        tier_flops=tier_flops, convert_tiles=convert_tiles,
        critical_path_flops=max(cp_flops, default=0.0),
        critical_path_tasks=max(cp_tasks, default=0))


def analyze(variant: str, p: int, policy: PrecisionPolicy, *,
            label: str | None = None) -> DagReport:
    """Build + check one variant's DAG; raises HazardError on violation."""
    return check_dag(build_dag(variant, p, policy), p, policy, variant,
                     label=label)


def flop_report(n: int, nb: int, policy: PrecisionPolicy,
                variant: str = "tile") -> dict[str, float]:
    """Per-tier FLOP counts (actual FLOPs, not nb^3 units) for an (n, n)
    factorization -- the costmodel/benchmarks entry point."""
    assert n % nb == 0, (n, nb)
    p = n // nb
    rep = analyze(variant, p, policy)
    unit = float(nb) ** 3
    out = {f"{t}_flops": f * unit for t, f in rep.tier_flops.items()}
    out["total_flops"] = rep.total_flops * unit
    out["critical_path_flops"] = rep.critical_path_flops * unit
    out["critical_path_tasks"] = float(rep.critical_path_tasks)
    for t in (HI, LO, LO2):
        out.setdefault(f"{t}_flops", 0.0)
        out[f"{t}_frac"] = out[f"{t}_flops"] / max(out["total_flops"], 1.0)
    out["convert_tiles"] = float(sum(rep.convert_tiles.values()))
    return out
