"""Per-tile kernels for the real executor -- the engines' math, task-sized.

Counterpart of `repro.sched.kernels`.  Each `KernelSet` maps one symbolic
task (`analysis.dag.Task`) plus its operand tensors to one output tensor,
with the port's per-tile operations:

  POTRF   -- `panel_cholesky._potrf(impl, hi)`, the choice the sequential
             engines make: an fp32 band launches the `blocked_potrf`
             kernel (its plain version on a CPU tensor or with
             impl="plain"), an fp64 band goes to `cholesky_ex`; a tile
             that is not positive definite comes back all NaN;
  TRSM    -- `torch.linalg.solve_triangular` on one tile, in the dtype
             Algorithm 1 gives it (lines 12 and 14);
  hi SYRK / GEMM -- `torch.matmul` (lines 19 and 25; the reference
             computes these outside any Pallas kernel too);
  lo GEMM -- `lo_matmul`: both operands rounded to lo, one sum in the
             accumulator dtype, one rounding (line 27);
  CONVERT -- `.to(dtype)` (dlag2s / sconv2d).

  tile  -- Algorithm 1 (`core/tile_cholesky.py`) tile by tile;
  panel -- the banded engine (`core/panel_cholesky.py`) tile by tile: its
           off-band storage is single-tier lo;
  dst   -- the dense right-looking hi path inside each super-block.

Every op is out of place: the initial store holds views of the caller's
matrix (`split_tiles`, converted where a tile's tier is not its dtype), and
the matrix comes back unmodified.  The sequential tile and panel engines
solve a column of tiles in one call and compute the trailing update as one
`mp_syrk` per step, so their sums run in other orders than these per-tile
products: a scheduled factor equals another schedule's bit for bit, and
the sequential engines' within the policy's registered bound.
"""

from __future__ import annotations

import torch

from ..analysis.dag import HI, LO, LO2, Task, storage_tier
from ..core.panel_cholesky import _impl, _potrf, _trsm_right_lt
from ..core.precision import PrecisionPolicy, lo_matmul, require_ieee_fp32
from ..core.tile_cholesky import split_tiles
from ..kernels import _build


def tier_dtype(policy: PrecisionPolicy, sym: str):
    """Map a symbolic tier (hi/lo/lo2) to the policy's storage dtype."""
    return {HI: policy.hi, LO: policy.lo, LO2: policy.lo2}[sym]


class KernelSet:
    """Initial tile storage + one-task execution for one engine variant."""

    variant: str

    def __init__(self, a, nb: int, policy: PrecisionPolicy, *,
                 impl: str = "kernel"):
        _impl(impl)
        require_ieee_fp32()
        self.policy = policy
        self.nb = nb
        self.device = a.device
        self._potrf = _potrf(impl, policy.hi)
        if a.is_cuda and impl == "kernel" and policy.hi == torch.float32:
            _build.library()   # built here: two workers must not build it
        tiles, self.p = split_tiles(a, nb)
        self._store = {}
        for (i, j), t in tiles.items():
            sym = storage_tier(policy, i, j, variant=self.variant)
            if sym is None:          # dropped (DST off-block) tile
                continue
            self._store[(i, j)] = t.to(tier_dtype(policy, sym))

    def initial_store(self) -> dict:
        return self._store

    def initial(self, tile: tuple[int, int]):
        return self._store[tile]

    def release(self, tile: tuple[int, int]) -> None:
        """Drop an initial tile once no task reads it any more."""
        del self._store[tile]

    def _out_dtype(self, task: Task):
        return tier_dtype(self.policy,
                          storage_tier(self.policy, *task.target,
                                       variant=self.variant))

    def potrf(self, a):
        return self._potrf(a.to(self.policy.hi).contiguous())[0]

    def run(self, task: Task, ops: list):
        raise NotImplementedError


class TileKernels(KernelSet):
    """`tile_cholesky`'s Algorithm 1 tile ops (see module docstring)."""

    variant = "tile"

    def run(self, task: Task, ops: list):
        pol = self.policy
        hi, lo = pol.hi, pol.lo
        if task.kind == "POTRF":
            return self.potrf(ops[0])                     # line 8 dpotrf
        if task.kind == "CONVERT":                        # dlag2s / sconv2d
            return ops[0].to(tier_dtype(pol, task.tier))
        if task.kind == "TRSM":
            l_kk, a_ik = ops
            if task.tier == HI:                           # line 12 dtrsm
                return _trsm_right_lt(l_kk, a_ik, hi, hi)
            return _trsm_right_lt(l_kk, a_ik,             # line 14 strsm
                                  pol.solve_dtype, self._out_dtype(task))
        if task.kind == "SYRK":                           # line 19 dsyrk
            c, acc = ops
            return acc - c @ c.mT
        a_ik, a_jk, acc = ops                             # GEMM
        if task.tier == HI:                               # line 25 dgemm
            return acc - a_ik @ a_jk.mT
        upd = lo_matmul(a_ik, a_jk.mT, pol, tier=lo)
        return (acc - upd).to(self._out_dtype(task))      # line 27 sgemm


class PanelKernels(KernelSet):
    """`panel_cholesky_banded`'s per-step ops, sliced to single tiles."""

    variant = "panel"

    def run(self, task: Task, ops: list):
        pol = self.policy
        hi = pol.hi
        lo = pol.lo if pol.mode != "full" else pol.hi   # single-tier off
        if task.kind == "POTRF":
            return self.potrf(ops[0])
        if task.kind == "CONVERT":
            return ops[0].to(hi if task.tier == HI else lo)
        if task.kind == "TRSM":
            l_kk, a_ik = ops
            if task.tier == HI:                           # dtrsm on the band
                return _trsm_right_lt(l_kk, a_ik, hi, hi)
            return _trsm_right_lt(l_kk, a_ik, pol.solve_dtype, lo)  # strsm
        lhs, rhs, acc = ops
        if task.tier == HI:                               # dsyrk / dgemm
            return acc - lhs @ rhs.mT
        return acc - lo_matmul(lhs, rhs.mT, pol).to(lo)   # off-band sgemm


class DstKernels(KernelSet):
    """Dense right-looking hi tile ops inside each DST super-block."""

    variant = "dst"

    def run(self, task: Task, ops: list):
        hi = self.policy.hi
        if task.kind == "POTRF":
            return self.potrf(ops[0])
        if task.kind == "TRSM":
            l_kk, a_ik = ops
            return _trsm_right_lt(l_kk, a_ik, hi, hi)
        if task.kind == "SYRK":
            c, acc = ops
            return acc - c @ c.mT
        a_ik, a_jk, acc = ops
        return acc - a_ik @ a_jk.mT


_KERNELS = {"tile": TileKernels, "panel": PanelKernels, "dst": DstKernels}


def make_kernels(variant: str, a, nb: int, policy: PrecisionPolicy, *,
                 impl: str = "kernel") -> KernelSet:
    return _KERNELS[variant](a, nb, policy, impl=impl)
