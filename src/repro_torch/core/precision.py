"""Precision policies for the mixed-precision tile Cholesky (paper Sec. VI).

Counterpart of `repro.core.precision` with torch dtypes.  Tiles with
tile-index distance |i - j| < diag_thick from the diagonal operate in `hi`;
farther tiles in `lo`.  Modes:
  * "full"  -- DP(100%), the paper's reference baseline;
  * "mixed" -- the two-tier pair ({fp32, bf16} on the card);
  * "dst"   -- Diagonal-Super-Tile tapering baseline (off-band dropped);
  * "three_tier" -- hi / lo / lo2 (fp8 e4m3) with two distance thresholds.
"""

from __future__ import annotations

import dataclasses

import torch


def as_dtype(value) -> torch.dtype:
    """A torch dtype from a dtype or its name ("float32", "bfloat16", ...)."""
    if isinstance(value, torch.dtype):
        return value
    if isinstance(value, str) and isinstance(getattr(torch, value, None),
                                             torch.dtype):
        return getattr(torch, value)
    raise TypeError(f"not a torch dtype: {value!r}")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    mode: str                 # "full" | "mixed" | "dst" | "three_tier"
    hi: torch.dtype           # band dtype
    lo: torch.dtype           # off-band dtype ("mixed"/"three_tier")
    diag_thick: int           # band half-width in tiles (>= 1)
    lo2: torch.dtype | None = None   # far-off-band dtype ("three_tier")
    diag_thick2: int = 0      # second threshold in tiles ("three_tier")
    solve_dtype: torch.dtype = torch.float32  # dtype lo TRSMs execute in
    accum_dtype: torch.dtype = torch.float32  # accumulator of lo GEMMs

    def __post_init__(self):
        if self.mode not in ("full", "mixed", "dst", "three_tier"):
            raise ValueError(f"unknown policy mode {self.mode!r}")
        if self.diag_thick < 1:
            raise ValueError(f"diag_thick must be >= 1, got {self.diag_thick}")
        for field in ("solve_dtype", "accum_dtype"):
            value = getattr(self, field)
            try:
                dt = as_dtype(value)
            except TypeError as e:
                raise ValueError(f"{field} is not a dtype: {value!r}") from e
            if not dt.is_floating_point:
                raise ValueError(
                    f"{field} must be a floating dtype, got {dt}")
            object.__setattr__(self, field, dt)
        # a narrower accumulator than the lo storage would silently round
        # every partial product below the paper's SP error model
        try:
            lo_bits = torch.finfo(as_dtype(self.lo)).bits
        except TypeError:
            lo_bits = None  # non-float lo is caught by downstream tile math
        accum_bits = torch.finfo(self.accum_dtype).bits
        if lo_bits is not None and accum_bits < lo_bits:
            raise ValueError(
                f"accum_dtype ({self.accum_dtype}, {accum_bits} bits) must "
                f"be at least as wide as lo ({self.lo}, {lo_bits} bits)")
        if self.mode == "three_tier":
            if self.lo2 is None:
                raise ValueError("three_tier policy needs a lo2 dtype")
            if self.diag_thick2 <= self.diag_thick:
                # diag_thick2 == diag_thick would silently erase the lo tier
                raise ValueError(
                    f"three_tier needs diag_thick2 > diag_thick, got "
                    f"diag_thick2={self.diag_thick2} <= "
                    f"diag_thick={self.diag_thick}")

    # ---- constructors -------------------------------------------------
    @staticmethod
    def full(hi=torch.float32) -> "PrecisionPolicy":
        """DP(100%): the paper's reference."""
        return PrecisionPolicy(mode="full", hi=hi, lo=hi, diag_thick=1 << 30,
                               solve_dtype=hi, accum_dtype=hi)

    @staticmethod
    def paper_cpu(diag_thick: int) -> "PrecisionPolicy":
        """The paper's literal pair: DP=fp64 band, SP=fp32 off-band."""
        return PrecisionPolicy(mode="mixed", hi=torch.float64,
                               lo=torch.float32, diag_thick=diag_thick,
                               solve_dtype=torch.float32,
                               accum_dtype=torch.float32)

    @staticmethod
    def tpu(diag_thick: int) -> "PrecisionPolicy":
        """The {fp32 band, bf16 off-band, fp32 accumulate} pair."""
        return PrecisionPolicy(mode="mixed", hi=torch.float32,
                               lo=torch.bfloat16, diag_thick=diag_thick,
                               solve_dtype=torch.float32,
                               accum_dtype=torch.float32)

    @staticmethod
    def dst(diag_thick: int, hi=torch.float32) -> "PrecisionPolicy":
        """Diagonal-Super-Tile tapering: off-band ZERO (independent blocks)."""
        return PrecisionPolicy(mode="dst", hi=hi, lo=hi, diag_thick=diag_thick,
                               solve_dtype=hi, accum_dtype=hi)

    @staticmethod
    def three_tier(diag_thick: int, diag_thick2: int) -> "PrecisionPolicy":
        """fp32 band / bf16 mid / fp8(e4m3) far -- the paper's future work."""
        return PrecisionPolicy(mode="three_tier", hi=torch.float32,
                               lo=torch.bfloat16, lo2=torch.float8_e4m3fn,
                               diag_thick=diag_thick, diag_thick2=diag_thick2,
                               solve_dtype=torch.float32,
                               accum_dtype=torch.float32)

    # ---- tile classification ------------------------------------------
    def tile_dtype(self, i: int, j: int):
        """Storage dtype of tile (i, j) (tile indices)."""
        d = abs(i - j)
        if self.mode == "full":
            return self.hi
        if d < self.diag_thick:
            return self.hi
        if self.mode == "three_tier" and d >= self.diag_thick2:
            return self.lo2
        if self.mode == "dst":
            return None  # zeroed / dropped
        return self.lo

    def in_band(self, i: int, j: int) -> bool:
        return abs(i - j) < self.diag_thick or self.mode == "full"

    def dp_fraction(self, p: int) -> float:
        """Fraction of lower-triangle tiles inside the DP band (for the
        paper's DP(x%)-SP(y%) labels)."""
        total = p * (p + 1) // 2
        t = min(self.diag_thick, p)
        band = t * p - t * (t - 1) // 2
        return band / total

    @staticmethod
    def from_dp_percent(p: int, dp_percent: float,
                        pair: str = "tpu") -> "PrecisionPolicy":
        """Build a policy whose band covers ~dp_percent of the lower tiles."""
        total = p * (p + 1) / 2
        best_t, best_err = 1, float("inf")
        for t in range(1, p + 1):
            frac = (t * p - t * (t - 1) / 2) / total
            err = abs(frac - dp_percent)
            if err < best_err:
                best_t, best_err = t, err
        ctor = {"tpu": PrecisionPolicy.tpu,
                "paper_cpu": PrecisionPolicy.paper_cpu,
                "dst": PrecisionPolicy.dst}[pair]
        return ctor(best_t)


def require_ieee_fp32() -> None:
    """Keep fp32 matrix products and convolutions in IEEE fp32 on the card.

    TF32 keeps about three decimal digits; the hi band must stay fp32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def lo_matmul(a, b, policy: PrecisionPolicy, tier=None):
    """Low-precision GEMM with an explicit accumulator.

    The operands are rounded to `lo`, multiplied and summed in
    `accum_dtype` (bf16 x bf16 products are exact in fp32), and the sum is
    rounded once to `lo`.
    """
    lo = tier if tier is not None else policy.lo
    acc = policy.accum_dtype
    return (a.to(lo).to(acc) @ b.to(lo).to(acc)).to(lo)
