"""Roofline terms of a planned cell, at a chip's rates.

The port of `repro.launch.roofline`.  Three terms per (arch x shape x
mesh), in seconds:

  compute    = FLOPs per chip (bf16-equivalent) / the bf16 peak
  memory     = device-memory bytes per chip / the memory rate
  collective = collective bytes per chip / the link rate

with the rates of `launch.mesh` (`H100` by default, `V5E` for the
reference's numbers).  The reference takes FLOPs and bytes from XLA's
cost analysis of a compiled module and collective bytes from its HLO
text; the port compiles nothing, so its dry-run takes all three from the
analytic cost model (`launch/costmodel.py`), as the reference's report
does too, and it has no HLO to parse.  What replaces the HLO parser is
`count_collectives`: the bytes the port's own collectives (the
distributed engine's broadcasts, gathers and reduce) move on this rank,
in the parser's shape.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json

from .mesh import H100

# the parser's kinds, then the two the port's engine uses beside all-gather
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute", "broadcast", "reduce")


@contextlib.contextmanager
def count_collectives():
    """Count the bytes this rank's collectives move while the block runs:
    yields {kind: bytes, ..., "total": bytes, "count": n} (the reference's
    `collective_bytes_from_hlo` shape), filled as the engine calls them.
    A broadcast and a reduce count their tensor's bytes, an all-gather its
    result's (every piece), as the parser counts result shapes; a call on
    one rank (no group) moves nothing and is not counted.  Off (outside the
    block) the engine pays one None check a collective."""
    from ..core import distributed
    out = {k: 0 for k in COLLECTIVE_KINDS}
    out["count"] = 0
    prev = distributed.COLLECTIVE_COUNT[0]
    distributed.COLLECTIVE_COUNT[0] = out
    try:
        yield out
    finally:
        distributed.COLLECTIVE_COUNT[0] = prev
        out["total"] = sum(out[k] for k in COLLECTIVE_KINDS)


@dataclasses.dataclass
class RooflineReport:
    name: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float          # 6*N*D useful-FLOPs reference (0 if n/a)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    rates: str = ""
    rates_source: str = ""
    peak_flops: float = 0.0     # the rates' bf16 peak, FLOP/s a chip
    extras: dict = dataclasses.field(default_factory=dict)

    def finalize(self, rates=H100):
        self.rates, self.rates_source = rates.name, rates.source
        self.peak_flops = rates.peak_bf16
        self.t_compute = self.flops_per_chip / rates.peak_bf16
        self.t_memory = self.bytes_per_chip / rates.hbm_bw
        self.t_collective = self.collective_bytes_per_chip / rates.link_bw
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        return self

    @property
    def t_bound(self) -> float:
        """The least time the step could take: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / global FLOPs (catches remat/redundancy waste)."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term-bound step time that is useful
        compute: t_useful_compute / max(all terms)."""
        if not self.t_bound:
            return 0.0
        return (self.model_flops / self.chips) / self.peak_flops / self.t_bound

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["useful_flops_fraction"] = self.useful_flops_fraction
        d["roofline_fraction"] = self.roofline_fraction
        return d


def lm_model_flops(cfg, shape) -> float:
    """6*N*D (dense) or 6*N_active*D (MoE); decode: D = global_batch tokens."""
    n_params = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params * tokens
    return 2.0 * n_params * shape.global_batch  # decode: one token per seq


@functools.lru_cache(maxsize=None)
def param_count(cfg) -> int:
    """init_lm's parameter count, counted on its tree on the meta device
    (nothing drawn, nothing allocated): the reference counts
    `jax.eval_shape(init_lm)`'s leaves; `ArchConfig.param_count()` is not
    used (ROADMAP C 24)."""
    import torch
    from ..models.transformer import init_lm
    from ..optim.adamw import tree_leaves
    params = init_lm(torch.Generator(), cfg, device="meta")
    return sum(x.numel() for x in tree_leaves(params))


def active_param_count(cfg) -> int:
    """Per-token active parameters (MoE counts top_k experts only)."""
    total = param_count(cfg)
    if cfg.moe is not None:
        # subtract the inactive expert fraction
        per_expert = 3 * cfg.d_model * cfg.moe.d_expert
        n_moe_layers = sum(1 for i in range(len(cfg.block_pattern))
                           if cfg.layer_is_moe(i)) * cfg.n_cycles
        inactive = (cfg.moe.n_experts - cfg.moe.top_k) * per_expert * n_moe_layers
        total -= inactive
    return total


def save_report(path: str, rep: RooflineReport):
    with open(path, "w") as f:
        json.dump(rep.to_dict(), f, indent=1)
