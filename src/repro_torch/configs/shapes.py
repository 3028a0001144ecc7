"""Assigned input shapes of the model zoo (the port of the `ShapeSpec` /
`SHAPES` half of `repro.configs.shapes`).

LM transformer shapes are seq_len x global_batch.  decode_* / long_* are
serving shapes (one new token against a KV cache of seq_len), not training
ones.  long_500k needs sub-quadratic attention: it runs for SSM, hybrid and
SWA archs and is skipped for pure full-attention archs.  `input_specs`
waits for the other families and `models/sharding.py` (ROADMAP A 9).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cell_applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for one (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.attention_is_subquadratic:
        return False, ("pure full-attention arch: 524288-token dense KV "
                       "decode is the quadratic regime this shape excludes "
                       "(DESIGN.md §9)")
    return True, ""
