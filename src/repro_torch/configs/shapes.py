"""Assigned input shapes of the model zoo and per-(arch x shape) input
specs (the port of `repro.configs.shapes`).

LM transformer shapes are seq_len x global_batch.  decode_* / long_* are
serving shapes (one new token against a KV cache of seq_len), not training
ones.  long_500k needs sub-quadratic attention: it runs for SSM, hybrid and
SWA archs and is skipped for pure full-attention archs.  `input_specs`
gives tensors on the meta device where the reference gives
`jax.ShapeDtypeStruct`s: the same keys, shapes and dtypes, no memory.
"""

from __future__ import annotations

import dataclasses

import torch


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


def input_specs(cfg, shape: ShapeSpec):
    """Meta-device stand-ins for every model input of this cell.

    train   -> the batch dict of train_step: tokens, labels (B, S) int32,
               with patches (B, n_patches, d) fp32 for the vision stub
               (seq_len counts patches + text, so the text is S -
               n_patches) and frames (B, n_enc_frames, d) fp32 for
               whisper;
    prefill -> the same without labels;
    decode  -> {"cache": init_cache(cfg, B, S), "tokens": (B, 1) int32,
               "pos": () int32}.
    Nothing is allocated."""
    b, sl = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    def token_batch():
        n_text = sl - cfg.n_patches if cfg.frontend == "vision_stub" else sl
        batch = {"tokens": spec((b, n_text), torch.int32),
                 "labels": spec((b, n_text), torch.int32)}
        if cfg.frontend == "vision_stub":
            batch["patches"] = spec((b, cfg.n_patches, cfg.d_model),
                                    torch.float32)
        if cfg.enc_dec:
            batch["frames"] = spec((b, cfg.n_enc_frames, cfg.d_model),
                                   torch.float32)
        return batch

    if shape.kind == "train":
        return token_batch()
    if shape.kind == "prefill":
        batch = token_batch()
        batch.pop("labels")
        return batch
    from ..models.decode import init_cache
    return {"cache": init_cache(cfg, b, sl, device="meta"),
            "tokens": spec((b, 1), torch.int32),
            "pos": spec((), torch.int32)}
