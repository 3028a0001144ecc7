"""End-to-end LM training example: data pipeline -> model -> AdamW ->
checkpointed fault-tolerant loop, with a loss-goes-down validation.

The port of `examples/train_lm.py`.  The default is a small model for quick
runs; --size 100m builds a ~100M-parameter llama-style model.

  PYTHONPATH=src python -m repro_torch.train_lm --steps 200   # on the card
  PYTHONPATH=src python -m repro_torch.train_lm --size 100m --steps 300
  PYTHONPATH=src python -m repro_torch.train_lm --steps 20 --device cpu
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from .data import DataConfig, SyntheticTokenSource
from .models.config import ArchConfig
from .optim.adamw import tree_leaves
from .runtime import FaultTolerantLoop, LoopConfig
from .train import TrainConfig, init_train_state, make_train_step

SIZES = {
    "tiny": dict(n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
                 d_head=16, d_ff=512, vocab=2048),
    "20m": dict(n_layers=8, d_model=384, n_heads=8, n_kv_heads=4,
                d_head=48, d_ff=1536, vocab=8192),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_head=64, d_ff=3072, vocab=32000),
}


def size_config(size: str) -> ArchConfig:
    return ArchConfig(name=f"llama-style-{size}", family="dense",
                      rope_theta=5e5, remat=False, **SIZES[size])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=list(SIZES), default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compression", choices=["none", "bf16", "int8"],
                    default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = size_config(args.size)
    tc = TrainConfig(peak_lr=args.lr, warmup=max(10, args.steps // 20),
                     total_steps=args.steps, compression=args.compression)
    gen = torch.Generator(device=args.device).manual_seed(0)
    state, _ = init_train_state(gen, cfg, tc, device=args.device)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"model: {n_params/1e6:.1f}M params, device {args.device}")

    src = SyntheticTokenSource(cfg, DataConfig(seed=0, global_batch=args.batch,
                                               seq_len=args.seq),
                               device=args.device)
    step = make_train_step(cfg, tc)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop = FaultTolerantLoop(
            LoopConfig(ckpt_dir=ckpt_dir, ckpt_every=max(50, args.steps // 4),
                       max_steps=args.steps),
            step, src, state)
        loop.run()

    losses = [m["loss"] for m in loop.metrics_log]
    k = max(1, len(losses) // 10)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"loss: {first:.4f} -> {last:.4f} over {len(losses)} steps "
          f"({'OK: decreasing' if last < first else 'WARNING: not decreasing'})")
    return first, last


if __name__ == "__main__":
    main()
