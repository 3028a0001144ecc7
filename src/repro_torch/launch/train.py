"""End-to-end training launcher (the port of `repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --preset smoke --steps 100 --ckpt-dir runs/run1 [--device cpu]

`--device` defaults to cuda.  Under torch.distributed (initialised by the
caller) the data pipeline shards by rank; the fault-tolerant loop resumes
from the latest checkpoint in --ckpt-dir after any restart, so a relaunch
of the same command continues the run.  The metrics log is written to
<ckpt-dir>/metrics.json.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..configs import LM_CONFIGS, LM_SMOKE_CONFIGS
from ..data import DataConfig, SyntheticTokenSource
from ..optim.adamw import tree_leaves
from ..runtime import FaultTolerantLoop, LoopConfig
from ..train import TrainConfig, init_train_state, make_train_step


def _processes():
    """(count, index) of this process: torch.distributed's world size and
    rank where a group is initialised, else (1, 0)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(LM_CONFIGS))
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke",
                    help="smoke = reduced config for the CPU; full = the "
                         "assigned config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", choices=["none", "bf16", "int8"],
                    default="none")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (LM_SMOKE_CONFIGS if args.preset == "smoke" else LM_CONFIGS)[args.arch]
    tc = TrainConfig(peak_lr=args.lr, warmup=min(100, args.steps // 10 + 1),
                     total_steps=args.steps, microbatches=args.microbatches,
                     compression=args.compression)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    state, _axes = init_train_state(gen, cfg, tc, device=args.device)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    n_proc, proc = _processes()
    print(f"[train] arch={args.arch} preset={args.preset} "
          f"params={n_params/1e6:.1f}M device={args.device} "
          f"processes={n_proc}")

    step_fn = make_train_step(cfg, tc)
    src = SyntheticTokenSource(cfg, DataConfig(
        seed=args.seed, global_batch=args.global_batch, seq_len=args.seq_len,
        n_processes=n_proc, process_index=proc), device=args.device)

    lc = LoopConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    max_steps=args.steps)
    loop = FaultTolerantLoop(lc, step_fn, src, state)
    state = loop.run()
    losses = [m["loss"] for m in loop.metrics_log]
    if losses:
        k = max(1, len(losses) // 10)
        print(f"[train] loss first-{k}-avg={sum(losses[:k])/k:.4f} "
              f"last-{k}-avg={sum(losses[-k:])/k:.4f} steps={len(losses)}")
    with open(os.path.join(args.ckpt_dir, "metrics.json"), "w") as f:
        json.dump(loop.metrics_log, f)
    return state


if __name__ == "__main__":
    main()
