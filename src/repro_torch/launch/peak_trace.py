"""Where a train step's device-memory peak lies, on the card.

    python -m repro_torch.launch.peak_trace [--arch llama3.2-1b] [--batch 8]
        [--seq 4096] [--microbatches 4]

Runs a few train steps of the arch at full width (random weights, bf16
compute, fp32 masters: chip_smoke.py phase 17 (b)'s step) and prints, one
JSON line each: every step's seconds and its peaks before and inside
AdamW's update (`backward_peak_gib`, `update_peak_gib`), the reckoning
`costmodel.train_peak_bytes`, then the live blocks at the last step's
peak, from the caching allocator's memory history: grouped by their
innermost frame in the port, and each block of at least 512 MiB with its
allocating operator.  This is how the train step's missing reckoning term
(the softmax backward's two fp32 temporaries) was found.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch

GIB = 2 ** 30


def _frame(frames, package="repro_torch"):
    for f in frames:
        if package in f["filename"]:
            return f"{Path(f['filename']).name}:{f['line']}:{f['name']}"
    return "(no Python frame: the autograd engine)"


def _op(frames):
    """The allocating ATen operator: the first frame naming at::_ops or a
    structured kernel."""
    for f in frames:
        name = f["name"]
        if "at::_ops::" in name or "structured_" in name:
            return name[:90]
    return "?"


def live_at_peak(snapshot):
    """(peak bytes over the traced start, the blocks live at the peak as
    (size, frames)) from a memory snapshot's device trace."""
    trace = snapshot["device_traces"][0]
    total = best = 0
    best_i = -1
    sizes = {}
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            sizes[e["addr"]] = e["size"]
            total += e["size"]
        elif e["action"] == "free_completed" and e["addr"] in sizes:
            total -= sizes.pop(e["addr"])
        if total > best:
            best, best_i = total, i
    live = {}
    for e in trace[:best_i + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    return best, list(live.values())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("peak_trace measures the card's allocator: no "
                           "CUDA device")
    from ..configs import LM_CONFIGS
    from ..data import DataConfig, SyntheticTokenSource
    from ..train import TrainConfig, init_train_state, make_train_step
    from ..train import train_step as ts
    from .costmodel import train_peak_bytes
    cfg = LM_CONFIGS[args.arch]
    tc = TrainConfig(microbatches=args.microbatches)
    gen = torch.Generator(device="cuda").manual_seed(170)
    state, _ = init_train_state(gen, cfg, tc, device="cuda")
    step = make_train_step(cfg, tc)
    src = SyntheticTokenSource(cfg, DataConfig(
        seed=170, global_batch=args.batch, seq_len=args.seq), device="cuda")
    marks, update = {}, ts.adamw.update

    def timed_update(*a, **k):   # the backward's peak, then the update's
        torch.cuda.synchronize()
        marks["backward_peak_gib"] = torch.cuda.max_memory_allocated() / GIB
        torch.cuda.reset_peak_memory_stats()
        out = update(*a, **k)
        torch.cuda.synchronize()
        marks["update_peak_gib"] = torch.cuda.max_memory_allocated() / GIB
        return out
    ts.adamw.update = timed_update
    snapshot = None
    try:
        for i in range(args.steps):
            batch = src.batch_at(i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            last = i == args.steps - 1
            if last:
                torch.cuda.memory._record_memory_history(
                    max_entries=2_000_000, stacks="all")
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            secs = time.perf_counter() - t0
            if last:
                snapshot = torch.cuda.memory._snapshot()
                torch.cuda.memory._record_memory_history(enabled=None)
            print(json.dumps(dict(step=i + 1, seconds=secs, loss=loss,
                                  held_gib=held / GIB, **marks)), flush=True)
    finally:
        ts.adamw.update = update
    micro = args.batch // args.microbatches
    best, live = live_at_peak(snapshot)
    # allocations the traced step made and still held at its peak (what was
    # held before it and freed during it is not subtracted)
    print(json.dumps(dict(arch=cfg.name, micro=micro, seq=args.seq,
                          step_allocations_at_peak_gib=best / GIB,
                          reckoned_gib=train_peak_bytes(cfg, micro, args.seq)
                          / GIB)), flush=True)
    groups = defaultdict(lambda: [0, 0])
    for size, frames in live:
        g = groups[_frame(frames)]
        g[0] += size
        g[1] += 1
    for key, (size, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(json.dumps(dict(gib=size / GIB, blocks=count, at=key)),
              flush=True)
    for size, frames in sorted(live, key=lambda b: -b[0]):
        if size >= GIB // 2:
            print(json.dumps(dict(gib=size / GIB, op=_op(frames),
                                  at=_frame(frames))), flush=True)


if __name__ == "__main__":
    main()
