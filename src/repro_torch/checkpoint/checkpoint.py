"""Checkpoints with async saves, atomic rename and restore onto a device.

The port of `repro.checkpoint.checkpoint`, with the reference's on-disk
layout, so a checkpoint written by either package restores into the other:

  <dir>/step_<N>/
    manifest.json   -- {"step", "dtypes": {key: dtype name}, "keys"}
    arrays.npz      -- the leaves, keyed by their tree path joined by "/"

bf16 is not a numpy dtype: such a leaf is stored as its uint16 bits with
the dtype tag "bfloat16".

  * save() snapshots every leaf into host memory of its own before it
    returns, then writes on one background thread: the loop never blocks on
    the filesystem, and a later in-place change to the state cannot reach
    the file;
  * latest_step() + the atomic rename of a finished directory give
    crash-consistent resume;
  * restore(..., device=) puts each leaf on the given device (the
    reference's `shardings=`), else on the device of its `state_like` leaf.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

_EXECUTOR = ThreadPoolExecutor(max_workers=1)


def _flatten_with_paths(tree, prefix=()):
    """{"a/b/c": leaf} in the reference's order (sorted keys)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


def _unflatten_like(tree, flat, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, prefix + (str(k),))
                for k, v in tree.items()}
    return flat["/".join(prefix)]


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy array that owns its memory: `.cpu()` of a CPU tensor is the
    tensor itself, and `.numpy()` shares its storage."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16)
    return t.to("cpu", copy=True).numpy()


def save(ckpt_dir: str, step: int, state, *, async_: bool = True) -> Future:
    """Snapshot `state` and write step_<N> atomically. Returns a Future."""
    meta, arrays = {}, {}
    for k, v in _flatten_with_paths(state).items():
        arrays[k] = _host_copy(v)
        meta[k] = "bfloat16" if v.dtype == torch.bfloat16 else \
            str(arrays[k].dtype)

    def write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "dtypes": meta,
                       "keys": sorted(arrays.keys())}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final

    if async_:
        return _EXECUTOR.submit(write)
    fut: Future = Future()
    fut.set_result(write())
    return fut


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, state_like, *, device=None):
    """Load step_<N> into the structure of `state_like`: each leaf in its
    stored dtype, on `device`, else on the device of its `state_like`
    leaf."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    restored = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, like in _flatten_with_paths(state_like).items():
            arr = data[key]
            if manifest["dtypes"][key] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            restored[key] = t.to(device if device is not None else like.device)
    return _unflatten_like(state_like, restored)
