"""In-house AdamW with decoupled weight decay and global-norm clipping.

The port of `repro.optim.adamw`: fp32 master weights and moments;
gradients may arrive bf16 (cast up).  The state is a plain dict tree of
tensors, so a checkpoint handles it like the params.  `update` is
functional: it returns new tensors and leaves its arguments as they were,
so a caller may keep the state it passed in (the fault-tolerant loop's
restart from its initial state does).  The arithmetic and its order are the
reference's, the step counter and the learning rate stay on the params'
device, and nothing waits for the device.
"""

from __future__ import annotations

import math

import torch


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves in the reference's order (sorted keys at every level)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def init(params, *, moment_dtype=torch.float32):
    """moment_dtype=bf16 halves first-moment memory."""
    step_device = tree_leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=step_device),
    }


def global_norm(tree):
    """sqrt of the sum, leaf by leaf in the reference's order, of each
    leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    # a true division: torch computes `scalar / tensor` as a reciprocal
    # times the scalar, which rounds twice
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
           weight_decay=0.1, clip_norm=1.0):
    """One AdamW step -> (new params, new state, grad norm before clipping).
    lr may be a scalar or a step -> lr callable (of the incremented step)."""
    step = state["step"] + 1
    if callable(lr):
        lr = lr(step)
    grads = tree_map(lambda g: g.float(), grads)
    grads, gnorm = clip_by_global_norm(grads, clip_norm)

    m = tree_map(lambda m_, g: (b1 * m_.float() + (1 - b1) * g).to(m_.dtype),
                 state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, m_, v_):
        mhat = m_.float() / bc1
        vhat = v_ / bc2
        return (p - lr * (mhat / (torch.sqrt(vhat) + eps)
                          + weight_decay * p)).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "step": step}, gnorm


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """step (an integer tensor) -> fp32 lr: linear warmup, then a cosine
    from peak_lr down to min_ratio * peak_lr at `total`."""
    def lr(step):
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
