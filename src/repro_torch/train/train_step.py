"""Training step factory: loss -> grads -> (compressed) -> AdamW.

The port of `repro.train.train_step`.  Flags on TrainConfig:
  * bf16 compute / fp32 master weights: the masters are cast to the compute
    dtype once a step, before the forward, and the gradients reach them
    through that cast;
  * global-norm clipping + cosine schedule;
  * microbatch gradient accumulation: each microbatch's gradient at the same
    params, summed in fp32, then divided by the count;
  * gradient compression with error feedback (runtime/compression.py);
  * remat is a model-config flag (ArchConfig.remat), applied per cycle.

The step is functional: it returns a new state and leaves the one it was
given as it was.  `init_train_state` returns the state and the params'
logical axes (`models.transformer.lm_axes`), as the reference's does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.transformer import init_lm, lm_axes, lm_loss
from ..optim import adamw
from ..optim.adamw import tree_map
from ..runtime.compression import compress_with_feedback, init_residual

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1            # grad accumulation factor
    compression: str = "none"        # none | bf16 | int8
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"    # "bfloat16" halves Adam-m memory


def init_train_state(gen, cfg, tc: TrainConfig, *, device="cuda"):
    """(state, axes): the state {"params", "opt", "data_step"[,
    "residual"]} with params from `gen` (a torch.Generator on `device`),
    and the params' logical axes (the params' tree, a packed name string a
    leaf)."""
    params = init_lm(gen, cfg, device=device)
    state = {"params": params,
             "opt": adamw.init(params, moment_dtype=_DTYPES[tc.moment_dtype]),
             "data_step": torch.zeros((), dtype=torch.int32, device=device)}
    if tc.compression != "none":
        state["residual"] = init_residual(params)
    return state, lm_axes(cfg)


def make_train_step(cfg, tc: TrainConfig):
    """train_step(state, batch) -> (new state, metrics): loss, grad_norm,
    lr, ce and aux, each a 0-dim tensor on the state's device."""
    lr_fn = adamw.cosine_schedule(tc.peak_lr, tc.warmup, tc.total_steps)
    cdt = _DTYPES[tc.compute_dtype]

    def loss_and_grads(params_c, batch):
        leaves = adamw.tree_leaves(params_c)
        loss, parts = lm_loss(params_c, batch, cfg, compute_dtype=cdt)
        grads = torch.autograd.grad(loss, leaves)
        # detached: a tensor with the graph's history would keep the
        # compute copy alive (the graph holds its leaves) through AdamW
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def train_step(state, batch):
        params = state["params"]
        # the compute copy: a leaf of its own, whose gradient is the one
        # the fp32 master receives through the cast (cast back up to fp32)
        params_c = tree_map(
            lambda p: (p.to(cdt) if p.dtype == torch.float32 else p)
            .detach().requires_grad_(True), params)
        if tc.microbatches > 1:
            b = batch["tokens"].shape[0]
            if b % tc.microbatches:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"microbatches {tc.microbatches}")
            micro = {k: torch.chunk(x, tc.microbatches) for k, x in batch.items()}
            g_sum, l_sum = None, None
            for i in range(tc.microbatches):
                loss, _, g = loss_and_grads(
                    params_c, {k: x[i] for k, x in micro.items()})
                if g_sum is None:  # 0 + g, exactly
                    g_sum = [x.float() for x in g]
                    l_sum = loss
                else:
                    for a, x in zip(g_sum, g):
                        a.add_(x)
                    l_sum = l_sum + loss
                del g
            grad_list = [x.div_(tc.microbatches) for x in g_sum]
            loss = l_sum / tc.microbatches
            parts = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, parts, g = loss_and_grads(params_c, batch)
            grad_list = [x.float() for x in g]
            del g  # a bf16 gradient is not kept through AdamW
        del params_c
        grads = _unflatten(params, grad_list)

        new_state = dict(state)
        if tc.compression != "none":
            grads, new_state["residual"] = compress_with_feedback(
                grads, state["residual"], mode=tc.compression)

        new_params, new_opt, gnorm = adamw.update(
            params, grads, state["opt"], lr=lr_fn,
            weight_decay=tc.weight_decay, clip_norm=tc.clip_norm)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        new_state["data_step"] = state["data_step"] + 1
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": lr_fn(new_opt["step"]), **parts}
        return new_state, metrics

    return train_step


def _unflatten(tree, leaves):
    """`leaves` (in tree_leaves order) in the structure of `tree`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)
