"""Analytic per-cell cost model, the task costs, and the memory plans.

The port of `repro.launch.costmodel`, in three parts.

1. The cells' roofline inputs (`lm_cell_cost`, `geostat_cell_cost`,
   `geostat_dag_cost`): the reference's formulas term for term -- exact
   matmul FLOPs, explicit-assumption traffic models for device-memory and
   collective bytes -- in bf16-equivalent FLOPs under a chip's rates
   (`launch.mesh`): a FLOP of a precision tier weighs the bf16 peak over
   its dtype's peak.  Under `V5E` every number is the reference's (its
   fixed TIER_WEIGHT: fp32 6x, fp8 0.5x); under `H100` (the default) an
   fp32 or fp64 FLOP weighs 989 / 67 = 14.8, a bf16 one 1, an fp8 one 0.5,
   and the LM attention's q k^T product, which the port computes from fp32
   copies of its operands, weighs fp32's.  Params are counted on the
   port's own tree on the meta device (`roofline.param_count`), never by
   `ArchConfig.param_count()` (ROADMAP C 24).

   Key modelling assumptions (the reference's): backward = 2x forward
   matmul FLOPs, full remat adds ~1x recompute; bf16 activations, fp32
   params and moments, bf16 KV cache; FSDP all-gather ~P bytes a chip a
   traversal of the params, grad reduce-scatter + all-gather ~2P bytes;
   TP all-reduce 2x activation bytes a block output.

2. The task runtime's costs (`task_virtual_cost`): tile-op FLOPs in nb^3
   units scaled by the reference's TIER_WEIGHT, or a measured table.  The
   analytic weights are the reference's model units, not the H100's; they
   only order the ready queue and drive the simulated backend.  A measured
   table ("KIND/tier" -> microseconds) is read from CALIBRATION_PATH when
   `calibrated=True`: the committed one holds the card's task times,
   measured with CUDA events by `python -m repro_torch.obs calibrate --nb
   1024 --p 6` (its `meta` names the card and its power limit).

3. The memory plans: what one path holds on one card at its peak, the
   port's counterpart of a compiled module's memory analysis, each
   reckoned term by term from what the path allocates and held on the
   card (`chip_smoke.py`): `train_peak_bytes`, `serve_peak_bytes`,
   `distributed_peak_gib`, `distributed_grad_peak_gib`,
   `panel_grad_peak_gib`, `scale_peak_bytes`;
   and one step's model FLOPs, `train_step_flops`.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import torch

from ..analysis.dag import _FLOP_UNITS
from .roofline import param_count

# the reference's matrix-unit throughput weights relative to bf16 (TPU
# v5e): the runtime's analytic task costs, and the cell costs under V5E
TIER_WEIGHT = {"hi": 6.0, "lo": 1.0, "lo2": 0.5}

# measured per-(kind, tier) task times of the card, written by
# `repro_torch.obs.calibrate`
CALIBRATION_PATH = Path(__file__).resolve().parent / "calibration.json"

_UNSET = object()
_calibration_cache: object = _UNSET   # dict | None once resolved


def load_calibration(path=None) -> dict | None:
    """Read a calibration table; returns its costs dict or None if absent.

    With no `path`, reads (and caches) the CALIBRATION_PATH table.  Costs
    map "KIND/tier" ("CONVERT" flat) -> measured microseconds; any key a
    DAG emits that the table lacks falls back to the analytic weight
    inside `task_virtual_cost`.
    """
    global _calibration_cache
    if path is not None:
        return json.loads(Path(path).read_text())["costs"]
    if _calibration_cache is _UNSET:
        if CALIBRATION_PATH.exists():
            _calibration_cache = json.loads(
                CALIBRATION_PATH.read_text())["costs"]
        else:
            _calibration_cache = None
    return _calibration_cache


def set_calibration(costs: dict | None) -> None:
    """Inject a cost table (tests / sweeps); None drops back to the file."""
    global _calibration_cache
    _calibration_cache = _UNSET if costs is None else dict(costs)


# Default virtual duration of a CONVERT (dlag2s/sconv2d) in the same
# bf16-equivalent nb^3 units as the compute weights: an nb x nb tile moves
# ~nb^2 bytes against ~nb^3-scale math, so a quarter unit keeps it visible
# on the critical path without dominating it.
CONVERT_COST_UNITS = 0.25


def task_virtual_cost(task, *, convert_cost: float = CONVERT_COST_UNITS,
                      calibrated: bool = False,
                      table: dict | None = None) -> float:
    """Virtual duration of one `analysis.dag.Task`.

    Analytic path (default): tile-op FLOP units (POTRF 1/3, TRSM/SYRK 1,
    GEMM 2) scaled by TIER_WEIGHT; CONVERTs cost a flat `convert_cost`.

    Calibrated path (`calibrated=True`): measured microseconds from the
    CALIBRATION_PATH table (or an injected `table`).  Keys the table lacks
    fall back to the analytic weight.  Raises FileNotFoundError when no
    table exists at all rather than silently pricing an "analytically
    calibrated" schedule.
    """
    if calibrated:
        costs = table if table is not None else load_calibration()
        if costs is None:
            raise FileNotFoundError(
                f"calibrated=True but no calibration table at "
                f"{CALIBRATION_PATH} (inject one via set_calibration)")
        key = "CONVERT" if task.kind == "CONVERT" \
            else f"{task.kind}/{task.tier}"
        if key in costs:
            return float(costs[key])
    if task.kind == "CONVERT":
        return float(convert_cost)
    return _FLOP_UNITS[task.kind] * TIER_WEIGHT[task.tier]


# ======================================================================
# 1. the cells' roofline inputs
# ======================================================================

BF16 = 2
F32 = 4


@dataclasses.dataclass
class CellCost:
    flops: float                # global FLOPs per step (bf16-equivalent)
    hbm_bytes: float            # global device-memory traffic per step
    collective_bytes_per_chip: float
    model_flops: float          # 6*N_active*D (train) / 2*N_active*D (serve)
    detail: dict


# ---------------------------------------------------------------- blocks

def _attn_flops(cfg, b, s, skv=None, causal=True):
    skv = skv or s
    h, kv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    if cfg.swa_window and causal:
        skv_eff = min(cfg.swa_window, skv)
    else:
        skv_eff = skv
    proj = 2 * b * s * d * (h + 2 * kv) * hd + 2 * b * s * h * hd * d
    factor = 0.5 if (causal and skv == s and not cfg.swa_window) else 1.0
    if cfg.swa_window and causal:
        factor = 1.0  # window already truncates skv_eff
    scores = 2 * 2 * b * s * skv_eff * h * hd * factor
    return proj + scores


def _mlp_flops(cfg, b, s):
    return 3 * 2 * b * s * cfg.d_model * cfg.d_ff


def _moe_flops(cfg, b, s):
    spec = cfg.moe
    t_eff = spec.capacity_factor * spec.top_k * b * s
    router = 2 * b * s * cfg.d_model * spec.n_experts
    experts = 3 * 2 * t_eff * cfg.d_model * spec.d_expert
    return router + experts


def _mamba_flops(cfg, b, s):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_d_state
    r = max(1, d // 16)
    return (2 * b * s * d * 2 * d_in          # in_proj
            + 2 * b * s * d_in * cfg.ssm_conv  # conv
            + 2 * b * s * d_in * (r + 2 * n)   # x_proj
            + 2 * b * s * r * d_in             # dt_proj
            + 8 * b * s * d_in * n             # scan + y einsum
            + 2 * b * s * d_in * d)            # out_proj


def _mlstm_flops(cfg, b, s):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    hd = d_in // cfg.n_heads
    return (2 * b * s * d * 2 * d_in
            + 3 * 2 * b * s * d_in * d_in
            + 6 * b * s * d_in * hd            # C update + readout
            + 2 * b * s * d_in * d)


def _slstm_flops(cfg, b, s):
    d = cfg.d_model
    hd = d // cfg.n_heads
    return (2 * b * s * d * 4 * d
            + 8 * b * s * d * hd               # block-diag recurrence
            + 2 * b * s * d * d)


_BLOCK_FLOPS = {"attn": _attn_flops, "mamba": _mamba_flops,
                "mlstm": _mlstm_flops, "slstm": _slstm_flops}


def _forward_flops(cfg, b, s, *, causal=True):
    total = 0.0
    for i in range(cfg.n_layers):
        bt = cfg.layer_block_type(i)
        if bt == "attn":
            total += _attn_flops(cfg, b, s, causal=causal)
        else:
            total += _BLOCK_FLOPS[bt](cfg, b, s)
        if cfg.layer_is_moe(i):
            total += _moe_flops(cfg, b, s)
        elif cfg.d_ff and bt in ("attn", "mamba"):
            total += _mlp_flops(cfg, b, s)
    if cfg.enc_dec:
        f = cfg.n_enc_frames
        for _ in range(cfg.n_enc_layers):
            total += _attn_flops(cfg, b, f, causal=False) + _mlp_flops(cfg, b, f)
        total += cfg.n_layers * (  # decoder cross attention
            2 * b * s * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
            + 2 * 2 * b * s * f * cfg.n_heads * cfg.d_head
            + 2 * b * s * cfg.n_heads * cfg.d_head * cfg.d_model)
    total += 2 * b * s * cfg.d_model * cfg.vocab   # logits
    return total


def _qk_flops(cfg, b, s, *, causal=True):
    """The q k^T half of `_forward_flops`' score products (self-attention,
    the encoder's and the cross-attention's), which the port computes in
    fp32."""
    n_attn = sum(cfg.layer_block_type(i) == "attn" for i in range(cfg.n_layers))
    h, hd = cfg.n_heads, cfg.d_head
    skv = min(cfg.swa_window, s) if (cfg.swa_window and causal) else s
    factor = 0.5 if (causal and not cfg.swa_window) else 1.0
    total = n_attn * 2 * b * s * skv * h * hd * factor
    if cfg.enc_dec:
        f = cfg.n_enc_frames
        total += cfg.n_enc_layers * 2 * b * f * f * h * hd
        total += cfg.n_layers * 2 * b * s * f * h * hd
    return total


# init_lm's parameter count from its meta tree, by the name the memory plans
# and chip_smoke.py's phases use
train_param_count = param_count


@functools.lru_cache(maxsize=None)
def layer_param_count(cfg, idx_in_pattern: int = 0) -> int:
    """The params of the block at `idx_in_pattern` of the cycle, from its
    tree on the meta device: its pre-norm and mixer and, on attention and
    mamba blocks, the FFN (the MLP or the MoE router and experts) with its
    pre-norm."""
    from ..models.transformer import _block_init
    from ..optim.adamw import tree_leaves
    block = _block_init(torch.Generator(), cfg, idx_in_pattern, device="meta")
    return sum(x.numel() for x in tree_leaves(block))


def _param_bytes(cfg, dtype_bytes=F32):
    total = train_param_count(cfg)
    return total * dtype_bytes, total


def _act_bytes_per_layer(cfg, b, s):
    return b * s * cfg.d_model * BF16


def _cache_bytes(cfg, b, s, *, kv_quant: bool = False):
    kv, hd = cfg.n_kv_heads, cfg.d_head
    attn_bytes = (1 + 4.0 / hd) if kv_quant else BF16  # int8 + fp32 scale
    total = 0
    for i in range(cfg.n_layers):
        bt = cfg.layer_block_type(i)
        if bt == "attn":
            w = min(cfg.swa_window or s, s)
            total += 2 * b * w * kv * hd * attn_bytes
        elif bt == "mamba":
            d_in = cfg.ssm_expand * cfg.d_model
            total += b * d_in * (cfg.ssm_d_state * F32 + (cfg.ssm_conv - 1) * BF16)
        elif bt == "mlstm":
            d_in = cfg.ssm_expand * cfg.d_model
            hd_i = d_in // cfg.n_heads
            total += b * cfg.n_heads * (hd_i * hd_i + hd_i + 1) * F32
        elif bt == "slstm":
            total += 4 * b * cfg.d_model * F32
    if cfg.enc_dec:
        total += cfg.n_layers * 2 * b * cfg.n_enc_frames * kv * hd * BF16
    return total


# ------------------------------------------------------------------ cells

def lm_cell_cost(cfg, shape, *, chips: int, mesh_axes: dict,
                 microbatches: int = 1, opts: dict | None = None,
                 rates=None) -> CellCost:
    """mesh_axes: {"data": 16, "model": 16, ["pod": 2]}.

    opts (perf variants): no_fsdp (replicate params over data: no gathers,
    full-grad all-reduce), compression=bf16|int8 (quantized grad reduce),
    kv_quant (int8 KV cache).  rates (default H100): the q k^T products
    weigh rates.weight("scores", fp32) bf16 FLOPs each (1 under V5E: the
    reference counts them in bf16), the rest 1."""
    from .mesh import H100
    from .roofline import active_param_count
    rates = rates or H100
    opts = opts or {}
    b, s = shape.global_batch, shape.seq_len
    n_active = active_param_count(cfg)
    p_bytes, p_count = _param_bytes(cfg)
    data_ways = mesh_axes.get("data", 1) * mesh_axes.get("pod", 1)
    model_ways = mesh_axes.get("model", 1)
    qk_extra = rates.weight("scores", torch.float32) - 1.0

    if shape.kind == "train":
        fwd = _forward_flops(cfg, b, s)
        passes = 4.0 if cfg.remat else 3.0  # fwd+recompute+2bwd
        flops = passes * fwd
        model_flops = 6.0 * n_active * b * s
        # HBM traffic: params (3 traversals per microbatch + optimizer),
        # layer activations (~8 passes incl. recompute), score matrices (3x)
        acts = _act_bytes_per_layer(cfg, b, s) * cfg.n_layers * 8
        h_sc = cfg.n_heads * (min(cfg.swa_window, s) if cfg.swa_window else s)
        scores = 3 * b * s * h_sc * F32 * (0.5 if not cfg.swa_window else 1.0)
        logits = 3 * b * s * cfg.vocab * F32
        hbm = p_bytes * (3 * microbatches + 6) + acts + scores + logits
        # collectives per chip: FSDP param all-gathers in the compute dtype
        # (bf16), fwd+recompute+bwd per microbatch; grad RS/AG; TP
        # all-reduces
        grad_bytes = {"bf16": BF16, "int8": 1}.get(
            opts.get("compression"), F32)
        fsdp = (0.0 if opts.get("no_fsdp")
                else 3 * microbatches * p_count * BF16)
        grads = 2 * p_count * grad_bytes
        tp_ar = (2 * 2 * microbatches * cfg.n_layers
                 * _act_bytes_per_layer(cfg, b // max(data_ways, 1), s))
        coll = fsdp + grads + tp_ar if model_ways > 1 or data_ways > 1 else 0.0
        qk = passes * _qk_flops(cfg, b, s)
        detail = {"fwd_flops": fwd, "param_bytes": p_bytes,
                  "act_bytes": acts, "fsdp": fsdp, "grads": grads,
                  "tp_ar": tp_ar}
    elif shape.kind == "prefill":
        flops = _forward_flops(cfg, b, s)
        model_flops = 2.0 * n_active * b * s
        acts = _act_bytes_per_layer(cfg, b, s) * cfg.n_layers * 3
        hbm = p_bytes + acts + _cache_bytes(cfg, b, s)
        # weight-stationary serving: per-block activation all-reduces only
        coll = 4 * cfg.n_layers * _act_bytes_per_layer(
            cfg, max(b // max(data_ways, 1), 1), s)
        qk = _qk_flops(cfg, b, s)
        detail = {"param_bytes": p_bytes, "cache_bytes": _cache_bytes(cfg, b, s)}
    else:  # decode
        flops = _forward_flops(cfg, b, 1, causal=False)
        # attention reads the cache: add 2*b*1*S_eff*h*hd x2 einsums
        qk = 0.0
        for i in range(cfg.n_layers):
            if cfg.layer_block_type(i) == "attn":
                s_eff = min(cfg.swa_window or s, s)
                flops += 2 * 2 * b * s_eff * cfg.n_heads * cfg.d_head
                qk += 2 * b * s_eff * cfg.n_heads * cfg.d_head
        model_flops = 2.0 * n_active * b
        cache = _cache_bytes(cfg, b, s, kv_quant=bool(opts.get("kv_quant")))
        hbm = p_bytes + cache  # read all params + whole cache once
        # weight-stationary: per-layer activation all-reduce (both axes)
        coll = 4 * cfg.n_layers * b * cfg.d_model * BF16
        detail = {"param_bytes": p_bytes, "cache_bytes": cache}

    if qk_extra:
        flops += qk_extra * qk
        detail["qk_fp32_flops"] = qk
    return CellCost(flops=flops, hbm_bytes=hbm,
                    collective_bytes_per_chip=coll,
                    model_flops=model_flops, detail=detail)


def geostat_cell_cost(n: int, nb: int, diag_thick: int, *, chips: int,
                      off_update: str = "masked_full",
                      rates=None) -> CellCost:
    """Mixed-precision panel Cholesky + Matern cov-gen + solve under the
    {fp32 band, bf16 off-band} policy.

    FLOPs are reported bf16-equivalent: a band FLOP weighs rates.weight("hi",
    fp32) (6 under V5E, the paper's speedup mechanism on a TPU; 14.8 on the
    H100), an off-band FLOP rates.weight("lo", bf16) (1).

    off_update waste factors over the useful n^3/3 (core/distributed.py,
    core/panel_cholesky.py):
      masked_full : every step updates the full (n, n) matrix -> 3.0x
      aligned     : rows pruned to the 16-tile boundary, full cols -> 1.5x
      square      : single-device banded engine, full m x m square -> 2.0x
      chunked     : exact lower trapezoid -> 1.0x
    """
    from .mesh import H100
    rates = rates or H100
    p = n // nb
    t = min(diag_thick, p)
    # band fraction of the trailing updates
    total_tiles = p * (p + 1) / 2
    band_tiles = t * p - t * (t - 1) / 2
    band_frac = band_tiles / total_tiles
    chol = n ** 3 / 3.0
    waste = {"masked_full": 3.0, "fori": 3.0, "aligned": 1.5,
             "square": 2.0, "chunked": 1.0}[off_update]
    lo_flops = chol * (1 - band_frac) * waste * rates.weight(
        "lo", torch.bfloat16)
    hi_flops = chol * band_frac * rates.weight("hi", torch.float32)
    covgen = 50.0 * n * n                      # ~50 flops/entry Matern
    solve = 2.0 * n * n
    flops = lo_flops + hi_flops + covgen + solve
    # memory: off stored bf16, band fp32; each panel step rereads trailing
    off_bytes = n * n / 2 * BF16
    band_bytes = n * t * nb * F32
    hbm = off_bytes * p * 2 * (waste / 2 + 0.5) + band_bytes * p + covgen * 0
    # collectives: per step all-gather the panel column (both mesh axes)
    coll_panel = sum((n - (k + 1) * nb) * nb * BF16 * 2 for k in range(p))
    coll = coll_panel / max(chips ** 0.5, 1)   # gathered along one mesh row
    return CellCost(flops=flops, hbm_bytes=hbm,
                    collective_bytes_per_chip=coll,
                    model_flops=chol,
                    detail={"band_frac": band_frac, "p": p, "t": t,
                            "lo_flops": lo_flops, "hi_flops": hi_flops})


def _tier_dtype(policy, tier):
    if tier == "hi" or policy.mode == "full":
        return policy.hi
    return policy.lo if tier == "lo" else policy.lo2


def geostat_dag_cost(n: int, nb: int, policy, *, chips: int,
                     variant: str = "tile", rates=None) -> CellCost:
    """Exact-count sibling of geostat_cell_cost, fed by the static task DAG
    (`analysis.dag.flop_report`): the POTRF/TRSM/SYRK/GEMM tasks the engine
    emits, so the per-tier mix, conversion traffic, and critical path are
    exact.  A tier's FLOPs weigh rates.weight(tier, its dtype under the
    policy): the reference's TIER_WEIGHT under V5E."""
    from ..analysis.dag import flop_report
    from .mesh import H100
    rates = rates or H100
    rep = flop_report(n, nb, policy, variant)
    flops = sum(rep[f"{t}_flops"] * rates.weight(t, _tier_dtype(policy, t))
                for t in TIER_WEIGHT if rep[f"{t}_flops"])
    # dlag2s/sconv2d traffic: one nb x nb tile read + write per conversion
    convert_bytes = rep["convert_tiles"] * nb * nb * (BF16 + F32)
    p = n // nb
    t = min(policy.diag_thick, p)
    off_bytes = n * n / 2 * BF16
    band_bytes = n * t * nb * F32
    hbm = off_bytes * p + band_bytes * p + convert_bytes
    coll_panel = sum((n - (k + 1) * nb) * nb * BF16 * 2 for k in range(p))
    coll = coll_panel / max(chips ** 0.5, 1)
    return CellCost(flops=flops, hbm_bytes=hbm,
                    collective_bytes_per_chip=coll,
                    model_flops=n ** 3 / 3.0,
                    detail={"hi_frac": rep["hi_frac"],
                            "lo_frac": rep["lo_frac"],
                            "lo2_frac": rep["lo2_frac"],
                            "total_flops": rep["total_flops"],
                            "critical_path_flops": rep["critical_path_flops"],
                            "critical_path_tasks": rep["critical_path_tasks"],
                            "convert_tiles": rep["convert_tiles"]})


# ======================================================================
# 3. the memory plans (and one train step's model FLOPs)
# ======================================================================

def scale_peak_bytes(n, nb):
    """The scale leg's predicted peak at n (bytes): the problem's fp32 Sigma
    (4 n^2) and the fp64 oracle factor L_ref (8 n^2) live throughout; on
    top, the larger of the oracle's moment (the fp64 upcast it factors,
    8 n^2) and the paper pair's factorization, which peaks with its tiles
    (the 2p - 1 band tiles in fp64, the rest of the lower triangle in
    fp32), a U of step 0's size (fp64, (n - nb)^2) and its assembled fp64
    factor (8 n^2) all live (measured on the card: 29.76 n^2 in all at
    n = 40,960, nb = 1,024).  The pair factors the fp32 Sigma, without an
    fp64 upcast of its own."""
    p = n // nb
    band = 2 * p - 1
    tiles = (8 * band + 4 * (p * (p + 1) // 2 - band)) * nb * nb
    pair = tiles + 8 * (n - nb) ** 2 + 8 * n * n
    return 12 * n * n + max(8 * n * n, pair)


def panel_grad_peak_gib(n, nb, t, hi_bytes, lo_bytes):
    """Predicted peak GiB of one panel value-and-gradient evaluation: the
    larger of (a) the solve's backward, the factor (band in hi, off in lo),
    the band's cotangent and the off-band's twice (its tile rows' and
    their stack), and (b) step 0 of the reverse sweep, the factor and its
    cotangents, the dense cotangent dU of the trailing (p - 1) nb square
    in hi and mp_syrk_grad's packed lo tiles of its lower half (in fp32 for
    an fp64 hi: the kernel's pre-pass writes the paper pair's in fp32)."""
    p = n // nb
    band = p * t * nb * nb * hi_bytes
    off = p * p * nb * nb * lo_bytes
    m = (p - 1) * nb
    solve = band + off + band + 2 * off
    sweep = 2 * (band + off) + m * m * hi_bytes + m * m // 2 * lo_bytes
    return max(solve, sweep) / 2 ** 30


def distributed_peak_gib(n, nb, t, hi_bytes, lo_bytes, u_bytes):
    """The memory one distributed evaluation on one rank adds at its peak,
    predicted, in GiB (`distributed_peak_bytes` on a 1 x 1 grid)."""
    return distributed_peak_bytes(n, nb, t, hi_bytes, lo_bytes,
                                  u_bytes)["total"] / 2 ** 30


def distributed_grad_peak_gib(n, nb, t, hi_bytes, lo_bytes, u_bytes):
    """The memory one distributed value-and-gradient evaluation on one rank
    adds at its peak, predicted, in GiB: the larger of the forward's
    (`distributed_peak_bytes`, the slabs and a step's moment) and the
    factorization's reverse sweep at step 0, where the slabs (saved for it)
    and their cotangents (their sizes again) live beside the larger of two
    moments, each over the n x nb panel column: the band updates' (c_lo in
    lo; c_t, its cotangent and one product in hi; C's three cotangent sums
    in the accumulator, fp32 or lo's width) and the lo update's (c_lo and
    the three sums, and where the product is upcast, u_bytes != lo_bytes
    as on a CPU, its two operands in the accumulator).  The solve's sweep
    (the slabs, their cotangents and one tile row's outer product) and the
    build's (the cotangents) stay under it."""
    fwd = distributed_peak_bytes(n, nb, t, hi_bytes, lo_bytes, u_bytes)
    acc = max(4, lo_bytes)
    column = n * nb
    band_moment = column * (lo_bytes + 3 * hi_bytes + 3 * acc)
    lo_moment = column * (lo_bytes + 3 * acc) + (
        2 * column * acc if u_bytes != lo_bytes else 0)
    sweep = 2 * fwd["storage"] + max(band_moment, lo_moment)
    return max(fwd["total"], sweep) / 2 ** 30


def train_peak_bytes(cfg, micro: int, seq: int, *, shard: float = 1.0) -> int:
    """Predicted peak device bytes of one train step (bf16 compute, fp32
    masters and moments, remat per cycle), the larger of two moments:
    the backward of a microbatch of `micro` sequences -- the state (params,
    m, v: 12 N), the step's fp32 gradient sum (4 N), bf16 compute copy (2
    N) and bf16 gradients (2 N), the larger of one layer's (micro, H, S, S)
    attention scores and the head's (micro, S, V) logits at 20 bytes an
    element (the saved fp32 softmax output, the incoming fp32 gradient, the
    softmax backward's output and the two fp32 temporaries of the card's
    softmax backward, its product and its buffer: measured on an H100, the
    caching allocator's history of llama3.2-1b's step), the bf16 carries
    saved at each cycle, and the recomputed layer's fp32 copies (its norms'
    inputs, q and k: four (micro, S, d) fp32); and the AdamW update -- old
    and new params, m and v, the gradient sum and its clipped copy (32 N)
    and five temporaries of the largest leaf (`adamw.update`'s m-hat and
    v-hat, held while the step's terms and their sum are made).

    shard: the share of every param leaf a rank holds (1 on one card; a
    sharded plan's per-rank params over N): the N terms and the largest
    leaf scale by it, the activations are the microbatch's."""
    n = train_param_count(cfg) * shard
    scores = micro * cfg.n_heads * seq * seq
    logits = micro * seq * cfg.vocab
    carries = cfg.n_cycles * micro * seq * cfg.d_model * 2
    copies = 4 * micro * seq * cfg.d_model * 4
    backward = 20 * n + 20 * max(scores, logits) + carries + copies
    leaf = max(cfg.vocab * cfg.d_model,
               cfg.n_layers * cfg.d_model * cfg.d_ff) * shard
    update = 32 * n + 5 * 4 * leaf
    return int(max(backward, update))


def train_step_flops(cfg, batch: int, seq: int, *, remat: bool) -> dict:
    """The model flops of one train step over batch x seq tokens: 6 N T
    (forward 2 N T, backward 4 N T, the tied head counted once), the
    attention's products over the full S x S (the causal mask is applied,
    not skipped: 4 S^2 H d_head a sequence and layer forward, twice that
    backward), and remat's recompute (the layers' forward once more, 2
    N_layers T, and its attention products)."""
    t = batch * seq
    attn_fwd = 4 * seq * seq * cfg.n_heads * cfg.d_head * cfg.n_layers * batch
    layers = cfg.n_layers * layer_param_count(cfg)
    return {"dense": 6 * train_param_count(cfg) * t, "attention": 3 * attn_fwd,
            "remat": (2 * layers * t + attn_fwd) if remat else 0}


def ssm_state_bytes(cfg, batch: int) -> int:
    """The recurrent blocks' cache entries (`init_cache`): mamba's bf16
    conv state (B, K-1, d_in) and fp32 ssm state (B, d_in, N), the mLSTM's
    fp32 C (B, H, hd, hd), n (B, H, hd), m (B, H) with hd = d_in / H, the
    sLSTM's fp32 c, n, h, m (B, H, d / H); constant in S."""
    d, h = cfg.d_model, cfg.n_heads
    d_in = cfg.ssm_expand * d
    hd = d_in // h
    per = {"attn": 0,
           "mamba": (cfg.ssm_conv - 1) * d_in * 2 + d_in * cfg.ssm_d_state * 4,
           "mlstm": (h * hd * hd + h * hd + h) * 4,
           "slstm": 4 * d * 4}
    return batch * sum(per[cfg.layer_block_type(i)] for i in range(cfg.n_layers))


def serve_peak_bytes(cfg, batch: int, prompt: int, new: int, *,
                     shard: float = 1.0) -> dict:
    """Predicted peak device bytes of `serve_lm.generate` (bf16 compute,
    fp32 params) on an attention, MoE, recurrent or hybrid model, by term,
    with T = B S (0 where the model has no such layer):
      params    4 N;
      state     the recurrent cache entries (`ssm_state_bytes`), allocated
                at the first cycle;
      cache     the attention layers' prompt bf16 K/V cache (prefill fills
                it layer by layer, allocated at the first) and its grown
                copy `cache_grown` (both held while `_grow_cache` runs); a
                sliding window's cache is W slots and is not grown;
      scores    the fp32 scores of one query chunk (all of S x S below
                `_QCHUNK_THRESHOLD`), two at once: the product beside its
                scaled copy, then the softmax beside its input;
      attention q, k, v, rope'd k, k in fp32, a chunk's fp32 queries, the
                chunks' outputs and their concatenation;
      dispatch  one MoE layer: the tokens with their zero row, the gathered
                slots (G E C, d) and their copy for the batched product,
                three (G E C, fe) expert activations, the outputs and their
                padded copy, one expert weight cast to bf16, the routing's
                fp32 logits, softmax and sorted values with int64 indices;
      mamba     one mamba layer at the end of its scan: xz (2 d_in bf16),
                the conv's padded input (kept by the state's view) and its
                activated output, dt, the scan's fp32 copies of dt and x_c
                (padded to the chunk), its fp32 y chunks and their
                concatenation (26 d_in bytes a token), the x_proj output
                and fp32 B and C (2 (r + 2N) + 8 N); or, if larger, the
                last chunk's moment (22 d_in + 2 (r + 2N) + 8 N bytes a
                token, four (B, chunk, d_in, N) fp32 tensors: the scan's
                pair, a product and the result it fills, three (B, d_in, N)
                states and A);
      mlstm     one mLSTM layer in its loop: xz, bf16 q, k, v, their fp32
                copies, the step outputs and their stack (32 d_in bytes a
                token) and four (B, H, hd, hd) fp32 memories (the carried
                C, its decayed copy, the outer product, the new C);
      slstm     one sLSTM layer: the fp32 pre-activations (16 d bytes a
                token), the step outputs and their stack (8 d);
      residual  three (B, S, d) activations (x, its norm, a block's output);
      inputs    the stub frames or patches, fp32, and their bf16 copy;
      cross     whisper's cross cache, bf16 k and v (C, B, F, KV, hd),
                allocated at the first cycle and passed through the grow;
      cross_attention  one decoder layer's cross-attention: two fp32
                (B, H, S, F) scores and the encoder memory's k, v, fp32 k;
      encoder   the encoder's moment: its residual, the fp32 sinusoid,
                and the larger of the scores and attention terms at F (its
                attention is never query-chunked below _QCHUNK_THRESHOLD)
                and its FFN's three (B, F, d_ff) activations, which come
                after the attention's are freed.
    With the vision stub S counts the patches: S = n_patches + prompt.
    `total` = params + state + inputs + the larger of the encoder's moment,
    `prefill`'s (cache, cross, the encoder's bf16 output, residual and the
    largest of scores + attention, cross_attention, dispatch, mamba,
    mlstm, slstm) and the grow's (both caches and cross).  `groups` and
    `capacity` are the MoE prefill's (None without MoE).  shard: the share
    of the params a rank holds (1 on one card)."""
    from ..models import layers
    kinds = set(cfg.block_pattern)
    d, h = cfg.d_model, cfg.n_heads
    d_in = cfg.ssm_expand * d
    out = dict.fromkeys(("cache", "cache_grown", "scores", "attention",
                         "dispatch", "mamba", "mlstm", "slstm", "inputs",
                         "cross", "cross_attention", "encoder"), 0)
    if cfg.frontend == "vision_stub":
        out["inputs"] = batch * cfg.n_patches * d * (4 + 2)
        prompt += cfg.n_patches
    t = batch * prompt
    out["params"] = int(4 * train_param_count(cfg) * shard)
    out["state"] = ssm_state_bytes(cfg, batch)
    out["residual"] = 3 * t * d * 2
    groups = capacity = None
    kv, hd = cfg.n_kv_heads, cfg.d_head

    def attention_terms(b, s):  # (scores, attention) of one layer at s
        chunked = (s >= layers._QCHUNK_THRESHOLD and s % layers._QCHUNK == 0)
        qc = layers._QCHUNK if chunked else s
        return (2 * b * h * qc * s * 4,
                3 * b * s * h * hd * 2 + 3 * b * s * kv * hd * 2
                + b * s * kv * hd * 4 + b * qc * h * hd * 4)
    if "attn" in kinds:
        n_attn = sum(cfg.layer_block_type(i) == "attn"
                     for i in range(cfg.n_layers))
        kv_row = n_attn * 2 * batch * kv * hd * 2
        scores, attention = attention_terms(batch, prompt)
        # a sliding window's cache is its W slots, and the grow keeps it
        w = cfg.swa_window
        out.update(cache=kv_row * (prompt if w is None else w),
                   cache_grown=kv_row * (prompt + new) if w is None else 0,
                   scores=scores, attention=attention)
    enc_out = 0
    if cfg.enc_dec:
        f = cfg.n_enc_frames
        out["inputs"] = batch * f * d * (4 + 2)
        out["cross"] = cfg.n_layers * 2 * batch * f * kv * hd * 2
        out["cross_attention"] = (2 * batch * h * prompt * f * 4
                                  + batch * f * kv * hd * (2 + 2 + 4))
        scores, attention = attention_terms(batch, f)
        out["encoder"] = (3 * batch * f * d * 2 + f * d * 4 + max(
            scores + attention, 3 * batch * f * cfg.d_ff * 2))
        enc_out = batch * f * d * 2
    if cfg.moe is not None:
        e, k, fe = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert
        groups = layers._moe_group_count(t, e)
        capacity = max(4, int(cfg.moe.capacity_factor * (t // groups) * k / e))
        slots = groups * e * capacity
        out["dispatch"] = ((t + groups) * d * 2 + 2 * slots * d * 2
                           + 3 * slots * fe * 2 + (2 * slots + groups) * d * 2
                           + e * d * fe * 2 + t * e * (3 * 4 + 8))
    if "mamba" in kinds:
        n, r = cfg.ssm_d_state, max(1, d // 16)
        chunk = min(cfg.mamba_chunk, prompt)
        padded = batch * (prompt + (-prompt) % chunk)
        per_token = 2 * (r + 2 * n) + 8 * n   # dbc, and B, C in fp32
        scan = 4 * batch * chunk * d_in * n * 4 + (3 * batch + 1) * d_in * n * 4
        out["mamba"] = max((26 * d_in + per_token) * padded,
                           (22 * d_in + per_token) * padded + scan)
    if "mlstm" in kinds:
        hd = d_in // h
        out["mlstm"] = 32 * t * d_in + 4 * batch * h * hd * hd * 4
    if "slstm" in kinds:
        out["slstm"] = 24 * t * d
    out["prefill"] = out["cache"] + out["cross"] + enc_out + out["residual"] + max(
        out["scores"] + out["attention"], out["cross_attention"],
        out["dispatch"], out["mamba"], out["mlstm"], out["slstm"])
    out["total"] = out["params"] + out["state"] + out["inputs"] + max(
        out["encoder"], out["prefill"],
        out["cache"] + out["cache_grown"] + out["cross"])
    out.update(groups=groups, capacity=capacity)
    return out


def distributed_collective_bytes(n: int, nb: int, t: int, data: int,
                                 model: int, *, hi_bytes: int, lo_bytes: int,
                                 version: str = "masked_full",
                                 position: int = 0) -> dict:
    """The bytes the distributed engine's collectives move on the rank at
    grid `position` (r * model + c) of a data x model grid in one evaluation
    (build, factor, solve), by kind, as `roofline.count_collectives` counts
    them, from the engine's own steps (`core/distributed.py`): per step k,
    the diagonal tile's row shares gathered along the row slab's grid row
    (where the grid splits columns), L_kk broadcast to every rank, then
    (before the last step) the band panel tiles' row shares gathered, the
    lo panel piece (the largest row slab's rows x nb) broadcast along the
    grid row and gathered along the grid column; per solve block j, band
    row j's shares gathered and the residual reduced on its row slab, and
    w_j with its log-determinant share (nb + 1 in hi) broadcast."""
    from ..core.distributed import layout, slab_bounds
    from .mesh import Grid
    from .roofline import COLLECTIVE_KINDS
    p = n // nb
    t = min(t, p)
    size = data * model
    lay = layout(p, Grid(data=data, model=model, ranks=tuple(range(size)),
                         rank=position), version)
    ra, rb = lay.rows
    row_n = sum(s[0] == lay.ir for s in lay.parts)   # the row slab's ranks
    col_n = sum(s[1] == lay.ic for s in lay.parts)   # the column slab's
    splits = len(lay.col_bounds)
    a, b = slab_bounds(nb, splits)[0]
    share = b - a                                    # the largest row share
    pad = max(b - a for a, b in lay.row_bounds) * nb
    out = dict.fromkeys(COLLECTIVE_KINDS, 0)
    out["count"] = 0

    def add(kind, nbytes):
        out[kind] += nbytes
        out["count"] += 1

    def gather_rows(tiles):
        if splits > 1:
            add("all-gather", row_n * tiles * share * nb * hi_bytes)
    for k in range(p):
        if ra <= k < rb:
            gather_rows(1)
        if size > 1:
            add("broadcast", nb * nb * hi_bytes)
        m_t = p - k - 1
        if m_t == 0:
            break
        bp = max(0, min(rb, k + min(t - 1, m_t) + 1) - max(ra, k + 1))
        if bp:
            gather_rows(bp)
        if row_n > 1:
            add("broadcast", pad * nb * lo_bytes)
        if col_n > 1:
            add("all-gather", col_n * pad * nb * lo_bytes)
    for j in range(p):
        if lay.row_part(j) == lay.ir:
            gather_rows(min(j + 1, t))
            if row_n > 1:
                add("reduce", nb * hi_bytes)
        if size > 1:
            add("broadcast", (nb + 1) * hi_bytes)
    out["total"] = sum(out[k] for k in COLLECTIVE_KINDS)
    return out


def panel_peak_bytes(n: int, nb: int, t: int, hi_bytes: int, lo_bytes: int,
                     u_bytes: int = 4) -> int:
    """Predicted peak device bytes one `geostat_loglik_step` evaluation
    through the panel engine adds (off_update="square", no autograd): step
    0's moment, when off (n^2 lo: p x p tiles), the band (p t nb^2 hi),
    mp_syrk's U over the m = (p - 1) nb trailing rows (m^2 in the
    accumulator, u_bytes), the panel column c_hi (m nb hi) and one tile row
    of U rounded to lo (m nb lo, the in-place update's operand) all live."""
    p = n // nb
    m = (p - 1) * nb
    return (n * n * lo_bytes + p * t * nb * nb * hi_bytes + m * m * u_bytes
            + m * nb * hi_bytes + m * nb * lo_bytes)


def distributed_peak_bytes(n: int, nb: int, t: int, hi_bytes: int,
                           lo_bytes: int, u_bytes: int, *, data: int = 1,
                           model: int = 1,
                           version: str = "masked_full") -> dict:
    """One distributed evaluation's bytes on the first rank of a data x
    model grid (the largest slabs), by term: `storage` its off slab (lo)
    and band rows (hi); `work` the largest of a step's moments, which
    never overlap (the engine frees each before the next): the lo TRSM
    (its column rows upcast and solved, 2 x rows nb hi at most), the panel
    column's gather (the padded piece, the gathered pieces and c_lo: 2 n
    nb lo beside the piece), the band's update (c_lo, its hi copy c_t and
    one product: n nb lo + 2 n nb hi) and the lo update (c_lo and one row
    chunk of U in its product's dtype, u_bytes, and, where that is not lo,
    rounded to lo).  Measured on an H100 80GB HBM3 (1 x 1 NCCL grid): the
    lo update decides, 10.63 GiB at geostat_65k under tpu(8) and 7.98 GiB
    for the pair at 40,960, each within 0.1 %; the form that added every
    buffer to U said 11.375 and 8.906."""
    from ..core.distributed import U_CHUNK_ELEMS, layout, slab_bounds
    from .mesh import Grid
    p = n // nb
    t = min(t, p)
    lay = layout(p, Grid(data=data, model=model,
                         ranks=tuple(range(data * model))), version)
    (ra, rb), (ca, cb) = lay.rows, lay.cols
    s0, s1 = slab_bounds(nb, len(lay.col_bounds))[0]
    storage = ((rb - ra) * nb * (cb - ca) * nb * lo_bytes
               + (rb - ra) * t * (s1 - s0) * nb * hi_bytes)
    rows = min(max(1, U_CHUNK_ELEMS // (nb * nb * (cb - ca))), rb - ra) * nb
    u = rows * (cb - ca) * nb * (u_bytes + (lo_bytes if u_bytes != lo_bytes
                                            else 0))
    pad = max(b - a for a, b in lay.row_bounds) * nb
    column = n * nb
    work = max(2 * (rb - ra) * nb * nb * hi_bytes,
               pad * nb * lo_bytes + 2 * column * lo_bytes,
               column * lo_bytes + 2 * column * hi_bytes,
               column * lo_bytes + u)
    return {"storage": storage, "work": work, "total": storage + work}


def decode_step_bytes(cfg, batch: int, seq: int, *,
                      kv_quant: bool = False) -> int:
    """Predicted working set of one `decode_step` beyond its params and
    cache (from the code, not yet held on the card): in one attention
    layer, the fp32 copy of its cached keys (B W KV hd; with kv_quant also
    the dequantized bf16 keys and values) and three fp32 (B, H, W) score
    buffers (the product, its scaled and masked copies, W = the window or
    S); one layer's params cast to bf16; the fp32 logits (B, vocab); three
    (B, d) bf16 residuals."""
    w = min(cfg.swa_window or seq, seq)
    kv_elems = batch * w * cfg.n_kv_heads * cfg.d_head
    attn = kv_elems * 4 + (2 * kv_elems * 2 if kv_quant else 0) \
        + 3 * batch * cfg.n_heads * w * 4
    layer = max(layer_param_count(cfg, i)
                for i in range(len(cfg.block_pattern))) * 2
    return int(attn + layer + batch * cfg.vocab * 4
               + 3 * batch * cfg.d_model * 2)
