"""Dry-run planner: every (architecture x input-shape x mesh) cell,
planned without a device: does it fit, and what bounds it.

The port of `repro.launch.dryrun`.  The reference lowers and compiles each
cell's step for 256 or 512 placeholder devices and reads XLA's memory plan
and cost analysis.  The port compiles nothing and touches no device: per
cell it builds the step's state, inputs and caches on the meta device
(`init_lm`, `configs/shapes.py:input_specs`, `init_cache`), resolves each
leaf's spec on the mesh from its logical axes (`models/sharding.py`) or
the reference's input and cache rules, and plans

  per-rank bytes   each leaf's bytes over the product of the mesh axes its
                   spec shards it over, plus the path's working set at the
                   per-rank batch (`launch/costmodel.py`'s memory plans:
                   `train_peak_bytes`, `serve_peak_bytes`' prefill moment,
                   `decode_step_bytes`, `distributed_peak_bytes`);
  roofline terms   `lm_cell_cost` / `geostat_cell_cost` at the chip's rates
                   (`launch/roofline.py`, H100 by default).

On the 1 x 1 smoke mesh every plan is the one-card number the port's
reckonings give, which the card holds them to (`chip_smoke.py` phase 21).
On (16, 16) and (2, 16, 16) it is a prediction: runs on more than one card
wait for ROADMAP A 18, which will check it; each report says so.

Usage:
  python -m repro_torch.launch.dryrun --cell qwen3-4b:train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --geostat geostat_500k --mesh single
  python -m repro_torch.launch.dryrun --cell llama3.2-1b:train_4k --mesh smoke
(--all runs every cell in this one process: nothing locks a device count.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import torch

from ..configs import GEOSTAT_CONFIGS, LM_CONFIGS, SHAPES, cell_applicable
from ..configs.shapes import input_specs
from ..models.sharding import (DEFAULT_RULES, P, axis_sizes, resolve_spec,
                               shard_count)
from ..optim.adamw import tree_leaves, tree_map
from . import costmodel
from .mesh import (H100, make_production_mesh, make_smoke_mesh,
                   mesh_num_devices)
from .roofline import RooflineReport

PREDICTION_NOTE = ("a prediction for a sharded mesh: runs on more than one "
                   "card wait for ROADMAP A 18")


# ------------------------------------------------------------ shardings

def _greedy_cache_sharding(mesh, leaf, *, batch_dim=1) -> P:
    """Auto-shard a cache/state leaf: batch over (pod, data) when it
    divides; then the largest remaining dims over unused axes."""
    sizes = axis_sizes(mesh)
    spec = [None] * leaf.ndim
    used = set()
    if leaf.ndim > batch_dim:
        b = leaf.shape[batch_dim]
        axes = tuple(a for a in ("pod", "data") if a in sizes)
        if axes and all(b % sizes[a] == 0 for a in axes) and \
                b % math.prod(sizes[a] for a in axes) == 0:
            spec[batch_dim] = axes if len(axes) > 1 else axes[0]
            used.update(axes)
    # remaining dims, largest first (skip dim 0 = stacked cycles)
    order = sorted(range(1, leaf.ndim), key=lambda i: -leaf.shape[i])
    for ax_name in mesh.axis_names:
        if ax_name in used:
            continue
        for i in order:
            if spec[i] is None and leaf.shape[i] % sizes[ax_name] == 0 \
                    and leaf.shape[i] >= sizes[ax_name] * 8:
                spec[i] = ax_name
                used.add(ax_name)
                break
    return P(*spec)


def _batch_shardings(mesh, batch_tree):
    """Each input's spec: its leading (batch) dim over (pod, data) where
    it divides, else replicated."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[a] for a in axes)

    def one(leaf):
        if leaf.ndim and leaf.shape[0] % total == 0:
            return P(axes if len(axes) > 1 else axes[0],
                     *(None,) * (leaf.ndim - 1))
        return P(*(None,) * leaf.ndim)
    return tree_map(one, batch_tree)


def _param_shardings(mesh, cfg, rules=None):
    """(params on the meta device, their specs): each leaf's logical axes
    (`lm_axes`) resolved on the mesh with the divisibility fallback."""
    from ..models.transformer import init_lm, lm_axes
    params = init_lm(torch.Generator(), cfg, device="meta")
    specs = tree_map(lambda x, a: resolve_spec(a, mesh, rules,
                                               shape=tuple(x.shape)),
                     params, lm_axes(cfg))
    return params, specs


def _rules_for_opts(opts):
    rules = dict(DEFAULT_RULES)
    if opts.get("no_fsdp"):
        rules["embed"] = ()   # replicate params over data (pure DP)
    return rules


def _rank_bytes(tree, specs, mesh, *, dtype=None) -> int:
    """The bytes one rank holds of `tree` (meta tensors) laid out by the
    parallel `specs`: each leaf's bytes over its shard count (in `dtype`
    where given)."""
    total = 0
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        size = (torch.finfo(dtype).bits // 8 if dtype is not None
                else x.element_size())
        total += x.numel() * size / shard_count(spec, mesh)
    return int(total)


def _rank_count(tree, specs, mesh) -> float:
    return sum(x.numel() / shard_count(s, mesh)
               for x, s in zip(tree_leaves(tree), tree_leaves(specs)))


# ------------------------------------------------------------ LM cells

# Per-arch production knobs for the train cells, the reference's exactly:
# sized so fp32 master + Adam + remat'd activations fit a 16 GB v5e chip.
# remat_group: 2-level remat group size; microbatches: grad accumulation;
# moment_dtype: bf16 first moment (grok-1's 314B x 12B/param squeeze).
TRAIN_OVERRIDES = {
    "grok-1-314b": dict(microbatches=8, moment_dtype="bfloat16",
                        remat_group=8),
    "qwen3-32b": dict(microbatches=2, remat_group=8),
    "llava-next-34b": dict(microbatches=2, remat_group=6),
    "qwen3-moe-30b-a3b": dict(remat_group=8),
    "jamba-v0.1-52b": dict(microbatches=2, remat_group=2),
    "xlstm-1.3b": dict(remat_group=8),
    "h2o-danube-1.8b": dict(remat_group=4),
    "qwen3-4b": dict(remat_group=6),
    "llama3.2-1b": dict(remat_group=4),
}


def arch_for_cell(arch: str):
    cfg = LM_CONFIGS[arch]
    ov = TRAIN_OVERRIDES.get(arch, {})
    if "remat_group" in ov:
        cfg = dataclasses.replace(cfg, remat_group=ov["remat_group"])
    return cfg


@dataclasses.dataclass
class Plan:
    """One cell's plan on a mesh: `args` the bytes one rank holds by group
    (state, params, inputs, cache, storage), `work` the path's working set
    beyond them, `cost` the cell's cost model, `detail` the reckoning's
    inputs."""
    name: str
    chips: int
    mesh_axes: dict
    cost: costmodel.CellCost
    args: dict
    work: int
    detail: dict

    @property
    def peak_bytes(self) -> int:
        return int(sum(self.args.values()) + self.work)


def _per_rank_batch(b, mesh):
    """The batch one rank holds: b over the (pod, data) ways where they
    divide it, else all of it (replicated), as `_batch_shardings` lays the
    inputs out."""
    sizes = axis_sizes(mesh)
    ways = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    return b // ways if b % ways == 0 else b


def plan_lm_cell(arch: str, shape, mesh, opts=None, *,
                 microbatches: int | None = None, cfg=None) -> Plan:
    """Plan one LM cell: `shape` a SHAPES name or a ShapeSpec (a measured
    run's own), `microbatches` the train step's (TRAIN_OVERRIDES' by
    default), `cfg` the architecture (arch_for_cell(arch) by default)."""
    opts = opts or {}
    cfg = cfg or arch_for_cell(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    specs = input_specs(cfg, shape)
    rules = _rules_for_opts(opts)
    chips = mesh_num_devices(mesh)
    mesh_axes = axis_sizes(mesh)
    params, p_spec = _param_shardings(mesh, cfg, rules)
    n_total = costmodel.train_param_count(cfg)
    shard = _rank_count(params, p_spec, mesh) / n_total
    b_r = _per_rank_batch(shape.global_batch, mesh)
    detail = {"per_rank_batch": b_r, "param_shard": shard}

    if shape.kind == "train":
        ov = TRAIN_OVERRIDES.get(arch, {})
        mb = microbatches or ov.get("microbatches", 1)
        moment = ("bfloat16" if opts.get("moment_bf16")
                  else ov.get("moment_dtype", "float32"))
        mdt = torch.bfloat16 if moment == "bfloat16" else torch.float32
        p_bytes = _rank_bytes(params, p_spec, mesh)
        state = {"params": p_bytes,
                 "opt": _rank_bytes(params, p_spec, mesh, dtype=mdt)
                 + p_bytes + 4, "data_step": 4}
        if opts.get("compression", "none") != "none":
            state["residual"] = p_bytes
        args = dict(state, inputs=_rank_bytes(
            specs, _batch_shardings(mesh, specs), mesh))
        micro_r = max(1, b_r // mb)
        seq = shape.seq_len
        # the reckoning's state term (params, m, v: 12 N a rank) is in args
        work = (costmodel.train_peak_bytes(cfg, micro_r, seq, shard=shard)
                - 12 * n_total * shard)
        cost = costmodel.lm_cell_cost(cfg, shape, chips=chips,
                                      mesh_axes=mesh_axes, microbatches=mb,
                                      opts=opts)
        detail.update(microbatches=mb, per_rank_microbatch=micro_r,
                      moment_dtype=moment)
    elif shape.kind == "prefill":
        n_text = specs["tokens"].shape[1]
        sp = costmodel.serve_peak_bytes(cfg, b_r, n_text, 0, shard=shard)
        args = {"params": _rank_bytes(params, p_spec, mesh),
                "inputs": _rank_bytes(specs, _batch_shardings(mesh, specs),
                                      mesh)}
        # serve_peak_bytes' prefill moment: its params and stub inputs are
        # in args; the recurrent state is allocated by prefill
        work = sp["state"] + max(sp["encoder"], sp["prefill"])
        cost = costmodel.lm_cell_cost(cfg, shape, chips=chips,
                                      mesh_axes=mesh_axes, opts=opts)
    else:  # decode
        from ..models.decode import init_cache
        kv_quant = bool(opts.get("kv_quant"))
        cache = (init_cache(cfg, shape.global_batch, shape.seq_len,
                            kv_quant=True, device="meta") if kv_quant
                 else specs["cache"])
        c_spec = tree_map(lambda x: _greedy_cache_sharding(mesh, x), cache)
        tokens = {"t": specs["tokens"]}
        args = {"params": _rank_bytes(params, p_spec, mesh),
                "cache": _rank_bytes(cache, c_spec, mesh),
                "inputs": _rank_bytes(tokens, _batch_shardings(mesh, tokens),
                                      mesh)}
        work = costmodel.decode_step_bytes(cfg, b_r, shape.seq_len,
                                           kv_quant=kv_quant)
        cost = costmodel.lm_cell_cost(cfg, shape, chips=chips,
                                      mesh_axes=mesh_axes, opts=opts)
    return Plan(name=f"{arch}:{shape.name}", chips=chips, mesh_axes=mesh_axes,
                cost=cost, args=args, work=int(work), detail=detail)


# -------------------------------------------------------- geostat cells

_GEO_AXES = {"masked_full": ("geo_rows geo_cols", "geo_rows . geo_cols ."),
             "aligned": ("geo_rows geo_cols", "geo_rows . geo_cols ."),
             "fori": ("geo_rows2d .", "geo_rows2d . . .")}


def plan_geostat_cell(name: str, mesh, version: str = "masked_full", *,
                      n: int | None = None, u_bytes: int = 2) -> Plan:
    """Plan one likelihood evaluation of the distributed engine under the
    {fp32 band, bf16 off-band} policy (PrecisionPolicy.tpu(diag_thick)):
    off (n, n) bf16 and the band (p, t, nb, nb) fp32 laid out by the
    engine's logical axes, locations and z whole on every rank, and the
    engine's working set (`distributed_peak_bytes`; u_bytes 2 for the
    card's bf16 product).  `n` cuts the config's n (a measured run's)."""
    gc = GEOSTAT_CONFIGS[name]
    n = n or gc.n
    nb = gc.nb
    p = n // nb
    t = min(gc.diag_thick, p)
    chips = mesh_num_devices(mesh)
    mesh_axes = axis_sizes(mesh)
    meta = dict(dtype=torch.float32, device="meta")
    storage = {"off": torch.empty((n, n), dtype=torch.bfloat16, device="meta"),
               "band": torch.empty((p, t, nb, nb), **meta)}
    off_axes, band_axes = _GEO_AXES[version]
    specs = {"off": resolve_spec(off_axes, mesh, shape=(n, n)),
             "band": resolve_spec(band_axes, mesh, shape=(p, t, nb, nb))}
    inputs = {"locs": torch.empty((n, 2), **meta),
              "z": torch.empty((n,), **meta)}
    grid = {k: mesh_axes.get(k, 1) for k in ("data", "model")}
    if "pod" in mesh_axes:   # the engine's grid has two dimensions
        grid["data"] *= mesh_axes["pod"]
    plan = costmodel.distributed_peak_bytes(n, nb, t, 4, 2, u_bytes,
                                            version=version, **grid)
    args = {"storage": _rank_bytes(storage, specs, mesh),
            "inputs": sum(x.numel() * 4 for x in inputs.values())}
    cost = costmodel.geostat_cell_cost(n, nb, gc.diag_thick, chips=chips,
                                       off_update=version)
    return Plan(name=f"{name}:{version}", chips=chips, mesh_axes=mesh_axes,
                cost=cost, args=args, work=plan["work"],
                detail={"n": n, "nb": nb, "t": t,
                        "engine_storage": plan["storage"]})


# -------------------------------------------------------------- driver

def _mesh(mode: str):
    if mode == "smoke":
        return make_smoke_mesh()
    return make_production_mesh(multi_pod=(mode == "multi"))


def report(plan: Plan, mesh_mode: str, *, rates=H100,
           hbm_bytes: float | None = None, name: str | None = None
           ) -> RooflineReport:
    """The plan as the reference's report: the roofline terms at `rates`,
    extras peak_bytes_per_chip, fits_hbm (against hbm_bytes, the rates'
    by default), the memory by group and cost_detail."""
    hbm = hbm_bytes if hbm_bytes is not None else rates.hbm_bytes
    cc = plan.cost
    peak = plan.peak_bytes
    extras = {"memory": {**{k: int(v) for k, v in plan.args.items()},
                         "work": plan.work},
              "peak_bytes_per_chip": peak,
              "fits_hbm": bool(peak <= hbm), "hbm_bytes_per_chip": hbm,
              "cost_detail": {k: float(v) for k, v in cc.detail.items()
                              if isinstance(v, (int, float))},
              "plan_detail": plan.detail}
    if mesh_mode != "smoke":
        extras["note"] = PREDICTION_NOTE
    return RooflineReport(
        name=name or plan.name, mesh=mesh_mode, chips=plan.chips,
        flops_per_chip=cc.flops / plan.chips,
        bytes_per_chip=cc.hbm_bytes / plan.chips,
        collective_bytes_per_chip=cc.collective_bytes_per_chip,
        model_flops=cc.model_flops, extras=extras).finalize(rates)


def run_cell(kind: str, arch: str, shape_name: str, mesh_mode: str,
             out_dir: str, opts=None, *, rates=H100,
             hbm_bytes: float | None = None) -> RooflineReport:
    opts = opts or {}
    t0 = time.time()
    mesh = _mesh(mesh_mode)
    suffix = ("+" + "+".join(sorted(k for k, v in opts.items() if v))
              if any(opts.values()) else "")
    name = f"{arch}:{shape_name}:{mesh_mode}{suffix}"
    if kind == "lm":
        plan = plan_lm_cell(arch, shape_name, mesh, opts)
    else:
        plan = plan_geostat_cell(arch, mesh,
                                 version=opts.get("geo_version", "masked_full"))
    rep = report(plan, mesh_mode, rates=rates, hbm_bytes=hbm_bytes, name=name)
    rep.extras["plan_s"] = round(time.time() - t0, 3)
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh_mode}{suffix}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rep.to_dict(), f, indent=1)
    peak = rep.extras["peak_bytes_per_chip"]
    print(f"[dryrun] {name}: chips={rep.chips} "
          f"flops/chip={rep.flops_per_chip:.3e} "
          f"t_comp={rep.t_compute*1e3:.2f}ms t_mem={rep.t_memory*1e3:.2f}ms "
          f"t_coll={rep.t_collective*1e3:.2f}ms bottleneck={rep.bottleneck} "
          f"peak={peak/2**30:.2f}GiB fits={rep.extras['fits_hbm']} "
          f"plan={rep.extras['plan_s']:.1f}s", flush=True)
    return rep


def all_cells():
    """[(kind, arch, shape name)] of every applicable LM cell, then the two
    geostat cells; the skipped ones printed with their reason."""
    cells = []
    for arch, cfg in LM_CONFIGS.items():
        for sname, shape in SHAPES.items():
            ok, why = cell_applicable(cfg, shape)
            if ok:
                cells.append(("lm", arch, sname))
            else:
                print(f"[dryrun] SKIP {arch}:{sname}: {why}")
    for g in ("geostat_500k", "geostat_1m"):
        cells.append(("geo", g, "-"))
    return cells


def run_all(meshes, out_dir, opts=None, *, rates=H100, hbm_bytes=None):
    """Every applicable cell on each mesh in this process (geostat_1m only
    on the multi-pod mesh, geostat_500k on the others); a report JSON already
    in out_dir is kept.  -> (reports, failures)."""
    reports, failures = [], []
    for kind, arch, sname in all_cells():
        for m in meshes:
            if kind == "geo" and ((arch == "geostat_1m") != (m == "multi")):
                continue  # 1m is the multi-pod geostat cell
            fname = f"{arch}__{sname}__{m}.json".replace("/", "_")
            if os.path.exists(os.path.join(out_dir, fname)):
                print(f"[dryrun] cached {arch}:{sname}:{m}")
                continue
            try:
                reports.append(run_cell(kind, arch, sname, m, out_dir, opts,
                                        rates=rates, hbm_bytes=hbm_bytes))
            except Exception as e:  # noqa: BLE001 -- reported and counted
                failures.append((arch, sname, m, repr(e)))
    print(f"[dryrun] done; {len(failures)} failures: {failures}")
    return reports, failures


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Plan every (arch x shape x mesh) cell on the meta "
                    "device: per-chip bytes, fits, roofline terms.")
    ap.add_argument("--cell", help="arch:shape")
    ap.add_argument("--geostat", help="geostat config name")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both", "smoke"],
                    default="single",
                    help="single (16, 16), multi (2, 16, 16), both, or smoke "
                         "(1 x 1: the one mesh a card can check)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=float, default=2400.0,
                    help="kept for the reference's command line: it bounds "
                         "the reference's per-cell compile subprocess; the "
                         "port plans in this process and compiles nothing, "
                         "so the value is not used")
    ap.add_argument("--opts", default="",
                    help="comma list: no_fsdp,kv_quant,moment_bf16,"
                         "compression=bf16,geo_version=aligned")
    args = ap.parse_args(argv)

    opts = {}
    for item in filter(None, args.opts.split(",")):
        if "=" in item:
            k, v = item.split("=", 1)
            opts[k] = v
        else:
            opts[item] = True

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        _, failures = run_all(meshes, args.out, opts)
        return 1 if failures else 0
    if args.geostat:
        run_cell("geo", args.geostat, "-", meshes[0], args.out, opts)
        return 0
    if not args.cell:
        ap.error("give --cell, --geostat or --all")
    arch, sname = args.cell.split(":")
    run_cell("lm", arch, sname, meshes[0], args.out, opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
