"""The port's cost model and roofline (`repro_torch.launch.costmodel`,
`.roofline`, `.mesh`'s rates) against `repro.launch.costmodel` and
`.roofline`: under the reference's v5e rates every cell's cost equals the
reference's within rel 1e-12 (the count of cells asserted); the analytic
forward FLOPs against torch's FlopCounterMode over the port's forward_lm
(the counterpart of the reference's check against XLA's cost analysis);
the reference's scaling-law tests; the bytes the distributed engine's
collectives move on gloo grids against the formula its steps give and
against the cost model's collective term; the memory plans moved out of
chip_smoke.py pinned to what they gave before the move."""

import functools
import os

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ALL_ARCHS, SHAPES as J_SHAPES
from repro.configs import cell_applicable as j_applicable
from repro.core import PrecisionPolicy as JP
from repro.launch import costmodel as jc
from repro.launch import roofline as jr
from repro_torch.configs import LM_CONFIGS, SHAPES
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import PrecisionPolicy as TP
from repro_torch.core import distributed as td
from repro_torch.launch import costmodel as tc
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import H100, V5E, make_grid
from repro_torch.models.config import ArchConfig, MoESpec
from repro_torch.models.transformer import forward_lm, init_lm

torch.set_num_threads(1)

REL = 1e-12
FIELDS = ("flops", "hbm_bytes", "collective_bytes_per_chip", "model_flops")
MESH_AXES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
OPTS = ({}, {"no_fsdp": True}, {"compression": "bf16"}, {"kv_quant": True})

# the reference counts params with jax.eval_shape(init_lm) at every call;
# the same counts, once an arch
_J_ACTIVE = functools.lru_cache(maxsize=None)(jr.active_param_count)
_J_PARAM_BYTES = functools.lru_cache(maxsize=None)(jc._param_bytes)


def _jax_dryrun():
    """repro.launch.dryrun (TRAIN_OVERRIDES, arch_for_cell), imported
    without leaving its 512-device XLA_FLAGS behind."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


def _close(a, b):
    return all(abs(getattr(a, f) - getattr(b, f)) <= REL * abs(getattr(a, f))
               for f in FIELDS)


def _lm_cells(arch):
    return [s for s in J_SHAPES if j_applicable(ALL_ARCHS[arch],
                                                J_SHAPES[s])[0]]


def test_the_cells_compared():
    """33 applicable (arch, shape) cells, each on two meshes under four
    option sets: 264 lm_cell_cost comparisons."""
    assert sum(len(_lm_cells(a)) for a in ALL_ARCHS) == 33
    assert list(ALL_ARCHS) == list(LM_CONFIGS)


@pytest.mark.parametrize("arch", list(ALL_ARCHS))
def test_lm_cell_cost_equals_the_reference_under_v5e(arch, monkeypatch):
    jd = _jax_dryrun()
    monkeypatch.setattr(jr, "active_param_count", _J_ACTIVE)
    monkeypatch.setattr(jc, "_param_bytes", _J_PARAM_BYTES)
    count = 0
    for s in _lm_cells(arch):
        kind = J_SHAPES[s].kind
        mb = (jd.TRAIN_OVERRIDES.get(arch, {}).get("microbatches", 1)
              if kind == "train" else 1)
        for axes in MESH_AXES:
            chips = 1
            for v in axes.values():
                chips *= v
            for opts in OPTS:
                a = jc.lm_cell_cost(jd.arch_for_cell(arch), J_SHAPES[s],
                                    chips=chips, mesh_axes=axes,
                                    microbatches=mb, opts=opts)
                b = tc.lm_cell_cost(dryrun.arch_for_cell(arch), SHAPES[s],
                                    chips=chips, mesh_axes=axes,
                                    microbatches=mb, opts=opts, rates=V5E)
                assert _close(a, b), (s, axes, opts)
                assert set(a.detail) == set(b.detail)
                for k, v in a.detail.items():
                    assert abs(v - b.detail[k]) <= REL * abs(v), (s, k)
                count += 1
    assert count == len(_lm_cells(arch)) * 8


@pytest.mark.parametrize("arch", list(ALL_ARCHS))
def test_model_flops_and_active_params_equal_the_reference(arch):
    """active_param_count counts the port's meta tree, as the reference
    counts jax.eval_shape's; lm_model_flops at every shape."""
    assert roofline.active_param_count(LM_CONFIGS[arch]) == \
        _J_ACTIVE(ALL_ARCHS[arch])
    for s in SHAPES:
        assert roofline.lm_model_flops(LM_CONFIGS[arch], SHAPES[s]) == \
            pytest.approx(jr.lm_model_flops(ALL_ARCHS[arch], J_SHAPES[s]),
                          rel=REL)


def test_geostat_cell_cost_equals_the_reference_under_v5e():
    count = 0
    for n, nb, t in ((524_288, 8_192, 8), (1_048_576, 16_384, 8),
                     (65_536, 1_024, 8), (4_096, 256, 3)):
        for off in ("masked_full", "fori", "aligned", "square", "chunked"):
            for chips in (1, 256, 512):
                a = jc.geostat_cell_cost(n, nb, t, chips=chips, off_update=off)
                b = tc.geostat_cell_cost(n, nb, t, chips=chips,
                                         off_update=off, rates=V5E)
                assert _close(a, b), (n, off, chips)
                count += 1
    assert count == 60


@pytest.mark.parametrize("policy", ["tpu", "paper_cpu", "three_tier"])
def test_geostat_dag_cost_equals_the_reference_under_v5e(policy):
    pols = {"tpu": (JP.tpu(2), TP.tpu(2)),
            "paper_cpu": (JP.paper_cpu(2), TP.paper_cpu(2)),
            "three_tier": (JP.three_tier(1, 3), TP.three_tier(1, 3))}
    jp, tp = pols[policy]
    count = 0
    for n, nb in ((4_096, 256), (8_192, 512)):
        for variant in ("tile", "panel", "dst"):
            for chips in (1, 16):
                a = jc.geostat_dag_cost(n, nb, jp, chips=chips,
                                        variant=variant)
                b = tc.geostat_dag_cost(n, nb, tp, chips=chips,
                                        variant=variant, rates=V5E)
                assert _close(a, b), (n, variant)
                assert a.detail == pytest.approx(b.detail, rel=REL)
                count += 1
    assert count == 12


def test_h100_weights_and_report():
    """Under the H100's rates a tier weighs the bf16 peak over its dtype's:
    14.8 for fp32 and fp64, 1 for bf16, 0.5 for fp8; the report divides by
    989e12 FLOP/s, 3.35e12 B/s and 50e9 B/s and names its source."""
    assert H100.weight("hi", torch.float32) == pytest.approx(989 / 67)
    assert H100.weight("hi", torch.float64) == pytest.approx(989 / 67)
    assert H100.weight("lo", torch.bfloat16) == 1.0
    assert H100.weight("lo2", torch.float8_e4m3fn) == pytest.approx(0.5,
                                                                    rel=1e-3)
    assert V5E.weight("hi", torch.float64) == 6.0
    rep = roofline.RooflineReport("x", "smoke", 1, 989e12, 3.35e12, 50e9,
                                  0.0).finalize()
    assert (rep.t_compute, rep.t_memory, rep.t_collective) == pytest.approx(
        (1.0, 1.0, 1.0))
    assert rep.rates == "H100" and "H100" in rep.rates_source
    a = tc.geostat_cell_cost(65_536, 1_024, 8, chips=1, off_update="square")
    b = tc.geostat_cell_cost(65_536, 1_024, 8, chips=1, off_update="square",
                             rates=V5E)
    assert a.detail["lo_flops"] == b.detail["lo_flops"]
    assert a.detail["hi_flops"] == pytest.approx(
        b.detail["hi_flops"] / 6 * 989 / 67)
    # phase 4's cell: the fp32 band decides, 0.47 s on the card
    rep = roofline.RooflineReport("4", "smoke", 1, a.flops, a.hbm_bytes,
                                  a.collective_bytes_per_chip,
                                  a.model_flops).finalize(H100)
    assert rep.bottleneck == "compute"
    assert rep.t_bound == pytest.approx(0.4717, abs=1e-4)


def test_h100_charges_the_fp32_score_product():
    """The port computes q k^T from fp32 copies: under the H100's rates
    that half of the scores weighs fp32's 14.8, under V5E's 1."""
    cfg = LM_CONFIGS["llama3.2-1b"]
    shape = ShapeSpec("t", "train", 4_096, 8)
    a = tc.lm_cell_cost(cfg, shape, chips=1, mesh_axes={}, microbatches=4)
    b = tc.lm_cell_cost(cfg, shape, chips=1, mesh_axes={}, microbatches=4,
                        rates=V5E)
    qk = 4 * 16 * 2 * 8 * 4_096 * 4_096 * 32 * 64 * 0.5
    assert a.detail["qk_fp32_flops"] == qk
    assert a.flops == pytest.approx(b.flops + (989 / 67 - 1) * qk, rel=REL)
    assert "qk_fp32_flops" not in b.detail


# ---------------------------------------------------------------------
# the analytic FLOPs against a counter (tests/test_costmodel_roofline.py's
# two tiny configs and tolerances; the reference counts with XLA)
# ---------------------------------------------------------------------

def _counted_flops(cfg):
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.zeros((4, 256), dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        forward_lm(params, toks, cfg, compute_dtype=torch.float32)
    return counter.get_total_flops()


def test_analytic_flops_match_the_counter_dense():
    cfg = ArchConfig(name="v", family="dense", n_layers=1, d_model=128,
                     n_heads=8, n_kv_heads=4, d_head=16, d_ff=512,
                     vocab=1024, remat=False)
    assert _counted_flops(cfg) == pytest.approx(
        tc._forward_flops(cfg, 4, 256), rel=0.25)


def test_analytic_flops_match_the_counter_moe():
    cfg = ArchConfig(name="vm", family="moe", n_layers=1, d_model=128,
                     n_heads=8, n_kv_heads=4, d_head=16, d_ff=0, vocab=1024,
                     moe=MoESpec(n_experts=8, top_k=2, d_expert=256),
                     remat=False)
    assert _counted_flops(cfg) == pytest.approx(
        tc._forward_flops(cfg, 4, 256), rel=0.3)


def test_lm_cell_cost_scaling_laws():
    """Sanity relations the roofline table relies on."""
    cfg = ArchConfig(name="s", family="dense", n_layers=4, d_model=256,
                     n_heads=8, n_kv_heads=4, d_head=32, d_ff=1024,
                     vocab=4096)
    axes = {"data": 16, "model": 16}
    train = ShapeSpec("t", "train", 4096, 256)
    decode = ShapeSpec("d", "decode", 32768, 128)
    c_train = tc.lm_cell_cost(cfg, train, chips=256, mesh_axes=axes)
    c_dec = tc.lm_cell_cost(cfg, decode, chips=256, mesh_axes=axes)
    assert c_train.flops > 100 * c_dec.flops          # train >> decode flops
    assert c_dec.hbm_bytes < c_train.hbm_bytes
    # kv_quant halves (approximately) the decode cache bytes
    c_dec_q = tc.lm_cell_cost(cfg, decode, chips=256, mesh_axes=axes,
                              opts={"kv_quant": True})
    cache = c_dec.detail["cache_bytes"]
    cache_q = c_dec_q.detail["cache_bytes"]
    assert 0.4 < cache_q / cache < 0.6
    # no_fsdp removes the gather term
    c_nf = tc.lm_cell_cost(cfg, train, chips=256, mesh_axes=axes,
                           opts={"no_fsdp": True})
    assert c_nf.collective_bytes_per_chip < c_train.collective_bytes_per_chip


def test_geostat_cost_band_fraction():
    c_mp = tc.geostat_cell_cost(65536, 2048, diag_thick=4, chips=256)
    c_dp = tc.geostat_cell_cost(65536, 2048, diag_thick=32, chips=256)
    assert c_dp.flops > c_mp.flops            # all-fp32 band costs more
    assert 0 < c_mp.detail["band_frac"] < 0.5
    # aligned version cuts the masked-full waste
    c_al = tc.geostat_cell_cost(65536, 2048, diag_thick=4, chips=256,
                                off_update="aligned")
    assert c_al.flops < c_mp.flops


def test_geostat_dag_cost_exact_counts():
    c2 = tc.geostat_dag_cost(4096, 512, TP.tpu(2), chips=16)
    c4 = tc.geostat_dag_cost(4096, 512, TP.tpu(4), chips=16)
    p, nb = 8, 512
    assert c2.detail["total_flops"] == pytest.approx((p**3 / 3) * nb**3)
    assert c2.model_flops == pytest.approx(4096**3 / 3)
    assert c4.flops > c2.flops                # more fp32-weighted hi tiles
    assert c4.detail["hi_frac"] > c2.detail["hi_frac"]
    assert c2.detail["critical_path_tasks"] == 3 * p - 2
    c_full = tc.geostat_dag_cost(4096, 512, TP.full(), chips=16)
    assert c_full.detail["hi_frac"] == pytest.approx(1.0)
    assert c_full.detail["convert_tiles"] == 0


# ---------------------------------------------------------------------
# the distributed engine's collectives: counted, against the formula its
# steps give and against the cost model's collective term
# ---------------------------------------------------------------------

N, NB, T = 256, 32, 2
THETA = [1.0, 0.1, 0.5]


def _collective_worker(rank, world, path, dims):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=world)
    grid = make_grid(*dims)
    g = torch.Generator().manual_seed(0)
    locs = torch.rand((N, 2), generator=g)
    z = torch.randn(N, generator=g)
    out = {}
    for v in td.VERSIONS:
        def run():
            return td.geostat_loglik_distributed(locs, z, THETA, nb=NB,
                                                 policy=TP.tpu(T), version=v,
                                                 grid=grid)
        off = run()
        with roofline.count_collectives() as counted:
            on = run()
        out[v] = dict(counted=counted, same_bits=bool(torch.equal(off, on)))
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.mark.parametrize("dims", [(1, 2), (2, 2)])
def test_collective_bytes_are_the_engines_steps(dims, tmp_path):
    """On a gloo grid, n = 256, nb = 32, band 2, tpu(2): each rank's counted
    bytes and calls equal `distributed_collective_bytes` exactly for every
    version, and counting leaves ll's bits unchanged.  Against
    geostat_cell_cost's collective term (the panel column gathered along
    one mesh row, (n - (k+1) nb) nb 2 x 2 bytes a step over sqrt(chips))
    masked_full moves 3.36x it a rank on 1 x 2 and 4.60-4.74x on 2 x 2 at
    this size: the engine also broadcasts L_kk and the solve's blocks and
    gathers whole padded panel pieces."""
    world = dims[0] * dims[1]
    mp.spawn(_collective_worker, args=(world, str(tmp_path), dims),
             nprocs=world)
    ratios = []
    model = tc.geostat_cell_cost(N, NB, T, chips=world).collective_bytes_per_chip
    for rank in range(world):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        for v in td.VERSIONS:
            want = tc.distributed_collective_bytes(
                N, NB, T, *dims, hi_bytes=4, lo_bytes=2, version=v,
                position=rank)
            assert got[v]["counted"] == want, (rank, v)
            assert got[v]["same_bits"]
        ratios.append(got["masked_full"]["counted"]["total"] / model)
    want = {(1, 2): [3.359], (2, 2): [4.599, 4.742]}[dims]
    assert sorted({round(r, 3) for r in ratios}) == want


def test_no_count_on_one_process():
    """The smoke grid's engine calls no collective: nothing is counted."""
    g = torch.Generator().manual_seed(0)
    locs, z = torch.rand((N, 2), generator=g), torch.randn(N, generator=g)
    with roofline.count_collectives() as counted:
        td.geostat_loglik_distributed(locs, z, THETA, nb=NB, policy=TP.tpu(T))
    assert counted["total"] == 0 and counted["count"] == 0
    assert tc.distributed_collective_bytes(N, NB, T, 1, 1, hi_bytes=4,
                                           lo_bytes=2)["total"] == 0


# ---------------------------------------------------------------------
# the memory plans, moved out of chip_smoke.py: the values it gave before
# the move (the repaired train_peak_bytes excepted)
# ---------------------------------------------------------------------

GIB = 2 ** 30


def test_moved_plans_keep_their_values():
    llama = LM_CONFIGS["llama3.2-1b"]
    assert tc.scale_peak_bytes(40_960, 1_024) == 50_084_184_064
    assert tc.panel_grad_peak_gib(65_536, 1_024, 8, 4, 2) == 39.3798828125
    assert tc.train_param_count(llama) == 1_235_814_400
    assert tc.train_step_flops(llama, 8, 4_096, remat=True) == {
        "dense": 242_970_997_555_200, "attention": 52_776_558_133_248,
        "remat": 81_368_155_422_720}
    assert tc.ssm_state_bytes(LM_CONFIGS["xlstm-1.3b"], 4) == 1_615_332_864


@pytest.mark.parametrize("arch, args, total", [
    ("llama3.2-1b", (4, 8_192, 64), 24_237_056_000),
    ("qwen3-moe-30b-a3b", (4, 8_192, 64), 144_039_534_592),
    ("xlstm-1.3b", (4, 512, 64), 12_669_954_304),
    ("jamba-v0.1-52b", (2, 4_096, 32), 215_658_283_008),
    ("llava-next-34b", (2, 1_216, 32), 156_077_977_600),
    ("h2o-danube-1.8b", (2, 8_192, 32), 17_068_173_312),
])
def test_moved_serve_plan_keeps_its_values(arch, args, total):
    """serve_peak_bytes at full depth, as chip_smoke.py gave it (whisper's,
    tightened, in test_tightened_plans)."""
    assert tc.serve_peak_bytes(LM_CONFIGS[arch], *args)["total"] == total


def test_train_peak_repaired():
    """llama3.2-1b at 2 x 4,096: 44,914,769,920 B (41.83 GiB, the update's
    moment) before; the card's softmax backward holds two more fp32
    buffers of the scores' size (8 B an element) and the recomputed layer
    four (B, S, d) fp32 copies: 46,996,430,848 B (43.77 GiB, the
    backward's), against 43.95 GiB measured on an H100 80GB HBM3."""
    llama = LM_CONFIGS["llama3.2-1b"]
    assert tc.train_peak_bytes(llama, 2, 4_096) == 46_996_430_848
    e = 2 * 32 * 4_096 ** 2
    assert 46_996_430_848 - 44_914_769_920 == (
        20 * 1_235_814_400 + 20 * e + 16 * 2 * 4_096 * 2_048 * 2
        + 4 * 2 * 4_096 * 2_048 * 4) - (32 * 1_235_814_400
                                        + 5 * 4 * 16 * 2_048 * 8_192)


def test_tightened_plans():
    """Two reckonings the card measured under their prediction by 5 %,
    tightened: the distributed engine's (10.625 GiB at
    geostat_65k, 11.375 before; test_torch_distributed.py has its terms)
    and whisper-tiny's encoder moment, whose FFN activations follow its
    attention's instead of adding to them (2,269,513,728 B at 16 x 32,
    2,490,697,728 before)."""
    assert tc.distributed_peak_gib(65_536, 1_024, 8, 4, 2, 2) == 10.625
    w = tc.serve_peak_bytes(LM_CONFIGS["whisper-tiny"], 16, 32, 64)
    assert w["total"] == 2_269_513_728
    assert 2_490_697_728 - w["total"] == 3 * 16 * 1_500 * 1_536 * 2


def test_panel_and_distributed_plans():
    """Phase 4's panel evaluation at 65,536: off 8 GiB, the band 2, U over
    64,512 rows in fp32 15.50, c_hi and a lo tile row: 25.87 GiB (25.91
    measured on an H100 with what the process held); the distributed
    engine on a 16 x 16 grid holds 1/256 of the storage and the whole
    panel column, whose band update (c_lo, c_t and a product) decides."""
    assert tc.panel_peak_bytes(65_536, 1_024, 8, 4, 2) / GIB == 25.873046875
    sh = tc.distributed_peak_bytes(524_288, 8_192, 8, 4, 2, 2, data=16,
                                   model=16)
    assert sh["storage"] == (524_288 ** 2 * 2 + 64 * 8 * 8_192 ** 2 * 4) // 256
    assert sh["work"] == 524_288 * 8_192 * 2 + 2 * 524_288 * 8_192 * 4
