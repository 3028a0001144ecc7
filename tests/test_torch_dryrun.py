"""The port's dry-run planner (`python -m repro_torch.launch.dryrun`), the
counterpart of tests/test_dryrun_smoke.py: every applicable cell on both
production meshes in one subprocess, with no device, one report each; a
smoke-mesh cell; the plans on the 1 x 1 mesh equal to the one-card
reckonings the card holds them to (chip_smoke.py phase 21); the
reference's TRAIN_OVERRIDES kept exactly."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import GEOSTAT_CONFIGS, LM_CONFIGS, SHAPES
from repro_torch.configs import cell_applicable
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import costmodel, dryrun
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh

ROOT = Path(__file__).resolve().parents[1]
BOTTLENECKS = ("compute", "memory", "collective")


def _run(*args, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)


def _applicable():
    return [(a, s) for a, cfg in LM_CONFIGS.items() for s, shape in
            SHAPES.items() if cell_applicable(cfg, shape)[0]]


def test_dryrun_all_cells_both_meshes(tmp_path):
    """--all --mesh both: one report per applicable cell and mesh, plus
    geostat_500k on (16, 16) and geostat_1m on (2, 16, 16); chips 256 and
    512, every term > 0, the bottleneck one of the three, the peak per
    chip and the note that a sharded plan is a prediction."""
    r = _run("--all", "--mesh", "both", out=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    files = sorted(os.listdir(tmp_path))
    cells = _applicable()
    assert len(cells) == 33
    assert len(files) == 2 * len(cells) + 2
    for arch, s in cells:
        for mesh, chips in (("single", 256), ("multi", 512)):
            rep = json.loads((tmp_path / f"{arch}__{s}__{mesh}.json")
                             .read_text())
            assert rep["chips"] == chips
            assert rep["t_compute"] > 0 and rep["t_memory"] > 0
            assert rep["t_collective"] > 0
            assert rep["bottleneck"] in BOTTLENECKS
            assert rep["extras"]["peak_bytes_per_chip"] > 0
            assert "A 18" in rep["extras"]["note"]
            assert rep["rates"] == "H100"
    for name, mesh in (("geostat_500k", "single"), ("geostat_1m", "multi")):
        rep = json.loads((tmp_path / f"{name}__-__{mesh}.json").read_text())
        assert rep["bottleneck"] in BOTTLENECKS
        assert rep["model_flops"] == GEOSTAT_CONFIGS[name].n ** 3 / 3
    lines = [x for x in r.stdout.splitlines()
             if x.startswith("[dryrun] ") and "chips=" in x]
    assert len(lines) == len(files)
    assert "SKIP" in r.stdout and "0 failures" in r.stdout


def test_dryrun_smoke_cell(tmp_path):
    r = _run("--cell", "llama3.2-1b:train_4k", "--mesh", "smoke",
             out=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    (f,) = os.listdir(tmp_path)
    rep = json.loads((tmp_path / f).read_text())
    assert rep["chips"] == 1 and rep["mesh"] == "smoke"
    assert "note" not in rep["extras"]
    assert rep["t_collective"] == 0.0
    assert rep["extras"]["fits_hbm"] is False   # 256 x 4,096 on one card


def test_help_says_what_timeout_bounds():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--help"], env=dict(os.environ,
                                            PYTHONPATH=str(ROOT / "src")),
                       cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0
    assert "--timeout" in r.stdout and "compiles nothing" in r.stdout
    assert "smoke" in r.stdout


def test_train_overrides_are_the_references():
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    assert dryrun.TRAIN_OVERRIDES == jd.TRAIN_OVERRIDES
    for arch in LM_CONFIGS:
        assert dryrun.arch_for_cell(arch).remat_group == \
            jd.arch_for_cell(arch).remat_group


def test_smoke_train_plan_is_the_one_card_reckoning():
    """Phase 17 (b)'s step on the 1 x 1 mesh: the state (params, m, v),
    the batch and train_peak_bytes' working set at the run's microbatch:
    train_peak_bytes plus the batch and the two step counters."""
    cfg = LM_CONFIGS["llama3.2-1b"]
    shape = ShapeSpec("train_4k", "train", 4_096, 8)
    plan = dryrun.plan_lm_cell("llama3.2-1b", shape, make_smoke_mesh(),
                               microbatches=4, cfg=cfg)
    batch = 2 * 8 * 4_096 * 4
    assert plan.peak_bytes == costmodel.train_peak_bytes(cfg, 2, 4_096) \
        + batch + 8
    assert plan.detail["param_shard"] == 1.0
    rep = dryrun.report(plan, "smoke")
    assert rep.t_collective == 0.0 and rep.bottleneck == "compute"


def test_smoke_geostat_plan_is_the_one_card_reckoning():
    """Phase 14 (b)'s masked_full evaluation at 65,536 on one rank: the
    storage and the working set are distributed_peak_gib's 10.625 GiB,
    beside the locations and z."""
    plan = dryrun.plan_geostat_cell("geostat_65k", make_smoke_mesh())
    assert (plan.args["storage"] + plan.work) / 2**30 == 10.625
    assert plan.args["inputs"] == 65_536 * 3 * 4


def test_sharded_plans_divide_the_state():
    """On (16, 16) a param leaf of llama3.2-1b is cut over both axes where
    its dims divide: the state a rank holds is the params' share."""
    mesh = make_production_mesh()
    plan = dryrun.plan_lm_cell("llama3.2-1b", "train_4k", mesh)
    n = costmodel.train_param_count(LM_CONFIGS["llama3.2-1b"])
    assert plan.args["params"] == pytest.approx(
        4 * n * plan.detail["param_shard"], rel=1e-9)
    assert plan.detail["param_shard"] < 1 / 128
    assert plan.detail["per_rank_batch"] == 16


def test_planning_touches_no_device(monkeypatch):
    """Every tensor the planner builds lies on the meta device."""
    made = []

    def spy(real):
        def make(*a, **k):
            out = real(*a, **k)
            made.append(out.device.type)
            return out
        return make
    for name in ("empty", "zeros", "ones", "full", "randn"):
        monkeypatch.setattr(torch, name, spy(getattr(torch, name)))
    dryrun.plan_lm_cell("whisper-tiny", "decode_32k", make_production_mesh())
    dryrun.plan_geostat_cell("geostat_500k", make_production_mesh())
    assert made and set(made) == {"meta"}
