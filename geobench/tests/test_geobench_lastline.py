"""The result line's shape, and run.py's refusals."""

import json
import math
import subprocess
import sys

import pytest
import torch

from geobench import harness, spec, trace

ROOT = spec.ROOT


def fake_run(cell, with_trace):
    red = None
    if with_trace:
        # two kernels of the port's library and one of cuBLAS, one gap
        red = trace.reduce([
            (True, "void syrk_band_lower_kernel<128>(float const*)", 0, 4e8),
            (True, "ampere_sgemm_128x64_tn", 5e8, 6e8),
            (False, "cudaFree", 4.1e8, 4.9e8),
            (False, "aten::sub_", 3e8, 4.2e8),
            (True, "void matern_cov_kernel<float, __nv_bfloat16>()", 6e8,
             7e8),
        ])
    return harness.Run(
        cell=cell.name, config=cell.config, traffic=cell.traffic, setup_s=12.5,
        window_s=0.8, answered=2, failed=0, peak_bytes=3 * 2 ** 30,
        trace=red, correct=True,
        checks={"ll_gap": {"value": 1e-6, "limit": 1e-5},
                "lead_gap": {"value": math.inf, "limit": 1e-3},
                "failed": {"value": 0, "limit": 0}},
        phases={})


@pytest.mark.parametrize("with_trace", [False, True])
def test_result_line(with_trace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    cell = spec.cell("tpu65k.loglik")
    line = harness.result(fake_run(cell, with_trace), cell, with_trace,
                          "NVIDIA H100 80GB HBM3, 700.00 W")
    text = json.dumps(line, allow_nan=False)
    assert json.loads(text) == line
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["checks"]["lead_gap"] == {"value": None, "limit": 1e-3}
    assert line["checks"]["failed"] == {"value": 0, "limit": 0}
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 3 * 2 ** 30
    want = {m["name"]: m["unit"] for m in
            (cell.per_layer if with_trace else cell.end_to_end)}
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    if not with_trace:
        assert set(line["metrics"]) == set(want)
        assert line["metrics"]["eval_s"]["value"] == pytest.approx(0.4)
        return
    assert dev["busy_s"] == pytest.approx(0.6) and dev["window_s"] == 0.8
    assert line["metrics"]["device_idle"]["value"] == pytest.approx(25.0)
    # 0.1 s of cuBLAS in two evaluations
    assert line["metrics"]["torch_ops_ms"]["value"] == pytest.approx(50.0)
    bd = line["breakdown"]
    assert bd["device_ops"][0] == ["void syrk_band_lower_kernel<128>(float "
                                   "const*)", 0.4]
    assert bd["idle_gaps"] == [["cudaFree", 0.1]]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_reduce_merges_overlaps_and_labels_the_innermost():
    red = trace.reduce([
        (True, "a", 0, 10), (True, "b", 5, 20), (True, "c", 30, 40),
        (True, "d", 45, 50),
        (False, "outer", 0, 100), (False, "inner", 21, 29),
        (False, "late", 41, 60),
    ])
    assert red.busy_s == pytest.approx(35e-9)
    assert red.gaps == [(10e-9, "inner"), (5e-9, "late")]
    assert red.kernels["a"] == [1, 10e-9]


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    out = subprocess.run(
        [sys.executable, "geobench/run.py", "--workload", "tpu65k.loglik",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
