"""BENCHMARK.json against the benchmark's contract, and every cell's
configuration, traffic, limits and metric readers found by name."""

import json
import re

import numpy as np
import pytest

from geobench import callers, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["geobench"]
    assert BENCH["command"][1] == "geobench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # a full check: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 a cell to
    # compile, 1,200 spare, within 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43_200


def test_names_units_and_entries():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= set(CELLS)
        # every listed cell reports the end-to-end metric this one moves
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in spec.cell(cell).end_to_end}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("geobench/configs/")
        assert len(c["source"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.cell(name)
    assert cell.config["n"] % cell.config["nb"] == 0
    assert cell.config["reduced"] == next(
        c["reduced"] for c in BENCH["configs"]
        if c["name"] == cell.config["name"])
    for key in cell.config["reduced"]:
        assert cell.config["source_sizes"][key] != cell.config[key]
    assert cell.traffic["entry"] == "value"
    numbers = set(cell.limits) - {"_readings"}
    assert numbers <= {"ll_gap", "ll_gap_tiled", "lead_gap"}
    assert {"ll_gap", "ll_gap_tiled"} & numbers
    # every cell reports setup_s, one more end-to-end metric and a
    # per-layer metric, each with a reader
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end:
        assert callable(spec.reader("e2e", m["name"]))
    for m in cell.per_layer:
        assert callable(spec.reader("metrics", m["name"]))


def test_unknown_cell_names_the_known():
    with pytest.raises(KeyError, match="tpu65k.loglik"):
        spec.cell("no.such.cell")


def test_thetas_from_the_seed():
    mix = spec.cell("tpu65k.loglik").traffic
    theta0 = [1.0, 0.03, 0.5]
    big = 2 ** 31 + 977
    a = callers.thetas(mix, theta0, big)
    assert a == callers.thetas(mix, theta0, big)
    assert a != callers.thetas(mix, theta0, big + 1)
    th = np.array(a)
    assert (th[:, 2] == 0.5).all()
    for k, (lo, hi) in enumerate(mix["theta_box"]):
        ratio = th[:, k] / theta0[k]
        assert ratio.min() >= lo * (1 - 1e-7) and ratio.max() <= hi * (1 + 1e-7)
        assert ratio.min() < lo + 0.01 and ratio.max() > hi - 0.01
    # every theta is an fp32 number, the same for both sides
    assert (th.astype(np.float32).astype(np.float64) == th).all()


def test_check_sample_from_the_seed():
    mix = spec.cell("tpu65k.loglik").traffic
    s = callers.check_sample(mix, 12345, 20)
    assert s == callers.check_sample(mix, 12345, 20)
    assert len(s) == mix["check_sample"] and s == sorted(set(s))
    assert callers.check_sample(mix, 12345, 2) == [0, 1]
    assert callers.check_sample(mix, 12345, 0) == []
