"""The port's task DAGs (repro_torch.analysis.dag) and task cost model
(repro_torch.launch.costmodel) against the reference's (repro.analysis.dag,
repro.launch.costmodel): for every variant in {tile, panel, dst}, policy
in {full, tpu(2), three_tier(1, 3), paper_cpu(2)} and p in {1, 4, 8}, the
same tasks field for field, the same producer indices, generations and
check_dag report, and the same HazardError on the same corrupted streams.
Pure Python on both sides: no tensor is touched."""

import dataclasses

import json

import pytest
import torch

import repro.analysis.dag as jdag
import repro.launch.costmodel as jcost
from repro.core.precision import PrecisionPolicy as JP
import repro_torch.analysis.dag as tdag
import repro_torch.launch.costmodel as tcost
from repro_torch.core.precision import PrecisionPolicy as TP

torch.set_num_threads(1)

# label -> (reference policy, port policy)
POLICIES = {
    "full": (JP.full(), TP.full()),
    "tpu2": (JP.tpu(2), TP.tpu(2)),
    "three_tier13": (JP.three_tier(1, 3), TP.three_tier(1, 3)),
    "paper_cpu2": (JP.paper_cpu(2), TP.paper_cpu(2)),
}
VARIANTS = ("tile", "panel", "dst")
PS = (1, 4, 8)


def _fields(tasks):
    return [dataclasses.astuple(t) for t in tasks]


def _verdict(mod, tasks, p, policy, variant):
    """check_dag's report as a dict, or the HazardError's message."""
    try:
        return dataclasses.asdict(mod.check_dag(tasks, p, policy, variant))
    except mod.HazardError as e:
        return f"HazardError: {e}"


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("label", sorted(POLICIES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_dag_equals_reference(variant, label, p):
    jp, tp = POLICIES[label]
    jt, tt = jdag.build_dag(variant, p, jp), tdag.build_dag(variant, p, tp)
    assert _fields(tt) == _fields(jt)
    assert [str(t) for t in tt] == [str(t) for t in jt]
    jd = jdag.task_dependencies(jt, p, jp, variant)
    td = tdag.task_dependencies(tt, p, tp, variant)
    assert td == jd
    assert tdag.successor_map(td) == jdag.successor_map(jd)
    assert tdag.generations(td) == jdag.generations(jd)
    verdict = _verdict(tdag, tt, p, tp, variant)
    assert verdict == _verdict(jdag, jt, p, jp, variant)
    assert isinstance(verdict, dict) and verdict["n_tasks"] >= 1
    assert [tdag.storage_tier(tp, i, j, variant=variant)
            for i in range(p) for j in range(i + 1)] == \
        [jdag.storage_tier(jp, i, j, variant=variant)
         for i in range(p) for j in range(i + 1)]


# ---- corrupted streams: the same HazardError ------------------------------

def _idx(tasks, kind, **attrs):
    for i, t in enumerate(tasks):
        if t.kind == kind and all(getattr(t, k) == v for k, v in attrs.items()):
            return i
    raise AssertionError(f"no {kind} {attrs} in stream")


def _swap_first_trsm(mod, tasks):          # TRSM before POTRF
    i = _idx(tasks, "TRSM")
    tasks[0], tasks[i] = tasks[i], tasks[0]


def _duplicate_update(mod, tasks):
    i = _idx(tasks, "GEMM")
    tasks.insert(i + 1, tasks[i])


def _drop_promote(mod, tasks):             # sconv2d gone
    del tasks[_idx(tasks, "CONVERT", tier=mod.HI, src_tier=mod.LO)]


def _drop_demote(mod, tasks):              # dlag2s gone
    del tasks[_idx(tasks, "CONVERT", tier=mod.LO, src_tier=mod.HI)]


def _skip_update(mod, tasks):
    del tasks[_idx(tasks, "SYRK")]


def _write_after_factor(mod, tasks):
    tasks.append(mod.Task("GEMM", 0, (3, 2), reads=((3, 0), (2, 0), (3, 2)),
                          tier=mod.LO))


def _duplicate_factor(mod, tasks):
    tasks.append(tasks[_idx(tasks, "POTRF")])


def _noop_convert(mod, tasks):
    tasks.insert(1, mod.Task("CONVERT", 0, (0, 0), tier=mod.HI,
                             src_tier=mod.HI))


def _missing_factor(mod, tasks):
    del tasks[_idx(tasks, "POTRF", target=(3, 3))]


def _move_consumer_first(mod, tasks):      # a GEMM before its TRSMs
    i = _idx(tasks, "GEMM")
    tasks.insert(1, tasks.pop(i))


CORRUPTIONS = {f.__name__[1:]: f for f in (
    _swap_first_trsm, _duplicate_update, _drop_promote, _drop_demote,
    _skip_update, _write_after_factor, _duplicate_factor, _noop_convert,
    _missing_factor, _move_consumer_first)}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corrupted_stream_same_hazard(name):
    out = []
    for mod, pol in ((jdag, POLICIES["tpu2"][0]), (tdag, POLICIES["tpu2"][1])):
        tasks = mod.build_dag("tile", 4, pol)
        CORRUPTIONS[name](mod, tasks)
        out.append(_verdict(mod, tasks, 4, pol, "tile"))
    assert out[1] == out[0]
    assert out[1].startswith("HazardError")


def test_dst_dag_refused_for_non_dst_generators():
    with pytest.raises(ValueError, match="dst_dag"):
        tdag.build_dag("tile", 4, TP.dst(2))


@pytest.mark.parametrize("label", sorted(POLICIES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_flop_report_equals_reference(variant, label):
    jp, tp = POLICIES[label]
    assert tdag.flop_report(256, 32, tp, variant) == \
        jdag.flop_report(256, 32, jp, variant)
    with pytest.raises(AssertionError):
        tdag.flop_report(100, 32, tp, variant)


# ---- the cost model the runtime reads --------------------------------------

@pytest.mark.parametrize("label", sorted(POLICIES))
def test_task_virtual_cost_equals_reference(label):
    jp, tp = POLICIES[label]
    assert tcost.TIER_WEIGHT == jcost.TIER_WEIGHT
    assert tcost.CONVERT_COST_UNITS == jcost.CONVERT_COST_UNITS
    for variant in VARIANTS:
        jt, tt = jdag.build_dag(variant, 6, jp), tdag.build_dag(variant, 6, tp)
        for cc in (0.0, 0.25, 3.0):
            assert [tcost.task_virtual_cost(t, convert_cost=cc) for t in tt] \
                == [jcost.task_virtual_cost(t, convert_cost=cc) for t in jt]


def test_calibration_table(monkeypatch, tmp_path):
    """The committed table is the card's: it loads, its keys cover every
    (kind, tier) pair the DAGs emit, and its meta names an NVIDIA card and
    its power limit; with the file missing calibrated=True raises, as the
    reference does without one; an injected table is read as the
    reference reads it, with the analytic weight for a missing key."""
    import re

    from repro_torch.obs.calibrate import cost_key
    task = tdag.Task("GEMM", 0, (2, 1), reads=((2, 0), (1, 0), (2, 1)),
                     tier=tdag.LO)
    payload = json.loads(tcost.CALIBRATION_PATH.read_text())
    tcost.set_calibration(None)
    costs = tcost.load_calibration()
    assert costs == payload["costs"] and all(v > 0 for v in costs.values())
    for label in sorted(POLICIES):
        for variant in VARIANTS:
            keys = {cost_key(t) for t in tdag.build_dag(
                variant, 6, POLICIES[label][1])}
            assert keys - {"GEMM/lo2", "TRSM/lo2"} <= set(costs), (label,
                                                                   variant)
    meta = payload["meta"]
    assert meta["backend"] == "cuda" and meta["units"] == "microseconds"
    assert meta["device"].startswith("NVIDIA")
    assert re.fullmatch(r"NVIDIA [^,]+, \d+\.\d+ W", meta["nvidia_smi"])
    assert tcost.task_virtual_cost(task, calibrated=True) == costs["GEMM/lo"]
    monkeypatch.setattr(tcost, "CALIBRATION_PATH", tmp_path / "missing.json")
    tcost.set_calibration(None)
    try:
        with pytest.raises(FileNotFoundError, match="calibration"):
            tcost.task_virtual_cost(task, calibrated=True)
    finally:
        monkeypatch.undo()
        tcost.set_calibration(None)
    table = {"GEMM/lo": 41.5, "CONVERT": 3.0}
    try:
        tcost.set_calibration(table)
        assert tcost.task_virtual_cost(task, calibrated=True) == 41.5
        potrf = tdag.Task("POTRF", 0, (0, 0), reads=((0, 0),))
        assert tcost.task_virtual_cost(potrf, calibrated=True) == \
            jcost.task_virtual_cost(jdag.Task("POTRF", 0, (0, 0),
                                              reads=((0, 0),)))
    finally:
        tcost.set_calibration(None)
    assert tcost.task_virtual_cost(task, table=table, calibrated=True) == 41.5
    assert tcost.task_virtual_cost(task) == 2.0    # GEMM units x lo weight
