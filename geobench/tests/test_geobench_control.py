"""On the card, at each cell's own size and load (a window of as many
answers as a run compares): the control (the reference one precision step
below the configuration's, in the program's place) comes out not correct
on three seeds.  python3 -m pytest -m card geobench/tests on the chip."""

import time

import pytest

from geobench import control, harness, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEEDS = (2 ** 31 + 7001, 2 ** 31 + 7002, 2 ** 31 + 7003)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, card):
    cell = spec.cell(name)
    for seed in SEEDS:
        run = harness.measure(cell, seed=seed, seconds=30.0, trace=False,
                              device=card, t_start=time.perf_counter(),
                              make_entry=control.control_entry)
        assert run.answered >= 1
        assert not run.correct, (seed, run.checks)


def test_control_steps_each_precision_down():
    tpu = spec.cell("tpu65k.loglik").config
    pair = spec.cell("pair65k.loglik").config
    # IEEE fp32 -> TF32 with the bf16 off-band as stated; fp64 -> fp32 and
    # IEEE fp32 -> TF32
    assert control.control_kind(tpu) == "tiled"
    assert control.control_kind(pair) == "dense"
    with pytest.raises(ValueError):
        control.control_kind(dict(pair, hi="float32", lo="float32"))
