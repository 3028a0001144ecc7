"""The comparison fails a broken program: a run driven on the CPU at a
small configuration (the program's plain versions, the reference in fp64),
past the harness's look for a card, once sound and once with each fault
this cell can have planted in the timed path."""

import pytest
import torch

from geobench import harness, program, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def small(name):
    """The cell at n = 1,024, nb = 64: p = 16 tiles, all in the band, so
    that the sound run's gap is rounding alone, far inside any limit."""
    cell = spec.cell(name)
    cell.config.update(n=1024, nb=64, diag_thick=16)
    return cell


def run(cell):
    torch.set_num_threads(2)
    return harness.measure(cell, seed=2 ** 31 + 101, seconds=0.3, trace=False,
                           device="cpu", t_start=0.0,
                           make_entry=program.entry)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(small(name))
    assert r.correct, r.checks
    assert r.answered >= 1 and r.failed == 0


def fault_answer_altered(monkeypatch):
    # the value off by 5 %
    from repro_torch.core import panel_cholesky as pc
    step = pc.banded_loglik
    monkeypatch.setattr(pc, "banded_loglik",
                        lambda *a, **k: step(*a, **k) * 1.05)


def fault_half_left_out(monkeypatch):
    # l of the first half of the observations, scaled to the whole
    from repro_torch.core import panel_cholesky as pc
    step = pc.banded_loglik

    def half(band, off, z, t, failed=None):
        h = band.shape[0] // 2
        return 2 * step(band[:h], off[:h, :h], z[:z.shape[0] // 2], t,
                        failed)
    monkeypatch.setattr(pc, "banded_loglik", half)


def fault_factor_unchanged(monkeypatch):
    # the factorization returns its state as it found it
    from repro_torch.core import panel_cholesky as pc
    monkeypatch.setattr(pc, "panel_cholesky_banded",
                        lambda band, off, policy, **kw: (
                            band, off, torch.zeros((), dtype=torch.bool)))


def fault_band_in_bf16(monkeypatch):
    # the trailing update's products from bf16 operands in the band too:
    # the band one precision step or more below what the configuration
    # states (the control on the card takes the step to TF32)
    from repro_torch.core import panel_cholesky as pc
    matern, potrf, syrk = pc._IMPLS["kernel"]
    monkeypatch.setitem(pc._IMPLS, "kernel", (
        matern, potrf,
        lambda p, **kw: syrk(p.to(torch.bfloat16).to(p.dtype), **kw)))


FAULTS = [fault_answer_altered, fault_half_left_out, fault_factor_unchanged,
          fault_band_in_bf16]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct(name, fault, monkeypatch):
    cell = small(name)
    fault(monkeypatch)
    r = run(cell)
    assert not r.correct, r.checks
