"""The port's accuracy harness (`repro_torch.verify`) against the
reference's (`repro.verify`), on the CPU.

The port's counterpart of tests/test_verify_accuracy.py (generators,
oracles, the bound registry, the golden gate) and
tests/test_conformance_sweep.py (the sweep's bounds, the paper's claims,
coverage, the golden gate against golden/accuracy_cpu.json), plus what
ties the two packages together: the registry and the dtype-pair labels
equal the reference's, the fp64 oracle equals numpy's and
`jnp.linalg.cholesky` under x64 (the reference's own oracle calls the
removed `jax.experimental.enable_x64`), the metric functions equal the
reference's numpy ones, and on reference problems carried across bit for
bit every Cholesky and kriging record equals, within the stated
tolerances, the same metric of the reference engines' factor.

On the CPU every kernel's `ops` runs its plain version, so the kernel
records compare the plain version with itself: 0, or for mp_attention the
rounding between the online softmax and the one-pass oracle.  The card's
sweep (through the kernels) is chip_smoke.py's phase 11.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrecisionPolicy as JP
from repro.core.kriging import krige_pmse as jax_krige_pmse
from repro.core.likelihood import dst_loglik as jax_dst_loglik
from repro.core.likelihood import loglik_from_factor as jax_loglik
from repro.core.panel_cholesky import (
    assemble_from_banded as jax_assemble_from_banded,
    banded_loglik as jax_banded_loglik,
    build_banded_covariance as jax_build_banded,
    panel_cholesky_banded as jax_panel,
)
from repro.core.tile_cholesky import (
    dst_assemble as jax_dst_assemble,
    dst_cholesky as jax_dst_cholesky,
    tile_cholesky as jax_tile_cholesky,
)
from repro.verify import bounds as jax_bounds
from repro.verify import generators as jax_generators
from repro.verify import oracles as jax_oracles
from repro_torch import interop
from repro_torch.core import PrecisionPolicy
from repro_torch.verify import (
    CHOLESKY_NB,
    CONDITIONS,
    REGIMES,
    SIZES,
    AccuracyBound,
    CholeskyProblem,
    attention_problem,
    backward_error,
    check_records,
    claim_failures,
    compare_to_golden,
    dtype_pair,
    exact_factor,
    exact_kriging_pmse,
    exact_loglik,
    load_golden,
    loglik_drift,
    lookup_bound,
    matern_problem,
    pmse_drift,
    policy_bound,
    registry_table,
    rel_frobenius,
    run_conformance,
    save_golden,
    spd_matrix,
    sweep_cholesky,
    sweep_kriging,
)
from repro_torch.verify import generators as port_generators
from repro_torch.verify import oracles as port_oracles
from repro_torch.verify.golden import CARD_NB, CARD_SIZES, golden_path
from repro_torch.verify.oracles import loglik_of_factor

torch.set_num_threads(1)
pytestmark = pytest.mark.accuracy

REFERENCE_GOLDEN = "src/repro/verify/golden/accuracy.json"


def _sym(a):
    """a made exactly symmetric in its own precision.  The reference's
    `jnp.linalg.cholesky` factors (a + a^T) / 2, torch's and numpy's the
    lower triangle: on a symmetric matrix (every covariance) the same."""
    return (a + a.T) / 2


# ---- generators -----------------------------------------------------------

def test_constants_are_the_references():
    assert SIZES == jax_generators.SIZES
    assert REGIMES == jax_generators.REGIMES
    assert CHOLESKY_NB == jax_generators.CHOLESKY_NB
    assert CONDITIONS == jax_generators.CONDITIONS


@pytest.mark.parametrize("n,regime,seed", [(64, "weak", 0), (128, "strong", 0),
                                           (192, "medium", 3)])
def test_problem_seed_is_the_reference_key(n, regime, seed):
    # the reference keys its problem with PRNGKey(seed*7919 + n*31 + regime)
    assert port_generators.problem_seed(n, regime, seed) == (
        seed * 7919 + n * 31 + jax_generators.REGIMES.index(regime))


@pytest.mark.parametrize("cond", sorted(CONDITIONS.values()))
def test_spd_matrix_deterministic_and_conditioned(cond):
    a = spd_matrix(3, 64, cond=cond, device="cpu").double().numpy()
    b = spd_matrix(3, 64, cond=cond, device="cpu").double().numpy()
    np.testing.assert_array_equal(a, b)
    # symmetric to fp32 rounding at the matrix's own scale
    assert np.abs(a - a.T).max() < 1e-6 * np.abs(a).max()
    eigs = np.linalg.eigvalsh(a)
    assert eigs.min() > 0
    # the spectrum is exactly log-spaced, so cond hits the target (the
    # reference's test holds 1e4 to 1e-2; 1e6 in fp32 to 5e-2)
    assert eigs.max() / eigs.min() == pytest.approx(cond, rel=5e-2)


def test_spd_matrix_accepts_a_generator():
    a = spd_matrix(torch.Generator().manual_seed(5), 32)
    b = spd_matrix(torch.Generator().manual_seed(5), 32)
    assert a.device.type == "cpu"
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("regime", REGIMES)
def test_matern_problem_deterministic_and_spd(regime):
    p1 = matern_problem(64, regime, device="cpu")
    p2 = matern_problem(64, regime, device="cpu")
    assert torch.equal(p1.cov, p2.cov) and torch.equal(p1.z, p2.z)
    assert isinstance(p1, CholeskyProblem)
    assert p1.p == 64 // p1.nb and p1.name == f"n64_{regime}"
    assert p1.cov.dtype == torch.float32 and p1.cov.shape == (64, 64)
    assert torch.equal(p1.cov, p1.cov.T)  # the symmetric kernel's Sigma
    # the reference's theta is an fp32 array
    assert p1.theta == pytest.approx(tuple(
        float(v) for v in jax_generators.CORRELATION_LEVELS[regime]), rel=1e-7)
    assert np.linalg.eigvalsh(p1.cov.double().numpy()).min() > 0


def test_matern_problem_rejects_an_unknown_regime():
    with pytest.raises(ValueError, match="unknown regime"):
        matern_problem(64, "tepid", device="cpu")


def test_matern_regimes_differ():
    weak = matern_problem(64, "weak", device="cpu")
    strong = matern_problem(64, "strong", device="cpu")
    # stronger correlation -> more off-diagonal mass
    off = lambda p: (p.cov.double() - torch.diag(torch.diag(p.cov.double()))
                     ).abs().sum()
    assert off(strong) > off(weak)


def test_attention_problem_shapes_and_scale():
    q, kn, vn, kf, vf = attention_problem(21, 2, 4, 64, 128, 256, scale=2.0,
                                          device="cpu")
    assert q.shape == (2, 4, 64) and kn.shape == vn.shape == (2, 128, 64)
    assert kf.shape == vf.shape == (2, 256, 64)
    q1 = attention_problem(21, 2, 4, 64, 128, 256, device="cpu")[0]
    torch.testing.assert_close(q, 2.0 * q1, rtol=0, atol=0)


def test_problem_from_numpy_carries_the_reference_problem_bit_for_bit():
    jp = jax_generators.matern_problem(64, "medium")
    tp = interop.problem_from_numpy(jp.name, jp.n, jp.nb, jp.regime,
                                    jp.theta, jp.locs, jp.z, jp.cov,
                                    device="cpu")
    for name in ("locs", "z", "cov"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert (tp.name, tp.n, tp.nb, tp.regime, tp.p) == (
        jp.name, jp.n, jp.nb, jp.regime, jp.p)
    assert tp.theta == tuple(float(v) for v in np.asarray(jp.theta))


# ---- oracles --------------------------------------------------------------

@pytest.mark.parametrize("cond", sorted(CONDITIONS.values()))
def test_exact_factor_matches_numpy_and_jax_x64(cond):
    """fp64 Cholesky of one symmetric fp32 matrix by torch, numpy and
    jnp.linalg.cholesky under x64: the same to 1e-12 of max |L| (measured
    <= 3e-14 at cond 1e6)."""
    a = _sym(spd_matrix(1, 32, cond=cond, device="cpu"))
    l = exact_factor(a)
    assert l.dtype == torch.float64
    a64 = a.double().numpy()
    with jax.enable_x64(True):
        l_jax = np.asarray(jnp.linalg.cholesky(jnp.asarray(a64)))
    assert l_jax.dtype == np.float64
    scale = np.abs(l_jax).max()
    for want in (np.linalg.cholesky(a64), l_jax):
        np.testing.assert_allclose(l.numpy(), want, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("cond", sorted(CONDITIONS.values()))
def test_exact_loglik_matches_direct_formula_and_jax_x64(cond):
    """Eq. 2 from the fp64 factor against slogdet + solve and against the
    same formula on jnp's x64 factor: rel 1e-12 (measured <= 2.4e-14)."""
    a = _sym(spd_matrix(2, 32, cond=cond, device="cpu"))
    z = np.random.default_rng(9).standard_normal(32)
    a64 = a.double().numpy()
    _, logdet = np.linalg.slogdet(a64)
    direct = (-0.5 * 32 * np.log(2 * np.pi) - 0.5 * logdet
              - 0.5 * z @ np.linalg.solve(a64, z))
    with jax.enable_x64(True):
        l_jax = jnp.linalg.cholesky(jnp.asarray(a64))
        w = np.asarray(jax.scipy.linalg.solve_triangular(
            l_jax, jnp.asarray(z), lower=True))
        via_jax = float(-0.5 * 32 * np.log(2 * np.pi)
                        - np.log(np.diag(np.asarray(l_jax))).sum()
                        - 0.5 * (w * w).sum())
    got = exact_loglik(a, z)
    assert got == pytest.approx(direct, rel=1e-12)
    assert got == pytest.approx(via_jax, rel=1e-12)


def test_exact_factor_is_nan_where_not_positive_definite():
    a = torch.eye(8)
    a[5, 5] = -1.0
    assert torch.isnan(exact_factor(a)).all()
    assert math.isnan(exact_loglik(a, np.ones(8)))


def test_exact_kriging_pmse_zero_when_truth_is_prediction():
    a = spd_matrix(4, 32, cond=10.0, device="cpu")
    z = np.random.default_rng(3).standard_normal(32)
    a64 = a.double().numpy()
    sigma_no = a64[:4, :]   # predict 4 "new" points
    mu = sigma_no @ np.linalg.solve(a64, z)
    assert exact_kriging_pmse(a, z, sigma_no, mu) == pytest.approx(0.0, abs=1e-18)


def test_exact_kriging_pmse_matches_the_reference_formula():
    a = spd_matrix(4, 32, cond=10.0, device="cpu")
    rng = np.random.default_rng(4)
    z, y = rng.standard_normal(32), rng.standard_normal(4)
    sigma_no = a.double().numpy()[4:8, :]
    got = exact_kriging_pmse(a, z, sigma_no, y)
    # the reference's oracle body in numpy (its enable_x64-free part)
    want = jax_oracles.exact_kriging_pmse(np.asarray(a), z, sigma_no, y)
    assert got == pytest.approx(want, rel=1e-12)


def test_error_metrics_zero_on_exact_inputs():
    a = spd_matrix(7, 32, cond=10.0, device="cpu")
    l = exact_factor(a)
    assert rel_frobenius(l, l) == 0.0
    assert backward_error(l, a) < 1e-7      # fp32 input, fp64 factor
    assert loglik_drift(-123.456, -123.456) == 0.0


def test_loglik_drift_normalization():
    # |ref| < 1 -> absolute scale; large |ref| -> relative scale
    assert loglik_drift(0.3, 0.1) == pytest.approx(0.2)
    assert loglik_drift(-1010.0, -1000.0) == pytest.approx(0.01)


def _metric_inputs():
    rng = np.random.default_rng(17)
    a = np.asarray(spd_matrix(8, 48, cond=1e3, device="cpu"))
    l = np.linalg.cholesky(a.astype(np.float64))
    l_noisy = (l * (1 + 1e-3 * rng.standard_normal(l.shape))).astype(np.float32)
    return a, l, l_noisy


@pytest.mark.parametrize("metric", ["rel_frobenius", "backward_error",
                                    "loglik_drift", "pmse_drift"])
def test_metrics_equal_the_references_numpy_ones(metric):
    """The port's metrics on torch tensors against the reference's on the
    same numpy arrays: rel 1e-12 (both fp64; the sums in other orders)."""
    a, l, l_noisy = _metric_inputs()
    port = {"rel_frobenius": rel_frobenius, "backward_error": backward_error,
            "loglik_drift": loglik_drift, "pmse_drift": pmse_drift}[metric]
    ref = getattr(jax_oracles, metric)
    if metric == "rel_frobenius":
        args = (l_noisy, l)
    elif metric == "backward_error":
        args = (l_noisy, a)
    else:
        args = (-812.25, -811.5)
    want = ref(*args)
    got = port(*(torch.as_tensor(x) if isinstance(x, np.ndarray) else x
                 for x in args))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("rows", [16, 20, 48])
def test_blocked_metrics_equal_the_dense_ones(rows, monkeypatch):
    """Row blocks (from n = 8,192 on: no second n^2 fp64 temporary on the
    card) against one dense pass on a symmetric A, rows dividing n or not:
    rel 1e-12; a NaN factor gives NaN either way."""
    a, l, l_noisy = _metric_inputs()
    a = _sym(torch.as_tensor(a))
    l, l_noisy = torch.as_tensor(l), torch.as_tensor(l_noisy)
    bad = l_noisy.clone()
    bad[30, 3] = torch.nan
    dense = (rel_frobenius(l_noisy, l), backward_error(l_noisy, a))
    monkeypatch.setattr(port_oracles, "BLOCKED_N", 1)
    monkeypatch.setattr(port_oracles, "BLOCK_ROWS", rows)
    assert rel_frobenius(l_noisy, l) == pytest.approx(dense[0], rel=1e-12)
    assert backward_error(l_noisy, a) == pytest.approx(dense[1], rel=1e-12)
    assert math.isnan(rel_frobenius(bad, l))
    assert math.isnan(backward_error(bad, a))


# ---- bounds registry ------------------------------------------------------

def test_registry_equals_the_references():
    port, ref = registry_table(), jax_bounds.registry_table()
    assert list(port) == list(ref)
    for key in ref:
        assert dataclasses.asdict(port[key]) == dataclasses.asdict(ref[key]), key


def _twin(jp):
    """The port's policy with the reference policy's fields."""
    name = lambda dt: None if dt is None else jnp.dtype(dt).name
    return interop.policy_from_fields(
        jp.mode, name(jp.hi), name(jp.lo), jp.diag_thick, lo2=name(jp.lo2),
        diag_thick2=jp.diag_thick2, solve_dtype=name(jp.solve_dtype),
        accum_dtype=name(jp.accum_dtype))


TWINS = {
    "full_f32": (JP.full(jnp.float32), "f32"),
    "full_f64": (JP.full(jnp.float64), "f64"),
    "tpu1": (JP.tpu(1), "f32/bf16"),
    "tpu2": (JP.tpu(2), "f32/bf16"),
    "paper_cpu1": (JP.paper_cpu(1), "f64/f32"),
    "mixed_f32f32": (JP(mode="mixed", hi=jnp.float32, lo=jnp.float32,
                        diag_thick=2), "f32/f32"),
    "three_tier": (JP.three_tier(1, 2), "f32/bf16/f8e4m3"),
    "dst": (JP.dst(2), "f32/zero"),
}


@pytest.mark.parametrize("which", list(TWINS))
def test_dtype_pair_is_the_reference_twins_label(which):
    jp, label = TWINS[which]
    assert jax_bounds.dtype_pair(jp) == label
    assert dtype_pair(_twin(jp)) == label


@pytest.mark.parametrize("which", list(TWINS))
@pytest.mark.parametrize("regime", REGIMES)
def test_policy_bound_is_the_reference_twins(which, regime):
    jp, _ = TWINS[which]
    try:
        want = jax_bounds.policy_bound(jp, regime)
    except KeyError:
        with pytest.raises(KeyError, match="no registered bound"):
            policy_bound(_twin(jp), regime)
        return
    assert dataclasses.asdict(policy_bound(_twin(jp), regime)) == \
        dataclasses.asdict(want)


def test_dtype_pair_labels():
    assert dtype_pair(PrecisionPolicy.full(torch.float32)) == "f32"
    assert dtype_pair(PrecisionPolicy.tpu(1)) == "f32/bf16"
    assert dtype_pair(PrecisionPolicy.paper_cpu(1)) == "f64/f32"
    assert dtype_pair(PrecisionPolicy.three_tier(1, 2)) == "f32/bf16/f8e4m3"
    assert dtype_pair(PrecisionPolicy.dst(2)) == "f32/zero"


def test_lookup_prefers_most_specific_key():
    generic = lookup_bound("mixed", "f32/bf16", 2, "strong")
    weak = lookup_bound("mixed", "f32/bf16", 2, "weak")
    # the regime-specific weak entry is strictly tighter than the fallback
    assert weak.factor_rel < generic.factor_rel


def test_lookup_unknown_mode_raises():
    with pytest.raises(KeyError, match="no registered bound"):
        lookup_bound("quantum", "f4/f2")


def test_policy_bound_roundtrip():
    pol = PrecisionPolicy.tpu(2)
    assert policy_bound(pol, "weak") is lookup_bound("mixed", "f32/bf16",
                                                     2, "weak")


def test_bound_violations():
    bound = AccuracyBound(factor_rel=1e-3, loglik_drift=1e-4)
    assert bound.violations({"factor_rel": 1e-4, "loglik_drift": 1e-5}) == []
    msgs = bound.violations({"factor_rel": 1e-2, "loglik_drift": 1e-5})
    assert len(msgs) == 1 and "factor_rel" in msgs[0]
    # metrics without a registered limit are ignored
    assert bound.violations({"pmse_rel": 1e9}) == []


@pytest.mark.parametrize("value", [float("nan"), math.inf, -math.inf])
def test_bound_flags_non_finite_as_violation(value):
    msgs = AccuracyBound(factor_rel=1e-3).violations({"factor_rel": value})
    assert len(msgs) == 1 and "non-finite" in msgs[0]


# ---- golden gate ----------------------------------------------------------

RECORDS = [
    {"id": "chol/a", "factor_rel": 1e-4, "loglik_drift": 1e-5},
    {"id": "kern/b", "max_abs": 1e-3},
]


def test_golden_roundtrip_and_clean_compare(tmp_path):
    path = save_golden(RECORDS, tmp_path / "g.json")
    golden = load_golden(path)
    assert set(golden["records"]) == {"chol/a", "kern/b"}
    assert golden["slack"] == 2.0 and golden["format"] == 1
    assert compare_to_golden(RECORDS, golden) == []


def test_golden_detects_drift(tmp_path):
    golden = load_golden(save_golden(RECORDS, tmp_path / "g.json"))
    moved = [dict(RECORDS[0], factor_rel=3e-4), RECORDS[1]]  # 3x > 2x slack
    drifts = compare_to_golden(moved, golden)
    assert len(drifts) == 1
    assert drifts[0][0] == "chol/a" and "drifted" in drifts[0][1]
    # within slack -> clean
    ok = [dict(RECORDS[0], factor_rel=1.5e-4), RECORDS[1]]
    assert compare_to_golden(ok, golden) == []


def test_golden_floor_absorbs_noise_near_zero(tmp_path):
    gold = [{"id": "kern/exact", "max_rel": 0.0}]
    golden = load_golden(save_golden(gold, tmp_path / "g.json"))
    # 0 * slack = 0, but the 1e-6 floor keeps epsilon-noise from flaking
    assert compare_to_golden([{"id": "kern/exact", "max_rel": 1e-8}],
                             golden) == []
    drifts = compare_to_golden([{"id": "kern/exact", "max_rel": 1e-3}], golden)
    assert len(drifts) == 1


def test_golden_flags_coverage_changes(tmp_path):
    golden = load_golden(save_golden(RECORDS, tmp_path / "g.json"))
    drifts = compare_to_golden(RECORDS + [{"id": "new", "max_abs": 0.1}],
                               golden)
    assert [d[0] for d in drifts] == ["new"]
    drifts = compare_to_golden(RECORDS[:1], golden)
    assert [d[0] for d in drifts] == ["kern/b"]
    assert "coverage lost" in drifts[0][1]


def test_golden_non_finite_metrics(tmp_path):
    """A NaN never passes as no drift against a finite golden value (the
    reference's `value > limit` lets it through); a NaN recorded in the
    golden file must stay non-finite, and a finite value there is a change."""
    golden = load_golden(save_golden(RECORDS, tmp_path / "g.json"))
    nan = [dict(RECORDS[0], factor_rel=float("nan")), RECORDS[1]]
    assert [d[0] for d in compare_to_golden(nan, golden)] == ["chol/a"]
    golden = load_golden(save_golden(nan, tmp_path / "n.json"))
    assert compare_to_golden(nan, golden) == []
    drifts = compare_to_golden(RECORDS, golden)
    assert [d[0] for d in drifts] == ["chol/a"] and "finite" in drifts[0][1]


def test_golden_path_per_device_type():
    assert golden_path("cpu").name == "accuracy_cpu.json"
    assert golden_path("cuda:0").name == "accuracy_cuda.json"
    assert golden_path() == golden_path("cuda")
    assert golden_path("cpu").exists() and golden_path("cuda").exists()


# ---- the default sweep on the CPU -------------------------------------------

@pytest.fixture(scope="module")
def records():
    return run_conformance(device="cpu")


@pytest.fixture(scope="module")
def problems():
    return port_generators.cholesky_problems(device="cpu")


def _by_id(records):
    return {r["id"]: r for r in records}


def test_sweep_ids_are_the_references(records, request):
    """126 records with the reference golden file's ids, one for one."""
    import json
    from pathlib import Path
    root = Path(request.config.rootpath)
    ref_ids = set(json.loads((root / REFERENCE_GOLDEN).read_text())["records"])
    ids = [r["id"] for r in records]
    assert len(ids) == len(set(ids)) == 126
    assert set(ids) == ref_ids


def test_record_fields_are_the_references(records):
    chol = {"id", "kind", "mode", "pair", "diag_thick", "regime", "n",
            "factor_rel", "backward_rel", "loglik_drift"}
    krige = chol - {"factor_rel", "backward_rel", "loglik_drift"} | {"pmse_rel"}
    kern = {"id", "kind", "kernel", "max_rel", "max_abs"}
    for rec in records:
        want = {"cholesky": chol, "kriging": krige, "kernel": kern}[rec["kind"]]
        if rec.get("kernel") == "blocked_potrf":
            want = want | {"backward_rel"}
        if rec.get("kernel") == "mp_attention":
            want = want - {"max_rel"}
        assert set(rec) == want, rec["id"]


def test_all_records_within_registered_bounds(records):
    violations = check_records(records)
    assert violations == [], "\n".join(f"{rid}: {msg}"
                                       for rid, msg in violations)


def test_no_deterioration_claim(records):
    """The paper's central claim, on the {fp32, bf16} pair: the mixed
    factor tracks the fp64 oracle at low-precision rounding scale, and the
    DST baseline at the same band width is a magnitude worse."""
    recs = _by_id(records)
    for n in SIZES:
        for regime in REGIMES:
            mixed = recs[f"chol/tile/mixed_f32bf16_t2/n{n}_{regime}"]
            dst = recs[f"chol/dst/t2/n{n}_{regime}"]
            bound = lookup_bound("mixed", "f32/bf16", 2, regime)
            assert mixed["factor_rel"] <= bound.factor_rel
            assert mixed["loglik_drift"] <= bound.loglik_drift
            if n >= 128:  # at n=64, p=2 the DST super-tile covers most of A
                assert dst["factor_rel"] > 10 * mixed["factor_rel"], (
                    f"n{n}_{regime}: DST should deteriorate, mixed should "
                    f"not -- dst={dst['factor_rel']:.2e} "
                    f"mixed={mixed['factor_rel']:.2e}")


def test_paper_pair_matches_f64_reference(records):
    """fp64 band / fp32 off-band: 'no deterioration' at the paper's own
    dtype pair -- factor error stays at fp32 rounding scale."""
    pair = [r for r in records
            if r["id"].startswith("chol/tile/paper_f64f32_t2/")]
    assert len(pair) == 9
    for rec in pair:
        assert rec["factor_rel"] < 1e-5
        assert rec["loglik_drift"] < 1e-6


def test_sweep_coverage(records):
    recs = _by_id(records)
    # three Cholesky variants on the full grid
    for n in SIZES:
        for regime in REGIMES:
            for variant in (f"chol/tile/full_f32/n{n}_{regime}",
                            f"chol/tile/mixed_f32bf16_t2/n{n}_{regime}",
                            f"chol/panel/mixed_f32bf16_t2/n{n}_{regime}",
                            f"chol/dst/t2/n{n}_{regime}",
                            f"krige/mixed_f32bf16_t2/n{n}_{regime}"):
                assert variant in recs, f"sweep lost coverage of {variant}"
    # all four kernel pairs, >= 9 cases each (3 shapes x 3 regimes)
    kernels = {}
    for rec in records:
        if rec["kind"] == "kernel":
            kernels[rec["kernel"]] = kernels.get(rec["kernel"], 0) + 1
    assert set(kernels) == {"matern_cov", "mp_syrk", "blocked_potrf",
                            "mp_attention"}
    assert all(count >= 9 for count in kernels.values()), kernels


def test_mixed_beats_dst_on_likelihood(records):
    """Accuracy ordering the paper's Fig. 7/8 relies on, in aggregate."""
    drift = lambda pat: np.median([r["loglik_drift"] for r in records
                                   if r["id"].startswith(pat)])
    assert drift("chol/tile/mixed_f32bf16_t2/") < drift("chol/dst/")


def test_claim_failures_is_empty_on_the_sweep(records, problems):
    """`claim_failures`, which chip_smoke.py's phase 11 gates on, finds
    none of the four claims broken where the tests above hold them."""
    assert claim_failures(records, problems) == []


@pytest.mark.parametrize("broken", ["coverage", "dst", "pair", "median"])
def test_claim_failures_catches_each_claim(records, problems, broken):
    recs = [dict(r) for r in records]
    if broken == "coverage":
        recs = [r for r in recs if r["id"] != "chol/panel/mixed_f32bf16_t2/n128_weak"]
    for r in recs:
        if broken == "dst" and r["id"] == "chol/dst/t2/n192_weak":
            r["factor_rel"] = 1e-6
        if broken == "pair" and r["id"] == "chol/tile/paper_f64f32_t2/n192_strong":
            r["loglik_drift"] = 2e-6
        if broken == "median" and r["id"].startswith("chol/dst/"):
            r["loglik_drift"] = 0.0
    assert claim_failures(recs, problems)


def test_golden_regression_gate(records, request):
    if request.config.getoption("--update-golden"):
        path = save_golden(records, device="cpu")
        pytest.skip(f"rewrote the CPU golden baseline at {path}")
    drifts = compare_to_golden(records, load_golden(device="cpu"))
    assert drifts == [], "\n".join(f"{rid}: {msg}" for rid, msg in drifts)


def test_cpu_kernel_records_compare_the_plain_version_with_itself(records):
    """On the CPU `ops` runs `ref`: matern_cov, mp_syrk and blocked_potrf
    read 0; mp_attention's online softmax against the one-pass oracle reads
    its rounding (<= 1e-6 here, the registry's 1e-3 on the card)."""
    for rec in records:
        if rec["kind"] != "kernel":
            continue
        if rec["kernel"] == "mp_attention":
            assert rec["max_abs"] <= 1e-6, rec
        else:
            assert rec["max_abs"] == 0.0 and rec["max_rel"] == 0.0, rec


@pytest.mark.parametrize("control,name", [("band_in_lo", "n128_weak"),
                                          ("band_in_lo", "n192_weak"),
                                          ("nan", "n192_medium")])
def test_negative_control_fails_check_records(records, control, name):
    """A {fp32, bf16} t=2 record whose band was computed in lo as well
    (Sigma and the factor rounded to bf16 everywhere), or whose metric is
    NaN, fails the registry where the real record passes.  The band in lo
    is caught at weak correlation only: there the registry's f32/bf16
    bound is 2e-3 in backward_rel (measured 2.18e-3 and 2.32e-3) and 1e-4
    in loglik_drift (1.24e-4 at n = 128); the medium and strong envelope
    (5e-2, 1e-2, 5e-3) holds an all-bf16 factor (measured <= 1.6e-2,
    2.0e-3, 6.1e-3 on this grid)."""
    real = _by_id(records)[f"chol/tile/mixed_f32bf16_t2/{name}"]
    assert check_records([real]) == []
    if control == "nan":
        bad = dict(real, loglik_drift=float("nan"))
    else:
        n, regime = name[1:].split("_")
        prob = matern_problem(int(n), regime, device="cpu")
        l_ref = exact_factor(prob.cov)
        ll_ref = loglik_of_factor(l_ref, prob.z)
        lo = torch.linalg.cholesky_ex(prob.cov.bfloat16().float())[0]
        lo = lo.bfloat16().double()
        bad = dict(real, factor_rel=rel_frobenius(lo, l_ref),
                   backward_rel=backward_error(lo, prob.cov),
                   loglik_drift=loglik_drift(loglik_of_factor(lo, prob.z),
                                             ll_ref))
    assert check_records([bad]), bad


def test_card_grid_three_tier_nan_is_the_problems():
    """The card's grid (CARD_SIZES at CARD_NB: p in {2, 4, 6}, twice the
    points in the same square) is harder than the CPU's: at n = 384 the
    strong field makes three_tier(1, 3)'s fp8 far field indefinite on the
    plain path as well, as on the card through the kernels (its golden
    file records that NaN).  chip_smoke.py phase 11 (a) therefore gates on
    violations the plain path does not share."""
    probs = port_generators.cholesky_problems(CARD_SIZES[2:], ("strong",),
                                              nb=CARD_NB, device="cpu")
    recs = sweep_cholesky(probs, device="cpu")
    bad = {rid for rid, _ in check_records(recs)}
    assert "chol/tile/three_tier_t1_t3/n384_strong" in bad
    card = load_golden(device="cuda")["records"]
    assert math.isnan(card["chol/tile/three_tier_t1_t3/n384_strong"]["factor_rel"])


# ---- parity with the reference engines on carried problems ------------------

JAX_POLICIES = {
    "full_f32": JP.full(jnp.float32),
    "mixed_f32f32_t2": JP(mode="mixed", hi=jnp.float32, lo=jnp.float32,
                          diag_thick=2),
    "mixed_f32bf16_t1": JP.tpu(diag_thick=1),
    "mixed_f32bf16_t2": JP.tpu(diag_thick=2),
    "three_tier_t1_t3": JP.three_tier(diag_thick=1, diag_thick2=3),
}
# |port metric - reference metric| <= RTOL * reference metric + atol:
# fp32-scale records differ by a few fp32 roundings of the two engines,
# amplified by the strong field (measured <= 1.8e-7 absolute); the paper
# pair's by its fp32 off-band roundings (measured <= 1.04e-8, its
# loglik_drift at n128_strong); bf16 records agree to 1.7e-5 relative in
# factor_rel and 3.6e-3 in loglik_drift
PARITY_RTOL = 1e-2
PARITY_ATOL = {"paper_f64f32_t2": 5e-8}
PARITY_ATOL_FP32 = 5e-7
# kriging: pmse_rel measured within 2e-6 absolute of the reference's
PARITY_ATOL_KRIGE = 1e-5


def _reference_factors(jp):
    """{record id: (L, ll)} of the reference engines on a reference problem,
    as its conformance sweep runs them (the paper pair under x64)."""
    out = {}
    for label, pol in JAX_POLICIES.items():
        l = jax_tile_cholesky(jp.cov.astype(pol.hi), jp.nb, pol)
        out[f"chol/tile/{label}/{jp.name}"] = (np.asarray(l, np.float64),
                                               float(jax_loglik(l, jp.z)))
    with jax.enable_x64(True):
        pol = JP.paper_cpu(2)
        l = jax_tile_cholesky(jnp.asarray(np.asarray(jp.cov, np.float64)),
                              jp.nb, pol)
        out[f"chol/tile/paper_f64f32_t2/{jp.name}"] = (
            np.asarray(l, np.float64), float(jax_loglik(l, jp.z)))
    pol = JP.tpu(2)
    band, off = jax_build_banded(jp.locs, jp.theta, nb=jp.nb, policy=pol,
                                 nu_static=0.5, jitter=1e-6)
    t = min(2, jp.p)
    band, off = jax_panel(band, off, pol)
    out[f"chol/panel/mixed_f32bf16_t2/{jp.name}"] = (
        np.asarray(jax_assemble_from_banded(band, off, t), np.float64),
        float(jax_banded_loglik(band, off, jp.z, t)))
    blocks = jax_dst_cholesky(jp.cov, jp.nb, diag_thick=2)
    out[f"chol/dst/t2/{jp.name}"] = (
        np.asarray(jax_dst_assemble(blocks, jp.n), np.float64),
        float(jax_dst_loglik(blocks, jp.z)))
    return out


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("regime", REGIMES)
def test_records_match_the_reference_engines_on_carried_problems(n, regime):
    """Each Cholesky record of the port's sweep on a reference problem
    (carried bit for bit) against the same metric of the reference engine's
    factor and log-likelihood, both against the port's fp64 oracle of the
    same fp32 Sigma; each kriging record against the reference's
    krige_pmse scored by the port's fp64 predictor."""
    jp = jax_generators.matern_problem(n, regime)
    tp = interop.problem_from_numpy(jp.name, jp.n, jp.nb, jp.regime, jp.theta,
                                    jp.locs, jp.z, jp.cov, device="cpu")
    recs = _by_id(sweep_cholesky([tp], device="cpu")
                  + sweep_kriging([tp], device="cpu"))
    l_ref = exact_factor(tp.cov)
    ll_ref = loglik_of_factor(l_ref, tp.z)
    ref = _reference_factors(jp)
    assert len(ref) == 8 and set(ref) <= set(recs)
    for rid, (l, ll) in ref.items():
        label = rid.split("/")[2]
        atol = PARITY_ATOL.get(label, PARITY_ATOL_FP32)
        lt = torch.as_tensor(l)
        want = {"factor_rel": rel_frobenius(lt, l_ref),
                "backward_rel": backward_error(lt, tp.cov),
                "loglik_drift": loglik_drift(ll, ll_ref)}
        for name, value in want.items():
            got = recs[rid][name]
            assert abs(got - value) <= PARITY_RTOL * value + atol, (
                rid, name, got, value)
    # kriging: the reference predictor's PMSE against the port's oracle
    n_obs = jp.n - jp.nb
    p_ref = _kriging_oracle(tp)
    for label in ("full_f32", "mixed_f32bf16_t2"):
        score = float(jax_krige_pmse(
            jp.locs[:n_obs], jp.z[:n_obs], jp.locs[n_obs:], jp.z[n_obs:],
            jp.theta, JAX_POLICIES[label], nb=jp.nb, nu_static=0.5,
            jitter=1e-6))
        got = recs[f"krige/{label}/{jp.name}"]["pmse_rel"]
        want = pmse_drift(score, p_ref)
        assert abs(got - want) <= PARITY_RTOL * want + PARITY_ATOL_KRIGE, (
            label, got, want)


def _kriging_oracle(tp):
    """The port sweep's fp64 kriging reference of a problem."""
    from repro_torch.core import build_covariance
    from repro_torch.covariance.matern import matern_covariance
    n_obs = tp.n - tp.nb
    cov_oo = build_covariance(tp.locs[:n_obs], tp.theta, nu_static=0.5,
                              jitter=1e-6, dtype=torch.float32)
    sigma_no = matern_covariance(tp.locs[n_obs:], tp.locs[:n_obs],
                                 torch.tensor(tp.theta), nu_static=0.5)
    return exact_kriging_pmse(cov_oo, tp.z[:n_obs], sigma_no, tp.z[n_obs:])
