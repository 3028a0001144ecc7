"""The port's batch engine (core/batch_engine.py) and fit_mle_grid against
the JAX engine on the same numpy inputs (n = 128, nb = 32, the dataset
and candidates of tests/test_batch_engine.py): batched equals sequential
per precision mode, chunking with padding, batched kriging PMSE, the fused
evaluation, best_index's NaN rules, the plan refusals and the grid
search."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BatchEngine as JEngine
from repro.core import BatchPlan as JPlan
from repro.core import PrecisionPolicy as JP
from repro.core import fit_mle_grid as j_fit_mle_grid
from repro.covariance import make_dataset as j_make_dataset
from repro.verify.bounds import policy_bound
from repro_torch.core import (BatchEngine, BatchPlan, BatchResult,
                              PrecisionPolicy, chunked, evaluate_batch,
                              fit_mle, fit_mle_grid, krige, pmse)
from test_torch_panel import _port_policy

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)

NB = 32
N = 128
THETAS = np.array([[1.0, 0.10, 0.5], [0.7, 0.15, 0.5], [1.3, 0.05, 0.5],
                   [0.9, 0.20, 0.5], [1.1, 0.12, 0.5]], np.float32)
# tests/test_batch_engine.py's modes and batched-vs-sequential tolerances
MODES = {
    "full": (lambda: JP.full(jnp.float32), 1e-6),
    "mixed_bf16": (lambda: JP.tpu(2), 1e-5),
    "mixed_fp32": (lambda: JP(mode="mixed", hi=jnp.float32, lo=jnp.float32,
                              diag_thick=2), 1e-6),
    "dst": (lambda: JP.dst(2), 1e-6),
    "three_tier": (lambda: JP.three_tier(1, 2), 1e-4),
}
OBS, NEW = slice(0, 96), slice(96, None)


@pytest.fixture(scope="module")
def ds():
    d = j_make_dataset(jax.random.PRNGKey(5), N, [1.0, 0.1, 0.5],
                       nu_static=0.5)
    return np.array(d.locs), np.array(d.z)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _drift(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(1.0, np.abs(want))


@functools.lru_cache(maxsize=None)
def _jax_logliks(mode, path, locs_bytes, z_bytes):
    locs = jnp.asarray(np.frombuffer(locs_bytes, np.float32).reshape(-1, 2))
    z = jnp.asarray(np.frombuffer(z_bytes, np.float32))
    engine = JEngine(locs, z, JPlan(policy=MODES[mode][0](), nb=NB,
                                    nu_static=0.5, path=path))
    return np.asarray(engine.loglik(jnp.asarray(THETAS)), np.float64)


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_loglik_equals_sequential_and_jax(ds, mode):
    make, rtol = MODES[mode]
    jp = make()
    engine = BatchEngine(*_t(*ds), BatchPlan(policy=_port_policy(jp), nb=NB,
                                             nu_static=0.5))
    ll_bat = engine.loglik(THETAS)
    assert isinstance(ll_bat, torch.Tensor) and ll_bat.shape == (5,)
    ll_seq = engine.loglik_sequential(THETAS)
    np.testing.assert_allclose(ll_bat.numpy(), ll_seq, rtol=rtol)
    want = _jax_logliks(mode, "tile", ds[0].tobytes(), ds[1].tobytes())
    # three_tier(1, 2)'s fp8 far field has no registered bound at t2 = 2:
    # its pair's bound
    assert np.all(_drift(ll_bat.numpy(), want) <= policy_bound(jp).loglik_drift)


def test_panel_path_equals_sequential_and_jax(ds):
    jp = JP.tpu(2)
    engine = BatchEngine(*_t(*ds), BatchPlan(policy=_port_policy(jp), nb=NB,
                                             nu_static=0.5, path="panel"))
    ll_bat = engine.loglik(THETAS).numpy()
    np.testing.assert_allclose(ll_bat, engine.loglik_sequential(THETAS),
                               rtol=1e-5)
    want = _jax_logliks("mixed_bf16", "panel", ds[0].tobytes(), ds[1].tobytes())
    assert np.all(_drift(ll_bat, want) <= policy_bound(jp).loglik_drift)


def test_chunked_equals_unchunked_with_padding(ds):
    # B = 5 with chunk_size = 2 pads 5 -> 6 and runs three chunks
    pol = PrecisionPolicy.full(torch.float32)
    ll = BatchEngine(*_t(*ds), BatchPlan(policy=pol, nb=NB, nu_static=0.5)
                     ).loglik(THETAS)
    ll_c = BatchEngine(*_t(*ds), BatchPlan(policy=pol, nb=NB, nu_static=0.5,
                                           chunk_size=2)).loglik(THETAS)
    assert ll_c.shape == (5,)
    np.testing.assert_allclose(ll_c.numpy(), ll.numpy(), rtol=1e-6)


@pytest.mark.parametrize("b", [1, 3, 5, 7])
@pytest.mark.parametrize("chunk_size", [2, 4])
def test_chunked_helper_bitwise_identical(b, chunk_size):
    def fn(x):  # batched, non-elementwise: mixes the trailing axes
        return torch.einsum("bij,bkj->bik", x, x) + torch.sin(x)

    def fn2(x):  # a tuple of outputs, as the fused evaluation returns
        return fn(x), x.sum(dim=(1, 2))

    x = torch.randn((b, 8, 8), generator=torch.Generator().manual_seed(b))
    np.testing.assert_array_equal(chunked(fn, chunk_size)(x).numpy(),
                                  fn(x).numpy())
    got = chunked(fn2, chunk_size)(x)
    assert isinstance(got, tuple) and got[1].shape == (b,)
    for g, w in zip(got, fn2(x)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert chunked(fn, None) is fn


@pytest.mark.parametrize("mode", ["full", "mixed_bf16", "dst"])
def test_batched_kriging_pmse_matches_per_candidate_and_jax(ds, mode):
    jp = MODES[mode][0]()
    locs, z = ds
    engine = BatchEngine(*_t(locs[OBS], z[OBS]),
                         BatchPlan(policy=_port_policy(jp), nb=NB,
                                   nu_static=0.5),
                         locs_new=torch.from_numpy(locs[NEW]),
                         y_true=torch.from_numpy(z[NEW]))
    scores = engine.krige_pmse(THETAS).numpy()
    pred = _port_policy(jp if jp.mode != "dst" else JP.full(jnp.float32))
    for b in range(len(THETAS)):
        mu = krige(*_t(locs[OBS], z[OBS], locs[NEW]), THETAS[b], pred, nb=NB,
                   nu_static=0.5)
        # tests/test_batch_engine.py's bound
        assert scores[b] == pytest.approx(
            float(pmse(mu, torch.from_numpy(z[NEW]))), rel=1e-4)
    j_engine = JEngine(jnp.asarray(locs[OBS]), jnp.asarray(z[OBS]),
                       JPlan(policy=jp, nb=NB, nu_static=0.5),
                       locs_new=jnp.asarray(locs[NEW]),
                       y_true=jnp.asarray(z[NEW]))
    want = np.asarray(j_engine.krige_pmse(jnp.asarray(THETAS)))
    rel = policy_bound(jp if jp.mode != "dst" else JP.full(jnp.float32)).pmse_rel
    np.testing.assert_allclose(scores, want, rtol=rel)


@pytest.mark.parametrize("nugget", [0.0, 0.05])
def test_fused_evaluate_matches_separate_programs(ds, nugget):
    locs, z = ds
    engine = BatchEngine(*_t(locs[OBS], z[OBS]),
                         BatchPlan(policy=PrecisionPolicy.tpu(2), nb=NB,
                                   nu_static=0.5, nugget=nugget),
                         locs_new=torch.from_numpy(locs[NEW]),
                         y_true=torch.from_numpy(z[NEW]))
    assert engine._eval_batch is not None
    res = engine.evaluate(THETAS)
    np.testing.assert_allclose(res.logliks, engine.loglik(THETAS).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(res.pmse, engine.krige_pmse(THETAS).numpy(),
                               rtol=1e-4)
    # evaluate_batch: the one-shot wrapper, dense policy (two programs)
    res = evaluate_batch(*_t(locs[OBS], z[OBS]), THETAS,
                         BatchPlan(policy=PrecisionPolicy.full(torch.float32),
                                   nb=NB, nu_static=0.5),
                         locs_new=torch.from_numpy(locs[NEW]),
                         y_true=torch.from_numpy(z[NEW]))
    assert res.logliks.shape == res.pmse.shape == (5,)
    assert res.best_index == int(np.argmax(res.logliks))
    np.testing.assert_array_equal(res.best_theta, res.thetas[res.best_index])


def test_two_column_thetas_equal_pinned_nu_column(ds):
    engine = BatchEngine(*_t(*ds), BatchPlan(
        policy=PrecisionPolicy.full(torch.float32), nb=NB, nu_static=0.5))
    np.testing.assert_array_equal(engine.loglik(THETAS[:, :2]).numpy(),
                                  engine.loglik(THETAS).numpy())


def test_best_index_nan_rules():
    # NaN candidates (non-SPD covariances) never win, -inf never wins, and
    # ties resolve to the FIRST maximal finite index
    res = BatchResult(thetas=THETAS,
                      logliks=np.array([np.nan, -3.0, 2.5, -np.inf, 2.5]))
    assert res.best_index == 2 and res.best_loglik == 2.5
    np.testing.assert_array_equal(res.best_theta, THETAS[2])
    res2 = BatchResult(thetas=THETAS,
                       logliks=np.array([np.nan, 7.0, 2.5, 1.0, 2.5]))
    assert res2.best_index == 1
    res3 = BatchResult(thetas=THETAS, logliks=np.full(5, np.nan))
    with pytest.raises(ValueError, match="non-finite"):
        _ = res3.best_theta


def test_bad_plans_rejected(ds):
    full = PrecisionPolicy.full(torch.float32)
    tpu = PrecisionPolicy.tpu(2)
    for kw in (dict(policy=full, path="warp"),
               dict(policy=PrecisionPolicy.dst(2), path="panel"),
               dict(policy=full, chunk_size=0),
               dict(policy=tpu, path="panel", nugget=0.05),
               dict(policy=tpu, path="panel", profiled=True),
               dict(policy=tpu, path="panel", use_tiles=True)):
        with pytest.raises(ValueError):
            BatchPlan(**kw)
    locs, z = _t(*ds)
    with pytest.raises(ValueError, match="profiled"):
        BatchEngine(locs[:96], z[:96], BatchPlan(policy=full, nb=NB,
                                                 nu_static=0.5, profiled=True),
                    locs_new=locs[96:], y_true=z[96:])
    with pytest.raises(ValueError, match="y_true"):
        BatchEngine(locs[:96], z[:96], BatchPlan(policy=full, nb=NB),
                    locs_new=locs[96:])
    with pytest.raises(ValueError, match="locs_new"):
        BatchEngine(locs, z, BatchPlan(policy=full, nb=NB)).krige_pmse(THETAS)


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_grid_search_stays_inside_bounds(impl):
    # the surrogate's optimum (theta = (10, 1)) lies OUTSIDE the bounds;
    # refinement clamps so the returned theta respects the box
    def f(ths):
        x = np.log(np.asarray(ths, np.float64))
        return -(x[:, 0] - np.log(10.0)) ** 2 - x[:, 1] ** 2

    fit = j_fit_mle_grid if impl == "jax" else fit_mle_grid
    res = fit(f, [(0.2, 5.0), (0.02, 0.6)], num=5, refine=4)
    assert 0.2 <= res.theta[0] <= 5.0 and 0.02 <= res.theta[1] <= 0.6
    assert res.theta[0] == pytest.approx(5.0, rel=0.05)
    assert res.theta[1] == pytest.approx(0.6, rel=0.05)
    assert res.n_evals == 4 * 25 and len(res.history) == 4


def test_grid_search_raises_when_every_candidate_is_non_finite():
    def bad(ths):
        return torch.full((len(ths),), torch.nan)
    with pytest.raises(ValueError, match="non-finite"):
        fit_mle_grid(bad, [(0.2, 5.0), (0.02, 0.6)], num=3, refine=2)
    with pytest.raises(ValueError, match="bounds"):
        fit_mle_grid(bad, [(0.0, 5.0)], num=3, refine=2)


def test_grid_search_and_polish_on_the_engine_match_jax(ds):
    locs, z = ds
    bounds = [(0.2, 5.0), (0.02, 0.6)]
    engine = BatchEngine(*_t(locs, z), BatchPlan(
        policy=PrecisionPolicy.full(torch.float32), nb=NB, nu_static=0.5))
    j_engine = JEngine(jnp.asarray(locs), jnp.asarray(z),
                       JPlan(policy=JP.full(jnp.float32), nb=NB, nu_static=0.5))
    got = fit_mle_grid(engine.loglik, bounds, num=4, refine=2)
    want = j_fit_mle_grid(j_engine.loglik, bounds, num=4, refine=2)
    assert got.n_evals == want.n_evals == 32
    # the same grid points: the same incumbent unless two candidates tie to
    # fp32 noise, so theta within the grid spacing and loglik within 1e-5
    np.testing.assert_allclose(got.theta, want.theta, rtol=1e-6)
    assert got.loglik == pytest.approx(want.loglik, rel=1e-5)
    # the batched Nelder-Mead polish from there, engine values as tensors
    res = fit_mle(None, got.theta, max_iters=30, batched_loglik_fn=engine.loglik)
    assert np.isfinite(res.loglik) and res.loglik >= got.loglik
