"""The port's kriging module against the JAX `core/kriging.py` on the same
numpy inputs (n = 256, nb = 32, the dataset of tests/test_mle_kriging.py):
krige (mean and variance, batched theta) and kfold_pmse within the
policy's registered pmse_rel (repro.verify.bounds); the reference tests'
properties (interpolation, 0 <= var <= theta1, MP PMSE near DP); and the
quickstart pipeline's gate."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrecisionPolicy as JP
from repro.core import fit_mle as j_fit_mle
from repro.core import kriging as jkr
from repro.core import make_loglik as j_make_loglik
from repro.covariance import make_dataset as j_make_dataset
from repro.verify.bounds import policy_bound
from repro_torch import quickstart
from repro_torch.core import PrecisionPolicy
from repro_torch.core import kriging as tkr
from test_torch_panel import _port_policy

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)

NB = 32
THETAS = np.array([[1.0, 0.10, 0.5], [0.8, 0.14, 0.5]], np.float32)
POLICIES = {
    "full": lambda: JP.full(jnp.float32),
    "tpu2": lambda: JP.tpu(2),
    "dst2": lambda: JP.dst(2),
}
OBS, NEW = slice(0, 224), slice(224, None)


@pytest.fixture(scope="module")
def med_ds():
    ds = j_make_dataset(jax.random.PRNGKey(3), 256, [1.0, 0.1, 0.5],
                        nu_static=0.5)
    return np.array(ds.locs), np.array(ds.z)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pmse_rel(jp):
    # DST predicts densely in hi precision: the full pair's bound
    return policy_bound(jp if jp.mode != "dst" else JP.full(jnp.float32)).pmse_rel


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_krige_mean_and_variance_match_jax(pol, med_ds):
    jp = POLICIES[pol]()
    locs, z = med_ds
    kw = dict(nb=NB, nu_static=0.5, return_var=True)
    mu_j, var_j = jkr.krige(jnp.asarray(locs[OBS]), jnp.asarray(z[OBS]),
                            jnp.asarray(locs[NEW]), jnp.asarray(THETAS), jp, **kw)
    mu, var = tkr.krige(*_t(locs[OBS], z[OBS], locs[NEW]), THETAS,
                        _port_policy(jp), **kw)
    mu_j, var_j = np.asarray(mu_j), np.asarray(var_j)
    assert mu.shape == var.shape == mu_j.shape == (2, 32)
    rel = _pmse_rel(jp)
    p_j = np.asarray(jkr.pmse(mu_j, z[NEW]))
    p = tkr.pmse(mu, torch.from_numpy(z[NEW])).numpy()
    assert np.all(np.abs(p - p_j) <= rel * p_j)
    # the mean and the variance at that same relative scale
    assert np.abs(mu.numpy() - mu_j).max() <= rel * np.abs(mu_j).max()
    assert np.abs(var.numpy() - var_j).max() <= rel * THETAS[:, 0].max()


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_kfold_pmse_matches_jax(pol, med_ds):
    jp = POLICIES[pol]()
    if jp.mode == "dst":                  # as examples/geostat_mle.py does
        jp = JP.full(jnp.float32)
    locs, z = med_ds
    theta = THETAS[0]
    want, folds_j = jkr.kfold_pmse(jnp.asarray(locs), jnp.asarray(z),
                                   jnp.asarray(theta), jp, k=4, nb=NB,
                                   nu_static=0.5)
    got, folds = tkr.kfold_pmse(*_t(locs, z), theta, _port_policy(jp), k=4,
                                nb=NB, nu_static=0.5)
    assert len(folds) == len(folds_j) == 4
    # the same default_rng(0) folds: fold by fold within pmse_rel
    rel = _pmse_rel(jp)
    np.testing.assert_allclose(folds, folds_j, rtol=rel)
    assert got == pytest.approx(want, rel=rel)


def test_krige_pmse_and_nugget_on_sigma_oo_only(med_ds):
    locs, z = med_ds
    jp = JP.tpu(2)
    kw = dict(nb=NB, nu_static=0.5, nugget=0.05)
    want = np.asarray(jkr.krige_pmse(*(jnp.asarray(a) for a in (
        locs[OBS], z[OBS], locs[NEW], z[NEW])), jnp.asarray(THETAS), jp, **kw))
    got = tkr.krige_pmse(*_t(locs[OBS], z[OBS], locs[NEW], z[NEW]), THETAS,
                         _port_policy(jp), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=_pmse_rel(jp))


def test_krige_interpolates_at_observed_points(med_ds):
    locs, z = med_ds
    mu = tkr.krige(*_t(locs[OBS], z[OBS], locs[:16]), [1.0, 0.1, 0.5],
                   PrecisionPolicy.full(torch.float32), nb=NB, nu_static=0.5,
                   jitter=1e-6)
    # tests/test_mle_kriging.py's tolerance
    np.testing.assert_allclose(mu.numpy(), z[:16], rtol=0.05, atol=0.02)


def test_krige_variance_positive_and_bounded(med_ds):
    locs, z = med_ds
    _, var = tkr.krige(*_t(locs[OBS], z[OBS], locs[NEW]), [1.0, 0.1, 0.5],
                       PrecisionPolicy.full(torch.float32), nb=NB,
                       nu_static=0.5, return_var=True)
    v = var.numpy()
    # bounded by the prior variance theta1, tests/test_mle_kriging.py's slack
    assert np.all(v > -1e-4) and np.all(v < 1.0 + 1e-4)


def test_mp_pmse_close_to_dp(med_ds):
    """Paper Fig. 8: mixed-precision PMSE ~ DP PMSE (rel 0.2, as the
    reference's test)."""
    locs, z = _t(*med_ds)
    theta = [1.0, 0.1, 0.5]
    dp, _ = tkr.kfold_pmse(locs, z, theta, PrecisionPolicy.full(torch.float32),
                           k=4, nb=NB, nu_static=0.5)
    mp, _ = tkr.kfold_pmse(locs, z, theta, PrecisionPolicy.tpu(2), k=4, nb=NB,
                           nu_static=0.5)
    assert mp == pytest.approx(dp, rel=0.2)


@functools.lru_cache(maxsize=None)
def _quickstart_jax():
    """examples/quickstart.py's steps on the JAX side: its dataset, theta-hat
    and held-out PMSE."""
    n, nb = quickstart.N, NB
    ds = j_make_dataset(jax.random.PRNGKey(0), n, theta0=[1.0, 0.1, 0.5],
                        nu_static=0.5, ordering="morton")
    new = np.arange(7, n, 8)
    obs = np.setdiff1d(np.arange(n), new)[:224]
    policy = JP.tpu(diag_thick=2)
    loglik = j_make_loglik(ds.locs[obs], ds.z[obs], policy, nb=nb,
                           nu_static=0.5)
    res = j_fit_mle(lambda th: loglik(jnp.concatenate([th, jnp.array([0.5])])),
                    theta0=[0.7, 0.15], max_iters=60)
    theta_hat = jnp.array([res.theta[0], res.theta[1], 0.5])
    mu = jkr.krige(ds.locs[obs], ds.z[obs], ds.locs[new], theta_hat, policy,
                   nb=nb, nu_static=0.5)
    return (np.array(ds.locs), np.array(ds.z), res.theta,
            float(jkr.pmse(mu, ds.z[new])))


def test_quickstart_pipeline_lands_on_the_jax_run():
    """The gate: the port's quickstart pipeline on the JAX dataset's numpy
    locations and field (N = 256, nb = 32, tpu(2), nu = 0.5) lands on the
    JAX run's theta-hat within rtol 0.05 and its held-out PMSE within rtol
    0.1.  Both Nelder-Mead runs stop on a likelihood surface that bf16
    rounding makes rough at the 1e-4 level, so theta-hat is held at the
    MLE tolerance, not at fp32 noise."""
    locs, z, theta_j, pmse_j = _quickstart_jax()
    res, mu, var, score = quickstart.pipeline(*_t(locs, z), nb=NB)
    np.testing.assert_allclose(res.theta, theta_j, rtol=0.05)
    assert score == pytest.approx(pmse_j, rel=0.1)
    assert mu.shape == var.shape == (32,) and bool(torch.isfinite(var).all())


def test_entry_points_refuse_a_card_tile_that_is_not_a_multiple_of_64():
    assert quickstart.resolve_nb(None, "cpu") == 32
    assert quickstart.resolve_nb(None, "cuda") == 64
    assert quickstart.resolve_nb(48, "cpu") == 48
    assert quickstart.resolve_nb(128, "cuda:0") == 128
    with pytest.raises(SystemExit, match="multiple of 64"):
        quickstart.resolve_nb(32, "cuda")
