"""The port's likelihood module against the JAX `core/likelihood.py` on the
same numpy inputs (n = 128, nb = 32): make_loglik per policy on a batch of
candidate thetas, within the policy's registered loglik_drift
(repro.verify.bounds); the profiled form, DST, general nu, the covariance
build and the functions of a given factor."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrecisionPolicy as JP
from repro.core import likelihood as jlik
from repro.covariance import make_dataset as j_make_dataset
from repro.verify.bounds import policy_bound
from repro_torch.core import likelihood as tlik
from test_torch_panel import _port_policy

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)

NB = 32
N = 128
THETAS = np.array([[1.0, 0.10, 0.5], [0.7, 0.15, 0.5], [1.3, 0.05, 0.5]],
                  np.float32)
POLICIES = {
    "full": (lambda: JP.full(jnp.float32), None),
    "full_tiles": (lambda: JP.full(jnp.float32), True),
    "tpu1": (lambda: JP.tpu(1), None),
    "tpu2": (lambda: JP.tpu(2), None),
    "three_tier13": (lambda: JP.three_tier(1, 3), None),
    "dst2": (lambda: JP.dst(2), None),
}


@pytest.fixture(scope="module")
def data():
    ds = j_make_dataset(jax.random.PRNGKey(5), N, [1.0, 0.1, 0.5],
                        nu_static=0.5)
    return np.array(ds.locs), np.array(ds.z)


def _drift(got, want):
    """|ll - ll_ref| / max(1, |ll_ref|), the registry's loglik_drift."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(1.0, np.abs(want))


def _torch(data):
    return torch.from_numpy(data[0]), torch.from_numpy(data[1])


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_make_loglik_batched_matches_jax(pol, data):
    make, use_tiles = POLICIES[pol]
    jp = make()
    kw = dict(nb=NB, nu_static=0.5, use_tiles=use_tiles)
    want = np.asarray(jlik.make_loglik(jnp.asarray(data[0]), jnp.asarray(data[1]),
                                       jp, **kw)(jnp.asarray(THETAS)))
    got = tlik.make_loglik(*_torch(data), _port_policy(jp), **kw)(THETAS)
    assert got.shape == (len(THETAS),) and np.isfinite(want).all()
    # the medium-correlation bound of the policy's pair
    assert np.all(_drift(got.numpy(), want) <= policy_bound(jp).loglik_drift)
    # one candidate at a time gives the batch's values
    for b, th in enumerate(THETAS):
        one = tlik.make_loglik(*_torch(data), _port_policy(jp), **kw)(th)
        assert one.shape == () and float(one) == pytest.approx(float(got[b]),
                                                                rel=1e-5)


def test_paper_cpu_loglik_matches_jax_under_x64(data):
    with jax.enable_x64(True):
        jp = JP.paper_cpu(2)
        want = np.asarray(jlik.make_loglik(
            jnp.asarray(data[0]), jnp.asarray(data[1]), jp, nb=NB,
            nu_static=0.5)(jnp.asarray(THETAS)))
    got = tlik.make_loglik(*_torch(data), _port_policy(jp), nb=NB,
                           nu_static=0.5)(THETAS)
    assert got.dtype == torch.float64
    assert np.all(_drift(got.numpy(), want) <= policy_bound(jp).loglik_drift)


@pytest.mark.parametrize("pol", ["full", "tpu2"])
def test_profiled_loglik_matches_jax(pol, data):
    jp = POLICIES[pol][0]()
    cands = THETAS[:, 1:]                         # (theta2, theta3)
    kw = dict(nb=NB, nu_static=0.5, profiled=True)
    want = np.asarray(jlik.make_loglik(jnp.asarray(data[0]), jnp.asarray(data[1]),
                                       jp, **kw)(jnp.asarray(cands)))
    got = tlik.make_loglik(*_torch(data), _port_policy(jp), **kw)(cands)
    assert np.all(_drift(got.numpy(), want) <= policy_bound(jp).loglik_drift)
    with pytest.raises(NotImplementedError, match="profiled DST"):
        tlik.make_loglik(*_torch(data), _port_policy(JP.dst(2)), nb=NB,
                         nu_static=0.5, profiled=True)(cands)


def test_general_nu_loglik_matches_jax(data):
    # nu_static=None: nu = theta3 through the Bessel K_nu path on both sides
    thetas = np.array([[1.0, 0.08, 1.3], [0.9, 0.1, 0.8]], np.float32)
    jp = JP.tpu(2)
    want = np.asarray(jlik.make_loglik(jnp.asarray(data[0]), jnp.asarray(data[1]),
                                       jp, nb=NB)(jnp.asarray(thetas)))
    got = tlik.make_loglik(*_torch(data), _port_policy(jp), nb=NB)(thetas)
    assert np.isfinite(want).all()
    assert np.all(_drift(got.numpy(), want) <= policy_bound(jp).loglik_drift)


@pytest.mark.parametrize("nu_static,nugget,jitter,dtype", [
    (0.5, 0.0, 1e-6, None), (1.5, 0.05, 1e-6, "float32"),
    (2.5, 0.0, 0.0, "float32"), (None, 0.02, 1e-6, None)])
def test_build_covariance_matches_jax(nu_static, nugget, jitter, dtype, data):
    thetas = THETAS.copy()
    thetas[:, 2] = 1.3 if nu_static is None else nu_static
    kw = dict(nu_static=nu_static, nugget=nugget, jitter=jitter)
    want = np.asarray(jlik.build_covariance(
        jnp.asarray(data[0]), jnp.asarray(thetas), dtype=dtype, **kw))
    got = tlik.build_covariance(torch.from_numpy(data[0]), thetas,
                                dtype=None if dtype is None else torch.float32,
                                **kw)
    assert got.shape == want.shape == (3, N, N) and got.dtype == torch.float32
    # exp (and the Bessel series) differ by a few fp32 ulp between the two
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_functions_of_a_factor_match_jax(data):
    cov = jlik.build_covariance(jnp.asarray(data[0]), jnp.asarray(THETAS),
                                nu_static=0.5, jitter=1e-6)
    l = np.array(jnp.linalg.cholesky(cov))
    z = data[1]
    lt, zt = torch.from_numpy(l), torch.from_numpy(z)
    np.testing.assert_allclose(tlik.loglik_from_factor(lt, zt).numpy(),
                               np.asarray(jlik.loglik_from_factor(l, z)),
                               rtol=1e-6)
    ll, t1 = tlik.profiled_loglik_from_factor(lt, zt)
    ll_j, t1_j = jlik.profiled_loglik_from_factor(l, z)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=1e-6)
    np.testing.assert_allclose(t1.numpy(), np.asarray(t1_j), rtol=1e-5)
    blocks_j = [(slice(0, 64), l[:, :64, :64]), (slice(64, N), l[:, 64:, 64:])]
    blocks = [(sl, torch.from_numpy(np.ascontiguousarray(b)))
              for sl, b in blocks_j]
    np.testing.assert_allclose(tlik.dst_loglik(blocks, zt).numpy(),
                               np.asarray(jlik.dst_loglik(blocks_j, z)),
                               rtol=1e-6)


@pytest.mark.parametrize("pol", ["tpu2", "full"])
def test_not_positive_definite_gives_nan_in_both(pol, data):
    # a jitter of -2 on a unit-variance covariance: not positive definite
    jp = POLICIES[pol][0]()
    kw = dict(nb=NB, nu_static=0.5, jitter=-2.0)
    want = float(jlik.make_loglik(jnp.asarray(data[0]), jnp.asarray(data[1]),
                                  jp, **kw)(jnp.asarray(THETAS[0])))
    got = float(tlik.make_loglik(*_torch(data), _port_policy(jp), **kw)(THETAS[0]))
    assert np.isnan(want) and np.isnan(got)


@functools.lru_cache(maxsize=None)
def _fits(data_bytes):
    """Nelder-Mead on both likelihoods (full fp32 and tpu(2)) from one
    start: the fitted thetas and log-likelihoods."""
    from repro.core import fit_mle as j_fit
    from repro_torch.core import fit_mle
    locs = np.frombuffer(data_bytes[0], np.float32).reshape(-1, 2)
    z = np.frombuffer(data_bytes[1], np.float32)
    out = {}
    for name in ("full", "tpu2"):
        jp = POLICIES[name][0]()
        jl = jlik.make_loglik(jnp.asarray(locs), jnp.asarray(z), jp, nb=NB,
                              nu_static=0.5)
        tl = tlik.make_loglik(torch.tensor(locs), torch.tensor(z),
                              _port_policy(jp), nb=NB, nu_static=0.5)
        out[name] = (
            j_fit(lambda th: jl(jnp.concatenate([th, jnp.array([0.5])])),
                  [0.8, 0.08], max_iters=40),
            fit_mle(lambda th: tl([th[0], th[1], 0.5]), [0.8, 0.08],
                    max_iters=40))
    return out


@pytest.mark.parametrize("pol", ["full", "tpu2"])
def test_fit_mle_on_make_loglik_lands_near_jax(pol, data):
    want, got = _fits((data[0].tobytes(), data[1].tobytes()))[pol]
    # the two likelihoods differ by fp32 (and bf16-flip) noise, so the
    # simplex paths may part near the optimum: theta within 5%, loglik within
    # the policy's drift
    np.testing.assert_allclose(got.theta, want.theta, rtol=0.05)
    jp = POLICIES[pol][0]()
    assert _drift(got.loglik, want.loglik) <= policy_bound(jp).loglik_drift
