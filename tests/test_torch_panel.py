"""The slice as a whole: the port's panel engine and MLE driver against the
JAX panel engine, at the JAX fixtures' size (n = 256, nb = 32, p = 8), for
full(f32), tpu(1), tpu(2) and tpu(4) with both off-band updates."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrecisionPolicy as JP
from repro.core import fit_mle as j_fit_mle
from repro.core import panel_cholesky as jpc
from repro_torch import interop
from repro_torch.core import fit_mle
from repro_torch.core import panel_cholesky as tpc

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)

NB = 32
THETA = [1.0, 0.1, 0.5]
POLICIES = {
    "full": lambda: JP.full(jnp.float32),
    "tpu1": lambda: JP.tpu(1),
    "tpu2": lambda: JP.tpu(2),
    "tpu4": lambda: JP.tpu(4),
}
CASES = [(pol, upd) for pol in POLICIES for upd in ("square", "chunked")]


def _port_policy(jp):
    name = lambda dt: None if dt is None else jnp.dtype(dt).name
    return interop.policy_from_fields(
        jp.mode, name(jp.hi), name(jp.lo), jp.diag_thick, lo2=name(jp.lo2),
        diag_thick2=jp.diag_thick2, solve_dtype=name(jp.solve_dtype),
        accum_dtype=name(jp.accum_dtype))


@pytest.fixture(scope="module")
def data(small_dataset):
    return np.array(small_dataset.locs), np.array(small_dataset.z)


@functools.lru_cache(maxsize=None)
def _jax_run(pol, off_update, locs_bytes, z_bytes):
    """The JAX engine on one case: storage before and after the factor,
    the dense factor, the forward solve and the log-likelihood."""
    jp = POLICIES[pol]()
    locs = jnp.asarray(np.frombuffer(locs_bytes, np.float32).reshape(-1, 2))
    z = jnp.asarray(np.frombuffer(z_bytes, np.float32))
    t = min(jp.diag_thick, locs.shape[0] // NB)

    @jax.jit
    def run(locs, z, theta):
        band, off = jpc.build_banded_covariance(locs, theta, nb=NB, policy=jp,
                                                nu_static=0.5)
        band_f, off_f = jpc.panel_cholesky_banded(band, off, jp,
                                                  off_update=off_update)
        return (band, off, band_f, off_f,
                jpc.assemble_from_banded(band_f, off_f, t),
                jpc.banded_forward_solve(band_f, off_f, z, t),
                jpc.banded_loglik(band_f, off_f, z, t))
    out = run(locs, z, jnp.asarray(THETA))
    return jp, t, [np.array(o, np.float32) for o in out]


def _case(pol, off_update, data):
    locs, z = data
    return _jax_run(pol, off_update, locs.tobytes(), z.tobytes())


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_build_banded_covariance_matches_jax(pol, data):
    jp, _, (band, off, *_) = _case(pol, "square", data)
    tb, to = tpc.build_banded_covariance(torch.from_numpy(data[0]), THETA,
                                         nb=NB, policy=_port_policy(jp),
                                         nu_static=0.5)
    assert tb.shape == band.shape and to.shape == off.shape
    # same IEEE arithmetic except exp and XLA's FMA contraction: fp32 ulps;
    # off-band values then round to lo, which can flip by one bf16 ulp
    np.testing.assert_allclose(tb.numpy(), band, rtol=1e-5, atol=1e-7)
    got = to.float().numpy()
    lo_ulp = np.ldexp(1.0, np.frexp(np.abs(off))[1] - 8)
    assert np.all(np.abs(got - off) <= (lo_ulp if jp.mode == "mixed" else
                                        1e-5 * np.abs(off) + 1e-7))


@pytest.mark.parametrize("pol,off_update", CASES)
def test_factor_matches_jax(pol, off_update, data):
    jp, t, (band, off, _, _, l_jax, _, _) = _case(pol, off_update, data)
    tp = _port_policy(jp)
    tb, to = interop.banded_from_numpy(band, off, lo=tp.lo, device="cpu")
    tb, to, failed = tpc.panel_cholesky_banded(tb, to, tp,
                                               off_update=off_update)
    assert not bool(failed)
    l_port = tpc.assemble_from_banded(tb, to, t).numpy()
    # the bound test_panel_cholesky.py holds the panel engine to
    np.testing.assert_allclose(l_port, l_jax, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("pol,off_update", CASES)
def test_forward_solve_and_loglik_match_jax(pol, off_update, data):
    jp, t, (_, _, band_f, off_f, _, w_jax, ll_jax) = _case(pol, off_update, data)
    tb, to = interop.banded_from_numpy(band_f, off_f,
                                       lo=_port_policy(jp).lo, device="cpu")
    z = torch.from_numpy(data[1])
    w = tpc.banded_forward_solve(tb, to, z, t).numpy()
    # one factor, two fp32 triangular solves
    np.testing.assert_allclose(w, w_jax, rtol=1e-4, atol=1e-4)
    ll = float(tpc.banded_loglik(tb, to, z, t))
    assert abs(ll - float(ll_jax)) <= 1e-5 * abs(float(ll_jax))


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("pol,off_update", CASES)
def test_geostat_loglik_step_matches_jax(pol, off_update, impl, data):
    jp, _, outs = _case(pol, off_update, data)
    ll = float(tpc.geostat_loglik_step(
        torch.from_numpy(data[0]), torch.from_numpy(data[1]), THETA, nb=NB,
        policy=_port_policy(jp), nu_static=0.5, off_update=off_update,
        impl=impl))
    ll_jax = float(outs[-1])
    # the slice's acceptance bound: 1e-3 |ll|
    assert abs(ll - ll_jax) <= 1e-3 * abs(ll_jax)


@pytest.mark.parametrize("off_update", ["square", "chunked"])
def test_non_spd_gives_nan_in_both(off_update, data):
    # a negative jitter of -2 on a unit-variance covariance: not SPD
    locs, z = data
    jp = JP.tpu(2)
    ll_jax = float(jax.jit(functools.partial(
        jpc.geostat_loglik_step, nb=NB, policy=jp, nu_static=0.5,
        jitter=-2.0, off_update=off_update))(
            jnp.asarray(locs), jnp.asarray(z), jnp.asarray(THETA)))
    tp = _port_policy(jp)
    band, off = tpc.build_banded_covariance(torch.from_numpy(locs), THETA,
                                            nb=NB, policy=tp, nu_static=0.5,
                                            jitter=-2.0)
    band, off, failed = tpc.panel_cholesky_banded(band, off, tp,
                                                  off_update=off_update)
    ll = float(tpc.banded_loglik(band, off, torch.from_numpy(z), 2, failed))
    assert np.isnan(ll_jax) and np.isnan(ll) and bool(failed)


def test_fit_mle_lands_near_jax(data):
    locs, z = data
    jp = JP.tpu(2)
    tp = _port_policy(jp)
    j_ll = lambda th: jpc.geostat_loglik_step(
        jnp.asarray(locs), jnp.asarray(z),
        jnp.concatenate([th, jnp.array([0.5])]), nb=NB, policy=jp,
        nu_static=0.5)
    t_ll = lambda th: tpc.geostat_loglik_step(
        torch.from_numpy(locs), torch.from_numpy(z), [th[0], th[1], 0.5],
        nb=NB, policy=tp, nu_static=0.5)
    want = j_fit_mle(j_ll, [0.8, 0.08], max_iters=40)
    got = fit_mle(t_ll, [0.8, 0.08], max_iters=40)
    assert np.all(np.isfinite(got.theta)) and np.isfinite(got.loglik)
    # the two likelihoods differ by fp32 noise, so the simplex paths may
    # part near the optimum: theta within 5%, loglik within 1e-3 |ll|
    np.testing.assert_allclose(got.theta, want.theta, rtol=0.05)
    assert abs(got.loglik - want.loglik) <= 1e-3 * abs(want.loglik)
