"""The paper's {fp64 band, fp32 off-band} pair and full fp64 on fp64 inputs:
the port against the JAX package under x64 on the same numpy data (n = 256,
nb = 32, p = 8).  Sigma is built in fp64 with theta in fp64 for fp64
locations, and the panel engine factors an fp64 band's diagonal tiles in
fp64, so full(fp64) agrees with the reference to fp64 rounding.  The pair's
own drift is that of its fp32 off-band: two fp32 GEMMs that sum the same
products in another order move the log-likelihood by ~2e-8 here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BatchEngine as JBatchEngine
from repro.core import BatchPlan as JBatchPlan
from repro.core import PrecisionPolicy as JP
from repro.core import kriging as jkr
from repro.core import likelihood as jlik
from repro.core import panel_cholesky as jpc
from repro.kernels.mp_gemm.ops import mp_syrk as j_syrk
from repro_torch.core import BatchEngine, BatchPlan, PrecisionPolicy
from repro_torch.core import kriging as tkr
from repro_torch.core import likelihood as tlik
from repro_torch.core import panel_cholesky as tpc
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.matern_cov import matern_cov as matern_kernel
from repro_torch.kernels.matern_cov import ref as matern_ref
from repro_torch.kernels.mp_gemm import mp_gemm as syrk_kernel
from repro_torch.kernels.mp_gemm import ref as syrk_ref
from test_torch_panel import _port_policy

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)

N, NB = 256, 32
THETAS = np.array([[1.0, 0.10, 0.5], [0.7, 0.15, 0.5], [1.3, 0.05, 0.5]])
# (JAX policy, use_tiles): full(fp64) dense and tiled, and the paper pair
# with its band over every tile (p = 8), which is fp64 everywhere
FP64 = {
    "full": (lambda: JP.full(jnp.float64), None),
    "full_tiles": (lambda: JP.full(jnp.float64), True),
    "paper_cpu8": (lambda: JP.paper_cpu(8), None),
}
FP64_REL = 1e-10
# paper_cpu(2) against the reference: 4.9e-8 measured, the sum of the two
# engines' distances from correctly rounded fp32 off-band sums (2.2e-8 and
# 2.7e-8, test_paper_pair_floor_is_its_fp32_off_band_sums), each held to
# PAPER2_FLOOR_REL there
PAPER2_FLOOR_REL = 5e-8
PAPER2_LOGLIK_REL = 2 * PAPER2_FLOOR_REL


@pytest.fixture(scope="module")
def data():
    """fp64 locations on the unit square in strips (tiles stay local), a
    field drawn at theta0 = (1, 0.1, 0.5) in fp64; every 9th point held
    out: (locs, z, locs_new, z_new)."""
    rng = np.random.default_rng(16)
    locs = rng.uniform(size=(N + 32, 2))
    strip = np.floor(locs[:, 0] * 4)
    key = strip * 10 + np.where(strip % 2, -locs[:, 1], locs[:, 1])
    locs = locs[np.argsort(key)]
    d = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1))
    cov = np.exp(-d / 0.1) + 1e-6 * np.eye(len(locs))
    z = np.linalg.cholesky(cov) @ rng.standard_normal(len(locs))
    obs = np.arange(len(locs)) % 9 != 8
    return locs[obs][:N], z[obs][:N], locs[~obs], z[~obs]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


@functools.lru_cache(maxsize=None)
def _jax_loglik(pol, locs_bytes, z_bytes):
    make, use_tiles = FP64[pol] if pol in FP64 else (
        lambda: JP.paper_cpu(2), None)
    with jax.enable_x64(True):
        locs = jnp.asarray(np.frombuffer(locs_bytes).reshape(-1, 2))
        z = jnp.asarray(np.frombuffer(z_bytes))
        fn = jlik.make_loglik(locs, z, make(), nb=NB, nu_static=0.5,
                              use_tiles=use_tiles)
        return np.asarray(fn(jnp.asarray(THETAS)))


def _jax(pol, data):
    return _jax_loglik(pol, data[0].tobytes(), data[1].tobytes())


# ------------------------------ likelihood -------------------------------

@pytest.mark.parametrize("pol", sorted(FP64))
def test_fp64_loglik_matches_jax_to_fp64_rounding(pol, data):
    make, use_tiles = FP64[pol]
    got = tlik.make_loglik(*_t(*data[:2]), _port_policy(make()), nb=NB,
                           nu_static=0.5, use_tiles=use_tiles)(THETAS)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), _jax(pol, data)) <= FP64_REL


def test_paper_pair_loglik_matches_jax(data):
    got = tlik.make_loglik(*_t(*data[:2]), PrecisionPolicy.paper_cpu(2),
                           nb=NB, nu_static=0.5)(THETAS)
    want = _jax("paper_cpu2", data)
    assert np.isfinite(want).all()
    assert _rel(got.numpy(), want) <= PAPER2_LOGLIK_REL
    # the pair is not fp64: it sits away from full(fp64)
    assert _rel(got.numpy(), _jax("full", data)) > 1e-9


def test_paper_pair_band_factor_matches_jax_to_fp64_rounding(data):
    """The pair's tile path in fp64 where it is fp64: the band of the
    factor's first tile column is factored and solved from Sigma in fp64
    before any fp32 off-band update reaches it, so it agrees with the
    reference under x64 to fp64 rounding (4.4e-16 measured); its off-band
    tiles are fp32 solves."""
    t = 2
    locs = data[0]
    with jax.enable_x64(True):
        want = np.asarray(jlik.make_factor_fn(
            jnp.asarray(locs), JP.paper_cpu(t), nb=NB, nu_static=0.5)(
                jnp.asarray(THETAS[0])))
    got = tlik.make_factor_fn(*_t(locs), PrecisionPolicy.paper_cpu(t),
                              nb=NB, nu_static=0.5)(THETAS[0])
    assert got.dtype == torch.float64
    err = np.abs(got.numpy()[:, :NB] - want[:, :NB])
    assert err[:t * NB].max() <= 1e-14
    assert err[t * NB:].max() <= 1e-6


def _correctly_rounded_syrk(p, *, tile, round_k, band_blocks, hi, lo, accum):
    """The plain SYRK with each fp32 off-band element replaced by the fp64
    sum of its fp32 operands' products rounded once to fp32."""
    out = syrk_ref.mp_syrk(p, tile=tile, round_k=round_k,
                           band_blocks=band_blocks, hi=hi, lo=lo, accum=accum)
    p_lo = p.to(lo).to(torch.float64)
    tiles = torch.arange(p.shape[0]) // tile
    in_band = (tiles[:, None] - tiles[None, :]).abs() < band_blocks
    return torch.where(in_band, out, (p_lo @ p_lo.T).to(lo).to(hi))


def test_paper_pair_floor_is_its_fp32_off_band_sums(data, monkeypatch):
    """What PAPER2_LOGLIK_REL rests on: the port and the reference each sit
    about 2e-8 (2.2e-8 and 2.7e-8 measured) from the same tile engine with
    correctly rounded fp32 off-band sums, so no fp64 repair brings the two
    closer than that; a bound 10x under 1.9e-8 cannot hold here."""
    locs, z = _t(*data[:2])
    pol = PrecisionPolicy.paper_cpu(2)
    port = tlik.make_loglik(locs, z, pol, nb=NB, nu_static=0.5)(THETAS)
    matern, potrf, _ = tpc._IMPLS["kernel"]
    monkeypatch.setitem(tpc._IMPLS, "kernel",
                        (matern, potrf, _correctly_rounded_syrk))
    rounded = tlik.make_loglik(locs, z, pol, nb=NB, nu_static=0.5)(THETAS)
    rounded, port = rounded.numpy(), port.numpy()
    want = _jax("paper_cpu2", data)
    for side in (port, want):
        assert 1.9e-9 < _rel(side, rounded) <= PAPER2_FLOOR_REL


def test_sigma_is_fp64_with_fp64_theta(data):
    """Sigma of fp64 locations is computed in fp64 from theta in fp64
    (theta2 = 0.1 is not an fp32 number), as the reference under x64."""
    locs = data[0][:64]
    with jax.enable_x64(True):
        want = np.asarray(jlik.build_covariance(
            jnp.asarray(locs), jnp.asarray(THETAS[0]), nu_static=0.5,
            jitter=1e-6))
    got = tlik.build_covariance(*_t(locs), THETAS[0], nu_static=0.5,
                                jitter=1e-6)
    assert got.dtype == torch.float64
    assert np.max(np.abs(got.numpy() - want)) <= 1e-15
    # fp32 locations keep fp32 theta and an fp32 Sigma
    got32 = tlik.build_covariance(torch.from_numpy(locs.astype(np.float32)),
                                  THETAS[0], nu_static=0.5)
    assert got32.dtype == torch.float32


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_fp64_matern_plain_version_matches_jax_under_x64(nu, data):
    locs = data[0]
    th = [1.3, 0.07]
    with jax.enable_x64(True):
        want = np.asarray(jlik.build_covariance(
            jnp.asarray(locs[:96]), jnp.asarray([th[0], th[1], nu]),
            nu_static=nu))
    got = matern_ref.matern_cov(*_t(locs[:96], locs[:96]), th, nu=nu,
                                out_dtype=torch.float64)
    assert got.dtype == torch.float64
    assert np.max(np.abs(got.numpy() - want)) <= 1e-13 * th[0]
    # the zip form and the lower form in fp64, tile by tile
    tiles = torch.from_numpy(locs[:96]).reshape(3, 32, 2)
    low = matern_ref.matern_cov_lower(tiles, th, nu=nu, min_lag=1,
                                      out_dtype=torch.float64)
    np.testing.assert_allclose(low[2, 0].numpy(), want[64:96, :32],
                               rtol=0, atol=1e-13 * th[0])
    # the panel path's off-band: computed in fp64, rounded once to fp32
    low32 = matern_ref.matern_cov_lower(tiles, th, nu=nu, min_lag=1,
                                        out_dtype=torch.float32)
    np.testing.assert_array_equal(low32[2, 0].numpy(),
                                  want[64:96, :32].astype(np.float32))


# ------------------------------- kriging ---------------------------------

@pytest.mark.parametrize("pol,mu_tol,var_tol", [
    ("full", 1e-12, 1e-12), ("full_tiles", 1e-12, 1e-12),
    # the pair's fp32 off-band: 2.4e-7 and 2.1e-8 measured
    ("paper_cpu2", 1e-6, 1e-7)])
def test_krige_on_fp64_locations_matches_jax(pol, mu_tol, var_tol, data):
    make, use_tiles = FP64.get(pol, (lambda: JP.paper_cpu(2), None))
    jp = make()
    locs, z, new, _ = data
    kw = dict(nb=NB, nu_static=0.5, use_tiles=use_tiles, return_var=True)
    with jax.enable_x64(True):
        want_mu, want_var = jkr.krige(jnp.asarray(locs), jnp.asarray(z),
                                      jnp.asarray(new), jnp.asarray(THETAS),
                                      jp, **kw)
    mu, var = tkr.krige(*_t(locs, z, new), THETAS, _port_policy(jp), **kw)
    assert mu.dtype == var.dtype == torch.float64
    assert mu.shape == (len(THETAS), len(new))
    assert np.max(np.abs(mu.numpy() - np.asarray(want_mu))) <= mu_tol
    assert np.max(np.abs(var.numpy() - np.asarray(want_var))) <= var_tol


@pytest.mark.parametrize("pol", ["full", "paper_cpu2"])
def test_batch_engine_on_fp64_locations_matches_jax(pol, data):
    make = FP64[pol][0] if pol in FP64 else (lambda: JP.paper_cpu(2))
    jp = make()
    locs, z = data[:2]
    with jax.enable_x64(True):
        want = np.asarray(JBatchEngine(
            jnp.asarray(locs), jnp.asarray(z),
            JBatchPlan(policy=jp, nb=NB, nu_static=0.5)).loglik(
                jnp.asarray(THETAS[:, :2])))
    engine = BatchEngine(*_t(locs, z), BatchPlan(
        policy=_port_policy(jp), nb=NB, nu_static=0.5, chunk_size=1))
    assert engine._prepare(THETAS[:, :2]).dtype == torch.float64
    got = engine.loglik(THETAS[:, :2])
    assert got.dtype == torch.float64
    tol = FP64_REL if pol == "full" else PAPER2_LOGLIK_REL
    assert _rel(got.numpy(), want) <= tol
    np.testing.assert_allclose(engine.loglik_sequential(THETAS[:, :2]),
                               got.numpy(), rtol=1e-12)


# ------------------------------ panel engine -----------------------------

@pytest.mark.parametrize("off_update", ["square", "chunked"])
@pytest.mark.parametrize("t", [2, 8])
def test_panel_paper_pair_matches_jax(t, off_update, data):
    """geostat_loglik_step under paper_cpu(t): 9.8e-10 measured at t = 2;
    t = 8 is fp64 everywhere."""
    locs, z = data[:2]
    with jax.enable_x64(True):
        want = float(jpc.geostat_loglik_step(
            jnp.asarray(locs), jnp.asarray(z), jnp.asarray(THETAS[0]), nb=NB,
            policy=JP.paper_cpu(t), nu_static=0.5))
    got = tpc.geostat_loglik_step(*_t(locs, z), THETAS[0], nb=NB,
                                  policy=PrecisionPolicy.paper_cpu(t),
                                  nu_static=0.5, off_update=off_update)
    assert got.dtype == torch.float64
    assert _rel(float(got), want) <= (2e-9 if t == 2 else FP64_REL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_panel_factors_an_fp64_band_in_fp64(impl, data):
    """The first diagonal factor of the paper pair is the fp64 Cholesky of
    Sigma's first tile, and the fp64 band launches no blocked_potrf."""
    locs = torch.from_numpy(data[0])
    pol = PrecisionPolicy.paper_cpu(2)
    band, off = tpc.build_banded_covariance(locs, THETAS[0], nb=NB,
                                            policy=pol, nu_static=0.5)
    assert band.dtype == torch.float64 and off.dtype == torch.float32
    a00 = band[0, 0].clone()
    reset_launch_counts()
    band, off, failed = tpc.panel_cholesky_banded(band, off, pol, impl=impl)
    assert not bool(failed)
    want = np.linalg.cholesky(a00.numpy())
    assert np.max(np.abs(band[0, 0].numpy() - want)) <= 1e-13
    assert launch_counts()["blocked_potrf"] == 0


def test_panel_flags_an_indefinite_fp64_band(data):
    locs = torch.from_numpy(data[0])
    pol = PrecisionPolicy.paper_cpu(2)
    band, off = tpc.build_banded_covariance(locs, THETAS[0], nb=NB,
                                            policy=pol, nu_static=0.5)
    band[3, 0].diagonal().sub_(10.0)
    band, off, failed = tpc.panel_cholesky_banded(band, off, pol)
    assert bool(failed) and torch.isnan(band[3, 0]).all()
    ll = tpc.banded_loglik(band, off, torch.from_numpy(data[1]), 2, failed)
    assert torch.isnan(ll)


# -------------------------------- mp_syrk --------------------------------

@pytest.mark.parametrize("m,k,tile,round_k,band", [
    (256, 128, 64, 64, 1), (256, 128, 64, 64, 2), (128, 256, 64, 128, 1),
    (256, 64, 128, 64, 4)])
def test_fp64_pair_syrk_plain_version_matches_jax_kernel(m, k, tile, round_k,
                                                         band):
    """ref.mp_syrk(hi=fp64, lo=fp32, accum=fp32) against the Pallas kernel
    (interpret mode) with hi fp64, lo fp32 and an fp64 accumulator: the band
    to fp64 rounding, the off-band within two fp32 ulps of each rounded
    partial sum plus the fp32 summation bound of each."""
    rng = np.random.default_rng(m + k + band)
    p = rng.standard_normal((m, k))
    with jax.enable_x64(True):
        want = np.asarray(j_syrk(jnp.asarray(p), band_blocks=band, bm=tile,
                                 bk=round_k, hi_dtype=jnp.float64,
                                 lo_dtype=jnp.float32,
                                 accum_dtype=jnp.float64))
    got = syrk_ref.mp_syrk(torch.from_numpy(p), tile=tile, round_k=round_k,
                           band_blocks=band, hi=torch.float64,
                           lo=torch.float32, accum=torch.float32)
    assert got.dtype == torch.float64 and torch.equal(got, got.T)
    got = got.numpy()
    tiles = np.arange(m) // tile
    in_band = np.abs(tiles[:, None] - tiles[None, :]) < band
    err = np.abs(got - want)
    assert err[in_band].max() <= 1e-12 * np.abs(want[in_band]).max()
    if (~in_band).any():
        p32 = p.astype(np.float32).astype(np.float64)
        gamma = round_k * 2.0 ** -24 / (1 - round_k * 2.0 ** -24)
        bound = np.zeros((m, m))
        for k0 in range(0, k, round_k):
            pc = p32[:, k0:k0 + round_k]
            nrm = np.linalg.norm(pc, axis=1)
            part = np.abs(pc @ pc.T)
            bound += 2 * np.spacing(part.astype(np.float32)) \
                + 2 * gamma * np.outer(nrm, nrm)
        assert np.all(err[~in_band] <= bound[~in_band])
        off = got[~in_band]
        assert 0 < np.abs(off - (p @ p.T)[~in_band]).max()


def test_fp64_pair_syrk_is_fp64_band_and_fp32_off_band():
    p = torch.randn((256, 64), generator=torch.Generator().manual_seed(16),
                    dtype=torch.float64)
    out = syrk_ref.mp_syrk(p, tile=64, round_k=64, band_blocks=1,
                           hi=torch.float64, lo=torch.float32,
                           accum=torch.float32)
    exact = p @ p.T
    for i in range(4):
        sl = slice(i * 64, (i + 1) * 64)
        torch.testing.assert_close(out[sl, sl], exact[sl, sl], rtol=1e-14,
                                   atol=1e-13)
    off = out[:64, 64:]
    assert torch.equal(off, off.float().double())   # fp32 values
    assert (off - exact[:64, 64:]).abs().max() > 1e-9


@pytest.mark.parametrize("hi,lo,accum", [
    (torch.float64, torch.bfloat16, torch.float32),
    (torch.float64, torch.float32, torch.float64),
    (torch.float32, torch.float64, torch.float64),
    (torch.float16, torch.float16, torch.float32)])
def test_syrk_wrapper_names_the_pairs_it_does_not_take(hi, lo, accum):
    reset_launch_counts()
    with pytest.raises(NotImplementedError, match=r"\(hi, lo, accum\)"):
        syrk_kernel.launch(torch.ones((128, 64), dtype=hi), tile=64,
                           round_k=64, band_blocks=1, hi=hi, lo=lo,
                           accum=accum)
    assert launch_counts()["mp_syrk"] == 0


@pytest.mark.parametrize("pair", [
    (torch.float64, torch.float32, torch.float32),
    (torch.float64, torch.float64, torch.float64)])
def test_syrk_wrapper_takes_the_fp64_pairs_on_cuda_tensors_only(pair):
    hi, lo, accum = pair
    kw = dict(tile=64, round_k=64, band_blocks=1, hi=hi, lo=lo, accum=accum)
    with pytest.raises(ValueError, match="CUDA"):
        syrk_kernel.launch(torch.ones((128, 64), dtype=torch.float64), **kw)
    with pytest.raises(ValueError, match="float64 CUDA"):    # p not in hi
        syrk_kernel.launch(torch.ones((128, 64)), **kw)
    assert syrk_kernel.block(1024) == 128
    assert syrk_kernel.block(64) == 64


# ------------------------------- matern_cov ------------------------------

@pytest.mark.parametrize("locs_dtype,out_dtype", [
    (torch.float32, torch.float64), (torch.float64, torch.bfloat16),
    (torch.float64, torch.float16)])
def test_matern_wrapper_refuses_mixed_dtypes(locs_dtype, out_dtype):
    locs = torch.rand((2, 32, 2), dtype=locs_dtype)
    out = torch.empty((2, 32, 32), dtype=out_dtype)
    reset_launch_counts()
    with pytest.raises(ValueError, match="fp64 locations with fp64 or fp32"):
        matern_kernel.launch(locs, locs, [1.0, 0.1], nu=0.5, out=out,
                             outer=False)
    # mixed location dtypes too
    with pytest.raises(ValueError, match="locations"):
        matern_kernel.launch(locs, locs.double() if locs_dtype ==
                             torch.float32 else locs.float(), [1.0, 0.1],
                             nu=0.5, out=out, outer=False)
    assert launch_counts()["matern_cov"] == 0
