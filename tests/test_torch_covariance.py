"""Covariance modules of the PyTorch port against the JAX reference:
distances, half-integer Matern, orderings and the data generator."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.covariance import generator as jgen
from repro.covariance import ordering as jord
from repro_torch.core import PrecisionPolicy, geostat_loglik_step
from repro_torch.core.panel_cholesky import build_banded_covariance
from repro_torch.covariance import generator as tgen
from repro_torch.covariance import ordering as tord

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)

# the packages re-export the function `matern`, which shadows the module
jmat = importlib.import_module("repro.covariance.matern")
tmat = importlib.import_module("repro_torch.covariance.matern")


def _locs(seed, n, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (shift + scale * rng.uniform(size=(n, 2))).astype(np.float32)


@pytest.mark.parametrize("metric,scale,shift", [
    ("euclidean", 1.0, 0.0), ("haversine", 15.0, 30.0)])
def test_pairwise_distance_matches_reference(metric, scale, shift):
    a, b = _locs(0, 64, scale, shift), _locs(1, 48, scale, shift)
    want = np.asarray(jmat.pairwise_distance(jnp.asarray(a), jnp.asarray(b),
                                             metric=metric))
    got = tmat.pairwise_distance(torch.from_numpy(a), torch.from_numpy(b),
                                 metric=metric).numpy()
    if metric == "euclidean":
        # the same operations, but XLA may contract dx*dx + dy*dy into one
        # FMA: one fp32 ulp (2^-23 relative) before the sqrt halves it
        np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)
    else:
        # sin/cos/arcsin implementations differ by a few fp32 ulp
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_batched_theta_matches_reference(nu):
    r = np.abs(np.random.default_rng(2).standard_normal((7, 9))).astype(np.float32)
    r[0, 0] = 0.0
    theta = np.array([[1.0, 0.1, nu], [2.0, 0.3, nu], [0.5, 0.03, nu]],
                     np.float32)
    want = np.asarray(jmat.matern(jnp.asarray(r), jnp.asarray(theta),
                                  nu_static=nu))
    got = tmat.matern(torch.from_numpy(r), torch.from_numpy(theta),
                      nu_static=nu).numpy()
    assert got.shape == want.shape == (3, 7, 9)
    # exp implementations differ by a few ulp; everything else is IEEE
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-30)


@pytest.mark.parametrize("nugget", [0.0, 0.1])
def test_matern_covariance_matches_reference(nugget):
    a = _locs(3, 40)
    theta = np.array([[1.3, 0.12, 0.5], [0.7, 0.2, 0.5]], np.float32)
    want = np.asarray(jmat.matern_covariance(
        jnp.asarray(a), jnp.asarray(a), jnp.asarray(theta), nu_static=0.5,
        nugget=nugget))
    got = tmat.matern_covariance(torch.from_numpy(a), torch.from_numpy(a),
                                 torch.from_numpy(theta), nu_static=0.5,
                                 nugget=nugget).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


def test_general_nu_raises():
    # general nu has no closed form: the CUDA kernel's wrapper refuses it
    # (before any build), and the public functions send it to the plain
    # Bessel path instead, on either device
    from repro_torch.kernels.matern_cov import matern_cov as mc_kernel
    from repro_torch.kernels.matern_cov import ops as mc_ops
    locs = torch.from_numpy(_locs(4, 64)).reshape(2, 32, 2)
    with pytest.raises(NotImplementedError, match="no closed form"):
        mc_kernel.launch(locs, locs, [1.0, 0.1], nu=1.3,
                         out=torch.empty((2, 32, 32)), outer=False)
    got = mc_ops.matern_cov(locs[0], locs[1], [1.0, 0.1], nu=1.3)
    want = tmat.matern_covariance(locs[0], locs[1],
                                  torch.tensor([1.0, 0.1, 1.3]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# the general-nu cases: the paper's real-data smoothnesses (Table I: 1.119
# to 1.417, 1.27 is wind region R2) and the half-integers; x spans both
# sides of 2, where the Temme series hands over to CF2
KV_NUS = [0.5, 1.5, 2.5, 1.1, 1.4, 1.27]
KV_X = np.concatenate([np.geomspace(1e-3, 2.0, 40),
                       np.geomspace(2.0001, 60.0, 40)])


@pytest.mark.parametrize("nu", KV_NUS)
def test_kv_f64_matches_jax_under_x64_and_scipy(nu):
    import scipy.special
    got = tmat.kv(torch.tensor(nu, dtype=torch.float64),
                  torch.from_numpy(KV_X)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jmat.kv(jnp.asarray(nu, jnp.float64),
                                  jnp.asarray(KV_X)))
    assert want.dtype == np.float64 and got.dtype == np.float64
    # the same fp64 operations in the same order: a few ulp
    np.testing.assert_allclose(got, want, rtol=1e-14)
    # Numerical Recipes' bessik against scipy's: 1e-12 (measured 4e-14)
    np.testing.assert_allclose(got, scipy.special.kv(nu, KV_X), rtol=1e-12)


@pytest.mark.parametrize("nu", KV_NUS)
def test_kv_f32_matches_jax(nu):
    x = KV_X.astype(np.float32)
    got = tmat.kv(nu, torch.from_numpy(x)).numpy()
    want = np.asarray(jmat.kv(nu, jnp.asarray(x)))
    assert got.dtype == np.float32
    # fp32 exp/log/sinh differ by an ulp between the libraries; the series
    # carry it over ~100 steps (measured 7e-7)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_kv_cf2_freeze_prevents_fp32_overflow(monkeypatch):
    import types
    nu = 1.27
    x = torch.tensor([2.5, 5.0, 20.0, 50.0])
    mu = torch.tensor(nu - 1.0)
    frozen = tmat._kv_cf2(mu, x)
    # the same loop without the freeze (torch.where keeps the new state):
    # run past convergence, fp32 q1/q2 underflow and the sum turns NaN
    no_freeze = types.SimpleNamespace(**{
        k: getattr(torch, k) for k in dir(torch) if not k.startswith("__")})
    no_freeze.where = lambda cond, old, new: new
    monkeypatch.setattr(tmat, "torch", no_freeze)
    unfrozen = tmat._kv_cf2(mu, x)
    monkeypatch.undo()
    assert bool(torch.isnan(unfrozen[0]).all())
    assert all(bool(torch.isfinite(v).all()) for v in frozen)
    import scipy.special
    np.testing.assert_allclose(tmat.kv(nu, x).numpy(),
                               scipy.special.kv(nu, x.numpy()), rtol=1e-5)


@pytest.mark.parametrize("metric,scale,shift", [
    ("euclidean", 1.0, 0.0), ("haversine", 15.0, 30.0)])
def test_matern_general_nu_matches_reference(metric, scale, shift):
    # batched theta with per-candidate nu, and r == 0 on the diagonal
    a = _locs(9, 48, scale, shift)
    theta = np.array([[1.0, 0.1 * scale, 1.27], [12.533, 0.3 * scale, 1.1],
                      [0.5, 0.05 * scale, 2.5]], np.float32)
    want = np.asarray(jmat.matern_covariance(jnp.asarray(a), jnp.asarray(a),
                                             jnp.asarray(theta), metric=metric))
    got = tmat.matern_covariance(torch.from_numpy(a), torch.from_numpy(a),
                                 torch.from_numpy(theta), metric=metric).numpy()
    assert got.shape == want.shape == (3, 48, 48)
    # fp32 lgamma/log/exp and the Bessel series, a few ulp apart
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_general_nu_covariance_f32_against_f64():
    # the bound chip_smoke.py phase 8.6 holds the card's fp32 general-nu
    # haversine covariance to: max relative error 1e-4 against fp64
    a = torch.from_numpy(_locs(10, 256, 15.0, 45.0))
    theta = torch.tensor(tgen.WIND_REGIONS["R2"])
    got = tmat.matern_covariance(a, a, theta, metric="haversine").double()
    want = tmat.matern_covariance(a.double(), a.double(), theta.double(),
                                  metric="haversine")
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-4


def test_panel_build_with_general_nu_matches_reference():
    from repro.core import PrecisionPolicy as JP
    from repro.core import panel_cholesky as jpc
    locs = _locs(11, 64)
    theta = [1.0, 0.1, 1.3]
    band_j, off_j = jpc.build_banded_covariance(
        jnp.asarray(locs), jnp.asarray(theta), nb=32, policy=JP.tpu(1))
    band, off = build_banded_covariance(torch.from_numpy(locs), theta, nb=32,
                                        policy=PrecisionPolicy.tpu(1))
    np.testing.assert_allclose(band.numpy(), np.asarray(band_j), rtol=1e-4,
                               atol=1e-6)
    # off-band values round to bf16: within one bf16 ulp
    np.testing.assert_allclose(off.float().numpy(),
                               np.asarray(off_j, np.float32), rtol=2 ** -7)
    ll = geostat_loglik_step(torch.from_numpy(locs), torch.zeros(64), theta,
                             nb=32, policy=PrecisionPolicy.tpu(1))
    assert bool(torch.isfinite(ll))


def test_wind_like_dataset_shape_and_metric():
    ds = tgen.wind_like_dataset(torch.Generator().manual_seed(5), "R2", 256)
    assert ds.locs.shape == (256, 2) and ds.z.shape == (256,)
    assert ds.metric == "haversine" and ds.locs.dtype == torch.float32
    np.testing.assert_allclose(ds.theta0.numpy(),
                               np.asarray(jgen.WIND_REGIONS["R2"]), rtol=1e-7)
    lon, lat = ds.locs[:, 0].numpy(), ds.locs[:, 1].numpy()
    assert lon.min() > 45.0 and lon.max() < 60.0
    assert lat.min() > 22.5 and lat.max() < 35.0
    assert bool(torch.isfinite(ds.z).all()) and float(ds.z.std()) > 0.5
    # Morton order on the box-normalized coordinates, as the reference
    unit = (ds.locs - ds.locs.min(0).values) / (
        ds.locs.max(0).values - ds.locs.min(0).values)
    assert np.all(np.diff(tord.morton_key(unit).numpy()) >= 0)
    for region, theta in jgen.WIND_REGIONS.items():
        np.testing.assert_allclose(tgen.WIND_REGIONS[region],
                                   np.asarray(theta), rtol=1e-7)


@pytest.mark.parametrize("name", ["morton", "hilbert", "none"])
@pytest.mark.parametrize("seed,n", [(5, 500), (6, 256), (7, 1)])
def test_orderings_identical(name, seed, n):
    locs = _locs(seed, n)
    want = np.asarray(jord.ORDERINGS[name](jnp.asarray(locs)))
    got = tord.ORDERINGS[name](torch.from_numpy(locs)).numpy()
    np.testing.assert_array_equal(got, want)
    z = np.arange(n, dtype=np.float32)
    jl, jz = jord.apply_ordering(locs, z, want)
    tl, tz = tord.apply_ordering(torch.from_numpy(locs), torch.from_numpy(z),
                                 torch.from_numpy(got))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_morton_keys_identical_on_duplicates_and_edges():
    locs = np.array([[0.0, 0.0], [0.999999, 0.999999], [0.5, 0.5],
                     [0.5, 0.5], [0.25, 0.75]], np.float32)
    want = np.asarray(jord.morton_key(jnp.asarray(locs))).astype(np.int64)
    got = tord.morton_key(torch.from_numpy(locs)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [100, 256])
def test_random_locations_perturbed_grid(n):
    gen = torch.Generator().manual_seed(0)
    locs = tgen.random_locations(gen, n).numpy()
    ref = np.asarray(jgen.random_locations(jax.random.PRNGKey(0), n))
    assert locs.shape == ref.shape == (n, 2) and locs.dtype == ref.dtype
    m = int(np.ceil(np.sqrt(n)))
    xs, ys = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    centre = (np.stack([xs.ravel(), ys.ravel()], -1)[:n] + 0.5) / m
    # the jitter is uniform in +-0.4 cells around each grid centre, as in
    # the reference (the random bits differ)
    for pts in (locs, ref):
        assert np.all(np.abs(pts - centre) <= 0.4 / m + 1e-6)
        assert np.all((pts > 0.0) & (pts < 1.0))


def test_simulate_field_matches_reference_on_shared_noise(monkeypatch):
    # 48-row chunks: 128 rows end in a partial chunk
    monkeypatch.setattr(tgen, "ROWS_PER_CHUNK", 48)
    locs = _locs(8, 128)
    theta0 = [1.0, 0.1, 0.5]
    gen = torch.Generator().manual_seed(11)
    z = tgen.simulate_field(gen, torch.from_numpy(locs), theta0,
                            nu_static=0.5).numpy()
    eps = torch.randn((128,), generator=torch.Generator().manual_seed(11)).numpy()
    cov = jmat.matern_covariance(jnp.asarray(locs), jnp.asarray(locs),
                                 jnp.asarray(theta0), nu_static=0.5)
    chol = jnp.linalg.cholesky(cov + 1e-8 * jnp.eye(128))
    want = np.asarray(chol @ jnp.asarray(eps))
    # two fp32 Cholesky factorizations of the same matrix
    np.testing.assert_allclose(z, want, rtol=1e-3, atol=1e-3)


def test_make_dataset_is_ordered_and_seeded():
    ds1 = tgen.make_dataset(torch.Generator().manual_seed(3), 256,
                            tgen.CORRELATION_LEVELS["medium"], nu_static=0.5)
    ds2 = tgen.make_dataset(torch.Generator().manual_seed(3), 256,
                            tgen.CORRELATION_LEVELS["medium"], nu_static=0.5)
    np.testing.assert_array_equal(ds1.z.numpy(), ds2.z.numpy())
    keys = tord.morton_key(ds1.locs).numpy()
    assert np.all(np.diff(keys) >= 0)
    assert ds1.metric == "euclidean" and ds1.z.shape == (256,)


def test_correlation_levels_match_reference():
    for name, theta in jgen.CORRELATION_LEVELS.items():
        np.testing.assert_allclose(tgen.CORRELATION_LEVELS[name],
                                   np.asarray(theta), rtol=1e-7)
