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
    r = torch.ones(4)
    with pytest.raises(NotImplementedError, match="general-nu"):
        tmat.matern(r, [1.0, 0.1, 1.3], nu_static=None)
    locs = torch.from_numpy(_locs(4, 64))
    with pytest.raises(NotImplementedError, match="general-nu"):
        build_banded_covariance(locs, [1.0, 0.1, 1.3], nb=32,
                                policy=PrecisionPolicy.tpu(1))
    with pytest.raises(NotImplementedError, match="general-nu"):
        geostat_loglik_step(locs, torch.zeros(64), [1.0, 0.1, 1.3], nb=32,
                            policy=PrecisionPolicy.tpu(1), nu_static=None)


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
