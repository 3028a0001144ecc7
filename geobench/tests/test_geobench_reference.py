"""The plain reference against numpy in fp64 at small n, its blocks made
small so that every blocked path runs."""

import math

import numpy as np
import pytest
import torch

from geobench import data
from geobench.reference import gaussian, mixed


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(gaussian, "BLOCK", 48)


def field(n, seed=3, theta0=(1.0, 0.1, 0.5)):
    locs, z = data.make(seed, dict(n=n, theta0=theta0, nu=theta0[2],
                                   field_jitter=1e-8), "cpu")
    return locs.double(), z.double()


def numpy_sigma(locs, theta, nu, jitter):
    x = locs.numpy()
    r = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)) / theta[1]
    f = {0.5: np.exp(-r), 1.5: (1 + r) * np.exp(-r),
         2.5: (1 + r + r * r / 3) * np.exp(-r)}[nu]
    return theta[0] * f + jitter * np.eye(len(x)), r


def numpy_loglik(locs, z, theta, nu, jitter):
    s, _ = numpy_sigma(locs, theta, nu, jitter)
    sign, logdet = np.linalg.slogdet(s)
    assert sign > 0
    zz = z.numpy()
    return -0.5 * len(zz) * math.log(2 * math.pi) - 0.5 * logdet \
        - 0.5 * zz @ np.linalg.solve(s, zz)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
@pytest.mark.parametrize("n", [100, 144])
def test_loglik_matches_numpy(n, nu):
    locs, z = field(n)
    theta = [1.1, 0.08, nu]
    got, scale = gaussian.loglik(locs, z, theta, nu=nu, jitter=1e-6)
    want = numpy_loglik(locs, z, theta, nu, 1e-6)
    assert got == pytest.approx(want, rel=1e-10)
    # the scale: the three terms' magnitudes, no cancellation among them
    s, _ = numpy_sigma(locs, theta, nu, 1e-6)
    logs = 2 * np.log(np.diag(np.linalg.cholesky(s)))
    quad = z.numpy() @ np.linalg.solve(s, z.numpy())
    assert scale == pytest.approx(0.5 * n * math.log(2 * math.pi)
                                  + 0.5 * np.abs(logs).sum() + 0.5 * quad,
                                  rel=1e-10)
    assert scale >= abs(got)


def test_blocked_factor_matches_numpy():
    locs, _ = field(150)
    s, _ = numpy_sigma(locs, [1.0, 0.1], 0.5, 1e-6)
    a = torch.from_numpy(s.copy())
    assert gaussian.cholesky_(a)
    want = np.linalg.cholesky(s)
    np.testing.assert_allclose(np.tril(a.numpy()), want, rtol=0, atol=1e-12)


def test_not_positive_definite_is_nan():
    locs, z = field(64)
    assert all(map(math.isnan, gaussian.loglik(
        locs, z, [-1.0, 0.1, 0.5], nu=0.5, jitter=1e-6)))
    assert all(map(math.isnan, mixed.loglik(
        locs, z, [-1.0, 0.1, 0.5], nu=0.5, jitter=1e-6, nb=16, t=2,
        lo=torch.bfloat16)))


def test_lower_precision_is_farther():
    """The control's arithmetic: the same reference in fp32 leaves fp64's."""
    locs, z = field(256, theta0=(1.0, 0.03, 0.5))
    theta = [1.0, 0.03, 0.5]
    want, _ = gaussian.loglik(locs, z, theta, nu=0.5, jitter=1e-6)
    got, _ = gaussian.loglik(locs.float(), z.float(), theta, nu=0.5,
                             jitter=1e-6, dtype=torch.float32)
    assert 0 < abs(got - want)


@pytest.mark.parametrize("nb,t", [(16, 2), (24, 3), (32, 8)])
def test_tile_algorithm_without_rounding_is_the_dense_one(nb, t):
    # lo = fp64 keeps every value: l and the first t nb observations' l
    # are the dense reference's, the latter of those observations alone
    locs, z = field(96)
    theta = [1.1, 0.08, 0.5]
    kw = dict(nu=0.5, jitter=1e-6)
    got = mixed.loglik(locs, z, theta, nb=nb, t=t, lo=torch.float64, **kw)
    assert got[:2] == pytest.approx(gaussian.loglik(locs, z, theta, **kw),
                                    rel=1e-12)
    m = min(t * nb, 96)
    assert got[2:] == pytest.approx(
        gaussian.loglik(locs[:m], z[:m], theta, **kw), rel=1e-12)


def test_tile_algorithm_keeps_the_off_band_in_lo():
    locs, _ = field(96)
    nb, t = 16, 2
    a = gaussian.covariance(locs, [1.0, 0.1, 0.5], 0.5, 1e-6, torch.float64)
    plain = a.clone()
    assert gaussian.cholesky_(plain)
    assert mixed.factor_(a, nb=nb, t=t, lo=torch.bfloat16)
    for i in range(96 // nb):
        for j in range(i + 1):
            tile = a[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
            if i - j >= t:     # off-band: bf16 numbers
                assert torch.equal(tile, tile.to(torch.bfloat16).double())
    # the first t tile rows are the band's alone: the plain factor's
    m = t * nb
    torch.testing.assert_close(a[:m, :m].tril(), plain[:m, :m].tril(),
                               rtol=0, atol=1e-13)
    # below them, the rounding shows
    assert (a[m:].tril(m) - plain[m:].tril(m)).abs().max() > 1e-5
