"""The port's kernel packages on the CPU: each plain version (ref.py)
against the JAX kernel (ops.py, Pallas in interpret mode) and the JAX
ref.py, on the shapes of tests/test_kernels.py; ops.py on a CPU tensor is
the plain version and launches nothing; the kernel wrappers refuse what
is not a CUDA tensor instead of falling back."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import spd_matrix
from repro.covariance import random_locations
from repro.kernels.blocked_potrf.ops import potrf as j_potrf
from repro.kernels.blocked_potrf.ref import potrf_ref as j_potrf_ref
from repro.kernels.matern_cov.ops import matern_cov as j_matern
from repro.kernels.matern_cov.ref import matern_cov_ref as j_matern_ref
from repro.kernels.mp_gemm.ops import mp_syrk as j_syrk
from repro.kernels.mp_gemm.ref import mp_syrk_ref as j_syrk_ref
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels.blocked_potrf import blocked_potrf as potrf_kernel
from repro_torch.kernels.blocked_potrf import ops as potrf_ops
from repro_torch.kernels.blocked_potrf import ref as potrf_ref
from repro_torch.kernels.matern_cov import matern_cov as matern_kernel
from repro_torch.kernels.mp_attention import mp_attention as attn_kernel
from repro_torch.kernels.matern_cov import ops as matern_ops
from repro_torch.kernels.matern_cov import ref as matern_ref
from repro_torch.kernels.mp_gemm import mp_gemm as syrk_kernel
from repro_torch.kernels.mp_gemm import ops as syrk_ops
from repro_torch.kernels.mp_gemm import ref as syrk_ref

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(np.asarray(x, np.float64)))
    return np.ldexp(1.0, e - 8)


# ----------------------------- matern_cov -----------------------------

@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
@pytest.mark.parametrize("m,n,bm,bn", [(128, 128, 64, 64), (256, 128, 128, 128),
                                       (64, 192, 32, 64)])
def test_matern_cov_ref_matches_jax(nu, m, n, bm, bn):
    la = np.array(random_locations(jax.random.PRNGKey(0), m))
    lb = np.array(random_locations(jax.random.PRNGKey(1), n))
    theta = jnp.array([1.3, 0.12, nu])
    got = matern_ref.matern_cov(torch.from_numpy(la), torch.from_numpy(lb),
                                [1.3, 0.12], nu=nu).numpy()
    # the JAX ref computes distances as the port does (direct differences):
    # only exp and an FMA contraction differ, a few fp32 ulp
    want_ref = np.asarray(j_matern_ref(la, lb, theta, nu=nu))
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-7)
    # the Pallas kernel uses |x|^2 + |y|^2 - 2 x.y: near-coincident points
    # lose ~1e-4 relative to cancellation (same bound as test_kernels.py)
    want_kernel = np.asarray(j_matern(la, lb, theta, nu=nu, bm=bm, bn=bn))
    np.testing.assert_allclose(got, want_kernel, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("nu", [0.5, 2.5])
def test_matern_cov_bf16_within_one_ulp_of_jax(nu):
    la = np.array(random_locations(jax.random.PRNGKey(2), 128))
    theta = jnp.array([1.0, 0.1, nu])
    got = matern_ref.matern_cov(torch.from_numpy(la), torch.from_numpy(la),
                                [1.0, 0.1], nu=nu, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(j_matern_ref(la, la, theta, nu=nu,
                                   out_dtype=jnp.bfloat16), np.float32)
    # both round an fp32 value that differs by a few ulp: one bf16 ulp
    assert np.all(np.abs(got - want)
                  <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))))


def test_matern_cov_tiles_and_lower_are_tilewise_matern():
    p, nb, t = 4, 32, 2
    locs = torch.from_numpy(np.array(random_locations(
        jax.random.PRNGKey(3), p * nb))).reshape(p, nb, 2)
    th = [1.0, 0.1]
    tiles = matern_ref.matern_cov_tiles(locs[1:], locs[:p - 1], th, nu=0.5)
    lower = matern_ref.matern_cov_lower(locs, th, nu=0.5, min_lag=t,
                                        out_dtype=torch.bfloat16)
    for b in range(p - 1):
        want = matern_ref.matern_cov(locs[b + 1], locs[b], th, nu=0.5)
        torch.testing.assert_close(tiles[b], want, rtol=0, atol=0)
    for i in range(p):
        for j in range(p):
            want = (matern_ref.matern_cov(locs[i], locs[j], th, nu=0.5)
                    if i - j >= t else torch.zeros(nb, nb))
            torch.testing.assert_close(lower[i, j].float(),
                                       want.to(torch.bfloat16).float(),
                                       rtol=0, atol=0)


# ------------------------------ mp_gemm -------------------------------

def _syrk_offband_bound(p, round_k):
    """One bf16 ulp per rounded partial sum (two at a power of two) plus the
    fp32 summation bound gamma_k |p_i| |p_j| of each partial, twice: two
    libraries sum the same exact products in different orders."""
    p = np.asarray(p, np.float64)
    p_lo = np.asarray(torch.from_numpy(p.astype(np.float32))
                      .to(torch.bfloat16).double())
    gamma = round_k * 2.0 ** -24 / (1 - round_k * 2.0 ** -24)
    bound = np.zeros((p.shape[0], p.shape[0]))
    for k0 in range(0, p.shape[1], round_k):
        pc = p_lo[:, k0:k0 + round_k]
        nrm = np.linalg.norm(pc, axis=1)
        bound += 2 * _bf16_ulp(pc @ pc.T) + 2 * gamma * np.outer(nrm, nrm)
    return bound


@pytest.mark.parametrize("m,k,bm,bk,band", [
    (256, 128, 64, 64, 1), (256, 128, 64, 64, 2), (128, 256, 64, 128, 1),
    (256, 64, 128, 64, 4),  # band >= nblocks: all-hi
])
def test_mp_syrk_ref_matches_jax(m, k, bm, bk, band):
    p = np.array(jax.random.normal(jax.random.PRNGKey(4), (m, k), jnp.float32))
    got = syrk_ref.mp_syrk(torch.from_numpy(p), tile=bm, round_k=bk,
                           band_blocks=band).double().numpy()
    tiles = np.arange(m) // bm
    in_band = np.abs(tiles[:, None] - tiles[None, :]) < band
    bound = _syrk_offband_bound(p, bk)
    for want in (j_syrk(p, band_blocks=band, bm=bm, bk=bk),
                 j_syrk_ref(p, band_blocks=band, bm=bm, bk=bk)):
        want = np.asarray(want, np.float64)
        # in the band: fp32 dot products summed in another order
        band_rel = (np.abs(got - want)[in_band].max()
                    / np.abs(want[in_band]).max())
        assert band_rel <= 1e-5
        assert np.all(np.abs(got - want)[~in_band] <= bound[~in_band])


def test_mp_syrk_band_is_exact_offband_is_bf16():
    m, k, bm = 256, 128, 64
    p = torch.randn((m, k), generator=torch.Generator().manual_seed(5))
    out = syrk_ref.mp_syrk(p, tile=bm, round_k=k, band_blocks=1)
    exact = p.double() @ p.double().T
    for i in range(m // bm):
        sl = slice(i * bm, (i + 1) * bm)
        torch.testing.assert_close(out[sl, sl].double(), exact[sl, sl],
                                   rtol=1e-5, atol=1e-5)
    off = out[:bm, bm:]
    assert torch.equal(off, off.to(torch.bfloat16).float())  # one rounding
    rel = (off.double() - exact[:bm, bm:]).abs().max() / exact.abs().max()
    assert 1e-5 < rel < 0.05


def test_mp_syrk_fp32_lo_is_all_hi():
    p = torch.randn((128, 64), generator=torch.Generator().manual_seed(6))
    out = syrk_ref.mp_syrk(p, tile=32, round_k=32, band_blocks=1,
                           lo=torch.float32)
    torch.testing.assert_close(out, p @ p.T, rtol=1e-5, atol=1e-5)


# ---------------------------- blocked_potrf ---------------------------

@pytest.mark.parametrize("n", [32, 64, 128, 256])
def test_potrf_ref_matches_jax(n):
    a = np.array(spd_matrix(jax.random.PRNGKey(6), n, cond=100.0))
    l, info = potrf_ref.potrf(torch.from_numpy(a))
    assert int(info) == 0
    for want in (j_potrf(a), j_potrf_ref(a)):
        np.testing.assert_allclose(l.numpy(), np.asarray(want),
                                   rtol=5e-4, atol=5e-4)


def test_potrf_ref_batched_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    a = np.stack([np.array(spd_matrix(k, 64)) for k in keys])
    l, info = potrf_ref.potrf(torch.from_numpy(a))
    assert info.shape == (4,) and not info.any()
    want = np.asarray(j_potrf(a))
    np.testing.assert_allclose(l.numpy(), want, rtol=5e-4, atol=5e-4)


def test_potrf_flags_indefinite_tile_with_nan():
    rng = np.random.default_rng(8)
    q, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    eigs = np.logspace(0, 2, 64)
    eigs[40] = -1.0
    bad = ((q * eigs) @ q.T).astype(np.float32)
    good = np.array(spd_matrix(jax.random.PRNGKey(9), 64))
    l, info = potrf_ref.potrf(torch.from_numpy(np.stack([good, bad])))
    assert int(info[0]) == 0 and int(info[1]) > 0
    assert torch.isfinite(l[0]).all() and torch.isnan(l[1]).all()
    l1, info1 = potrf_ref.potrf(torch.from_numpy(bad))
    assert info1.shape == () and int(info1) > 0 and torch.isnan(l1).all()


# ------------------------- dispatch and counters -------------------------

def test_ops_on_cpu_are_the_plain_versions_and_launch_nothing():
    reset_launch_counts()
    gen = torch.Generator().manual_seed(10)
    locs = torch.rand((3, 32, 2), generator=gen)
    th = [1.0, 0.2]
    torch.testing.assert_close(
        matern_ops.matern_cov_tiles(locs, locs, th, nu=1.5),
        matern_ref.matern_cov_tiles(locs, locs, th, nu=1.5), rtol=0, atol=0)
    torch.testing.assert_close(
        matern_ops.matern_cov_lower(locs, th, nu=0.5, min_lag=1),
        matern_ref.matern_cov_lower(locs, th, nu=0.5, min_lag=1),
        rtol=0, atol=0)
    a = torch.from_numpy(np.array(spd_matrix(jax.random.PRNGKey(11), 32)))
    for got, want in zip(potrf_ops.potrf(a), potrf_ref.potrf(a)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    p = torch.randn((128, 64), generator=gen)
    kw = dict(tile=64, round_k=64, band_blocks=1)
    torch.testing.assert_close(syrk_ops.mp_syrk(p, **kw),
                               syrk_ref.mp_syrk(p, **kw), rtol=0, atol=0)
    du = torch.randn((128, 128), generator=gen)
    kw.pop("round_k")
    torch.testing.assert_close(syrk_ops.mp_syrk_grad(du, p, **kw),
                               syrk_ref.mp_syrk_grad(du, p, **kw),
                               rtol=0, atol=0)
    g = torch.randn((32, 32), generator=gen)
    torch.testing.assert_close(
        matern_ops.matern_cov_grad(locs[0], locs[1], th, g, nu=2.5),
        matern_ref.matern_cov_grad(locs[0], locs[1], th, g, nu=2.5),
        rtol=0, atol=0)
    assert launch_counts() == {"matern_cov": 0, "matern_cov_grad": 0,
                               "blocked_potrf": 0, "mp_syrk": 0,
                               "mp_syrk_grad": 0, "mp_attention": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    locs = torch.rand((2, 32, 2))
    out = torch.empty((2, 32, 32))
    with pytest.raises(ValueError, match="CUDA"):
        matern_kernel.launch(locs, locs, [1.0, 0.1], nu=0.5, out=out,
                             outer=False)
    with pytest.raises(ValueError, match="CUDA"):
        potrf_kernel.launch(torch.eye(32)[None])
    with pytest.raises(ValueError, match="CUDA"):
        syrk_kernel.launch(torch.ones(128, 64), tile=64, round_k=64,
                           band_blocks=1, hi=torch.float32, lo=torch.bfloat16,
                           accum=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        syrk_kernel.launch_grad(torch.ones(128, 128), torch.ones(128, 64),
                                tile=64, band_blocks=1, hi=torch.float32,
                                lo=torch.bfloat16, accum=torch.float32)
    with pytest.raises(NotImplementedError, match="pairs"):
        syrk_kernel.launch_grad(torch.ones(128, 128), torch.ones(128, 64),
                                tile=64, band_blocks=1, hi=torch.float32,
                                lo=torch.float16, accum=torch.float32)
    q = torch.zeros((2, 4, 64))
    kv = torch.zeros((2, 128, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        attn_kernel.launch(q, kv, kv, torch.ones((2, 1, 2)),
                           torch.full((2,), 128, dtype=torch.int32))
    # haversine passes the smoothness check and meets the device check
    with pytest.raises(ValueError, match="CUDA"):
        matern_kernel.launch(locs, locs, [1.0, 0.1], nu=0.5, out=out,
                             outer=False, metric="haversine")
    with pytest.raises(NotImplementedError, match="nu=1.3"):
        matern_kernel.launch(locs, locs, [1.0, 0.1], nu=1.3, out=out,
                             outer=False)
    with pytest.raises(ValueError, match="CUDA"):
        matern_kernel.launch_grad(locs[0], locs[1], [1.0, 0.1], out[0],
                                  nu=0.5)
    with pytest.raises(NotImplementedError, match="nu=1.3"):
        matern_kernel.launch_grad(locs[0], locs[1], [1.0, 0.1], out[0],
                                  nu=1.3)
    assert launch_counts() == {"matern_cov": 0, "matern_cov_grad": 0,
                               "blocked_potrf": 0, "mp_syrk": 0,
                               "mp_syrk_grad": 0, "mp_attention": 0}


def _c_params(name):
    """Parameter count of an extern "C" entry point in csrc/."""
    for src in _build.sources():
        text = src.read_text()
        hit = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        if hit:
            return len([a for a in hit.group(1).split(",") if a.strip()])
    raise AssertionError(f"{name} not found in csrc/")


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_sources(name):
    # a ctypes argtypes list that disagrees with the C function corrupts the
    # launch silently on the card; the count at least must agree
    assert len(_build.SIGNATURES[name]) == _c_params(name)
