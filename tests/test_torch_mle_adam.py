"""The gradient path against the JAX package on the same numpy inputs: the
log-likelihood and its gradient in theta (torch.autograd against
`jax.value_and_grad` of the JAX `make_loglik`) for the dense and tiled
engines and the profiled form, the plain backward of the Matern kernel
against autograd of a Matern written out here, `fit_mle_adam` against the
reference's, and the dense Cholesky's forward with and without autograd.

Inputs: n = 128 points uniform on the unit square from a numpy seed, a
field drawn at (theta1, theta2) = (1, 0.1), nu = 0.5, through an fp64
Cholesky; the tiled cases use nb = 32 (p = 4).  Gradient errors are
max |g_port - g_jax| / max |g_jax| over (theta1, theta2) unless a test says
otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrecisionPolicy as JP
from repro.core import fit_mle_adam as j_fit_mle_adam
from repro.core import likelihood as jlik
from repro.core.tile_cholesky import (_potrf, _trsm_right_lt, assemble_lower,
                                      split_tiles)
from repro_torch.core import PrecisionPolicy, fit_mle, fit_mle_adam
from repro_torch.core import likelihood as tlik
from repro_torch.core.panel_cholesky import _cholesky
from repro_torch.covariance.matern import pairwise_distance
from repro_torch.kernels.matern_cov import ops as mc_ops
from repro_torch.kernels.matern_cov import ref as mc_ref
from test_torch_panel import _port_policy

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)

N, NB = 128, 32
THETA0 = (1.0, 0.1)


def _field(seed, n, dtype):
    """(locs, z): n uniform locations and a field drawn at THETA0, nu = 0.5,
    with a 1e-6 nugget, in fp64, returned in `dtype`."""
    rng = np.random.default_rng(seed)
    locs = rng.uniform(size=(n, 2))
    d = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1))
    cov = THETA0[0] * np.exp(-d / THETA0[1]) + 1e-6 * np.eye(n)
    z = np.linalg.cholesky(cov) @ rng.standard_normal(n)
    return locs.astype(dtype), z.astype(dtype)


@pytest.fixture(scope="module")
def data32():
    return _field(0, N, np.float32)


@pytest.fixture(scope="module")
def data64():
    return _field(0, N, np.float64)


def _value_and_grads(jp, theta, locs, z, *, impl="plain", **kw):
    """(ll_jax, g_jax, ll_port, g_port) as fp64 numpy at theta."""
    f = jlik.make_loglik(jnp.asarray(locs), jnp.asarray(z), jp, nb=NB, **kw)
    v, g = jax.value_and_grad(f)(jnp.asarray(theta))
    tf = tlik.make_loglik(torch.from_numpy(locs), torch.from_numpy(z),
                          _port_policy(jp), nb=NB, impl=impl, **kw)
    t = torch.tensor(theta, requires_grad=True)
    ll = tf(t)
    (gt,) = torch.autograd.grad(ll, t)
    return (float(v), np.asarray(g, np.float64), float(ll.detach()),
            gt.double().numpy())


def _check(case, tol_ll, tol_grad):
    v, g, ll, gt = case
    assert np.isfinite(v) and np.isfinite(g).all() and np.isfinite(gt).all()
    assert abs(ll - v) <= tol_ll * abs(v)
    assert np.abs(gt - g).max() <= tol_grad * np.abs(g).max()


# dense full(fp32) per nu at theta2 = 0.03, where Sigma stays well enough
# conditioned in fp32 for every nu: gradient error measured 3.8e-9, 6.2e-5
# and 1.1e-5 (fp32 rounding through the Cholesky of Sigma grows with nu's
# smoothness), log-likelihood 0, 3.9e-7, 2.4e-6
DENSE_FP32_GRAD_TOL = {0.5: 1e-6, 1.5: 2e-4, 2.5: 5e-5}


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_dense_fp32_value_and_grad_matches_jax(nu, impl, data32):
    theta = np.array([1.0, 0.03, nu], np.float32)
    case = _value_and_grads(JP.full(jnp.float32), theta, *data32,
                            impl=impl, nu_static=nu)
    _check(case, 1e-5, DENSE_FP32_GRAD_TOL[nu])
    assert case[3][2] == 0.0  # nu_static ignores theta3


def test_dense_fp32_kernel_impl_is_the_plain_on_the_cpu(data32):
    """impl="kernel" on a CPU tensor runs the plain versions: same bits."""
    theta = np.array([1.0, 0.1, 0.5], np.float32)
    a = _value_and_grads(JP.full(jnp.float32), theta, *data32, impl="kernel",
                         nu_static=0.5)
    b = _value_and_grads(JP.full(jnp.float32), theta, *data32, impl="plain",
                         nu_static=0.5)
    assert a[2] == b[2] and np.array_equal(a[3], b[3])


def test_tiled_fp32_value_and_grad_matches_jax(data32):
    """tiled full(fp32) (Algorithm 1 through the plain POTRF and SYRK):
    log-likelihood 0, gradient 2.4e-6 measured."""
    theta = np.array([1.0, 0.1, 0.5], np.float32)
    _check(_value_and_grads(JP.full(jnp.float32), theta, *data32,
                            use_tiles=True, nu_static=0.5), 1e-6, 1e-5)


def test_profiled_value_and_grad_matches_jax(data32):
    """Eq. 3, theta = (theta2, nu): the profiled cat([1, theta[:2]])
    differentiates as the reference's concatenate (measured 1.1e-7 and
    7.7e-7); its second component, the smoothness, gets 0."""
    theta = np.array([0.1, 0.5], np.float32)
    case = _value_and_grads(JP.full(jnp.float32), theta, *data32,
                            profiled=True, nu_static=0.5)
    _check(case, 1e-6, 5e-6)
    assert case[1][1] == 0.0 and case[3][1] == 0.0


@pytest.mark.parametrize("theta_dtype", [np.float32, np.float64])
def test_dense_fp64_value_and_grad_matches_jax_under_x64(theta_dtype, data64):
    """full(fp64) on fp64 inputs: Sigma, the Cholesky and Eq. 2 in fp64 in
    both (measured 1.2e-15 with an fp64 theta, 0 with the fp32 theta
    fit_mle_adam hands it)."""
    with jax.enable_x64(True):
        theta = np.array([1.0, 0.1, 0.5], theta_dtype)
        case = _value_and_grads(JP.full(jnp.float64), theta, *data64,
                                nu_static=0.5)
    _check(case, 1e-13, 1e-12)


def test_paper_cpu2_value_and_grad_matches_jax_under_x64(data64):
    """paper_cpu(2) through the tiles on fp64 inputs: the fp32 off-band sums
    in another order (log-likelihood 5.8e-9, gradient 3.7e-7 measured)."""
    with jax.enable_x64(True):
        theta = np.array([1.0, 0.1, 0.5])
        case = _value_and_grads(JP.paper_cpu(2), theta, *data64,
                                nu_static=0.5)
    _check(case, 5e-8, 2e-6)


# ----------------------------------------------------------------------
# tpu(1): the gradient of a bf16 policy is defined to the rounding of its
# cotangents
# ----------------------------------------------------------------------

@jax.custom_vjp
def _bf16_st(x):
    """x rounded to bf16 and back, with an fp32 cotangent (straight
    through)."""
    return x.astype(jnp.bfloat16).astype(jnp.float32)


_bf16_st.defvjp(lambda x: (_bf16_st(x), None), lambda _, g: (g,))


def _jax_tiles_fp32_cotangents(a, nb, policy):
    """The reference's Algorithm 1 (`repro.core.tile_cholesky`) for a
    {fp32, bf16} policy with every bf16 value held as fp32 rounded to bf16
    by `_bf16_st`: the same forward, fp32 cotangents."""
    rnd, f32 = _bf16_st, jnp.float32
    tiles, p = split_tiles(a, nb)
    store = {k: t if policy.in_band(*k) else rnd(t) for k, t in tiles.items()}
    for k in range(p):
        l_kk = _potrf(store[(k, k)], f32)
        store[(k, k)] = l_kk
        l_kk_lo = rnd(l_kk)
        for i in range(k + 1, p):
            if policy.in_band(i, k):
                store[(i, k)] = _trsm_right_lt(l_kk, store[(i, k)], f32, f32)
            else:
                store[(i, k)] = rnd(_trsm_right_lt(l_kk_lo, store[(i, k)],
                                                   f32, f32))
        for j in range(k + 1, p):
            a_jk_t = jnp.swapaxes(store[(j, k)], -1, -2)
            store[(j, j)] = store[(j, j)] - store[(j, k)] @ a_jk_t
            for i in range(j + 1, p):
                if policy.in_band(i, j):
                    store[(i, j)] = store[(i, j)] - store[(i, k)] @ a_jk_t
                else:
                    upd = rnd(rnd(store[(i, k)]) @ rnd(a_jk_t))
                    store[(i, j)] = rnd(store[(i, j)] - upd)
    return assemble_lower(store, p, nb, f32)


# the three gradients' distances below, measured: port - JAX 5.9e-5 (theta1)
# and 3.1e-5 (theta2), JAX with fp32 cotangents - JAX 2.9e-5 and 6.8e-5, of
# the scale sum_ij |G_ij dSigma_ij/dtheta_k|
TPU1_GRAD_GAP = 1e-4


def test_tpu1_gradient_gap_is_the_rounding_of_bf16_cotangents(data32):
    """Under tpu(1) the port's gradient is not the reference's: both
    differentiate through the bf16 roundings, and the cotangent of every
    bf16 value is bf16 in both, rounded at other points (JAX per tile
    update, summed in bf16; the port once per panel column, inside the
    SYRK's fp32 product).  theta1's gradient is a small difference of
    large terms, so the gap is percent-size there (ROADMAP C 13).  Held
    against the scale s_k = sum |G| dSigma/dtheta_k (G = dl/dSigma, the
    terms the gradient sums): the gap is below 1e-4 s_k, no larger than
    the one between the reference and the reference with fp32 cotangents."""
    locs, z = data32
    theta = np.array([1.0, 0.1, 0.5], np.float32)
    jp = JP.tpu(1)
    _, g_jax, _, g_port = _value_and_grads(jp, theta, locs, z, nu_static=0.5)
    jl, jz = jnp.asarray(locs), jnp.asarray(z)

    def ll_fp32_cotangents(th):
        cov = jlik.build_covariance(jl, th, nu_static=0.5, jitter=1e-6,
                                    dtype=jnp.float32)
        return jlik.loglik_from_factor(
            _jax_tiles_fp32_cotangents(cov, NB, jp), jz)

    g_st = np.asarray(jax.grad(ll_fp32_cotangents)(jnp.asarray(theta)),
                      np.float64)
    # G = dl/dSigma of the port's tile engine, and the scale of each sum
    lt = torch.from_numpy(locs)
    cov = tlik.build_covariance(lt, theta, nu_static=0.5, jitter=1e-6,
                                impl="plain").requires_grad_(True)
    ll = tlik.loglik_from_factor(tlik.tile_cholesky(
        cov, NB, _port_policy(jp), impl="plain"), torch.from_numpy(z))
    (g_cov,) = torch.autograd.grad(ll, cov)
    scale = mc_ref.matern_cov_grad(lt, lt, theta.tolist(), g_cov.abs(),
                                   nu=0.5).double().numpy()
    gap = np.abs(g_port[:2] - g_jax[:2]) / scale
    ref_gap = np.abs(g_st[:2] - g_jax[:2]) / scale
    assert gap.max() <= TPU1_GRAD_GAP and ref_gap.max() <= TPU1_GRAD_GAP
    # percent-size on theta1 itself (2.3 % here)
    assert abs(g_port[0] - g_jax[0]) > 1e-3 * abs(g_jax[0])


def test_general_nu_gradient(data32):
    """General nu (tiled full(fp32), the Bessel path, which autograd
    differentiates): theta1's gradient matches the reference's; the
    reference's theta2 and nu gradients are NaN (ROADMAP C 14), the
    port's theta2 gradient is finite, and its nu gradient is held to
    nothing."""
    theta = np.array([1.0, 0.1, 0.5], np.float32)
    _, g, _, gt = _value_and_grads(JP.full(jnp.float32), theta, *data32,
                                   use_tiles=True)
    assert np.isnan(g[1]) and np.isnan(g[2])
    assert np.isfinite(gt[:2]).all()
    assert abs(gt[0] - g[0]) <= 1e-4 * abs(g[0])


# ----------------------------------------------------------------------
# the backward of the Matern kernel
# ----------------------------------------------------------------------

def _matern_written_out(la, lb, theta, nu):
    """theta1 * corr(r / theta2), 1 at r = 0, as a plain formula of its own
    (not the port's closed forms), for autograd to differentiate."""
    r = torch.sqrt(((la[:, None, :] - lb[None, :, :]) ** 2).sum(-1))
    x = r / theta[1]
    poly = {0.5: torch.ones_like(x), 1.5: 1 + x, 2.5: 1 + x + x ** 2 / 3}[nu]
    return theta[0] * torch.where(r == 0, torch.ones_like(x),
                                  poly * torch.exp(-x))


def _grad_inputs(dtype):
    """Two location sets that share 8 points (r = 0 pairs), theta and G."""
    rng = np.random.default_rng(7)
    la = rng.uniform(size=(96, 2))
    lb = np.concatenate([la[:8], rng.uniform(size=(72, 2))])
    g = rng.standard_normal((96, 80))
    return (torch.tensor(la, dtype=dtype), torch.tensor(lb, dtype=dtype),
            torch.tensor(g, dtype=dtype))


# fp64: rounding of the closed forms against the written-out formula and
# of the sums (measured <= 3e-16 of the scale); fp32: the terms in fp32
# (measured <= 1.2e-7)
GRAD_TOL = {torch.float64: 1e-13, torch.float32: 2e-6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_cov_grad_matches_autograd(nu, dtype):
    la, lb, g = _grad_inputs(dtype)
    theta = [0.8, 0.07, nu]
    th = torch.tensor(theta[:2], dtype=dtype, requires_grad=True)
    (want,) = torch.autograd.grad(
        (_matern_written_out(la, lb, th, nu) * g).sum(), th)
    got = mc_ops.matern_cov_grad(la, lb, theta, g, nu=nu)
    scale = mc_ref.matern_cov_grad(la, lb, theta, g.abs(), nu=nu)
    assert got.dtype == dtype and got.shape == (2,)
    assert torch.all((got - want).abs() <= GRAD_TOL[dtype] * scale)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_matern_cov_function_gradcheck(nu):
    """MaternCov (forward matern_cov, backward matern_cov_grad) against
    finite differences in fp64, a zero theta3 gradient, and Sigma changed
    in place after the forward, as build_covariance adds its jitter."""
    la, lb, _ = _grad_inputs(torch.float64)
    theta = torch.tensor([0.8, 0.07, nu], dtype=torch.float64,
                         requires_grad=True)
    fn = lambda th: mc_ops.MaternCov.apply(la, lb, th, nu, "euclidean",
                                           mc_ops)
    assert torch.autograd.gradcheck(fn, (theta,))
    sigma = fn(theta)
    sigma.diagonal().add_(1e-3)
    (grad,) = torch.autograd.grad(sigma.sum(), theta)
    assert grad[2] == 0.0 and torch.isfinite(grad).all()


def test_matern_cov_grad_refuses_general_nu():
    la, lb, g = _grad_inputs(torch.float32)
    with pytest.raises(ValueError):
        mc_ops.matern_cov_grad(la, lb, [1.0, 0.1], g, nu=0.7)


# ----------------------------------------------------------------------
# fit_mle_adam
# ----------------------------------------------------------------------

def test_fit_mle_adam_history_matches_jax(data32):
    """30 Adam steps from (0.8, 0.08) on dense full(fp32): the history every
    10 steps and the final value against the reference's (measured theta
    2.6e-6, log-likelihood 2.2e-7 relative)."""
    locs, z = data32
    jl = jlik.make_loglik(jnp.asarray(locs), jnp.asarray(z),
                          JP.full(jnp.float32), nb=NB, nu_static=0.5)
    want = j_fit_mle_adam(lambda th: jl(jnp.concatenate([th, jnp.array([0.5])])),
                          [0.8, 0.08], steps=30, lr=0.05)
    tl = tlik.make_loglik(torch.from_numpy(locs), torch.from_numpy(z),
                          PrecisionPolicy.full(torch.float32), nb=NB,
                          nu_static=0.5)
    got = fit_mle_adam(lambda th: tl(torch.cat([th, torch.tensor([0.5])])),
                       [0.8, 0.08], steps=30, lr=0.05)
    assert len(got.history) == len(want.history) == 3
    for (th_p, ll_p), (th_j, ll_j) in zip(got.history, want.history):
        np.testing.assert_allclose(th_p, th_j, rtol=2e-5)
        assert ll_p == pytest.approx(ll_j, rel=2e-6)
    np.testing.assert_allclose(got.theta, want.theta, rtol=2e-5)
    assert got.loglik == pytest.approx(want.loglik, rel=2e-6)
    assert got.theta.dtype == want.theta.dtype == np.float32
    assert (got.n_evals, got.n_iters, got.converged) == (30, 30, True)


def test_adam_gradient_path():
    """The port's twin of tests/test_mle_kriging.py's test_adam_gradient_path:
    n = 256, nb = 32, dense full(fp32), nu = 0.5, 120 steps at lr 0.05 from
    (0.8, 0.08); theta2-hat within rel 0.1 of the port's Nelder-Mead fit
    (measured 3.5e-4) and inside the reference's sampling band."""
    locs, z = _field(3, 256, np.float32)
    tl = tlik.make_loglik(torch.from_numpy(locs), torch.from_numpy(z),
                          PrecisionPolicy.full(torch.float32), nb=NB,
                          nu_static=0.5)
    nm = fit_mle(lambda th: tl([th[0], th[1], 0.5]), [0.8, 0.08],
                 max_iters=60)
    res = fit_mle_adam(lambda th: tl(torch.cat([th, torch.tensor([0.5])])),
                       [0.8, 0.08], steps=120, lr=0.05)
    assert 0.05 < res.theta[1] < 0.2
    assert res.theta[1] == pytest.approx(nm.theta[1], rel=0.1)


# ----------------------------------------------------------------------
# the dense Cholesky under autograd
# ----------------------------------------------------------------------

def _spd_and_indefinite(dtype):
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((48, 48)))
    spd = (q * np.logspace(0, 2, 48)) @ q.T
    bad = spd.copy()
    bad[20, 20] = -1.0
    return torch.tensor(np.stack([spd, bad]), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cholesky_same_bits_with_and_without_grad(dtype):
    """_cholesky's NaN is written in place without autograd and out of
    place with it: the same factor bit for bit, NaN for the matrix that is
    not positive definite either way, and the grad form differentiates."""
    a = _spd_and_indefinite(dtype)
    l0, info0 = _cholesky(a, dtype)
    ag = a.clone().requires_grad_(True)
    l1, info1 = _cholesky(ag, dtype)
    assert torch.equal(info0, info1) and info0[0] == 0 and info0[1] != 0
    assert torch.equal(l0[0], l1[0].detach())
    assert torch.isnan(l0[1]).all() and torch.isnan(l1[1]).all()
    (g,) = torch.autograd.grad(torch.log(torch.diagonal(l1[0])).sum(), ag)
    assert torch.isfinite(g[0]).all()
    with torch.no_grad():
        l2, _ = _cholesky(ag, dtype)
    assert torch.equal(l2[0], l0[0]) and torch.isnan(l2[1]).all()


# ----------------------------------------------------------------------
# chip_smoke.py's phase 10 arithmetic (it runs on the card only)
# ----------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_grad_bound_is_the_bytes_of_g():
    """matern_cov_grad's bound at the fidelity path's Sigma: G read once,
    6.71 GB in fp32 (2.00 ms at 3.35 TB/s) and 13.4 GB in fp64 (4.01 ms)."""
    cs = _chip_smoke()
    ms32, by32 = cs.grad_bound(40_960, 40_960, torch.float32)
    ms64, by64 = cs.grad_bound(40_960, 40_960, torch.float64)
    assert by32 == by64 == "bytes"
    assert ms32 == pytest.approx(2.003, abs=1e-3)
    assert ms64 == pytest.approx(4.007, abs=1e-3)


@pytest.mark.parametrize("peak32,want", [(30.0, 40_960), (35.0, 40_960),
                                         (37.56, 38_912), (60.0, 30_720)])
def test_chip_smoke_cuts_the_fp64_gradient_n(peak32, want):
    """full(fp64)'s n_obs: kept while twice the fp32 peak fits in 70 GiB,
    else the largest multiple of 1,024 whose n^2-scaled peak does."""
    cs = _chip_smoke()
    n = cs.fp64_grad_n(40_960, peak32, 70.0)
    assert n == want and n % 1024 == 0
    assert 2 * peak32 * (n / 40_960) ** 2 <= 70.0
    assert n == 40_960 or 2 * peak32 * ((n + 1024) / 40_960) ** 2 > 70.0


# ----------------------------------------------------------------------
# haversine distance (ROADMAP C 15): the theta-gradient on the CPU, the
# card's refusal
# ----------------------------------------------------------------------

# theta = (1, theta2, 0.5) by nu.  theta2 = 2 degrees for nu = 0.5; the
# smoother nu take a shorter range, since at theta2 = 2 their fp32 Sigma
# is too ill-conditioned to compare two fp32 orders of summation (measured
# there: log-likelihoods 5.8e-4 (nu = 1.5) and 2.3e-2 (2.5) apart, tpu(2)
# NaN in both packages)
HAV_THETA2 = {0.5: 2.0, 1.5: 0.3, 2.5: 0.2}


@pytest.fixture(scope="module")
def hav_data():
    """n = 128 fp32 (lon, lat) in a 10 x 10 degree box, z standard
    normal."""
    rng = np.random.default_rng(21)
    locs = rng.uniform(0.0, 10.0, size=(N, 2)).astype(np.float32)
    return locs, rng.standard_normal(N).astype(np.float32)


def _hav_scale(jp, theta, nu, locs, z):
    """s_k = sum |G| dSigma/dtheta_k with G = dl/dSigma of the port's path
    (dense for full, the tile engine for a mixed policy), haversine r."""
    lt = torch.from_numpy(locs)
    pol = _port_policy(jp)
    cov = tlik.build_covariance(lt, theta, nu_static=nu, metric="haversine",
                                jitter=1e-6, impl="plain").requires_grad_(True)
    l = (tlik.reference_cholesky(cov, pol.hi) if pol.mode == "full"
         else tlik.tile_cholesky(cov, NB, pol, impl="plain"))
    (g,) = torch.autograd.grad(tlik.loglik_from_factor(l, torch.from_numpy(z)),
                               cov)
    return mc_ref.matern_cov_grad(lt, lt, theta.tolist(), g.abs(), nu=nu,
                                  metric="haversine").double().numpy()


# (log-likelihood relative, gradient gap over s_k), measured for nu = 0.5 /
# 1.5 / 2.5: dense full(fp32) ll 4.2e-7 / 6.4e-7 / 3.7e-6 and gradient
# 8.4e-9 / 8.7e-8 / 1.3e-6 (fp32 sums in other orders); tpu(2) ll 9.5e-7
# / 0 / 0 and gradient 2.6e-4 / 2.0e-5 / 3.5e-5, the bf16 cotangent-rounding
# gap of ROADMAP C 13, larger than the Euclidean cases' (<= 1e-4) in this
# strongly correlated field
HAV_TOL = {"full(fp32)": (1e-5, 5e-6), "tpu(2)": (1e-5, 1e-3)}


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
@pytest.mark.parametrize("case", list(HAV_TOL))
def test_haversine_value_and_grad_matches_jax(case, nu, hav_data):
    """ROADMAP C 15: MaternCov differentiates haversine distance (it raised
    for every half-integer nu); dense full(fp32) and tiled tpu(2) through
    MaternCov (impl="kernel": the plain versions on the CPU) against
    jax.value_and_grad of the JAX make_loglik, nb = 32."""
    jp = JP.full(jnp.float32) if case == "full(fp32)" else JP.tpu(2)
    theta = np.array([1.0, HAV_THETA2[nu], 0.5], np.float32)
    v, g, ll, gt = _value_and_grads(jp, theta, *hav_data, impl="kernel",
                                    nu_static=nu, metric="haversine")
    ll_tol, tol = HAV_TOL[case]
    assert np.isfinite([v, ll]).all() and np.isfinite(gt).all() and gt[2] == 0
    assert abs(ll - v) <= ll_tol * abs(v)
    gap = np.abs(gt[:2] - g[:2]) / _hav_scale(jp, theta, nu, *hav_data)
    assert gap.max() <= tol, gap


def test_haversine_matern_cov_grad_matches_autograd():
    """The plain backward under haversine (ref.matern_cov_grad, through
    MaternCov) against autograd of the Matern written out on the haversine
    distance, fp64, every nu (measured <= 6.3e-18 of the scale), with 8
    r = 0 pairs."""
    la, lb, g = _grad_inputs(torch.float64)
    la, lb = la * 10.0, lb * 10.0  # degrees
    r = pairwise_distance(la, lb, metric="haversine")
    for nu in (0.5, 1.5, 2.5):
        th = torch.tensor([0.8, 2.0, nu], dtype=torch.float64,
                          requires_grad=True)
        x = r / th[1]
        poly = {0.5: torch.ones_like(x), 1.5: 1 + x, 2.5: 1 + x + x ** 2 / 3}[nu]
        k = th[0] * torch.where(r == 0, torch.ones_like(x), poly * torch.exp(-x))
        (want,) = torch.autograd.grad((k * g).sum(), th)
        sigma = mc_ops.MaternCov.apply(la, lb, th, nu, "haversine", mc_ops)
        (got,) = torch.autograd.grad((sigma * g).sum(), th)
        scale = mc_ref.matern_cov_grad(la, lb, [0.8, 2.0], g.abs(), nu=nu,
                                       metric="haversine")
        assert got[2] == 0.0
        assert torch.all((got[:2] - want[:2]).abs() <= 1e-13 * scale)


def test_haversine_grad_kernel_refuses_before_any_build(monkeypatch):
    """The backward kernel's wrapper takes haversine distance: past _two_nu
    and its checks (the CUDA-device check stubbed here, where there is no
    card) a haversine call reaches the library's build; a general nu (1.3)
    still refuses in _two_nu, before its checks and before any build."""
    from repro_torch.kernels.matern_cov import matern_cov as mc_kernel

    class Built(Exception):
        pass

    def build():
        raise Built

    monkeypatch.setattr(mc_kernel, "library", build)
    monkeypatch.setattr(mc_kernel, "_check_locs", lambda locs, name: None)
    la, lb, g = _grad_inputs(torch.float32)
    with pytest.raises(Built):
        mc_kernel.launch_grad(la, lb, [1.0, 2.0], g, nu=0.5,
                              metric="haversine")
    with pytest.raises(NotImplementedError, match="nu=1.3"):
        mc_kernel.launch_grad(la, lb, [1.0, 2.0], g, nu=1.3,
                              metric="haversine")
