"""The panel engine's gradient: `geostat_loglik_step` with a theta that
requires grad (`BandedMaternCov` -> `PanelCholesky` -> `banded_loglik`)
against `jax.value_and_grad` of the JAX `geostat_loglik_step` on the same
numpy inputs; the plain tile-stack backward forms of `matern_cov`
against autograd of the plain covariance; the kernel wrappers' refusals
without a card; and chip_smoke.py's phase 13 arithmetic.

Inputs: n = 256 points uniform on the unit square from a numpy seed and a
field drawn at (theta1, theta2) = (1, 0.1), nu = 0.5 (tests/
test_torch_mle_adam.py's `_field`), or n = 256 lon/lat points in wind
region R2's box with a field drawn under haversine distance; nb = 64
(p = 4), band t = 2 unless a case says otherwise.  Gradient gaps are
|g_port - g_jax| / s_k per component, s_k = sum |G| dSigma/dtheta_k with
G the port's cotangent of the split storage (chip_smoke.panel_grad_scale,
the plain versions here): the scale of the terms each gradient sums
(ROADMAP C 13)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrecisionPolicy as JP
from repro.core.panel_cholesky import geostat_loglik_step as j_step
from repro_torch.core import panel_cholesky as tpc
from repro_torch.covariance.matern import matern_covariance
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.matern_cov import matern_cov as mc_kernel
from repro_torch.kernels.matern_cov import ops as mc_ops
from repro_torch.kernels.matern_cov import ref as mc_ref
from repro_torch.kernels.mp_gemm import ops as syrk_ops
from test_torch_mle_adam import _chip_smoke, _field
from test_torch_panel import _port_policy

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

N, NB = 256, 64
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
HAV_THETA2 = 2.0   # degrees: the lon/lat field's range


def _lonlat_field(seed, n, dtype):
    """(locs, z): n lon/lat points uniform in wind region R2's box (45-60 E,
    22.5-35 N), sorted by longitude then latitude, and a field drawn at
    (1, HAV_THETA2), nu = 0.5, under the haversine distance in degrees with
    a 1e-6 nugget, in fp64, returned in `dtype`."""
    rng = np.random.default_rng(seed)
    lon = 45.0 + 15.0 * rng.uniform(size=n)
    lat = 22.5 + 12.5 * rng.uniform(size=n)
    order = np.lexsort((lat, lon))
    lon, lat = lon[order], lat[order]
    la, ph = np.deg2rad(lon), np.deg2rad(lat)
    h = (np.sin((ph[:, None] - ph[None]) / 2) ** 2 + np.cos(ph)[:, None]
         * np.cos(ph)[None] * np.sin((la[:, None] - la[None]) / 2) ** 2)
    d = 2 * (180 / np.pi) * np.arcsin(np.sqrt(np.clip(h, 0, 1)))
    cov = np.exp(-d / HAV_THETA2) + 1e-6 * np.eye(n)
    z = np.linalg.cholesky(cov) @ rng.standard_normal(n)
    return np.stack([lon, lat], -1).astype(dtype), z.astype(dtype)


@functools.lru_cache(maxsize=None)
def _data(kind, x64):
    dt = np.float64 if x64 else np.float32
    return _lonlat_field(2, N, dt) if kind == "lonlat" else _field(1, N, dt)


# case -> (JAX policy, x64, off_update, nu, theta, data, metric, ll tol,
# gradient tol over s_k).  Measured (gap over s_k, |ll| relative):
#   full(fp32) 1.7e-8, 1.1e-7 (fp32 sums in other orders);
#   tpu(2) 5.2e-6, 0 (the bf16 cotangent-rounding gap of ROADMAP C 13);
#   paper_cpu(2) 6.9e-10, 6.9e-10; the same under "chunked" (the backward
#   is one sweep for both); tpu(2) nu = 1.5 at theta2 = 0.03 1.9e-5;
#   full(fp32) nu = 1.5 / 2.5 at theta2 = 0.03 2.0e-7 / 1.4e-6, ll 9.5e-7 /
#   1.5e-4 (fp32 through the Cholesky of a smoother Sigma, as the dense
#   tests find), paper_cpu(2) at nu = 2.5 there 1.4e-6, ll 1.5e-4 (its fp32
#   off-band the same way); tpu(2) / paper_cpu(2) under haversine 5.6e-7 /
#   1.7e-10
SMOOTH = (1.0, 0.03)
CASES = {
    "full(fp32)": (lambda: JP.full(jnp.float32), False, "square", 0.5,
                   (1.0, 0.1), "unit", "euclidean", 1e-6, 5e-7),
    "full(fp32) chunked": (lambda: JP.full(jnp.float32), False, "chunked",
                           0.5, (1.0, 0.1), "unit", "euclidean", 1e-6, 5e-7),
    "tpu(2)": (lambda: JP.tpu(2), False, "square", 0.5, (1.0, 0.1), "unit",
               "euclidean", 1e-6, 1e-4),
    "tpu(2) chunked": (lambda: JP.tpu(2), False, "chunked", 0.5, (1.0, 0.1),
                       "unit", "euclidean", 1e-6, 1e-4),
    "paper_cpu(2)": (lambda: JP.paper_cpu(2), True, "square", 0.5,
                     (1.0, 0.1), "unit", "euclidean", 1e-8, 2e-8),
    "paper_cpu(2) chunked": (lambda: JP.paper_cpu(2), True, "chunked", 0.5,
                             (1.0, 0.1), "unit", "euclidean", 1e-8, 2e-8),
    "tpu(2) nu=1.5": (lambda: JP.tpu(2), False, "square", 1.5, SMOOTH, "unit",
                      "euclidean", 1e-6, 1e-4),
    "full(fp32) nu=1.5": (lambda: JP.full(jnp.float32), False, "square", 1.5,
                          SMOOTH, "unit", "euclidean", 1e-5, 2e-6),
    "full(fp32) nu=2.5": (lambda: JP.full(jnp.float32), False, "square", 2.5,
                          SMOOTH, "unit", "euclidean", 1e-3, 1e-5),
    "paper_cpu(2) nu=2.5": (lambda: JP.paper_cpu(2), True, "chunked", 2.5,
                            SMOOTH, "unit", "euclidean", 1e-3, 1e-5),
    "tpu(2) haversine": (lambda: JP.tpu(2), False, "square", 0.5,
                         (1.0, HAV_THETA2), "lonlat", "haversine", 1e-6, 1e-4),
    "paper_cpu(2) haversine": (lambda: JP.paper_cpu(2), True, "chunked", 0.5,
                               (1.0, HAV_THETA2), "lonlat", "haversine", 1e-8,
                               2e-8),
}


@functools.lru_cache(maxsize=None)
def _jax(case, jitter=1e-6, general=False):
    """(ll, gradient) of the JAX panel engine for a case, as fp64 numpy."""
    make_jp, x64, off_update, nu, th, kind, metric, *_ = CASES[case]
    with jax.enable_x64(x64):
        locs, z = _data(kind, x64)
        theta = np.array([*th, nu], locs.dtype)
        jp = make_jp()
        f = jax.jit(jax.value_and_grad(lambda t: j_step(
            jnp.asarray(locs), jnp.asarray(z), t, nb=NB, policy=jp,
            nu_static=None if general else nu, metric=metric, jitter=jitter,
            off_update=off_update)))
        v, g = f(jnp.asarray(theta))
        return float(v), np.asarray(g, np.float64)


def _port(case, impl="kernel", jitter=1e-6, general=False):
    """(ll tensor with its graph, gradient, no-grad ll) of the port."""
    make_jp, x64, off_update, nu, th, kind, metric, *_ = CASES[case]
    locs, z = (torch.from_numpy(x) for x in _data(kind, x64))
    with jax.enable_x64(x64):
        pol = _port_policy(make_jp())
    kw = dict(nb=NB, policy=pol, nu_static=None if general else nu,
              metric=metric, jitter=jitter, off_update=off_update, impl=impl)
    theta = [*th, nu]
    t = torch.tensor(theta, dtype=locs.dtype, requires_grad=True)
    ll = tpc.geostat_loglik_step(locs, z, t, **kw)
    (g,) = torch.autograd.grad(ll, t, retain_graph=True)
    with torch.no_grad():
        ll0 = tpc.geostat_loglik_step(locs, z, torch.tensor(theta, dtype=locs.dtype),
                                      **kw)
    return ll, g.double().numpy(), ll0


def _scale(case):
    """s_k of the port's plain panel engine for a case."""
    make_jp, x64, off_update, nu, th, kind, metric, *_ = CASES[case]
    locs, z = (torch.from_numpy(x) for x in _data(kind, x64))
    with jax.enable_x64(x64):
        pol = _port_policy(make_jp())
    return np.array(_chip_smoke().panel_grad_scale(
        locs, z, pol, [*th, nu], NB, nu, metric, impl="plain"))


def _graph(t):
    """The class names of every node of t's autograd graph."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo += [f for f, _ in node.next_functions]
    return {type(node).__name__ for node in seen}


# ----------------------------------------------------------------------
# the engine against jax.value_and_grad
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_panel_value_and_grad_matches_jax(case):
    """ll and its gradient in theta (theta3 zero under a half-integer
    nu_static in both) within the case's tolerance of the JAX panel
    engine's; ll with autograd the same bits as without; the graph through
    BandedMaternCov and PanelCholesky."""
    *_, tol_ll, tol = CASES[case]
    v, g = _jax(case)
    ll, gp, ll0 = _port(case)
    assert torch.equal(ll.detach(), ll0)
    assert {"BandedMaternCovBackward", "PanelCholeskyBackward"} <= _graph(ll)
    llp = float(ll.detach())
    assert np.isfinite(v) and np.isfinite(g).all() and np.isfinite(gp).all()
    assert g[2] == 0.0 and gp[2] == 0.0
    assert abs(llp - v) <= tol_ll * abs(v), (llp, v)
    gap = np.abs(gp[:2] - g[:2]) / _scale(case)
    assert gap.max() <= tol, (gap, gp, g)


@pytest.mark.parametrize("case", ["tpu(2)", "paper_cpu(2) haversine"])
def test_kernel_impl_is_the_plain_on_the_cpu(case):
    """impl="kernel" on CPU tensors runs the plain versions (ops dispatch by
    device), forward and backward: the same bits as impl="plain"."""
    a, ga, _ = _port(case, impl="kernel")
    b, gb, _ = _port(case, impl="plain")
    assert torch.equal(a.detach(), b.detach()) and np.array_equal(ga, gb)


def test_panel_gradient_launches_nothing_on_the_cpu():
    reset_launch_counts()
    _port("tpu(2)")
    assert sum(launch_counts().values()) == 0


def test_general_nu_panel_gradient():
    """nu_static=None (theta3 = 0.5 through the Bessel path, which autograd
    differentiates through the plain covariance): theta1's gradient within
    1e-4 relative of the reference's (measured 4.3e-6) and of the closed
    form's at the same theta; the reference's theta2 gradient is NaN
    (ROADMAP C 14), the port's finite and within 1e-4 of the closed
    form's; nu's NaN in both."""
    v, g = _jax("full(fp32)", general=True)
    ll, gp, ll0 = _port("full(fp32)", general=True)
    _, g_half, _ = _port("full(fp32)")
    assert torch.equal(ll.detach(), ll0) and "BandedMaternCovBackward" not in _graph(ll)
    assert abs(float(ll.detach()) - v) <= 1e-6 * abs(v)
    assert np.isnan(g[1]) and np.isnan(g[2]) and np.isnan(gp[2])
    assert abs(gp[0] - g[0]) <= 1e-4 * abs(g[0])
    np.testing.assert_allclose(gp[:2], g_half[:2], rtol=1e-4)


@pytest.mark.parametrize("case", ["tpu(2)", "paper_cpu(2)"])
def test_non_spd_gives_nan_in_both(case):
    """A jitter of -1.5 on the diagonal (theta1 = 1): the first diagonal tile
    is not positive definite; ll and every gradient component NaN in both
    (theta3's too in the port: 0 times a NaN factor)."""
    v, g = _jax(case, jitter=-1.5)
    ll, gp, _ = _port(case, jitter=-1.5)
    assert np.isnan(v) and np.isnan(g[:2]).all()
    assert torch.isnan(ll.detach()) and np.isnan(gp[:2]).all()


def test_z_is_differentiable_and_locations_refuse():
    """z that requires grad differentiates through the solve: dl/dz =
    -Sigma^-1 z under paper_cpu(2), within 1e-5 of its largest entry of a
    dense fp64 solve and of JAX's (measured 9.2e-7 and 6.6e-7: the fp32
    off-band); locations that require grad raise, before any work, on
    every impl."""
    locs, z = (torch.from_numpy(x) for x in _data("unit", True))
    with jax.enable_x64(True):
        pol = _port_policy(JP.paper_cpu(2))
        jf = jax.jit(jax.grad(lambda zz: j_step(
            jnp.asarray(locs.numpy()), zz, jnp.array([1.0, 0.1, 0.5]), nb=NB,
            policy=JP.paper_cpu(2), nu_static=0.5)))
        want_j = np.asarray(jf(jnp.asarray(z.numpy())))
    zr = z.clone().requires_grad_(True)
    ll = tpc.geostat_loglik_step(locs, zr, [1.0, 0.1, 0.5], nb=NB, policy=pol,
                                 nu_static=0.5)
    (gz,) = torch.autograd.grad(ll, zr)
    sigma = matern_covariance(locs, locs, torch.tensor([1.0, 0.1, 0.5],
                                                       dtype=F64),
                              nu_static=0.5) + 1e-6 * torch.eye(N, dtype=F64)
    want = -torch.linalg.solve(sigma, z)
    top = float(want.abs().max())
    assert float((gz - want).abs().max()) <= 1e-5 * top
    assert float(np.abs(gz.numpy() - want_j).max()) <= 1e-5 * top
    for impl in ("kernel", "plain"):
        with pytest.raises(NotImplementedError, match="locations"):
            tpc.geostat_loglik_step(locs.clone().requires_grad_(True), z,
                                    torch.tensor([1.0, 0.1, 0.5],
                                                 requires_grad=True),
                                    nb=NB, policy=pol, nu_static=0.5,
                                    impl=impl)


def test_panel_cholesky_backward_is_its_own_sweep():
    """panel_cholesky_backward against autograd through a differentiable
    copy of the forward (`_panel_out_of_place`: the same steps out of place,
    the plain POTRF and SYRK), on a split storage with an fp32 band and an
    fp32 off-band (a "mixed" policy, t = 2, nb = 32, p = 8: the lo panel,
    the trailing off-band and every step run, and no bf16 rounding tells
    the two apart), for random cotangents of every storage tile: they
    agree to fp32 sums in other orders (measured 2.4e-7 of the largest
    cotangent)."""
    from repro_torch.core import PrecisionPolicy
    locs = torch.from_numpy(_data("unit", False)[0])
    pol = PrecisionPolicy(mode="mixed", hi=F32, lo=F32, diag_thick=2)
    band0, off0 = tpc.build_banded_covariance(locs, [1.0, 0.1, 0.5], nb=32,
                                              policy=pol, nu_static=0.5)
    p, t = band0.shape[:2]
    gen = torch.Generator().manual_seed(7)
    gb = torch.randn(band0.shape, generator=gen)
    go = torch.randn(off0.shape, generator=gen)
    for d in range(t):  # band tiles (i, d) with i < d are not storage
        gb[:d, d] = 0
    band, off, failed = tpc.panel_cholesky_banded(band0.clone(), off0.clone(),
                                                  pol)
    assert not bool(failed)
    got_b, got_o = tpc.panel_cholesky_backward(band, off, gb.clone(),
                                               go.clone(), pol, impl="plain")
    b_in = band0.clone().requires_grad_(True)
    o_in = off0.clone().requires_grad_(True)
    b_out, o_out = _panel_out_of_place(b_in, o_in, pol)
    torch.testing.assert_close(b_out.detach(), band, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(o_out.detach(), off, rtol=1e-5, atol=1e-6)
    want_b, want_o = torch.autograd.grad((b_out, o_out), (b_in, o_in),
                                         (gb, go))
    scale = float(torch.maximum(want_b.abs().max(), want_o.abs().max()))
    assert float((got_b - want_b).abs().max()) <= 1e-5 * scale
    assert float((got_o - want_o).abs().max()) <= 1e-5 * scale


def _panel_out_of_place(band, off, pol):
    """panel_cholesky_banded's square update written with out-of-place tile
    lists, autograd's own backward through every op (the plain POTRF and
    SYRK); returns the factored storage."""
    from repro_torch.kernels.mp_gemm import ref as syrk_ref
    p, t, nb, _ = band.shape
    hi, lo = pol.hi, off.dtype
    b = [[band[i, d] for d in range(t)] for i in range(p)]
    o = [[off[i, j] for j in range(p)] for i in range(p)]
    for k in range(p):
        lkk = torch.linalg.cholesky(b[k][0])
        b[k][0] = lkk
        m_t = p - k - 1
        if m_t == 0:
            break
        n_bp = min(t - 1, m_t)
        for d in range(1, n_bp + 1):
            b[k + d][d] = torch.linalg.solve_triangular(
                lkk.mT, b[k + d][d], upper=True, left=False)
        l_lo = lkk.to(lo).to(pol.solve_dtype)
        for i in range(k + t, p):
            o[i][k] = torch.linalg.solve_triangular(
                l_lo.mT, o[i][k].to(pol.solve_dtype), upper=True,
                left=False).to(lo)
        c = torch.cat([b[k + d][d] for d in range(1, n_bp + 1)]
                      + [o[i][k].to(hi) for i in range(k + t, p)])
        u = syrk_ref.mp_syrk(c, tile=nb, round_k=nb, band_blocks=t, hi=hi,
                             lo=lo, accum=pol.accum_dtype)
        u4 = u.view(m_t, nb, m_t, nb)
        for a in range(m_t):
            for bb in range(a + 1):
                i, j = k + 1 + a, k + 1 + bb
                if i - j < t:
                    b[i][i - j] = b[i][i - j] - u4[a, :, bb, :]
                else:
                    o[i][j] = o[i][j] - u4[a, :, bb, :].to(lo)
    zero_b = band.new_zeros((nb, nb))
    return (torch.stack([torch.stack([b[i][d] if i >= d else zero_b
                                      for d in range(t)]) for i in range(p)]),
            torch.stack([torch.stack(o[i]) for i in range(p)]))


# ----------------------------------------------------------------------
# the plain tile-stack backward forms against autograd
# ----------------------------------------------------------------------

PAIRS = [(F32, F32), (F32, BF16), (F64, F64), (F64, F32)]


def _tile_locs(metric, dtype, p=4, nb=16):
    rng = np.random.default_rng(21)
    x = rng.uniform(size=(p * nb, 2))
    if metric == "haversine":
        x = np.stack([45 + 15 * x[:, 0], 22.5 + 12.5 * x[:, 1]], -1)
    return torch.tensor(x, dtype=dtype).reshape(p, nb, 2)


def _autograd_theta(locs_pairs, g_tiles, theta, nu, metric, dtype):
    """d/dtheta[:2] of sum_b sum G_b * C(a_b, b_b), the covariance the plain
    way (covariance/matern.py) under autograd, G read in the locations'
    precision."""
    th = torch.tensor([*theta, nu], dtype=dtype, requires_grad=True)
    total = sum(torch.sum(g.to(dtype) * matern_covariance(
        a, b, th, nu_static=nu, metric=metric))
        for (a, b), g in zip(locs_pairs, g_tiles))
    (grad,) = torch.autograd.grad(total, th)
    return grad[:2].double()


# fp32: the fp64 sums against autograd's fp32 ones (measured <= 2e-7 of the
# scale); fp64: sums in other orders
FORM_TOL = {F32: 1e-5, F64: 1e-12}


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
@pytest.mark.parametrize("metric", ["euclidean", "haversine"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "-".join(
    str(d).split(".")[-1] for d in p))
def test_plain_tile_forms_match_autograd(pair, metric, nu):
    """ref.matern_cov_grad_tiles over a band-like strided G (sub-diagonals 0
    and 1 of a (p, t, nb, nb) storage) and ref.matern_cov_grad_lower over an
    off-band G (p, p, nb, nb), min_lag 2, G in a storage dtype, against
    autograd of the plain covariance, within FORM_TOL of the scale (the
    same sums over |G|); fp64 results, the untouched tiles unread (NaN)."""
    ldt, gdt = pair
    lt = _tile_locs(metric, ldt)
    p, nb, _ = lt.shape
    theta = [1.0, 0.1] if metric == "euclidean" else [1.0, 2.0]
    gen = torch.Generator().manual_seed(5)
    band_g = torch.randn((p, 3, nb, nb), generator=gen, dtype=F64).to(gdt)
    band_g[:, 2] = torch.nan  # a sub-diagonal the calls do not read
    off_g = torch.randn((p, p, nb, nb), generator=gen, dtype=F64).to(gdt)
    lag = 2
    mask = (torch.arange(p)[:, None] - torch.arange(p)[None]) >= lag
    off_g[~mask] = torch.nan
    tol = FORM_TOL[ldt]
    for d in (0, 1):
        args = (lt[d:], lt[:p - d], theta)
        got = mc_ref.matern_cov_grad_tiles(*args, band_g[d:, d], nu=nu,
                                           metric=metric)
        scale = mc_ref.matern_cov_grad_tiles(*args, band_g[d:, d].abs(),
                                             nu=nu, metric=metric)
        want = _autograd_theta(list(zip(lt[d:], lt[:p - d])),
                               band_g[d:, d], theta, nu, metric, ldt)
        assert got.dtype == F64
        assert float(((got - want).abs() / scale).max()) <= tol
        via_ops = mc_ops.matern_cov_grad_tiles(*args, band_g[d:, d], nu=nu,
                                               metric=metric)
        assert torch.equal(via_ops, got)
    got = mc_ref.matern_cov_grad_lower(lt, theta, off_g, nu=nu, min_lag=lag,
                                       metric=metric)
    scale = mc_ref.matern_cov_grad_lower(lt, theta, off_g.abs(), nu=nu,
                                         min_lag=lag, metric=metric)
    pairs = [(i, j) for i in range(p) for j in range(p) if i - j >= lag]
    want = _autograd_theta([(lt[i], lt[j]) for i, j in pairs],
                           [off_g[i, j] for i, j in pairs], theta, nu, metric,
                           ldt)
    assert torch.isfinite(got).all()
    assert float(((got - want).abs() / scale).max()) <= tol
    assert torch.equal(mc_ops.matern_cov_grad_lower(
        lt, theta, off_g, nu=nu, min_lag=lag, metric=metric), got)


def test_banded_matern_cov_backward_sums_the_forms():
    """BandedMaternCov's backward is the fp64 sum of the zip form over each
    band sub-diagonal and the lower form over off (min_lag t), rounded once
    to theta's dtype; theta3 gets 0; the forward is the plain build's."""
    locs = torch.from_numpy(_data("unit", False)[0])
    pol = _port_policy(JP.tpu(2))
    build = functools.partial(tpc.build_banded_covariance, locs, nb=NB,
                              policy=pol, nu_static=1.5)
    th = torch.tensor([1.0, 0.1, 1.5], requires_grad=True)
    band, off = mc_ops.BandedMaternCov.apply(locs, th, build, 1.5,
                                             "euclidean", mc_ref)
    b0, o0 = build(torch.tensor([1.0, 0.1, 1.5]))
    assert torch.equal(band.detach(), b0) and torch.equal(off.detach(), o0)
    gen = torch.Generator().manual_seed(3)
    gb, go = torch.randn(band.shape, generator=gen), torch.randn(
        off.shape, generator=gen).to(BF16)
    (g,) = torch.autograd.grad((band, off), th, (gb, go))
    lt = locs.reshape(-1, NB, 2)
    p, t = band.shape[:2]
    want = mc_ref.matern_cov_grad_lower(lt, [1.0, 0.1], go, nu=1.5, min_lag=t)
    for d in range(t):
        want = want + mc_ref.matern_cov_grad_tiles(lt[d:], lt[:p - d],
                                                   [1.0, 0.1], gb[d:, d],
                                                   nu=1.5)
    assert torch.equal(g[:2], want.to(F32)) and g[2] == 0.0


# ----------------------------------------------------------------------
# the kernel wrappers without a card
# ----------------------------------------------------------------------

def test_grad_tile_wrappers_refuse_before_any_build(monkeypatch):
    """launch_grad_tiles and launch_grad_lower: a general nu raises in
    _two_nu, an unknown metric in _hav, a CPU tensor in the checks, all
    before the library is built and without a launch counted; haversine
    passes _two_nu."""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(mc_kernel, "library", no_build)
    lt = _tile_locs("haversine", F32)
    g = torch.zeros((4, 16, 16))
    reset_launch_counts()
    with pytest.raises(NotImplementedError, match="nu=1.3"):
        mc_kernel.launch_grad_tiles(lt, lt, [1.0, 2.0], g, nu=1.3,
                                    metric="haversine")
    with pytest.raises(ValueError, match="unknown metric"):
        mc_kernel.launch_grad_tiles(lt, lt, [1.0, 2.0], g, nu=0.5,
                                    metric="manhattan")
    with pytest.raises(ValueError, match="CUDA"):
        mc_kernel.launch_grad_tiles(lt, lt, [1.0, 2.0], g, nu=0.5,
                                    metric="haversine")
    with pytest.raises(ValueError, match="CUDA"):
        mc_kernel.launch_grad_lower(lt, [1.0, 2.0],
                                    torch.zeros((4, 4, 16, 16), dtype=BF16),
                                    nu=2.5, min_lag=1, metric="haversine")
    with pytest.raises(ValueError, match="fp32 or bf16"):
        mc_kernel.launch_grad_lower(lt, [1.0, 2.0],
                                    torch.zeros((4, 4, 16, 16), dtype=F64),
                                    nu=2.5, min_lag=1)
    assert sum(launch_counts().values()) == 0


# ----------------------------------------------------------------------
# chip_smoke.py's phase 13 arithmetic (it runs on the card only)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fp32_band,potrf", [(True, 64), (False, 0)])
def test_chip_smoke_panel_grad_launches(fp32_band, potrf):
    """One value-and-gradient evaluation at phase 4's p = 64, t = 8: the
    forward's 9 matern_cov launches (8 band sub-diagonals and the
    off-band) and as many backward ones, blocked_potrf per diagonal tile of
    an fp32 band, mp_syrk and mp_syrk_grad per step; with t = p (full
    precision) no off-band tile is computed and its backward launches
    nothing."""
    want = {"matern_cov": 9, "matern_cov_grad": 9, "blocked_potrf": potrf,
            "mp_syrk": 63, "mp_syrk_grad": 63, "mp_attention": 0}
    cs = _chip_smoke()
    assert cs.panel_grad_launches(64, 8, fp32_band) == want
    assert set(want) == set(launch_counts())
    assert cs.panel_grad_launches(4, 4, True)["matern_cov_grad"] == 4


@pytest.mark.parametrize("case,t", [("tpu(2)", 2), ("full(fp32)", 4)])
def test_chip_smoke_launch_arithmetic_is_the_engines_calls(case, t,
                                                           monkeypatch):
    """The calls one CPU value-and-gradient evaluation makes to the
    functions that launch on the card (the forward's matern_cov tile
    forms, their backward forms, mp_syrk_grad) are the counts
    panel_grad_launches gives for p = 4."""
    calls = dict.fromkeys(("matern_cov_tiles", "matern_cov_lower",
                           "matern_cov_grad_tiles", "matern_cov_grad_lower"),
                          0)
    for name in calls:
        fn = getattr(mc_ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mc_ops, name, counted)
    n_grad = [0]
    grad_fn = syrk_ops.mp_syrk_grad

    def counted_grad(*a, **k):
        n_grad[0] += 1
        return grad_fn(*a, **k)
    monkeypatch.setattr(syrk_ops, "mp_syrk_grad", counted_grad)
    _port(case)
    want = _chip_smoke().panel_grad_launches(N // NB, t, True)
    # the no-grad evaluation in _port makes the forward's calls again
    assert calls["matern_cov_tiles"] + calls["matern_cov_lower"] == \
        2 * want["matern_cov"]
    assert calls["matern_cov_grad_tiles"] + (
        calls["matern_cov_grad_lower"] if N // NB > t else 0) == \
        want["matern_cov_grad"]
    assert n_grad[0] == want["mp_syrk_grad"]


def test_chip_smoke_panel_grad_peaks():
    """The predicted peaks phase 13 (b) prints before each evaluation:
    tpu(8) at n = 65,536 ~39.4 GiB (the factor's 10, its cotangents' 10,
    step 0's dU 15.5 and mp_syrk_grad's packed bf16 tiles 3.9); the paper
    pair there ~78.8 GiB, past 70, so its n is cut to 61,440 (~69.6 GiB);
    at 49,152 ~45.6 GiB."""
    cs = _chip_smoke()
    assert cs.panel_grad_peak_gib(65_536, 1_024, 8, 4, 2) == pytest.approx(
        39.38, abs=0.01)
    assert cs.panel_grad_peak_gib(65_536, 1_024, 8, 8, 4) == pytest.approx(
        78.76, abs=0.01)
    assert cs.panel_grad_n(65_536, 1_024, 8, 8, 4, 70.0) == 61_440
    assert cs.panel_grad_peak_gib(61_440, 1_024, 8, 8, 4) <= 70.0
    assert cs.panel_grad_peak_gib(49_152, 1_024, 8, 8, 4) == pytest.approx(
        45.57, abs=0.01)
