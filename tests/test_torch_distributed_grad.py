"""The distributed engine's gradient (`repro_torch.core.distributed`):
`geostat_loglik_distributed` with a theta or z that requires grad against
`jax.value_and_grad` of `repro.core.distributed`, its three reverse sweeps
against `jax.vjp` of the reference's factorization and solve on the
reference's own storage, the gradient over gloo process grids of 1 to 4
ranks against the one-process call, and chip_smoke.py's phase 14 (d)
arithmetic.

Inputs: n = 96 points uniform on the unit square from a numpy seed and a
field drawn at (theta1, theta2) = (1, 0.1), nu = 0.5 (`_data`), nb = 16 (p = 6), band t = 2; full(fp32)
keeps every tile in the band (t = p, off all zero).  Gradient gaps are
|g_port - g_jax| / s_k per component, s_k = sum |G| dSigma/dtheta_k with G
the port's cotangent of the slabs (chip_smoke.distributed_grad_scale, the
plain versions here), as tests/test_torch_panel_grad.py takes them.

The JAX side is jitted and cached per module, and imported inside the
functions that run it: the gloo workers import this module by name, and
need only the port."""

import functools
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import interop
from repro_torch.core import PrecisionPolicy as P
from repro_torch.core import distributed as td
from repro_torch.core import panel_cholesky as tpc
from repro_torch.launch import costmodel
from repro_torch.launch.mesh import make_grid

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

N, NB, T = 96, 16, 2
THETA = (1.0, 0.1)
VERSIONS = td.VERSIONS
# name -> (the port's policy, the reference's constructor and its args,
# x64); the pair runs on fp64 inputs, its JAX side under jax.enable_x64
POLICIES = {"full": (P.full(torch.float32), "full", (), False),
            "tpu2": (P.tpu(T), "tpu", (T,), False),
            "paper2": (P.paper_cpu(T), "paper_cpu", (T,), True)}
LABELS = {"full": "full(fp32)", "tpu2": "tpu(2)", "paper2": "paper_cpu(2)"}


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """chip_smoke.py as a module (it imports nothing of JAX)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _data(x64):
    """(locs, z): N uniform locations (numpy seed 3) and a field drawn at
    THETA, nu = 0.5, with a 1e-6 nugget, in fp64, returned in fp64 or fp32
    (tests/test_torch_mle_adam.py's `_field`, which imports JAX)."""
    rng = np.random.default_rng(3)
    locs = rng.uniform(size=(N, 2))
    d = np.sqrt(((locs[:, None] - locs[None]) ** 2).sum(-1))
    cov = THETA[0] * np.exp(-d / THETA[1]) + 1e-6 * np.eye(N)
    z = np.linalg.cholesky(cov) @ rng.standard_normal(N)
    dt = np.float64 if x64 else np.float32
    return locs.astype(dt), z.astype(dt)


def _port_inputs(pol):
    locs, z = _data(POLICIES[pol][3])
    return torch.from_numpy(locs), torch.from_numpy(z)


def _jax_policy(pol):
    import jax.numpy as jnp
    from repro.core import PrecisionPolicy as JP
    _, ctor, args, _ = POLICIES[pol]
    return getattr(JP, ctor)(*args) if args else JP.full(jnp.float32)


# ----------------------------------------------------------------------
# the reverse sweeps against jax.vjp on the reference's storage
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_sweeps(pol, version):
    """The reference's storage at THETA, random cotangents of its factor
    (numpy, seed 5) and jax.vjp of its factorization under `version`; the
    factor's log-likelihood cotangents (g_ll = 1.3) by jax.vjp of its
    solve.  All as numpy (fp64 where the dtype allows)."""
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as jd
    x64 = POLICIES[pol][3]
    with jax.enable_x64(x64):
        jp = _jax_policy(pol)
        locs, z = (jnp.asarray(a) for a in _data(x64))
        theta = jnp.asarray([*THETA, 0.5], locs.dtype)
        off, band = jd.build_covariance_distributed(locs, theta, nb=NB,
                                                    policy=jp, nu_static=0.5)
        t = band.shape[1]
        rng = np.random.default_rng(5)
        g_off = jnp.asarray(rng.standard_normal(off.shape), off.dtype)
        g_band = jnp.asarray(rng.standard_normal(band.shape), band.dtype)

        @jax.jit
        def sweeps(off, band, g_off, g_band):
            factor, vjp = jax.vjp(lambda o, b: jd.panel_cholesky_distributed(
                o, b, jp, version=version), off, band)
            ll, vjp_ll = jax.vjp(lambda o, b, zz: jd.loglik_distributed(
                o, b, zz, t), *factor, z)
            return factor, vjp((g_off, g_band)), vjp_ll(
                jnp.asarray(1.3, ll.dtype))

        factor, (in_off, in_band), (s_off, s_band, s_z) = sweeps(
            off, band, g_off, g_band)
        f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
        return dict(off=np.asarray(off, np.float32 if not x64 else np.float64),
                    band=np.asarray(band), g_off=f64(g_off),
                    g_band=f64(g_band), in_off=f64(in_off),
                    in_band=f64(in_band), factor=tuple(map(np.asarray, factor)),
                    s_off=f64(s_off), s_band=f64(s_band), s_z=f64(s_z))


def _kept(t):
    """The (N, N) mask of off's tiles i - j >= t."""
    p = N // NB
    return np.kron(np.subtract.outer(np.arange(p), np.arange(p)) >= t,
                   np.ones((NB, NB))).astype(bool)


# element gaps over the array's largest |value|, measured (the same for
# every version): the factor's sweep 5.1e-3 / 6.0e-3 (off / band) under
# tpu(2) (a bf16 ulp of C's cotangent is 3.9e-3 of it: the reference's and
# the port's fp32 sums come in other orders before their roundings to
# bf16), 0 / 1.6e-6 full(fp32), 5.2e-7 / 5.8e-7 the pair; the solve's 4.4e-7
# / 5.9e-7 / 0 (z / band / off) under tpu(2), 3.3e-7 / 3.9e-7 full(fp32),
# 1.7e-15 / 1.3e-15 / 0 the pair.  In fp64 throughout (a mixed policy with
# hi = lo = fp64) both sweeps agree to 1e-14.
SWEEP_TOL = {"full": 2e-5, "tpu2": 2e-2, "paper2": 5e-6}
SOLVE_TOL = {"full": 1e-5, "tpu2": 1e-5, "paper2": 1e-12}


def _gap(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_factor_sweep_matches_jax_vjp(pol, version):
    """`panel_cholesky_distributed_backward` on the port's factor of the
    reference's storage against jax.vjp of the reference's factorization,
    element by element: the cotangents of off (every element: the tiles
    the sweep never reads pass theirs through, as the reference's masks
    do) and of the band."""
    policy = POLICIES[pol][0]
    run = _jax_sweeps(pol, version)
    lo = td._lo_dtype(policy)
    off, band = interop.distributed_from_numpy(run["off"], run["band"], lo=lo,
                                               version=version, device="cpu")
    off, band = td.panel_cholesky_distributed(off, band, policy,
                                              version=version)
    g_off = torch.tensor(run["g_off"]).to(lo)
    g_band = torch.tensor(run["g_band"]).to(policy.hi)
    got_off, got_band = td.panel_cholesky_distributed_backward(
        off, band, g_off, g_band, policy, version=version)
    assert got_off.dtype == lo and got_band.dtype == policy.hi
    assert _gap(got_off.double(), run["in_off"]) <= SWEEP_TOL[pol]
    assert _gap(got_band.double(), run["in_band"]) <= SWEEP_TOL[pol]


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_solve_sweep_matches_jax_vjp(pol):
    """`loglik_distributed_backward` on the reference's factor against
    jax.vjp of its solve at g_ll = 1.3: z's cotangent, the band's (L_jj's
    lower triangle, the reference's solve reads no other), off's on its
    tiles i - j >= t; the port's is 0 on the others, which no theta reaches
    (the reference's is -v_i w_j^T there too)."""
    policy = POLICIES[pol][0]
    run = _jax_sweeps(pol, "masked_full")
    lo = td._lo_dtype(policy)
    off, band = interop.distributed_from_numpy(*run["factor"], lo=lo,
                                               device="cpu")
    t = band.shape[1]
    _, z = _port_inputs(pol)
    ll, w = td._solve(off, band, z, t, grid=None, version="masked_full",
                      n=None)
    g_off, g_band, v = td.loglik_distributed_backward(
        off, band, w, torch.tensor(1.3, dtype=ll.dtype), t)
    assert _gap(v.double(), run["s_z"]) <= SOLVE_TOL[pol]
    assert _gap(g_band.double(), run["s_band"]) <= SOLVE_TOL[pol]
    kept = _kept(t)
    got = g_off.double().numpy()
    if kept.any():
        assert _gap(got[kept], run["s_off"][kept]) <= SOLVE_TOL[pol]
    assert not got[~kept].any()
    _, _, v_only = td.loglik_distributed_backward(
        off, band, w, torch.tensor(1.3, dtype=ll.dtype), t, storage=False)
    assert torch.equal(v_only, v)


@pytest.mark.parametrize("pol", ["tpu2", "paper2"])
def test_build_backward_reads_only_the_kept_tiles(pol):
    """`build_covariance_distributed_backward` with random cotangents,
    nonzero on off's tiles i - j < t too: the same bits as with those tiles
    zeroed (the forward wrote 0 there), and near autograd through the plain
    covariance in fp64 over the kept tiles and the band: 1e-12 for the
    pair's fp64 locations, 1e-6 for fp32 ones, whose terms the backward
    takes in fp32 as the forward does (measured 8.6e-8)."""
    from repro_torch.covariance.matern import matern_covariance
    policy = POLICIES[pol][0]
    locs, _ = _port_inputs(pol)
    off, band = td.build_covariance_distributed(locs, [*THETA, 0.5], nb=NB,
                                                policy=policy)
    rng = np.random.default_rng(6)
    g_off = torch.tensor(rng.standard_normal(off.shape)).to(off.dtype)
    g_band = torch.tensor(rng.standard_normal(band.shape)).to(band.dtype)
    t = band.shape[1]
    kept = torch.from_numpy(_kept(t))
    got = td.build_covariance_distributed_backward(
        locs, [*THETA, 0.5], g_off.clone(), g_band, nb=NB, policy=policy)
    masked = td.build_covariance_distributed_backward(
        locs, [*THETA, 0.5], g_off * kept, g_band, nb=NB, policy=policy)
    assert torch.equal(got, masked)
    th = torch.tensor([*THETA, 0.5], dtype=torch.float64, requires_grad=True)
    loc64 = locs.double()
    total = (matern_covariance(loc64, loc64, th, nu_static=0.5)
             * (g_off.double() * kept)).sum()
    p = N // NB
    tiles = loc64.view(p, NB, 2)
    for d in range(t):
        total = total + (matern_covariance(tiles[d:], tiles[:p - d], th,
                                           nu_static=0.5)
                         * g_band[d:, d].double()).sum()
    (want,) = torch.autograd.grad(total, th)
    rtol = 1e-12 if pol == "paper2" else 1e-6
    assert np.allclose(got.numpy(), want[:2].numpy(), rtol=rtol, atol=0)


def test_sweeps_pass_gradcheck_in_fp64():
    """The whole chain -- build, factorization and solve under a mixed
    policy with hi = lo = fp64 and t = 2 -- against finite differences in
    theta and z (torch.autograd.gradcheck), on one process and p = 4."""
    pol = P(mode="mixed", hi=torch.float64, lo=torch.float64, diag_thick=2,
            solve_dtype=torch.float64, accum_dtype=torch.float64)
    locs, z = (torch.from_numpy(a[:32]) for a in _data(True))
    theta = torch.tensor([*THETA, 0.5], dtype=torch.float64,
                         requires_grad=True)
    z = z.clone().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda th, zz: td.geostat_loglik_distributed(
            locs, zz, th, nb=8, policy=pol, impl="plain"), (theta, z),
        eps=1e-6, atol=1e-6, rtol=1e-5)


def test_pair_gradient_leaves_dense_fp64_by_its_fp32_storage():
    """The engine's theta gradient against dense full(fp64)'s
    (`make_loglik`) over s_k: under a mixed policy with hi = lo = fp64 and
    t = 2 within 1e-15 (measured 6.7e-17), so the adjoint adds nothing of
    its own; under the pair, whose off-band tiles and lo update are fp32,
    within 1e-8 (measured 4.1e-9), a million times that: phase 14 (d.3)'s
    gap to 10.1's dense gradient is the pair's rounding."""
    from repro_torch.core import make_loglik
    locs, z = _port_inputs("paper2")
    th0 = [*THETA, 0.5]

    def grad(fn):
        th = torch.tensor(th0, dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(fn(th), th)
        return g[:2].numpy()
    dense = grad(make_loglik(locs, z, P.full(torch.float64), nu_static=0.5,
                             impl="plain"))
    all64 = P(mode="mixed", hi=torch.float64, lo=torch.float64, diag_thick=T,
              solve_dtype=torch.float64, accum_dtype=torch.float64)
    for pol, tol in ((all64, 1e-15), (POLICIES["paper2"][0], 1e-8)):
        got = grad(lambda th: td.geostat_loglik_distributed(
            locs, z, th, nb=NB, policy=pol, impl="plain"))
        scale = np.array(_chip_smoke().distributed_grad_scale(
            locs, z, pol, th0, NB, impl="plain"))
        assert (np.abs(got - dense) / scale).max() <= tol


# ----------------------------------------------------------------------
# ll and its gradients against jax.value_and_grad
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(pol, version, nu, theta=THETA):
    """(ll, theta's gradient, z's gradient) of the reference's
    geostat_loglik_distributed, as fp64 numpy."""
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as jd
    x64 = POLICIES[pol][3]
    with jax.enable_x64(x64):
        jp = _jax_policy(pol)
        locs, z = (jnp.asarray(a) for a in _data(x64))
        f = jax.jit(jax.value_and_grad(
            lambda th, zz: jd.geostat_loglik_distributed(
                locs, zz, th, nb=NB, policy=jp, nu_static=nu,
                version=version), argnums=(0, 1)))
        v, (gt, gz) = f(jnp.asarray([*theta, nu], locs.dtype), z)
        return float(v), np.asarray(gt, np.float64), np.asarray(gz, np.float64)


def _port_value_and_grad(pol, version, nu, impl="plain", grid=None,
                         theta=THETA):
    """(ll tensor with its graph, theta's gradient, z's gradient, ll
    without autograd) of the port."""
    locs, z = _port_inputs(pol)
    policy = POLICIES[pol][0]
    kw = dict(nb=NB, policy=policy, nu_static=nu, version=version, grid=grid,
              impl=impl)
    th = torch.tensor([*theta, nu], dtype=locs.dtype, requires_grad=True)
    zz = z.clone().requires_grad_()
    ll = td.geostat_loglik_distributed(locs, zz, th, **kw)
    g_th, g_z = torch.autograd.grad(ll, (th, zz))
    with torch.no_grad():
        ll0 = td.geostat_loglik_distributed(locs, z, th.detach(), **kw)
    return ll, g_th.double().numpy(), g_z.double().numpy(), ll0


@functools.lru_cache(maxsize=None)
def _scale(pol, nu, theta=THETA):
    locs, z = _port_inputs(pol)
    return np.array(_chip_smoke().distributed_grad_scale(
        locs, z, POLICIES[pol][0], [*theta, nu], NB, nu, impl="plain"))


# ll relative, z's gradient over its largest |value|, measured at nu = 0.5
# (every version alike): ll 1.9e-5 full(fp32), 1.1e-6 tpu(2), 2.2e-9 the
# pair (the port's Sigma takes differences where the reference's norm
# expansion loses near distances, ROADMAP C 19, which a smoother Sigma
# magnifies: SMOOTH_TOL); z 1.7e-3, 7.2e-4, 3.5e-7 (z's cotangent is
# Sigma^-1 z, which carries C 19's difference).  The theta gradient's gap
# over s_k, measured 8.0e-8 full(fp32), 6.5e-5 tpu(2) (within its bf16
# cotangent roundings, ROADMAP C 13: the reference's own masked_full and
# fori differ by that much on one storage), 3.0e-9 the pair: GRAD_TOL.
LL_TOL = {"full": 1e-4, "tpu2": 1e-5, "paper2": 1e-8}
GRAD_TOL = {"full": 5e-6, "tpu2": 2e-4, "paper2": 1e-7}
Z_TOL = {"full": 1e-2, "tpu2": 3e-3, "paper2": 2e-6}
# the smoother kernels at theta2 = 0.03, as the panel engine's tests take
# them (at 0.1 the field is too smooth for tpu(2) at nu = 2.5: NaN in both
# packages): (ll relative, gap over s_k, z relative), measured (1.2e-5,
# 3.3e-5, 9.0e-3) full(fp32) nu = 1.5, (7.8e-5, 2.0e-5, 1.1e-2) 2.5; (2.4e-6,
# 1.2e-4, 4.2e-4) tpu(2) 1.5, (5.0e-6, 4.5e-5, 5.8e-4) 2.5; (1.7e-9,
# 5.2e-9, 1.4e-7) the pair 1.5, (4.6e-8, 1.7e-8, 5.8e-7) 2.5
SMOOTH = (1.0, 0.03)
SMOOTH_TOL = {("full", 1.5): (1e-4, 2e-4, 3e-2),
              ("full", 2.5): (5e-4, 2e-4, 5e-2),
              ("tpu2", 1.5): (2e-5, 5e-4, 3e-3),
              ("tpu2", 2.5): (5e-5, 5e-4, 3e-3),
              ("paper2", 1.5): (1e-8, 1e-7, 2e-6),
              ("paper2", 2.5): (5e-7, 1e-7, 5e-6)}
# every version of the port against the reference's fori (one backward
# serves the port's versions; the reference's fori compiles fastest), and
# under tpu(2) against its masked_full as well
GRAD_CASES = ([(pol, v, 0.5, THETA) for pol in sorted(POLICIES)
               for v in VERSIONS]
              + [(pol, "masked_full", nu, SMOOTH) for pol in sorted(POLICIES)
                 for nu in (1.5, 2.5)])


@pytest.mark.parametrize("pol,version,nu,theta", GRAD_CASES)
def test_value_and_grad_matches_jax(pol, version, nu, theta):
    """ll, its gradient in theta (theta3 zero under a half-integer nu_static
    in both) and in z against jax.value_and_grad of the reference; under
    tpu(2) the theta gradient within the gap of both the reference's fori
    and masked_full; ll with autograd the same bits as without; the graph
    through the engine's three Functions."""
    ll, g_th, g_z, ll0 = _port_value_and_grad(pol, version, nu, theta=theta)
    assert torch.equal(ll.detach(), ll0)
    assert {"DistributedMaternCovBackward", "DistributedCholeskyBackward",
            "DistributedLoglikBackward"} <= _graph(ll)
    v, gt, gz = _jax_value_and_grad(pol, "fori", nu, theta)
    assert np.isfinite(g_th).all() and g_th[2] == 0.0 and gt[2] == 0.0
    tol_ll, tol, tol_z = SMOOTH_TOL.get((pol, nu), (
        LL_TOL[pol], GRAD_TOL[pol], Z_TOL[pol]))
    assert abs(float(ll.detach()) - v) <= tol_ll * abs(v)
    scale = _scale(pol, nu, theta)
    wants = [gt]
    if pol == "tpu2" and nu == 0.5:
        wants.append(_jax_value_and_grad(pol, "masked_full", nu, theta)[1])
    for want in wants:
        gap = np.abs(g_th[:2] - want[:2]) / scale
        assert gap.max() <= tol, (gap, g_th, want)
    assert _gap(g_z, gz) <= tol_z


def _graph(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo += [f for f, _ in node.next_functions]
    return {type(node).__name__ for node in seen}


def test_versions_share_one_gradient():
    """The port's versions factor to the same bits in one process, and one
    backward serves them: the same ll and gradient bits."""
    runs = [_port_value_and_grad("tpu2", v, 0.5) for v in VERSIONS]
    for ll, g_th, g_z, _ in runs[1:]:
        assert torch.equal(ll.detach(), runs[0][0].detach())
        assert np.array_equal(g_th, runs[0][1])
        assert np.array_equal(g_z, runs[0][2])


@pytest.mark.parametrize("which", ["theta", "z", "both"])
def test_autograd_leaves_ll_alone(which):
    """ll has the same bits with autograd on theta, on z or on both as
    without; theta alone gives the gradient the pair gives, z alone the
    same z gradient."""
    locs, z = _port_inputs("tpu2")
    kw = dict(nb=NB, policy=P.tpu(T))
    th = torch.tensor([*THETA, 0.5], requires_grad=which != "z")
    zz = z.clone().requires_grad_(which != "theta")
    ll = td.geostat_loglik_distributed(locs, zz, th, **kw)
    want = td.geostat_loglik_distributed(locs, z, [*THETA, 0.5], **kw)
    assert ll.requires_grad and torch.equal(ll.detach(), want)
    grads = torch.autograd.grad(ll, [x for x in (th, zz) if x.requires_grad])
    _, g_th, g_z, _ = _port_value_and_grad("tpu2", "masked_full", 0.5)
    if which != "z":
        assert np.array_equal(grads[0].double().numpy(), g_th)
    if which != "theta":
        assert np.array_equal(grads[-1].double().numpy(), g_z)


def test_kernel_impl_is_the_plain_on_the_cpu():
    """impl="kernel" on CPU tensors runs the plain versions (the ops
    dispatch by device), forward and backward: the same bits as
    impl="plain"."""
    a = _port_value_and_grad("paper2", "aligned", 0.5, impl="kernel")
    b = _port_value_and_grad("paper2", "aligned", 0.5, impl="plain")
    assert torch.equal(a[0].detach(), b[0].detach())
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])


def test_refuses_locations_that_require_grad():
    locs, z = _port_inputs("tpu2")
    with pytest.raises(NotImplementedError, match="C 26"):
        td.geostat_loglik_distributed(
            locs.requires_grad_(), z, torch.tensor([*THETA, 0.5],
                                                   requires_grad=True),
            nb=NB, policy=P.tpu(T))


# ----------------------------------------------------------------------
# process grids over gloo
# ----------------------------------------------------------------------

# world size -> its grids; every version under tpu(2) and the pair
WORLDS = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 3: [(3, 1), (1, 3)], 4: [(2, 2)]}
GRID_POLICIES = ("tpu2", "paper2")
# a grid of more than one rank sums C's, L_kk's and w's cotangents over its
# ranks (rows split: the D^T c_lo products and w's pushes; columns split:
# D c_lo, the band shares' products), in another order than one process's
# single sums, so the gradient moves by the last bits of those sums, not
# only where the grid splits columns (measured over s_k: at most 4.5e-9
# tpu(2), 1.3e-9 the pair, whose C cotangents sum in fp32; z relative to
# its largest 2.2e-7, 1.3e-16); ll keeps its bits (the forward's grids)
GRID_GRAD_TOL = {"tpu2": 5e-8, "paper2": 2e-8}
GRID_Z_TOL = {"tpu2": 2e-6, "paper2": 1e-14}


def _mirror_grid_groups(dims, size):
    """The `new_group` calls `make_grid(*dims, group=...)` makes over ranks
    0 .. size - 1, for a process outside them (every process of the default
    group makes them, in the same order)."""
    data, model = dims
    ranks = list(range(size))
    for members in ([ranks[r * model:(r + 1) * model] for r in range(data)]
                    + [ranks[c::model] for c in range(model)]):
        if len(members) != size:
            dist.new_group(members, backend="gloo")


def _grid_worker(rank, path):
    """One process of a gloo world of max(WORLDS) ranks: each world size's
    grids over ranks 0 .. size - 1 (one spawn: a process's start is most
    of a small world's time)."""
    torch.set_num_threads(1)
    size_all = max(WORLDS)
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=size_all)
    out = []
    for world in sorted(WORLDS):
        group = dist.new_group(list(range(world))) if world < size_all \
            else dist.group.WORLD
        for dims in WORLDS[world]:
            if rank >= world:
                _mirror_grid_groups(dims, world)
                continue
            grid = make_grid(*dims, group=group)
            for pol in GRID_POLICIES:
                for v in VERSIONS:
                    ll, g_th, g_z, ll0 = _port_value_and_grad(pol, v, 0.5,
                                                              grid=grid)
                    out.append(dict(world=world, dims=dims, pol=pol,
                                    version=v, ll=ll.item(), ll0=ll0.item(),
                                    g_th=g_th, g_z=g_z))
                scale = _chip_smoke().distributed_grad_scale(
                    *_port_inputs(pol), POLICIES[pol][0], [*THETA, 0.5], NB,
                    grid=grid, impl="plain")
                out[-1]["scale"] = scale
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """world size -> each of its ranks' cases."""
    path = str(tmp_path_factory.mktemp("gloo_grad"))
    size_all = max(WORLDS)
    mp.spawn(_grid_worker, args=(path,), nprocs=size_all)
    outs = [torch.load(os.path.join(path, f"rank{r}.pt"), weights_only=False)
            for r in range(size_all)]
    return {w: [[c for c in out if c["world"] == w] for out in outs[:w]]
            for w in WORLDS}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_grid_gradient_matches_one_process(world, grid_runs):
    """Every rank returns the same ll, theta gradient and z gradient, ll
    the same bits with and without autograd and as the forward's grids
    keep it; on the 1 x 1 grid the gradients are the one-process call's
    bits, on the others within GRID_GRAD_TOL over s_k (GRID_Z_TOL of z's
    largest gradient); s_k, summed over the grid's slabs, within 1e-8 of
    one process's (measured 3.2e-10)."""
    from test_torch_distributed import GRID_LL_REL
    runs = grid_runs[world]
    for idx, case in enumerate(runs[0]):
        for out in runs[1:]:
            got = out[idx]
            assert got["ll"] == case["ll"]
            assert np.array_equal(got["g_th"], case["g_th"])
            assert np.array_equal(got["g_z"], case["g_z"])
            assert got.get("scale") == case.get("scale")
        assert case["ll"] == case["ll0"]
        if "scale" in case:
            np.testing.assert_allclose(case["scale"], _scale(case["pol"], 0.5),
                                       rtol=1e-8)
        pol = case["pol"]
        ll, g_th, g_z, _ = _port_value_and_grad(pol, case["version"], 0.5)
        if case["dims"] == (1, 1):
            assert case["ll"] == ll.item()
            assert np.array_equal(case["g_th"], g_th)
            assert np.array_equal(case["g_z"], g_z)
            continue
        assert abs(case["ll"] - ll.item()) <= GRID_LL_REL[pol] * abs(ll.item())
        gap = np.abs(case["g_th"][:2] - g_th[:2]) / _scale(pol, 0.5)
        assert gap.max() <= GRID_GRAD_TOL[pol], (case["dims"], gap)
        assert _gap(case["g_z"], g_z) <= GRID_Z_TOL[pol]
        assert math.isfinite(case["ll"])


# ----------------------------------------------------------------------
# chip_smoke.py's phase 14 (d) arithmetic (it runs on the card only)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_chip_smoke_launches_under_grad_are_the_engines_calls(pol,
                                                              monkeypatch):
    """The calls one CPU value-and-gradient evaluation makes to the
    functions that launch on the card (matern_cov's tile form, its
    backward's tile form, the POTRF of an fp32 band) are the counts
    chip_smoke's distributed_launches(..., grad=True) gives."""
    from repro_torch.kernels.matern_cov import ops as mc_ops
    calls = {"matern_cov": 0, "matern_cov_grad": 0, "blocked_potrf": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(mc_ops, "matern_cov_tiles",
                        counted("matern_cov", mc_ops.matern_cov_tiles))
    monkeypatch.setattr(mc_ops, "matern_cov_grad_tiles",
                        counted("matern_cov_grad",
                                mc_ops.matern_cov_grad_tiles))
    matern, potrf, syrk = tpc._IMPLS["kernel"]
    monkeypatch.setitem(tpc._IMPLS, "kernel",
                        (matern, counted("blocked_potrf", potrf), syrk))
    policy = POLICIES[pol][0]
    locs, z = _port_inputs(pol)
    th = torch.tensor([*THETA, 0.5], dtype=locs.dtype, requires_grad=True)
    torch.autograd.grad(td.geostat_loglik_distributed(
        locs, z, th, nb=NB, policy=policy), th)
    p = N // NB
    want = _chip_smoke().distributed_launches(
        p, min(policy.diag_thick, p), policy.hi == torch.float32, grad=True)
    assert {k: want[k] for k in calls} == calls
    assert sum(want.values()) == sum(calls.values())


def test_chip_smoke_distributed_grad_peaks():
    """distributed_grad_peak_gib: the reverse sweep's step 0 decides -- the
    slabs and their cotangents (2 (n^2 lo + p t nb^2 hi)) and the band
    updates' moment over the n x nb panel column (c_lo in lo, three hi
    buffers, three accumulator sums) -- 21.625 GiB for geostat_65k under
    tpu(8) with the card's bf16 product; 13.953125 GiB for the pair at
    38,912 under DP(10%) (t = 2); on a CPU (an fp32-upcast product) the lo
    update's two upcast operands join the other moment."""
    gib, col = 2 ** 30, 65_536 * 1_024
    storage = 65_536 ** 2 * 2 + 64 * 8 * 1_024 ** 2 * 4
    a = costmodel.distributed_grad_peak_gib(65_536, 1_024, 8, 4, 2, 2)
    assert a * gib == 2 * storage + col * (2 + 3 * 4 + 3 * 4)
    assert a == 21.625
    col = 38_912 * 1_024
    storage = 38_912 ** 2 * 4 + 38 * 2 * 1_024 ** 2 * 8
    b = costmodel.distributed_grad_peak_gib(38_912, 1_024, 2, 8, 4, 4)
    assert b * gib == 2 * storage + col * (4 + 3 * 8 + 3 * 4)
    assert b == 13.953125
    col = 96 * 16
    assert costmodel.distributed_grad_peak_gib(96, 16, 2, 4, 2, 4) * gib == (
        2 * (96 ** 2 * 2 + 6 * 2 * 16 ** 2 * 4)
        + max(col * (2 + 3 * 4 + 3 * 4), col * (2 + 3 * 4) + 2 * col * 4))
    # the gradient's peak is never under the forward's
    for args in ((65_536, 1_024, 8, 4, 2, 2), (40_960, 1_024, 2, 8, 4, 4)):
        assert (costmodel.distributed_grad_peak_gib(*args)
                >= costmodel.distributed_peak_gib(*args))
