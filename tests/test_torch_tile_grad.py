"""The tile engine's gradient through its kernels' autograd Functions:
`mp_syrk_grad`'s plain version against autograd through the plain
`mp_syrk`, `MpSyrk` and `Potrf` against finite differences, `Potrf`'s
backward against autograd through the plain `potrf`, the tile engine with
impl="kernel" (on the CPU: the plain forwards and backwards through both
Functions) against `jax.value_and_grad` of the JAX `make_loglik`, the
panel engine's refusal of a theta that requires grad, and chip_smoke.py's
phase 10.3 arithmetic.

The engine cases reuse tests/test_torch_mle_adam.py's inputs: n = 128
uniform points from a numpy seed, a field drawn at (1, 0.1), nu = 0.5,
nb = 32 (p = 4)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrecisionPolicy as JP
from repro_torch.core import PrecisionPolicy, geostat_loglik_step
from repro_torch.core import likelihood as tlik
from repro_torch.core.tile_cholesky import _Assemble, _Cut
from repro_torch.core.panel_cholesky import _cholesky
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.blocked_potrf import ops as potrf_ops
from repro_torch.kernels.blocked_potrf import ref as potrf_ref
from repro_torch.kernels.matern_cov import ref as mc_ref
from repro_torch.kernels.mp_gemm import ops as syrk_ops
from repro_torch.kernels.mp_gemm import ref as syrk_ref
from test_torch_mle_adam import NB, _chip_smoke, _field, _value_and_grads
from test_torch_panel import _port_policy

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
PAIRS = [(F32, BF16, F32), (F32, F32, F32), (F64, F32, F32), (F64, F64, F64)]


def _lower_tiles(m, tile):
    t = torch.arange(m) // tile
    return t[:, None] >= t[None, :]


# ----------------------------------------------------------------------
# mp_syrk's backward
# ----------------------------------------------------------------------

def _autograd_syrk_grad(du, p, tile, kw):
    """dP by autograd through ref.mp_syrk from dU's lower tiles."""
    low = torch.where(_lower_tiles(p.shape[0], tile), du, 0)
    pr = p.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        syrk_ref.mp_syrk(pr, round_k=p.shape[1], **kw), pr, low)
    return want


@pytest.mark.parametrize("band", [1, 2, 3])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "-".join(
    str(d).split(".")[-1] for d in p))
def test_mp_syrk_grad_matches_autograd_through_ref(pair, band):
    """ref.mp_syrk_grad(dU) against autograd through ref.mp_syrk with dU's
    lower tiles (the upper ones are nonzero here and must be ignored: the
    same bits as with them zeroed), within chip_smoke.syrk_grad_err's
    tolerance, the one phase 10.3 (a) holds the kernel to: the band's hi
    sums to 1e-6 (fp32) or 1e-13 (fp64) of the band's scale, the
    off-band's fp32 sums to 1e-6 of its own scale and its rounding to lo to
    one lo ulp of its value (measured up to 0.25 of the tolerance).  Then a
    dU that is zero off the band, the same check (measured <= 0.25), which
    the plain version with that band in lo fails (measured 29.6 to 1.2e6
    times the tolerance)."""
    hi, lo, accum = pair
    tile, n_t, k = 32, 5, 32
    m = tile * n_t
    gen = torch.Generator().manual_seed(band)
    p = torch.randn((m, k), generator=gen, dtype=hi)
    du = torch.randn((m, m), generator=gen, dtype=hi)
    kw = dict(tile=tile, band_blocks=band, hi=hi, lo=lo, accum=accum)
    want = _autograd_syrk_grad(du, p, tile, kw)
    got = syrk_ref.mp_syrk_grad(du, p, **kw)
    assert got.dtype == hi and got.shape == p.shape
    low = torch.where(_lower_tiles(m, tile), du, 0)
    assert torch.equal(got, syrk_ref.mp_syrk_grad(low, p, **kw))
    cs = _chip_smoke()
    ratio, _ = cs.syrk_grad_err(got, want, du, p, tile, band, pair)
    assert ratio <= 1.0, ratio
    # the public function under autograd: MpSyrk, whose backward is it
    pr = p.clone().requires_grad_(True)
    u = syrk_ops.mp_syrk(pr, round_k=k, **kw)
    assert type(u.grad_fn).__name__ == "MpSyrkBackward"
    (via_ops,) = torch.autograd.grad(u, pr, du)
    assert torch.equal(via_ops, got)
    # the band alone, and a band in lo against it
    g = cs.band_only(du.clone(), tile, band)
    want = _autograd_syrk_grad(g, p, tile, kw)
    ratio, _ = cs.syrk_grad_err(syrk_ref.mp_syrk_grad(g, p, **kw), want, g,
                                p, tile, band, pair)
    assert ratio <= 1.0, ratio
    if lo != hi:
        lo_band = syrk_ref.mp_syrk_grad(g, p, **dict(kw, band_blocks=0))
        ctrl, _ = cs.syrk_grad_err(lo_band, want, g, p, tile, band, pair)
        assert ctrl > 1.0, ctrl


def test_mp_syrk_function_gradcheck():
    """MpSyrk under the all-fp64 pair against finite differences, on U's
    lower tiles (the only ones its backward reads), with band_blocks = 1 so
    that off-band tiles take the lo branch (fp64 here)."""
    tile, n_t, k = 4, 3, 4
    low = _lower_tiles(tile * n_t, tile)
    kw = dict(tile=tile, round_k=k, band_blocks=1, hi=F64, lo=F64,
              accum=F64)
    p = torch.randn((tile * n_t, k), generator=torch.Generator().manual_seed(3),
                    dtype=F64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: syrk_ops.MpSyrk.apply(x, kw, False) * low, (p,))


# ----------------------------------------------------------------------
# POTRF's backward
# ----------------------------------------------------------------------

def _spd_tiles(dtype, indefinite=False):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 24, 24))
    a = a @ a.transpose(0, 2, 1) + 24 * np.eye(24)
    if indefinite:
        a[1, 9, 9] = -1.0
    return torch.tensor(a, dtype=dtype)


def test_potrf_function_gradcheck():
    """Potrf with an fp64 forward (the paper pair's band: _cholesky in fp64)
    against finite differences, on the symmetric part of its input."""
    a = _spd_tiles(F64).requires_grad_(True)
    factor = functools.partial(_cholesky, dtype=F64)
    assert torch.autograd.gradcheck(
        lambda x: potrf_ops.Potrf.apply(0.5 * (x + x.mT), factor)[0], (a,))


def test_potrf_backward_matches_autograd_through_ref():
    """potrf on tiles that require grad goes through Potrf; its backward
    gives what autograd through ref.potrf gives, bit for bit (the same
    torch ops).  A tile that is not positive definite: info != 0, a NaN
    factor and a NaN gradient (autograd through ref.potrf gives that tile
    a zero gradient, torch.where masking it, but its NaN factor makes the
    log-likelihood and every gradient in theta NaN either way)."""
    a = _spd_tiles(F32, indefinite=True)
    gl = torch.randn(a.shape, generator=torch.Generator().manual_seed(9))
    got_a = a.clone().requires_grad_(True)
    l, info = potrf_ops.potrf(got_a)
    assert type(l.grad_fn).__name__ == "PotrfBackward"
    assert not info.requires_grad and info.tolist()[1] != 0
    want_a = a.clone().requires_grad_(True)
    l_ref, info_ref = potrf_ref.potrf(want_a)
    assert torch.equal(info, info_ref)
    assert torch.equal(l.detach().nan_to_num(), l_ref.detach().nan_to_num())
    (got,) = torch.autograd.grad(l, got_a, gl)
    (want,) = torch.autograd.grad(l_ref, want_a, gl)
    ok = info == 0
    assert torch.equal(got[ok], want[ok])
    assert torch.isnan(got[1]).all() and torch.isfinite(got[ok]).all()


# ----------------------------------------------------------------------
# the engine's cuts and assembly: one gradient tensor each
# ----------------------------------------------------------------------

BLOCKS = [(0, 4, 0, 4), (4, 8, 0, 2), (4, 8, 2, 8)]


@pytest.mark.parametrize("which", ["cut views", "cut copies", "assemble"])
def test_cut_and_assemble_match_slicing(which):
    """tile_cholesky's _Cut (Sigma's runs as copies, each step's U blocks
    as views) and _Assemble (L from the runs) give the values and
    gradients of slices and slice assignments, bit for bit."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 8, 8), generator=gen, dtype=F64)
    gs = [torch.randn((2, r1 - r0, c1 - c0), generator=gen, dtype=F64)
          for r0, r1, c0, c1 in BLOCKS]
    dts = [F64] * 3 if which == "cut views" else [F32, F64, BF16]
    if which == "assemble":
        pieces = [g.to(dt).requires_grad_(True) for g, dt in zip(gs, dts)]
        out = _Assemble.apply((2, 8, 8), F64, BLOCKS, *pieces)
        want = torch.zeros((2, 8, 8), dtype=F64)
        for (r0, r1, c0, c1), piece in zip(BLOCKS, pieces):
            want[..., r0:r1, c0:c1] = piece.detach()
        assert torch.equal(out.detach(), want)
        got = torch.autograd.grad(out, pieces, x)
        for (r0, r1, c0, c1), piece, g in zip(BLOCKS, pieces, got):
            assert torch.equal(g, x[..., r0:r1, c0:c1].to(piece.dtype))
        return
    views = which == "cut views"
    cuts = []
    for x_in in (x.clone().requires_grad_(True),
                 x.clone().requires_grad_(True)):
        if not cuts:
            outs = _Cut.apply(x_in, BLOCKS, None if views else dts)
        else:  # the same by slices
            outs = [x_in[..., r0:r1, c0:c1] if views
                    else x_in[..., r0:r1, c0:c1].to(dt)
                    for (r0, r1, c0, c1), dt in zip(BLOCKS, dts)]
        assert [o.dtype for o in outs] == dts
        (g,) = torch.autograd.grad(outs, x_in, [g.to(dt)
                                                for g, dt in zip(gs, dts)])
        cuts.append(([o.detach() for o in outs], g))
    (got, got_g), (want, want_g) = cuts
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got_g, want_g)


# ----------------------------------------------------------------------
# the tile engine through both Functions against jax.value_and_grad
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def data32():
    return _field(0, 128, np.float32)


@pytest.fixture(scope="module")
def data64():
    return _field(0, 128, np.float64)


def _same_ll_with_and_without_grad(jp, theta, locs, z):
    """The kernel-impl log-likelihood with autograd and without, bit for
    bit; returns the one with its graph."""
    fn = tlik.make_loglik(torch.from_numpy(locs), torch.from_numpy(z),
                          _port_policy(jp), nb=NB, nu_static=0.5,
                          use_tiles=True)
    th = torch.tensor(theta, requires_grad=True)
    ll = fn(th)
    with torch.no_grad():
        ll0 = fn(torch.tensor(theta))
    assert torch.equal(ll.detach(), ll0)
    return ll


def _g_scale(jp, theta, locs, z):
    """s_k = sum |G| dSigma/dtheta_k with G = dl/dSigma of the port's tile
    engine: the scale of the terms each gradient sums (ROADMAP C 13)."""
    lt = torch.from_numpy(locs)
    cov = tlik.build_covariance(lt, theta, nu_static=0.5, jitter=1e-6,
                                impl="plain").requires_grad_(True)
    ll = tlik.loglik_from_factor(tlik.tile_cholesky(
        cov, NB, _port_policy(jp), impl="plain"), torch.from_numpy(z))
    (g_cov,) = torch.autograd.grad(ll, cov)
    return mc_ref.matern_cov_grad(lt, lt, list(theta[:2]), g_cov.abs(),
                                  nu=0.5).double().numpy()


# (JAX policy, x64, tolerance on |g_port - g_jax| / s_k), measured:
# tiled full(fp32) 3.95e-8, paper_cpu(2) 3.07e-9 and paper_cpu(3) 1.57e-9
# (under x64), the fp32 sums of the two in other orders; tpu(2) 3.11e-5,
# the bf16 cotangent-rounding gap of ROADMAP C 13, under tpu(1)'s 1e-4
ENGINE_CASES = {
    "full(fp32)": (lambda: JP.full(jnp.float32), False, 5e-7),
    "tpu(2)": (lambda: JP.tpu(2), False, 1e-4),
    "paper_cpu(2)": (lambda: JP.paper_cpu(2), True, 2e-8),
    "paper_cpu(3)": (lambda: JP.paper_cpu(3), True, 2e-8),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_tile_engine_gradient_through_the_functions(case, data32, data64):
    make_jp, x64, tol = ENGINE_CASES[case]
    locs, z = data64 if x64 else data32
    theta = np.array([1.0, 0.1, 0.5], np.float64 if x64 else np.float32)
    with jax.enable_x64(x64):
        jp = make_jp()
        ll = _same_ll_with_and_without_grad(jp, theta, locs, z)
        v, g, llp, gp = _value_and_grads(jp, theta, locs, z, impl="kernel",
                                         nu_static=0.5, use_tiles=True)
    # an fp32 band's POTRF is the blocked_potrf wrapper's; an fp64 band's
    # cholesky_ex, which autograd differentiates itself
    potrf_node = ("PotrfBackward" if jp.hi == jnp.float32
                  else "LinalgCholeskyExBackward0")
    assert {type(n).__name__ for n in _graph(ll)} >= {"MpSyrkBackward",
                                                      potrf_node}
    assert llp == float(ll.detach()) and np.isfinite(gp).all() and gp[2] == 0.0
    assert abs(llp - v) <= 1e-5 * abs(v)
    gap = np.abs(gp[:2] - g[:2]) / _g_scale(jp, theta, locs, z)
    assert gap.max() <= tol, gap


def _graph(t):
    """Every node of t's autograd graph."""
    seen, todo = [], [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.append(node)
        todo += [f for f, _ in node.next_functions]
    return seen


def test_tile_engine_launches_nothing_on_the_cpu(data32):
    locs, z = data32
    reset_launch_counts()
    _value_and_grads(JP.tpu(2), np.array([1.0, 0.1, 0.5], np.float32), locs,
                     z, impl="kernel", nu_static=0.5)
    assert sum(launch_counts().values()) == 0


# ----------------------------------------------------------------------
# the panel engine refuses a theta that requires grad
# ----------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_geostat_loglik_step_refuses_grad(impl):
    """n = 256, nb = 64, tpu(2): a theta that requires grad raised only on
    the card with impl="kernel"; on the CPU the same call came back as a
    number without a graph (requires_grad False).  Now a theta, locs or z
    that requires grad raises on every device and for both impls; without
    grad mode the same call runs."""
    locs, z = (torch.from_numpy(x) for x in _field(2, 256, np.float32))
    th = torch.tensor([1.0, 0.1, 0.5])
    call = functools.partial(geostat_loglik_step, nb=64,
                             policy=PrecisionPolicy.tpu(2), nu_static=0.5,
                             impl=impl)
    grad = lambda x: x.clone().requires_grad_(True)  # noqa: E731
    for args in ((locs, z, grad(th)), (grad(locs), z, th),
                 (locs, grad(z), th)):
        with pytest.raises(NotImplementedError,
                           match="panel engine's gradient"):
            call(*args)
        with torch.no_grad():
            assert torch.isfinite(call(*args))


# ----------------------------------------------------------------------
# chip_smoke.py's phase 10.3 arithmetic (it runs on the card only)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fp32_band,potrf", [(True, 40), (False, 0)])
def test_chip_smoke_tile_grad_launches(fp32_band, potrf):
    """One value-and-gradient evaluation at p = 40: matern_cov and its
    backward once, blocked_potrf per diagonal tile of an fp32 band (0 for
    the paper pair's fp64 band), mp_syrk and mp_syrk_grad per step."""
    want = {"matern_cov": 1, "matern_cov_grad": 1, "blocked_potrf": potrf,
            "mp_syrk": 39, "mp_syrk_grad": 39, "mp_attention": 0}
    assert _chip_smoke().tile_grad_launches(40, fp32_band) == want
    assert set(want) == set(launch_counts())


def test_chip_smoke_syrk_grad_bound():
    """mp_syrk_grad at the tile path's step 0 (39 tile rows of 1,024, band
    2): 2 m^2 k = 3.27e12 flops, 115 band tiles; the paper pair's bound is
    its fp32 off-band at 67 TFLOP/s (45.07 ms; the fp64 band's 3.7 ms runs
    on the tensor cores beside it), the bf16 pair's its fp32 band (3.69
    ms), above its bytes."""
    cs = _chip_smoke()
    band, off = cs.syrk_grad_flops(39, 1024, 2)
    assert band + off == 2 * (39 * 1024) ** 2 * 1024
    assert band == 2 * 1024 ** 3 * 115
    ms, by = cs.syrk_grad_bound(39, 1024, 2, (F64, F32, F32))
    assert by == "operations" and ms == pytest.approx(45.07, abs=0.01)
    ms, by = cs.syrk_grad_bound(39, 1024, 2, (F32, BF16, F32))
    assert by == "operations" and ms == pytest.approx(3.69, abs=0.01)


# the kernels of one mp_syrk_grad call as the profiler named them on the
# card (demangled, cut as device_profile's rows are not), and kernels of
# the forward that must not count
PROFILED = {
    "void (anonymous namespace)::mp_syrk_grad_diag_kernel<float>(float "
    "const*, float*, int, int)": "prepass",
    "void (anonymous namespace)::mp_syrk_grad_lo_tiles_kernel<float, "
    "__nv_bfloat16>(float const*, __nv_bfloat16*, int, int, int, long long)":
        "prepass",
    "void (anonymous namespace)::mp_syrk_grad_lo_p_kernel<double, float, "
    "false>(double const*, float*, int, int)": "prepass",
    "void (anonymous namespace)::mp_syrk_grad_offband_wgmma_kernel<128, "
    "128>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float*, int, int, "
    "int, int)": "offband",
    "void (anonymous namespace)::mp_syrk_grad_fp32_kernel<128, 128, true>("
    "float const*, float const*, float const*, void*, int, int, int, int, "
    "int)": "offband",
    "void (anonymous namespace)::mp_syrk_grad_fp32_kernel<128, 128, false>("
    "float const*, float const*, float const*, void*, int, int, int, int, "
    "int)": "band",
    "void (anonymous namespace)::mp_syrk_grad_dmma_kernel<128, 128>(double "
    "const*, double const*, double const*, double*, int, int, int, int, int)":
        "band",
    "void (anonymous namespace)::syrk_band_lower_kernel<128>(float const*, "
    "float*, int, int, (anonymous namespace)::Grid)": None,
    "void (anonymous namespace)::to_fp32_kernel(double2 const*, float2*, "
    "long long)": None,
    "void (anonymous namespace)::syrk_band_f64_dmma_kernel<128>(double "
    "const*, double*, int, int, (anonymous namespace)::Grid)": None,
    "Memcpy DtoD (Device -> Device)": None,
}


def test_chip_smoke_syrk_grad_kernel_names(tmp_path):
    """chip_smoke.py's profile sums for mp_syrk_grad (10.3 (a)'s classes,
    10.3 (b)'s mp_syrk_grad_device_ms) take every kernel of the call and
    no other, and its ptxas / SASS facts name every kernel: the
    SYRK_GRAD_KERNELS tuple is exactly the __global__ mp_syrk_grad_*
    kernels of csrc/mp_syrk.cu."""
    import re
    from pathlib import Path
    cs = _chip_smoke()
    rows = [(name, 1, float(i + 1)) for i, name in enumerate(PROFILED)]
    classes, total = cs.syrk_grad_device_ms(rows)
    want = {c: sum(ms for (name, _, ms) in rows if PROFILED[name] == c)
            for c in ("prepass", "offband", "band")}
    assert classes == want and total == sum(want.values()) == 28.0
    for name, cls in PROFILED.items():
        assert cs.syrk_grad_class(name) == cls
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "csrc" / "mp_syrk.cu").read_text()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                         r"(mp_syrk_grad_\w+_kernel)\(", src)
    assert sorted(kernels) == sorted(cs.SYRK_GRAD_KERNELS)
    # the build's ptxas keys, one per instantiation, typed
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124mp_"
           "syrk_grad_fp32_kernelILi128ELi128ELb1EEEvPKfS2_S2_Pviiiii' for "
           "'sm_90a'\nptxas info    : Function properties for x\n    0 bytes "
           "stack frame, 0 bytes spill stores, 0 bytes spill loads\nptxas "
           "info    : Used 243 registers\n")
    path = tmp_path / "nvcc.log"
    path.write_text(log)
    usage = cs.ptxas_usage(path, cs.SYRK_GRAD_KERNELS, typed=True)
    assert usage == {"mp_syrk_grad_fp32_kernel<128,128,1>": {
        "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 243}}


@pytest.mark.parametrize("case", ["tpu(2)", "full(fp32)", "paper_cpu(2)"])
def test_chip_smoke_grad_scale_is_the_leaf_scale(case, data32, data64):
    """10.3 (b)'s scale s_k = sum |G| dSigma/dtheta_k takes G by a hook
    during the backward, so that Sigma is freed as in the evaluation; it
    equals, bit for bit, G taken with Sigma held as a leaf."""
    from repro_torch.core import build_covariance, loglik_from_factor
    from repro_torch.core import tile_cholesky
    from repro_torch.kernels.matern_cov import ops as mc_ops
    make_jp, x64, _ = ENGINE_CASES[case]
    locs, z = (torch.from_numpy(x) for x in (data64 if x64 else data32))
    with jax.enable_x64(x64):
        pol = _port_policy(make_jp())
    theta = [1.0, 0.1, 0.5]
    cov = build_covariance(locs, theta, nu_static=0.5, jitter=1e-6,
                           dtype=pol.hi).requires_grad_(True)
    (g,) = torch.autograd.grad(
        loglik_from_factor(tile_cholesky(cov, NB, pol), z), cov)
    want = mc_ops.matern_cov_grad(locs, locs, theta, g.abs(), nu=0.5).tolist()
    assert _chip_smoke()._grad_scale(locs, z, pol, theta, NB) == want
