"""The distributed panel engine (`repro_torch.core.distributed`) against
`repro.core.distributed` at the reference tests' size (n = 256, nb = 32,
p = 8, t = 2): the storage each builds, the factor and log-likelihood of
each version on the same storage, the reference's own four checks, the
engine over gloo process grids of 1 to 4 ranks against the one-process call,
and its refusals.

The JAX side is imported inside the functions that run it: the gloo
workers import this module by name, and need only the port."""

import dataclasses
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
from repro_torch.launch.mesh import grid_num_ranks, make_grid, make_smoke_grid
from repro_torch.launch import costmodel

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)

N, NB, T = 256, 32, 2
THETA = [1.0, 0.1, 0.5]
VERSIONS = td.VERSIONS
# name -> (the port's policy, the reference's constructor and its args);
# the pair runs on fp64 inputs, its JAX side under jax.enable_x64(True)
POLICIES = {"tpu2": (P.tpu(T), "tpu", (T,)),
            "full": (P.full(torch.float32), "full", ()),
            "paper2": (P.paper_cpu(T), "paper_cpu", (T,))}
MANTISSA = {torch.bfloat16: 8, torch.float32: 24, torch.float64: 53}
EPS = {torch.float32: 2.0 ** -23, torch.float64: 2.0 ** -52}


@pytest.fixture(scope="module")
def data(small_dataset):
    return np.array(small_dataset.locs), np.array(small_dataset.z)


def _inputs(pol, data):
    """(locs, z) as numpy in the policy's input precision: fp64 for the
    pair, fp32 otherwise."""
    dt = np.float64 if pol == "paper2" else np.float32
    return tuple(np.ascontiguousarray(a, dt) for a in data)


@functools.lru_cache(maxsize=None)
def _jax_run(pol, locs_bytes, z_bytes):
    """The reference on one policy: the storage it builds, and for each
    version the factored storage and the log-likelihood of that storage."""
    import jax
    import jax.numpy as jnp
    from repro.core import PrecisionPolicy as JP
    from repro.core import distributed as jd
    _, ctor, args = POLICIES[pol]
    dt = np.float64 if pol == "paper2" else np.float32
    with jax.enable_x64(pol == "paper2"):
        jp = getattr(JP, ctor)(*args) if args else JP.full(jnp.float32)
        locs = jnp.asarray(np.frombuffer(locs_bytes, dt).reshape(-1, 2))
        z = jnp.asarray(np.frombuffer(z_bytes, dt))
        theta = jnp.asarray(THETA, dt)
        off, band = jd.build_covariance_distributed(locs, theta, nb=NB,
                                                    policy=jp, nu_static=0.5)
        t = band.shape[1]
        out = {"built": (np.array(off, np.float32 if pol != "paper2"
                                  else np.float64), np.array(band))}
        for v in VERSIONS:
            off_f, band_f = jd.panel_cholesky_distributed(off, band, jp,
                                                          version=v)
            ll = jd.loglik_distributed(off_f, band_f, z, t)
            out[v] = (np.array(off_f, np.float64), np.array(band_f),
                      float(ll))
    return out


def _jax(pol, data):
    locs, z = _inputs(pol, data)
    return _jax_run(pol, locs.tobytes(), z.tobytes())


def _ulp(x, dtype):
    return np.ldexp(1.0, np.frexp(np.abs(x))[1] - MANTISSA[dtype])


def _norm_expansion_slack(la, lb, hi):
    """What the reference's distance, |a|^2 + |b|^2 - 2 a.b in hi, can lose
    to cancellation: d^2 off by up to 4 eps (|a|^2 + |b|^2), so d by
    sqrt(d^2 + that) - d, and a value of the exponential kernel by theta1 /
    theta2 times that (its slope is at most theta1 / theta2).  At d = 0 the
    reference's own distance need not be 0 (measured: band diagonal
    elements 4.9e-3 under 1.0)."""
    la, lb = np.asarray(la, np.float64), np.asarray(lb, np.float64)
    d2 = ((la[:, None] - lb[None]) ** 2).sum(-1)
    delta = 4 * EPS[hi] * ((la ** 2).sum(-1)[:, None] + (lb ** 2).sum(-1)[None])
    return THETA[0] / THETA[1] * (np.sqrt(d2 + delta) - np.sqrt(d2))


# ---------------------------------------------------------------------
# parity with repro.core.distributed
# ---------------------------------------------------------------------

@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_build_matches_jax(pol, data):
    """off and band elementwise: one storage ulp of the reference's value
    plus what its norm-expansion distance can lose (the port's matern_cov
    takes differences, as its kernel does)."""
    policy = POLICIES[pol][0]
    locs, _ = _inputs(pol, data)
    want_off, want_band = _jax(pol, data)["built"]
    off, band = td.build_covariance_distributed(torch.from_numpy(locs), THETA,
                                                nb=NB, policy=policy)
    lo, hi = off.dtype, policy.hi
    assert off.shape == want_off.shape and band.shape == want_band.shape
    assert band.dtype == hi and str(want_band.dtype) == str(hi).split(".")[1]
    err = np.abs(off.double().numpy() - want_off)
    slack = _norm_expansion_slack(locs, locs, hi)
    assert np.all(err <= _ulp(want_off, lo) + slack)
    p = N // NB
    locs_t = locs.reshape(p, NB, 2)
    for i in range(p):
        for d in range(min(T if policy.mode != "full" else p, i + 1)):
            got = band[i, d].double().numpy()
            want = want_band[i, d].astype(np.float64)
            bound = _ulp(want, hi) + _norm_expansion_slack(locs_t[i],
                                                           locs_t[i - d], hi)
            assert np.all(np.abs(got - want) <= bound), (i, d)


# the factor of the same storage, port against reference, and the
# log-likelihood: the same arithmetic in other libraries, whose fp32 sums
# in other orders flip lo roundings; measured max |diff| (off / band)
# 3.1e-5 / 1.3e-5 under tpu2, 0 / 3.1e-7 full(fp32), 3.0e-7 / 8.3e-8 the
# pair; ll 1.1e-7, 0 and 5.7e-9 relative (the pair's fp32 off-band sums:
# test_torch_paper_pair.py's PAPER2_FLOOR_REL, 5e-8)
FACTOR_TOL = {"tpu2": (1e-3, 1e-4), "full": (1e-5, 1e-6),
              "paper2": (1e-5, 1e-6)}
LL_REL = {"tpu2": 1e-5, "full": 1e-6, "paper2": 5e-8}


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_factor_and_loglik_match_jax(pol, version, data):
    policy = POLICIES[pol][0]
    run = _jax(pol, data)
    off, band = interop.distributed_from_numpy(*run["built"], lo=td._lo_dtype(policy),
                                               version=version, device="cpu")
    off, band = td.panel_cholesky_distributed(off, band, policy,
                                              version=version)
    want_off, want_band, want_ll = run[version]
    rtol, atol = FACTOR_TOL[pol]
    np.testing.assert_allclose(off.double().numpy(), want_off, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(band.double().numpy(), want_band, rtol=rtol,
                               atol=atol)
    _, z = _inputs(pol, data)
    ll = float(td.loglik_distributed(off, band, torch.from_numpy(z),
                                     band.shape[1]))
    assert abs(ll - want_ll) <= LL_REL[pol] * abs(want_ll)


def test_versions_give_the_same_bits_in_one_process(data):
    """masked_full and fori are one arithmetic on one layout here; aligned
    computes fewer rows of U, each the same product."""
    locs, z = (torch.from_numpy(a) for a in _inputs("tpu2", data))
    lls = [td.geostat_loglik_distributed(locs, z, THETA, nb=NB, policy=P.tpu(T),
                                         version=v) for v in VERSIONS]
    assert lls[0].dtype == torch.float32 and lls[0].shape == ()
    assert lls[0].item() == lls[1].item() == lls[2].item()


# ---------------------------------------------------------------------
# the reference's own checks (tests/test_distributed_geostat.py)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("version", VERSIONS)
def test_distributed_matches_banded(version, data):
    locs, z = (torch.from_numpy(a) for a in _inputs("tpu2", data))
    pol = P.tpu(T)
    ll = float(td.geostat_loglik_distributed(locs, z, THETA, nb=NB, policy=pol,
                                             version=version))
    ll_ref = float(tpc.geostat_loglik_step(locs, z, THETA, nb=NB, policy=pol,
                                           nu_static=0.5))
    assert ll == pytest.approx(ll_ref, abs=1.0)


@pytest.mark.parametrize("version", VERSIONS)
def test_distributed_band_region_is_zero_in_off(version, data):
    locs, _ = _inputs("tpu2", data)
    off, _ = td.build_covariance_distributed(torch.from_numpy(locs), THETA,
                                             nb=NB, policy=P.tpu(T),
                                             version=version)
    o = off.float().numpy()
    p = N // NB
    for i in range(p):
        for j in range(p):
            blk = o[i * NB:(i + 1) * NB, j * NB:(j + 1) * NB]
            if i - j >= T:
                assert np.abs(blk).max() > 0
            else:
                assert np.abs(blk).max() == 0


def test_distributed_full_policy_matches_dense(data):
    from repro_torch.core import (build_covariance, loglik_from_factor,
                                  reference_cholesky)
    locs, z = (torch.from_numpy(a) for a in _inputs("full", data))
    pol = P.full(torch.float32)
    ll = float(td.geostat_loglik_distributed(locs, z, THETA, nb=NB, policy=pol))
    cov = build_covariance(locs, THETA, nu_static=0.5, jitter=1e-6,
                           dtype=torch.float32)
    ll_dense = float(loglik_from_factor(reference_cholesky(cov), z))
    assert ll == pytest.approx(ll_dense, abs=0.5)


def test_distributed_two_thetas_are_finite_and_differ(data):
    locs, z = (torch.from_numpy(a) for a in _inputs("tpu2", data))
    v1, v2 = (float(td.geostat_loglik_distributed(
        locs, z, th, nb=NB, policy=P.tpu(T))) for th in
        (THETA, [v * 1.1 for v in THETA]))
    assert np.isfinite(v1) and np.isfinite(v2) and v1 != v2


# ---------------------------------------------------------------------
# process grids over gloo
# ---------------------------------------------------------------------

# world size -> its grids; every version runs on each (fori: rows over
# every rank), under tpu(2) and the pair; 1 x 3 splits each band tile's 32
# rows unevenly (11, 11, 10)
WORLDS = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 3: [(3, 1), (1, 3)], 4: [(2, 2)]}
GRID_POLICIES = ("tpu2", "paper2")
# a grid that splits the columns sums each block's residual over its grid
# row in another order, which can move ll by its last bits (measured 0 on
# this field under both policies); the factor the same bits on every grid
GRID_LL_REL = {"tpu2": 1e-6, "paper2": 1e-13}


def _grid_worker(rank, world, path, locs_by_pol, z_by_pol):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=world)
    out = []
    for dims in WORLDS[world]:
        grid = make_grid(*dims)
        for pol in GRID_POLICIES:
            policy = POLICIES[pol][0]
            locs, z = (torch.from_numpy(a) for a in
                       (locs_by_pol[pol], z_by_pol[pol]))
            for v in VERSIONS:
                off, band = td.build_covariance_distributed(
                    locs, THETA, nb=NB, policy=policy, grid=grid, version=v)
                built = (tuple(off.shape), tuple(band.shape))
                off, band = td.panel_cholesky_distributed(
                    off, band, policy, version=v, grid=grid, n=N)
                ll = td.loglik_distributed(off, band, z, band.shape[1],
                                           grid=grid, version=v, n=N)
                lay = td.layout(N // NB, grid, v)
                out.append(dict(dims=dims, pol=pol, version=v, ll=ll.item(),
                                built=built, rows=lay.rows, cols=lay.cols,
                                band_rows=lay.band_rows(NB),
                                off=off.double().numpy(),
                                band=band.double().numpy()))
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _grid_run(world, path, locs_bytes, z_bytes):
    locs = {p: np.frombuffer(locs_bytes, np.float32).reshape(-1, 2).astype(
        np.float64 if p == "paper2" else np.float32) for p in GRID_POLICIES}
    z = {p: np.frombuffer(z_bytes, np.float32).astype(
        np.float64 if p == "paper2" else np.float32) for p in GRID_POLICIES}
    mp.spawn(_grid_worker, args=(world, path, locs, z), nprocs=world)
    return [torch.load(os.path.join(path, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@functools.lru_cache(maxsize=None)
def _one_process(pol, version, locs_bytes, z_bytes):
    dt = np.float64 if pol == "paper2" else np.float32
    locs = torch.from_numpy(np.frombuffer(locs_bytes, np.float32).reshape(
        -1, 2).astype(dt))
    z = torch.from_numpy(np.frombuffer(z_bytes, np.float32).astype(dt))
    policy = POLICIES[pol][0]
    off, band = td.build_covariance_distributed(locs, THETA, nb=NB,
                                                policy=policy, version=version)
    off, band = td.panel_cholesky_distributed(off, band, policy,
                                              version=version)
    ll = td.loglik_distributed(off, band, z, band.shape[1], version=version)
    return off.double().numpy(), band.double().numpy(), ll.item()


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_grid_matches_one_process(world, data, tmp_path_factory):
    """Every rank holds exactly its slab of off and, of the band tiles of
    its row slab, its share of their rows (`test_band_rows_split_over_the_
    grid_row`), replicas of a slab hold the same bits, every rank returns
    the same ll, and the gathered factor is the one-process factor bit for
    bit; ll too where the grid does not split columns."""
    locs, z = data[0].tobytes(), data[1].tobytes()
    path = str(tmp_path_factory.mktemp(f"gloo{world}"))
    runs = _grid_run(world, path, locs, z)
    for idx, case in enumerate(runs[0]):
        want_off, want_band, want_ll = _one_process(case["pol"],
                                                    case["version"], locs, z)
        off = np.full((N, N), np.nan)
        band = np.full_like(want_band, np.nan)
        for r, out in enumerate(runs):
            got = out[idx]
            (ra, rb), (ca, cb), (s0, s1) = (got["rows"], got["cols"],
                                            got["band_rows"])
            shape = ((rb - ra) * NB, (cb - ca) * NB), (rb - ra, T, s1 - s0, NB)
            assert got["built"] == shape and (got["off"].shape,
                                              got["band"].shape) == shape
            for whole, part, sl in ((off, got["off"], np.s_[ra * NB:rb * NB,
                                                           ca * NB:cb * NB]),
                                    (band, got["band"], np.s_[ra:rb, :,
                                                              s0:s1])):
                prev = whole[sl]
                assert np.isnan(prev).all() or np.array_equal(prev, part)
                whole[sl] = part
            assert got["ll"] == case["ll"], (r, case["dims"], case["version"])
        assert not np.isnan(off).any() and not np.isnan(band).any()
        assert np.array_equal(off, want_off) and np.array_equal(band, want_band)
        if case["dims"][1] == 1 or case["version"] == "fori":
            assert case["ll"] == want_ll
        else:
            assert abs(case["ll"] - want_ll) <= GRID_LL_REL[case["pol"]] * abs(
                want_ll)
        assert math.isfinite(case["ll"])


@pytest.mark.parametrize("world", [2, 3, 4])
def test_band_rows_split_over_the_grid_row(world, data, tmp_path_factory):
    """Under masked_full and aligned a rank at (r, c) holds (rb - ra, t,
    nb_c, nb) of the band: its row slab's tiles, of each its share of the nb
    rows, the first shares a row larger (32 over 2 grid columns: 16 + 16;
    over 3: 11 + 11 + 10); the shares of a grid row are disjoint and cover
    the nb rows.  Under fori each rank holds whole tiles."""
    locs, z = data[0].tobytes(), data[1].tobytes()
    path = str(tmp_path_factory.mktemp(f"gloo{world}"))
    runs = _grid_run(world, path, locs, z)
    want_shares = {1: [(0, NB)], 2: [(0, 16), (16, 32)],
                   3: [(0, 11), (11, 22), (22, 32)]}
    seen = 0
    for idx, case in enumerate(runs[0]):
        data_, model = case["dims"]
        if model == 1:
            continue
        split = case["version"] != "fori"
        rows = {}
        for out in runs:
            got = out[idx]
            (ra, rb), (s0, s1) = got["rows"], got["band_rows"]
            assert got["built"][1] == (rb - ra, T, s1 - s0, NB)
            rows.setdefault((ra, rb), []).append((s0, s1))
        for shares in rows.values():
            assert sorted(shares) == (want_shares[model] if split
                                      else [(0, NB)])
            assert sum(b - a for a, b in shares) == NB
        seen += 1
    assert seen == 2 * len(VERSIONS) * sum(m > 1 for _, m in WORLDS[world])


@pytest.mark.parametrize("dims", [(1, 2), (2, 2), (1, 3)])
def test_interop_slices_a_ranks_band_rows(dims, data):
    """`interop.distributed_from_numpy` gives each grid position the slabs
    the engine builds there: off's (rows, columns) slab, the band tiles of
    its row slab and of each its share of the rows."""
    locs, _ = _inputs("tpu2", data)
    pol = P.tpu(T)
    off, band = td.build_covariance_distributed(torch.from_numpy(locs), THETA,
                                                nb=NB, policy=pol)
    base = make_smoke_grid()
    for q in range(dims[0] * dims[1]):
        grid = dataclasses.replace(base, data=dims[0], model=dims[1],
                                   ranks=tuple(range(dims[0] * dims[1])),
                                   rank=q)
        for v in VERSIONS:
            lay = td.layout(N // NB, grid, v)
            (ra, rb), (ca, cb), (s0, s1) = lay.rows, lay.cols, lay.band_rows(NB)
            o, b = interop.distributed_from_numpy(
                off.float().numpy(), band.numpy(), lo="bfloat16", grid=grid,
                version=v, device="cpu")
            assert b.shape == (rb - ra, T, s1 - s0, NB)
            assert torch.equal(b, band[ra:rb, :, s0:s1])
            assert torch.equal(o, off[ra * NB:rb * NB, ca * NB:cb * NB])


def test_smoke_grid_is_one_process_without_a_group():
    grid = make_smoke_grid()
    assert grid_num_ranks(grid) == 1 and grid.group is None
    assert grid.backend is None and grid.row_groups == grid.col_groups == (None,)


def test_slabs_are_whole_tiles_the_first_ones_larger():
    assert td.slab_bounds(8, 3) == ((0, 3), (3, 6), (6, 8))
    assert td.slab_bounds(8, 4) == ((0, 2), (2, 4), (4, 6), (6, 8))
    with pytest.raises(ValueError):
        td.slab_bounds(2, 3)


@pytest.mark.parametrize("dims,version,rows,cols", [
    ((2, 2), "masked_full", (2, 2), (2, 2)),
    ((2, 2), "aligned", (2, 2), (2, 2)),
    ((2, 2), "fori", (4,), (1,)),
    ((3, 1), "masked_full", (3, 3, 3), (1, 1, 1)),
    ((1, 3), "fori", (3,), (1,)),
])
def test_layout_follows_the_rules(dims, version, rows, cols):
    """LAYOUT_RULES: off's rows over "data" and columns over "model", or
    rows over both for fori; grid position q = r * model + c."""
    base = make_smoke_grid()
    for q in range(dims[0] * dims[1]):
        grid = dataclasses.replace(base, data=dims[0], model=dims[1],
                                   ranks=tuple(range(dims[0] * dims[1])),
                                   rank=q)
        lay = td.layout(8, grid, version)
        r, c = divmod(q, dims[1])
        assert len(lay.row_bounds) == rows[0] and len(lay.col_bounds) == cols[0]
        want_ir = q if version == "fori" else r
        want_ic = 0 if version == "fori" else c
        assert (lay.ir, lay.ic) == (want_ir, want_ic)


# ---------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------

def test_refuses_locations_that_require_grad(data):
    locs, z = (torch.from_numpy(a) for a in _inputs("tpu2", data))
    with pytest.raises(NotImplementedError, match="C 26"):
        td.geostat_loglik_distributed(locs.requires_grad_(), z, THETA, nb=NB,
                                      policy=P.tpu(T))


@pytest.mark.parametrize("nu", [1.0, 0.25, None])
def test_refuses_a_nu_without_closed_form(nu, data):
    locs, _ = _inputs("tpu2", data)
    with pytest.raises(ValueError, match="half-integer"):
        td.build_covariance_distributed(torch.from_numpy(locs), THETA, nb=NB,
                                        policy=P.tpu(T), nu_static=nu)


def test_refuses_a_device_the_backend_does_not_take(data):
    """A CPU tensor under an NCCL grid raises before any collective (the
    card checks a CUDA tensor under gloo: chip_smoke.py phase 14 (a))."""
    locs, z = (torch.from_numpy(a) for a in _inputs("tpu2", data))
    grid = dataclasses.replace(make_smoke_grid(), backend="nccl")
    with pytest.raises(ValueError, match="nccl"):
        td.geostat_loglik_distributed(locs, z, THETA, nb=NB, policy=P.tpu(T),
                                      grid=grid)
    off, band = td.build_covariance_distributed(locs, THETA, nb=NB,
                                                policy=P.tpu(T))
    with pytest.raises(ValueError, match="nccl"):
        td.panel_cholesky_distributed(off, band, P.tpu(T), grid=grid)


def test_refuses_an_unknown_version_and_a_missing_order(data):
    locs, z = (torch.from_numpy(a) for a in _inputs("tpu2", data))
    with pytest.raises(ValueError, match="version"):
        td.geostat_loglik_distributed(locs, z, THETA, nb=NB, policy=P.tpu(T),
                                      version="square")
    off, band = td.build_covariance_distributed(locs, THETA, nb=NB,
                                                policy=P.tpu(T))
    grid = dataclasses.replace(make_smoke_grid(), data=2, ranks=(0, 1))
    with pytest.raises(ValueError, match="n "):
        td.panel_cholesky_distributed(off, band, P.tpu(T), grid=grid)


def test_lo_product_is_lo_matmul_on_the_cpu():
    from repro_torch.core import lo_matmul
    g = torch.Generator().manual_seed(0)
    a = torch.randn(96, NB, generator=g).bfloat16()
    b = torch.randn(160, NB, generator=g).bfloat16()
    pol = P.tpu(T)
    assert torch.equal(td.lo_product(a, b, pol), lo_matmul(a, b.T, pol))


# ---------------------------------------------------------------------
# chip_smoke.py's phase 14 arithmetic (it runs on the card only)
# ---------------------------------------------------------------------

def _chip_smoke():
    from test_torch_mle_adam import _chip_smoke as load
    return load()


@pytest.mark.parametrize("pol", ["tpu2", "paper2", "full"])
def test_chip_smoke_distributed_launches_are_the_engines_calls(pol, data,
                                                                monkeypatch):
    """The calls one CPU evaluation makes to the functions that launch on
    the card (matern_cov's tile form; the POTRF of an fp32 band) are the
    counts chip_smoke's distributed_launches gives."""
    from repro_torch.kernels.matern_cov import ops as mc_ops
    calls = {"matern_cov": 0, "blocked_potrf": 0}
    tiles = mc_ops.matern_cov_tiles

    def counted_tiles(*a, **k):
        calls["matern_cov"] += 1
        return tiles(*a, **k)
    monkeypatch.setattr(mc_ops, "matern_cov_tiles", counted_tiles)
    matern, potrf, syrk = tpc._IMPLS["kernel"]

    def counted_potrf(a):
        calls["blocked_potrf"] += 1
        return potrf(a)
    monkeypatch.setitem(tpc._IMPLS, "kernel", (matern, counted_potrf, syrk))
    policy = POLICIES[pol][0]
    locs, z = (torch.from_numpy(a) for a in _inputs(pol, data))
    td.geostat_loglik_distributed(locs, z, THETA, nb=NB, policy=policy)
    p = N // NB
    want = _chip_smoke().distributed_launches(p, min(policy.diag_thick, p),
                                              policy.hi == torch.float32)
    assert {k: want[k] for k in calls} == calls
    assert sum(want.values()) == sum(calls.values())


def test_chip_smoke_distributed_peaks():
    """The phase's predicted peaks: off (n^2 lo) and the band (p t nb^2
    hi), and the largest of a step's moments, which the engine never
    overlaps: the lo update's c_lo and one row chunk of U (4 tile rows at
    65,536, 6 at 40,960) in its product's dtype (and in lo where that
    differs) decides in each case: 10.625 GiB for geostat_65k under tpu(8)
    with the card's bf16 product, 7.96875 GiB for the pair at 40,960 under
    paper_cpu(2) (DP(10%) at p = 40); the CPU's fp32-upcast U adds its lo
    copy.  (Measured on an H100: 10.63 and 7.98 GiB.  The reckoning used
    to add the panel column's five buffers to U: 11.375 and 8.906.)"""
    gib = 2 ** 30
    a = costmodel.distributed_peak_gib(65_536, 1_024, 8, 4, 2, 2)
    assert a * gib == (65_536 ** 2 * 2 + 64 * 8 * 1_024 ** 2 * 4
                       + 65_536 * 1_024 * 2 + 4_096 * 65_536 * 2)
    assert a == 10.625
    b = costmodel.distributed_peak_gib(40_960, 1_024, 2, 8, 4, 4)
    assert b * gib == (40_960 ** 2 * 4 + 40 * 2 * 1_024 ** 2 * 8
                       + 40_960 * 1_024 * 4 + 6_144 * 40_960 * 4)
    assert b == 7.96875
    c = costmodel.distributed_peak_gib(65_536, 1_024, 8, 4, 2, 4)
    assert c == a + 4_096 * 65_536 * 4 / gib