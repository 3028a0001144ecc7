"""The port's Algorithm 1 tile engine (core/tile_cholesky.py) against the
JAX `tile_cholesky` on the verify/generators.py grid (SIZES 64/128/192 x
weak/medium/strong, nb = CHOLESKY_NB = 32): the same fp32 covariance into
both, both factors held against a torch fp64 oracle within the policy's
registered factor bound (repro.verify.bounds); batch axes; the fp8 cliff;
DST and the dense reference."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrecisionPolicy as JP
from repro.core import dst_assemble as j_dst_assemble
from repro.core import dst_cholesky as j_dst
from repro.core import tile_cholesky as j_tile
from repro.verify.bounds import policy_bound
from repro.verify.generators import CHOLESKY_NB, REGIMES, SIZES, matern_problem
from repro_torch.core import (PrecisionPolicy, assemble_lower, dst_assemble,
                              dst_cholesky, reference_cholesky, split_tiles,
                              tile_cholesky)
from repro_torch.core.tile_cholesky import _check_card
from repro_torch.sched import SchedConfig
from test_torch_panel import _port_policy

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)

NB = CHOLESKY_NB
POLICIES = {
    "full": lambda: JP.full(jnp.float32),
    "tpu2": lambda: JP.tpu(2),
    "three_tier13": lambda: JP.three_tier(1, 3),
}
GRID = [(n, r) for n in SIZES for r in REGIMES]


@functools.lru_cache(maxsize=None)
def _problem(n, regime):
    """The problem's fp32 covariance (numpy) and its fp64 torch factor."""
    cov = np.array(matern_problem(n, regime).cov)
    return cov, torch.linalg.cholesky(torch.from_numpy(cov).double())


def _f64(x):
    return x.double().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float64)


def _rel(l, ref):
    """||l - ref||_F / ||ref||_F in fp64 (the registry's factor_rel)."""
    l, ref = _f64(l), _f64(ref)
    return float(np.linalg.norm(l - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("n,regime", GRID)
@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_factor_matches_jax_and_fp64(pol, n, regime):
    jp = POLICIES[pol]()
    cov, l64 = _problem(n, regime)
    l_jax = np.asarray(j_tile(jnp.asarray(cov), NB, jp), np.float64)
    l = tile_cholesky(torch.tensor(cov), NB, _port_policy(jp))
    assert l.dtype == torch.float32 and l.shape == (n, n)
    assert bool(torch.equal(l, torch.tril(l)))
    bound = policy_bound(jp, regime).factor_rel
    # fp32 alone: the same IEEE operations in another summation order; with
    # a bf16 off-band a last-bit difference can flip a bf16 rounding, so the
    # pair's own factor bound
    assert _rel(l, l_jax) <= (1e-5 if jp.mode == "full" else bound)
    assert _rel(l, l64) <= bound and _rel(l_jax, l64) <= bound


@pytest.mark.parametrize("n,regime", GRID)
def test_paper_cpu_pair_matches_jax_under_x64(n, regime):
    # the JAX side computes fp64 only under enable_x64; without it its
    # "fp64" band would silently be fp32
    cov, l64 = _problem(n, regime)
    with jax.enable_x64(True):
        jp = JP.paper_cpu(2)
        l_jax = np.asarray(j_tile(jnp.asarray(cov), NB, jp))
    assert l_jax.dtype == np.float64
    l = tile_cholesky(torch.tensor(cov), NB, _port_policy(jp))
    assert l.dtype == torch.float64
    bound = policy_bound(jp, regime).factor_rel        # 1e-5
    assert _rel(l, l_jax) <= bound
    assert _rel(l, l64) <= bound and _rel(l_jax, l64) <= bound


@pytest.mark.parametrize("n,regime", GRID)
def test_dst_matches_jax(n, regime):
    cov, l64 = _problem(n, regime)
    blocks_j = j_dst(jnp.asarray(cov), NB, 2)
    blocks = dst_cholesky(torch.tensor(cov), NB, 2)
    assert [sl for sl, _ in blocks] == [sl for sl, _ in blocks_j]
    l = dst_assemble(blocks, n)
    l_jax = np.asarray(j_dst_assemble(blocks_j, n), np.float64)
    # independent fp32 Cholesky factorizations of the same diagonal blocks
    assert _rel(l, l_jax) <= 1e-5
    # dropping the off-band is the DST baseline's point: the registry only
    # bounds it at finiteness scale
    bound = policy_bound(JP.dst(2), regime).factor_rel
    assert _rel(l, l64) <= bound and _rel(l_jax, l64) <= bound


@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_batch_axes_equal_single_factorizations(pol):
    jp = POLICIES[pol]()
    covs = np.stack([_problem(128, r)[0] for r in REGIMES])   # (3, n, n)
    tp = _port_policy(jp)
    l_bat = tile_cholesky(torch.tensor(covs), NB, tp)
    assert l_bat.shape == covs.shape
    l_jax = np.asarray(j_tile(jnp.asarray(covs), NB, jp))
    for b in range(len(covs)):
        l_one = tile_cholesky(torch.tensor(covs[b]), NB, tp)
        # the reference test's bound for a batch against its members
        np.testing.assert_allclose(l_bat[b].numpy(), l_one.numpy(), atol=1e-5)
        assert _rel(l_bat[b], l_jax[b]) <= (
            1e-5 if jp.mode == "full" else policy_bound(jp, REGIMES[b]).factor_rel)
    # two leading axes reshape back to both
    l2 = tile_cholesky(torch.tensor(covs[None]), NB, tp)
    assert l2.shape == (1,) + covs.shape
    np.testing.assert_array_equal(l2[0].numpy(), l_bat.numpy())


def test_fp8_cliff_three_tier_1_2_goes_indefinite():
    # three_tier(1, 2) rounds the second sub-diagonal to fp8: on the strong
    # n = 192 problem the trailing matrix goes indefinite in the reference
    # (CHANGES.md PR 2), and the port must give NaN there too
    jp = JP.three_tier(1, 2)
    cov, _ = _problem(192, "strong")
    l_jax = np.asarray(j_tile(jnp.asarray(cov), NB, jp))
    l = tile_cholesky(torch.tensor(cov), NB, _port_policy(jp))
    assert np.isnan(l_jax).any() and bool(torch.isnan(l).any())
    # ... while the weak problem stays finite in both
    cov, _ = _problem(192, "weak")
    assert np.isfinite(np.asarray(j_tile(jnp.asarray(cov), NB, jp))).all()
    assert bool(torch.isfinite(tile_cholesky(torch.tensor(cov), NB,
                                             _port_policy(jp))).all())


def test_plain_impl_equals_kernel_impl_on_the_cpu():
    # on a CPU tensor the kernels' public functions run their plain
    # versions, so the two impls are the same computation
    cov, _ = _problem(128, "medium")
    tp = PrecisionPolicy.tpu(2)
    a = torch.tensor(cov)
    np.testing.assert_array_equal(
        tile_cholesky(a, NB, tp, impl="kernel").numpy(),
        tile_cholesky(a, NB, tp, impl="plain").numpy())
    with pytest.raises(ValueError, match="impl"):
        tile_cholesky(a, NB, tp, impl="fast")


def test_input_is_not_modified_and_dense_reference_matches():
    cov, l64 = _problem(64, "medium")
    a = torch.tensor(cov)
    tile_cholesky(a, NB, PrecisionPolicy.tpu(1))
    np.testing.assert_array_equal(a.numpy(), cov)
    l = reference_cholesky(a)
    assert _rel(l, np.linalg.cholesky(cov.astype(np.float64))) <= 1e-5
    # not positive definite: all NaN, as jnp.linalg.cholesky gives
    bad = reference_cholesky(a - 2.0 * torch.eye(64))
    assert bool(torch.isnan(bad).all())


def test_split_tiles_and_assemble_lower_round_trip():
    cov, _ = _problem(64, "weak")
    tiles, p = split_tiles(torch.tensor(cov), NB)
    assert p == 2 and sorted(tiles) == [(0, 0), (1, 0), (1, 1)]
    out = assemble_lower(tiles, p, NB, torch.float64)
    np.testing.assert_array_equal(out.numpy(), np.tril(cov).astype(np.float64))


def test_refusals():
    a = torch.eye(64)
    with pytest.raises(ValueError, match="dst_cholesky"):
        tile_cholesky(a, NB, PrecisionPolicy.dst(2))
    # the schedule hook runs the task runtime's real backend, without grad
    with pytest.raises(ValueError, match="backend='real'"):
        tile_cholesky(a, NB, PrecisionPolicy.tpu(2),
                      schedule=SchedConfig(backend="sim"))
    with pytest.raises(NotImplementedError, match="no backward"):
        tile_cholesky(a.clone().requires_grad_(True), NB,
                      PrecisionPolicy.tpu(2), schedule=SchedConfig())
    # what the kernels do not take raises on a CUDA tensor before any work
    # (the paper pair's fp64 band runs on the card: no refusal by dtype)
    card = types.SimpleNamespace(is_cuda=True)
    with pytest.raises(ValueError, match="multiple of 64"):
        _check_card(card, 32, "kernel")
    _check_card(card, 32, "plain")
    _check_card(card, 1024, "kernel")
