"""The block plan of the symmetric Matern kernels and the facts it rests on.

The CUDA forward and backward (csrc/matern_cov.cu, _grad.cu) compute a tile whose row
and column locations are the same locations only on its lower BLOCK x
BLOCK blocks: the forward writes each with its mirror, the backward reads
G's two mirrored blocks against one evaluation.  Here, without a card:
the plan the wrapper sizes the grids and the partials with covers every
element exactly once; the plain K(locs, locs) is its own transpose bit for
bit (what the mirror writes); a paired gradient, lower blocks against
G + G^T and diagonal blocks once, agrees with the plain backward and with
`jax.value_and_grad` of the JAX Matern; and the dispatch predicate picks
the symmetric form exactly for the same tiles.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.covariance import matern_covariance as j_matern_covariance
from repro_torch.covariance.matern import (_matern_half_integer,
                                           pairwise_distance)
from repro_torch.kernels.matern_cov import matern_cov as mc_kernel
from repro_torch.kernels.matern_cov import ref as mc_ref

torch.set_num_threads(1)

B = mc_kernel.BLOCK
NUS = (0.5, 1.5, 2.5)
# n a multiple of the block, ragged, smaller than one block, and one point
SIZES = (3 * B, 2 * B + 17, B - 5, 1)
# paired against direct gradients, of the scale sum |G| dK/dtheta: the same
# terms in fp32 or fp64 summed in another order (and G_ij + G_ji in fp64)
PAIRED_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


def _locs(n, dtype, seed=0, repeat=4):
    """n points on the unit square, the first `repeat` repeated at the end
    (coincident pairs, r = 0, off the diagonal)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 2))
    k = min(repeat, n // 2)
    if k:
        pts[n - k:] = pts[:k]
    return torch.tensor(pts, dtype=dtype)


def _block(i, n):
    return slice(i * B, min((i + 1) * B, n))


@pytest.mark.parametrize("n", SIZES)
def test_lower_pair_enumerates_the_lower_blocks_row_by_row(n):
    t = mc_kernel.blocks(n)
    pairs = [mc_kernel.lower_pair(k) for k in range(mc_kernel.sym_blocks(n))]
    assert pairs == [(i, j) for i in range(t) for j in range(i + 1)]


def test_lower_pair_at_the_fidelity_sigma():
    # 40,960 / 64 = 640 blocks a side: the map stays exact at the last pair
    # and at every row start, where a rounded square root would be off
    t = mc_kernel.blocks(40_960)
    assert mc_kernel.sym_blocks(40_960) == t * (t + 1) // 2 == 205_120
    for i in list(range(0, t, 37)) + [t - 1]:
        k0 = i * (i + 1) // 2
        assert mc_kernel.lower_pair(k0) == (i, 0)
        assert mc_kernel.lower_pair(k0 + i) == (i, i)


@pytest.mark.parametrize("n", SIZES)
def test_symmetric_forward_plan_writes_every_element_once(n):
    """The forward's blocks, each written directly and (off the diagonal)
    mirrored, cover the (n, n) tile exactly once."""
    writes = np.zeros((n, n), dtype=np.int64)
    for k in range(mc_kernel.sym_blocks(n)):
        i, j = mc_kernel.lower_pair(k)
        writes[_block(i, n), _block(j, n)] += 1
        if i != j:
            writes[_block(j, n), _block(i, n)] += 1
    assert (writes == 1).all()


OUTER_SHAPES = [(64, 64, 8), (5, 5, 0), (6, 4, 2), (3, 7, 1), (4, 4, 9),
                (1, 1, 0)]


@pytest.mark.parametrize("n_ti,n_tj,min_lag", OUTER_SHAPES)
def test_outer_order_computes_the_lower_tiles_and_zeros_the_rest_once(
        n_ti, n_tj, min_lag):
    """The outer (off-band lower) form's grid.z: every tile with ti - tj >=
    min_lag once among the computed tiles, in row order, every other tile
    once among the zero tiles."""
    items = mc_kernel.outer_order(n_ti, n_tj, min_lag)
    tiles = [(i, j) for i in range(n_ti) for j in range(n_tj)]
    assert [(i, j) for i, j, zero in items if not zero] == [
        (i, j) for i, j in tiles if i - j >= min_lag]
    assert sorted((i, j) for i, j, zero in items if zero) == [
        (i, j) for i, j in tiles if i - j < min_lag]


@pytest.mark.parametrize("n_ti,n_tj,min_lag", OUTER_SHAPES)
def test_outer_order_spreads_the_zero_tiles_evenly(n_ti, n_tj, min_lag):
    """Among the first k items the share of zero tiles is the whole grid's,
    within one, so zero stores run beside the arithmetic."""
    zeros = np.cumsum([z for _, _, z in mc_kernel.outer_order(n_ti, n_tj,
                                                               min_lag)])
    share = zeros[-1] / len(zeros)
    assert all(abs(z - share * (k + 1)) <= 1 for k, z in enumerate(zeros))


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_grad_plan_reads_every_g_element_once(n, sym):
    """The backward's blocks read G's block (I, J) and, in the symmetric
    form off the diagonal, its mirror (J, I): every element once; its
    partials hold two sums for each block of the first pass."""
    cols = n if sym else n + 3
    n_blocks, n_partials = mc_kernel.grad_plan(n, cols, sym)
    assert n_partials == 2 * min(n_blocks, mc_kernel.GRAD_MAX_GRID)
    reads = np.zeros((n, cols), dtype=np.int64)
    for k in range(n_blocks):
        if sym:
            i, j = mc_kernel.lower_pair(k)
        else:
            i, j = divmod(k, mc_kernel.blocks(cols))
        reads[_block(i, n), _block(j, cols)] += 1
        if sym and i != j:
            reads[_block(j, n), _block(i, cols)] += 1
    assert (reads == 1).all()


def test_grad_plan_refuses_a_symmetric_rectangle():
    with pytest.raises(ValueError):
        mc_kernel.grad_plan(64, 65, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", NUS)
def test_plain_k_is_its_own_transpose_bit_for_bit(nu, dtype):
    """The mirror writes K(i, j) at (j, i): the plain version gives the
    same bits there, coincident points (r = 0) included."""
    locs = _locs(150, dtype)
    k = mc_ref.matern_cov(locs, locs, [1.3, 0.07], nu=nu,
                          out_dtype=dtype)
    assert torch.equal(k, k.T)
    assert (k[146:, :4].diagonal() == k.diagonal()[:4]).all()


def _paired_grad(locs, theta, g, nu):
    """sum_ij G_ij dK_ij/dtheta as the symmetric backward forms it: each
    lower block once against G_IJ + G_JI^T in fp64, each diagonal block once
    against its own G."""
    n = locs.shape[0]
    acc = torch.zeros(2, dtype=torch.float64)
    for k in range(mc_kernel.sym_blocks(n)):
        i, j = mc_kernel.lower_pair(k)
        bi, bj = _block(i, n), _block(j, n)
        gs = g[bi, bj].double()
        if i != j:
            gs = gs + g[bj, bi].double().T
        acc += _grad_block(locs[bi], locs[bj], theta, gs, nu)
    return acc


def _grad_block(la, lb, theta, gs, nu):
    """sum gs corr and (theta1 / theta2) sum gs x g(x) over one block, the
    terms in the locations' precision as the kernel computes them."""
    th = mc_ref._theta(theta, nu, la)
    r = pairwise_distance(la, lb)
    x = r / th[1]
    at0 = r == 0
    corr = torch.where(at0, 1.0, _matern_half_integer(x, nu))
    term = torch.where(at0, 0.0, mc_ref._grad_terms(x, nu))
    th64 = th[:2].double()
    return torch.stack([(gs * corr.double()).sum(),
                        (gs * term.double()).sum() * th64[0] / th64[1]])


def _grad_case(n, dtype, nu, seed):
    locs = _locs(n, dtype, seed=seed)
    rng = np.random.default_rng(seed + 100)
    g = torch.tensor(rng.standard_normal((n, n)), dtype=dtype)  # not symmetric
    theta = [0.9, 0.08]
    return locs, theta, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("n", [2 * B + 17, B - 5])
def test_paired_gradient_matches_the_plain_backward(n, nu, dtype):
    locs, theta, g = _grad_case(n, dtype, nu, seed=n)
    got = _paired_grad(locs, theta, g, nu)
    want = mc_ref.matern_cov_grad(locs, locs, theta, g, nu=nu).double()
    scale = mc_ref.matern_cov_grad(locs, locs, theta, g.abs(), nu=nu).double()
    assert ((got - want).abs() <= PAIRED_TOL[dtype] * scale).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", NUS)
def test_paired_gradient_matches_jax_value_and_grad(nu, dtype):
    """The paired sums against jax.value_and_grad of sum(G * K) through the
    JAX Matern, on the same numpy inputs (fp64 under jax.enable_x64)."""
    n = 2 * B + 17
    locs, theta, g = _grad_case(n, dtype, nu, seed=3)
    got = _paired_grad(locs, theta, g, nu)
    scale = mc_ref.matern_cov_grad(locs, locs, theta, g.abs(), nu=nu).double()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        la, gj = jnp.asarray(locs.numpy(), jdt), jnp.asarray(g.numpy(), jdt)

        def f(th):
            full = jnp.concatenate([th, jnp.asarray([nu], jdt)])
            return jnp.sum(gj * j_matern_covariance(la, la, full,
                                                    nu_static=nu))
        _, want = jax.value_and_grad(f)(jnp.asarray(theta, jdt))
    want = torch.tensor(np.asarray(want, dtype=np.float64))
    assert ((got - want).abs() <= PAIRED_TOL[dtype] * scale).all()


def _rn32(x):
    """x (a Fraction) rounded to the nearest fp32, ties to even."""
    f = np.float32(float(x))
    near = [f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                    int(v.view(np.int32)) & 1))


# x = r / theta2 in the kernels (csrc/matern_cov.cuh: div_by): q = RN(r y)
# with y = RN(1 / theta2), the remainder r - q theta2 exact in one FMA,
# then RN(q + remainder y) in one more
@pytest.mark.parametrize("theta2", [0.03, 0.07, 0.1, 0.3, 1.3, 3.0])
def test_reciprocal_and_one_fma_give_the_ieee_quotient(theta2):
    """The divide the kernels use equals the IEEE divide the plain version
    uses: 4,000 fp32 and 1,000 fp64 quotients per theta2 over the
    distances the unit square gives (and small ones), computed exactly in
    fractions before each rounding."""
    rng = np.random.default_rng(int(theta2 * 1000))
    r = np.concatenate([rng.uniform(0, 1.5, 3000), rng.uniform(0, 1e-4, 1000)])
    b32 = np.float32(theta2)
    y32 = np.float32(1) / b32
    for a in r.astype(np.float32):
        q = a * y32
        rem = _rn32(Fraction(float(a)) - Fraction(float(b32)) * Fraction(float(q)))
        got = _rn32(Fraction(float(q)) + Fraction(float(rem)) * Fraction(float(y32)))
        assert got == a / b32
    y64 = 1.0 / theta2
    for a in r[::4]:
        q = a * y64
        rem = float(Fraction(a) - Fraction(theta2) * Fraction(q))
        assert float(Fraction(q) + Fraction(rem) * Fraction(y64)) == a / theta2


def test_symmetric_dispatch_is_the_same_tiles_only():
    """The panel path's band sub-diagonal d = 0 (locs_t[0:] against
    locs_t[:p]) and Sigma = C(locs, locs) go to the symmetric form; a
    shifted sub-diagonal and a copy of the locations do not."""
    p, nb = 5, 32
    locs = _locs(p * nb, torch.float32)
    locs_t = locs.reshape(p, nb, 2)
    assert mc_kernel.symmetric(locs_t[0:], locs_t[:p])
    assert mc_kernel.symmetric(locs[None], locs[None])
    assert not mc_kernel.symmetric(locs_t[1:], locs_t[:p - 1])
    assert not mc_kernel.symmetric(locs_t, locs_t.clone())
    assert not mc_kernel.symmetric(locs_t[:2], locs_t[:3])
