"""PrecisionPolicy of the PyTorch port against the JAX reference policy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro_torch.core import precision as tprec

# pytest runs several workers on a few cores: one intra-op thread each
# keeps these small-shape tests from oversubscribing them
torch.set_num_threads(1)

JP, TP = jprec.PrecisionPolicy, tprec.PrecisionPolicy


def _name(dt):
    if dt is None:
        return None
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return jnp.dtype(dt).name


CONSTRUCTORS = {
    "full": (lambda: JP.full(jnp.float32), lambda: TP.full(torch.float32)),
    "tpu1": (lambda: JP.tpu(1), lambda: TP.tpu(1)),
    "tpu3": (lambda: JP.tpu(3), lambda: TP.tpu(3)),
    "paper_cpu2": (lambda: JP.paper_cpu(2), lambda: TP.paper_cpu(2)),
    "dst2": (lambda: JP.dst(2), lambda: TP.dst(2)),
    "three_tier13": (lambda: JP.three_tier(1, 3), lambda: TP.three_tier(1, 3)),
}


@pytest.mark.parametrize("ctor", sorted(CONSTRUCTORS))
@pytest.mark.parametrize("p", [1, 4, 8])
def test_tile_classification_matches_reference(ctor, p):
    jp, tp = (make() for make in CONSTRUCTORS[ctor])
    assert tp.mode == jp.mode and tp.diag_thick == jp.diag_thick
    for field in ("hi", "lo", "lo2", "solve_dtype", "accum_dtype"):
        assert _name(getattr(tp, field)) == _name(getattr(jp, field)), field
    for i in range(p):
        for j in range(p):
            assert _name(tp.tile_dtype(i, j)) == _name(jp.tile_dtype(i, j))
            assert tp.in_band(i, j) == jp.in_band(i, j)
    assert tp.dp_fraction(p) == jp.dp_fraction(p)


@pytest.mark.parametrize("pair", ["tpu", "paper_cpu", "dst"])
@pytest.mark.parametrize("p,dp", [(4, 0.3), (8, 0.1), (8, 0.6), (16, 0.22)])
def test_from_dp_percent_matches_reference(pair, p, dp):
    jp = JP.from_dp_percent(p, dp, pair)
    tp = TP.from_dp_percent(p, dp, pair)
    assert (tp.mode, tp.diag_thick) == (jp.mode, jp.diag_thick)
    assert _name(tp.hi) == _name(jp.hi) and _name(tp.lo) == _name(jp.lo)


# ---- the invalid inputs of tests/test_policy_validation.py ----------------

def test_unknown_mode_rejected():
    with pytest.raises(ValueError, match="mode"):
        TP(mode="half", hi=torch.float32, lo=torch.bfloat16, diag_thick=1)


@pytest.mark.parametrize("t", [0, -1])
def test_nonpositive_diag_thick_rejected(t):
    with pytest.raises(ValueError, match="diag_thick"):
        TP(mode="mixed", hi=torch.float32, lo=torch.bfloat16, diag_thick=t)


def test_three_tier_requires_lo2():
    with pytest.raises(ValueError, match="lo2"):
        TP(mode="three_tier", hi=torch.float32, lo=torch.bfloat16,
           diag_thick=1, diag_thick2=3)


@pytest.mark.parametrize("t, t2", [(2, 2), (3, 1)])
def test_three_tier_thresholds_must_be_ordered(t, t2):
    with pytest.raises(ValueError, match="diag_thick2"):
        TP.three_tier(diag_thick=t, diag_thick2=t2)


@pytest.mark.parametrize("field", ["solve_dtype", "accum_dtype"])
@pytest.mark.parametrize("bad", [torch.int32, torch.int8, torch.bool, "int16"])
def test_non_floating_exec_dtypes_rejected(field, bad):
    with pytest.raises(ValueError, match=field):
        TP(mode="mixed", hi=torch.float32, lo=torch.bfloat16, diag_thick=2,
           **{field: bad})


@pytest.mark.parametrize("field", ["solve_dtype", "accum_dtype"])
def test_garbage_exec_dtype_rejected(field):
    with pytest.raises(ValueError, match="dtype"):
        TP(mode="mixed", hi=torch.float32, lo=torch.bfloat16, diag_thick=2,
           **{field: object()})


def test_accum_narrower_than_lo_rejected():
    with pytest.raises(ValueError, match="accum_dtype"):
        TP(mode="mixed", hi=torch.float32, lo=torch.float32, diag_thick=2,
           accum_dtype=torch.bfloat16)


def test_accum_equal_width_to_lo_and_string_dtypes_accepted():
    pol = TP(mode="mixed", hi=torch.float32, lo=torch.bfloat16, diag_thick=2,
             solve_dtype="float32", accum_dtype=torch.float16)
    assert pol.solve_dtype == torch.float32
    assert pol.accum_dtype == torch.float16


# ---- lo_matmul -------------------------------------------------------------

def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("ctor", ["tpu1", "paper_cpu2", "full"])
@pytest.mark.parametrize("shape", [(64, 32, 48), (3, 16, 16, 16)])
def test_lo_matmul_matches_reference(ctor, shape):
    rng = np.random.default_rng(0)
    *batch, m, k, n = shape
    a = rng.standard_normal((*batch, m, k)).astype(np.float32)
    b = rng.standard_normal((*batch, k, n)).astype(np.float32)
    jp, tp = (make() for make in CONSTRUCTORS[ctor])
    want = np.asarray(jprec.lo_matmul(jnp.asarray(a), jnp.asarray(b), jp),
                      np.float64)
    got = tprec.lo_matmul(torch.from_numpy(a), torch.from_numpy(b), tp)
    assert _name(got.dtype) == _name(jp.lo)
    got = got.double().numpy()
    # both sum exact products in fp32 in different orders: the fp32 sums
    # differ by at most gamma_k sum|a||b|, and rounding to lo can turn that
    # into one lo ulp (bf16: 2^-8 relative; fp32 lo: no second rounding)
    gamma = k * 2.0 ** -24 / (1 - k * 2.0 ** -24)
    bound = gamma * (np.abs(a).astype(np.float64) @ np.abs(b))
    if _name(jp.lo) == "bfloat16":
        bound = bound + _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= bound)
