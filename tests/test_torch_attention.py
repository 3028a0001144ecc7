"""The port's mp_attention package on the CPU against the JAX one: the plain
segment partials (ref.flash_decode_segment) against the Pallas kernel in
interpret mode, the public ops against JAX's ops and ref on the shapes and
logit scales of tests/test_kernels.py and the conformance sweep, the int8
quantization bit for bit, and the served-cache fold of serve_lm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mp_attention.mp_attention import (
    flash_decode_segment as j_segment)
from repro.kernels.mp_attention.ops import (
    banded_decode_attention as j_banded, quantize_kv as j_quantize_kv)
from repro.kernels.mp_attention.ref import (
    banded_decode_attention_ref as j_banded_ref)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.mp_attention import ops, ref
from repro_torch.serve_lm import banded_kv_attention, cache_bytes_saved

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

# (b, g, d, sn, sf, blk): tests/test_kernels.py and verify/conformance.py
SHAPES = [(2, 4, 64, 128, 256, 128), (1, 8, 128, 256, 128, 64),
          (4, 1, 64, 128, 128, 128)]
SCALES = (0.5, 1.0, 2.0)   # logit scales of the conformance sweep


def _problem(seed, b, g, d, sn, sf, *, scale=1.0, near_dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = (scale * rng.standard_normal((b, g, d))).astype(np.float32)
    kn, vn = (rng.standard_normal((b, sn, d)).astype(near_dtype)
              for _ in range(2))
    kf, vf = (rng.standard_normal((b, sf, d)).astype(np.float32)
              for _ in range(2))
    return q, kn, vn, kf, vf


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j_near(x, near_bf16):
    return jnp.asarray(x, jnp.bfloat16) if near_bf16 else jnp.asarray(x)


def _t_near(x, near_bf16):
    t = _t(x)
    return t.to(torch.bfloat16) if near_bf16 else t


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_kv_matches_jax_exactly(shape):
    b, _, d, _, sf, blk = shape
    _, _, _, kf, vf = _problem(1, *shape[:5])
    kq_j, vq_j, sc_j = j_quantize_kv(jnp.asarray(kf), jnp.asarray(vf), blk=blk)
    kq, vq, sc = ops.quantize_kv(_t(kf), _t(vf), blk=blk)
    assert kq.dtype == torch.int8 and sc.shape == (b, sf // blk, 2)
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kq_j))
    np.testing.assert_array_equal(vq.numpy(), np.asarray(vq_j))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_j))


@pytest.mark.parametrize("near_bf16", [False, True], ids=["near_f32", "near_bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_segment_partials_match_pallas_interpret(shape, near_bf16):
    b, g, d, sn, sf, blk = shape
    q, kn, vn, kf, vf = _problem(2, b, g, d, sn, sf)
    kq, vq, sc = ops.quantize_kv(_t(kf), _t(vf), blk=blk)
    near_len = np.full((b,), sn - 5, np.int32)  # a ragged last block
    far_len = np.array([0] + [sf] * (b - 1), np.int32)  # row 0 has no far key
    sm = 1.0 / np.sqrt(d)
    cases = [  # (k, v, scales, seg_len) as JAX and as torch
        ((_j_near(kn, near_bf16), _j_near(vn, near_bf16), None,
          jnp.asarray(near_len)),
         (_t_near(kn, near_bf16), _t_near(vn, near_bf16), None,
          _t(near_len))),
        ((jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
          jnp.asarray(sc.numpy()), jnp.asarray(far_len)),
         (kq, vq, sc, _t(far_len))),
    ]
    for jargs, targs in cases:
        want = j_segment(jnp.asarray(q), *jargs, blk=blk, sm_scale=sm,
                         interpret=True)
        got = ref.flash_decode_segment(_t(q), *targs, blk=blk, sm_scale=sm)
        for name, w, o in zip("acc m l".split(), want, got):
            w = np.asarray(w)
            assert o.dtype == torch.float32 and o.shape == w.shape, name
            np.testing.assert_allclose(o.numpy(), w, rtol=2e-5, atol=2e-5,
                                       err_msg=name)
    # the far segment of row 0 is fully masked: m = -1e30, l = S, no NaN
    _, m, l = ref.flash_decode_segment(_t(q), kq, vq, sc, _t(far_len),
                                       blk=blk, sm_scale=sm)
    assert bool((m[0] == -1e30).all()) and bool((l[0] == sf).all())


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_banded_attention_matches_jax_ops_and_ref(shape, scale):
    b, g, d, sn, sf, blk = shape
    q, kn, vn, kf, vf = _problem(3, b, g, d, sn, sf, scale=scale)
    kq, vq, sc = ops.quantize_kv(_t(kf), _t(vf), blk=blk)
    near_len = np.full((b,), sn, np.int32)
    far_len = np.full((b,), sf, np.int32)
    sm = 1.0 / np.sqrt(d)
    t_args = (_t(q), _t(kn), _t(vn), _t(near_len), kq, vq, sc, _t(far_len))
    j_args = tuple(jnp.asarray(t.numpy()) for t in t_args)
    reset_launch_counts()
    got = ops.banded_decode_attention(*t_args, blk=blk, sm_scale=sm).numpy()
    assert launch_counts()["mp_attention"] == 0  # a CPU tensor: plain version
    want_ops = np.asarray(j_banded(*j_args, blk=blk, sm_scale=sm))
    want_ref = np.asarray(j_banded_ref(*j_args, blk=blk, sm_scale=sm))
    # tests/test_kernels.py holds JAX's ops to its ref at 2e-4;
    # verify/bounds.py ("kernel", "mp_attention"): max_abs 1e-3
    np.testing.assert_allclose(got, want_ops, rtol=2e-4, atol=2e-4)
    assert np.abs(got - want_ref).max() <= 1e-3
    port_ref = ref.banded_decode_attention_ref(*t_args, blk=blk, sm_scale=sm)
    np.testing.assert_allclose(port_ref.numpy(), want_ref, rtol=1e-5, atol=1e-5)


def test_banded_attention_ragged_lengths_with_empty_far_segment():
    b, g, d, sn, sf, blk = 2, 4, 64, 128, 256, 128
    q, kn, vn, kf, vf = _problem(4, b, g, d, sn, sf)
    kq, vq, sc = ops.quantize_kv(_t(kf), _t(vf), blk=blk)
    near_len = np.array([128, 70], np.int32)
    far_len = np.array([200, 0], np.int32)
    sm = 1.0 / np.sqrt(d)
    t_args = (_t(q), _t(kn), _t(vn), _t(near_len), kq, vq, sc, _t(far_len))
    j_args = tuple(jnp.asarray(t.numpy()) for t in t_args)
    got = ops.banded_decode_attention(*t_args, blk=blk, sm_scale=sm).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, np.asarray(j_banded(*j_args, blk=blk, sm_scale=sm)),
        rtol=2e-4, atol=2e-4)
    assert np.abs(got - np.asarray(j_banded_ref(*j_args, blk=blk, sm_scale=sm))
                  ).max() <= 1e-3


def test_merge_partials_matches_a_single_softmax():
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((3, 2, 64)).astype(np.float32))
    k = _t(rng.standard_normal((3, 256, 64)).astype(np.float32))
    v = _t(rng.standard_normal((3, 256, 64)).astype(np.float32))
    full = torch.full((3,), 128, dtype=torch.int32)
    parts = [ref.flash_decode_segment(q, k[:, i:i + 128], v[:, i:i + 128],
                                      None, full, sm_scale=0.125)
             for i in (0, 128)]
    scores = torch.einsum("bgd,bsd->bgs", q, k) * 0.125
    want = torch.einsum("bgs,bsd->bgd", torch.softmax(scores, -1), v)
    torch.testing.assert_close(ops.merge_partials(parts), want,
                               rtol=1e-5, atol=1e-5)


def _served_cache(b=2, s=320, kv=2, hd=64, g=4):
    """One layer's (B, S, KV, hd) bf16 cache, as prefill + decode leave it,
    and a (B*KV, G, hd) query."""
    rng = np.random.default_rng(6)
    ck, cv = (torch.from_numpy(rng.standard_normal((b, s, kv, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((b * kv, g, hd)).astype(np.float32))
    return ck, cv, q


@pytest.mark.parametrize("length,near", [(300, 64), (320, 256)])
def test_banded_kv_attention_folds_the_served_cache(length, near):
    ck, cv, q = _served_cache()
    b, _, kv, hd = ck.shape
    blk = 64
    reset_launch_counts()
    out, exact = banded_kv_attention(ck, cv, q, length, near=near, blk=blk)
    assert launch_counts()["mp_attention"] == 0
    # the same fold by hand through JAX's ops: far = whole blocks beyond the
    # near window, near = the rest padded to blk, slots past length masked
    fold = ck[:, :length].permute(0, 2, 1, 3).reshape(b * kv, length, hd)
    fold_v = cv[:, :length].permute(0, 2, 1, 3).reshape(b * kv, length, hd)
    far_n = max(length - near, 0) // blk * blk
    near_n = length - far_n
    pad = -near_n % blk
    kf = jnp.asarray(fold[:, :far_n].float().numpy())
    vf = jnp.asarray(fold_v[:, :far_n].float().numpy())
    kq, vq, sc = j_quantize_kv(kf, vf, blk=blk)
    kn = jnp.pad(jnp.asarray(fold[:, far_n:].float().numpy(), jnp.bfloat16),
                 ((0, 0), (0, pad), (0, 0)))
    vn = jnp.pad(jnp.asarray(fold_v[:, far_n:].float().numpy(), jnp.bfloat16),
                 ((0, 0), (0, pad), (0, 0)))
    lens = [jnp.full((b * kv,), n, jnp.int32) for n in (near_n, far_n)]
    want = j_banded(jnp.asarray(q.numpy()), kn, vn, lens[0], kq, vq, sc,
                    lens[1], blk=blk, sm_scale=hd ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # against exact attention over the unquantized positions: the int8 far
    # blocks cost ~1e-2 (tests/test_kernels.py), bf16 alone ~1e-7
    assert 1e-6 < float((out - exact).abs().max()) < 0.05


def test_banded_kv_attention_with_no_far_block_is_exact():
    # fewer filled slots than the near window: an empty int8 far segment,
    # whose partials merge with weight 0
    ck, cv, q = _served_cache()
    out, exact = banded_kv_attention(ck, cv, q, 200, near=256, blk=64)
    torch.testing.assert_close(out, exact, rtol=1e-5, atol=1e-5)


def test_cache_bytes_saved_at_the_serving_shape():
    # 8,255 filled of 8,256 slots, near = 1,024, blk = 128: 56 int8 far
    # blocks (7,168 slots) and 1,152 bf16 near slots
    assert cache_bytes_saved(1152, 7168) == pytest.approx(0.4308, abs=1e-4)
    assert cache_bytes_saved(128, 0) == 0.0
