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


def test_oracle_takes_an_empty_far_segment():
    # a served cache shorter than one key block past the near window folds
    # to a far segment of no slots: the oracle is the near softmax alone
    b, g, d, sn, blk = 2, 4, 64, 128, 64
    q, kn, vn, _, _ = _problem(8, b, g, d, sn, blk)
    empty = torch.zeros((b, 0, d), dtype=torch.int8)
    near_len = torch.tensor([sn, 70], dtype=torch.int32)
    got = ref.banded_decode_attention_ref(
        _t(q), _t(kn), _t(vn), near_len, empty, empty,
        torch.zeros((b, 0, 2)), torch.zeros((b,), dtype=torch.int32),
        blk=blk, sm_scale=d ** -0.5)
    for i, n in enumerate(near_len.tolist()):
        scores = _t(q)[i] @ _t(kn)[i, :n].T * d ** -0.5
        want = torch.softmax(scores, -1) @ _t(vn)[i, :n]
        torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-5)


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


# ------------------------------------------------- d_head 80 (h2o-danube)

@pytest.mark.parametrize("near_bf16", [False, True], ids=["near_f32", "near_bf16"])
def test_segment_partials_at_d80_match_pallas_interpret(near_bf16):
    # h2o-danube-1.8b's served shape: d_head 80, G = 4 (32 heads on 8 KV)
    b, g, d, sn, sf, blk = 2, 4, 80, 128, 256, 128
    q, kn, vn, kf, vf = _problem(7, b, g, d, sn, sf)
    kq, vq, sc = ops.quantize_kv(_t(kf), _t(vf), blk=blk)
    near_len = np.array([sn - 5, 70], np.int32)
    far_len = np.array([sf, 0], np.int32)
    sm = 1.0 / np.sqrt(d)
    cases = [((_j_near(kn, near_bf16), _j_near(vn, near_bf16), None,
               jnp.asarray(near_len)),
              (_t_near(kn, near_bf16), _t_near(vn, near_bf16), None,
               _t(near_len))),
             ((jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
               jnp.asarray(sc.numpy()), jnp.asarray(far_len)),
              (kq, vq, sc, _t(far_len)))]
    for jargs, targs in cases:
        want = j_segment(jnp.asarray(q), *jargs, blk=blk, sm_scale=sm,
                         interpret=True)
        got = ref.flash_decode_segment(_t(q), *targs, blk=blk, sm_scale=sm)
        for name, w, o in zip("acc m l".split(), want, got):
            w = np.asarray(w)
            assert o.shape == w.shape == (b, g, d if name == "acc" else 1)
            np.testing.assert_allclose(o.numpy(), w, rtol=2e-5, atol=2e-5,
                                       err_msg=name)
    # the merged output against JAX's ops and its oracle
    t_args = (_t(q), _t(kn), _t(vn), _t(near_len), kq, vq, sc, _t(far_len))
    j_args = tuple(jnp.asarray(t.numpy()) for t in t_args)
    got = ops.banded_decode_attention(*t_args, blk=blk, sm_scale=sm).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_banded(*j_args, blk=blk, sm_scale=sm)),
        rtol=2e-4, atol=2e-4)
    assert np.abs(got - np.asarray(j_banded_ref(*j_args, blk=blk, sm_scale=sm))
                  ).max() <= 1e-3


@pytest.mark.parametrize("d,ok", [(64, True), (80, True), (128, True),
                                  (72, False), (96, False)])
def test_launch_checks_take_the_kernels_head_dims(d, ok):
    from repro_torch.kernels.mp_attention.mp_attention import (HEAD_DIMS,
                                                               check_inputs)
    assert HEAD_DIMS == (64, 80, 128)
    b, g, s, blk = 2, 4, 256, 128
    q = torch.zeros((b, g, d))
    k = torch.zeros((b, s, d), dtype=torch.int8)
    sc = torch.ones((b, s // blk, 2))
    seg_len = torch.full((b,), s, dtype=torch.int32)
    if ok:
        assert check_inputs(q, k, k.clone(), sc, seg_len, blk=blk)[:4] == (
            b, g, d, s)
    else:
        with pytest.raises(NotImplementedError, match="d in"):
            check_inputs(q, k, k.clone(), sc, seg_len, blk=blk)
    with pytest.raises(ValueError, match="CUDA"):  # a CPU tensor never launches
        from repro_torch.kernels.mp_attention.mp_attention import launch
        launch(q, k, k.clone(), sc, seg_len, blk=blk)


# The specification of flash_chunk_kernel's P V product's thread map,
# written out in Python; csrc/mp_attention.cu is its one implementation
# (kGroups, kHeads, `owns`, g0 and col in flash_chunk_kernel).
K_THREADS, K_MAX_G = 256, 16


def pv_owners(d, g, *, fixed=True):
    """How many threads accumulate each (head, column) pair of the P V
    product for G = g heads: kGroups = 256 // d threads per column, each
    with heads g0, g0 + kGroups, ... (kHeads of them, rounded up);
    threads at or past kGroups * d own nothing.  fixed=False: the map
    before d = 80 (kHeads rounded down, no thread sitting out)."""
    groups = K_THREADS // d
    heads = -(-K_MAX_G // groups) if fixed else K_MAX_G // groups
    owners = np.zeros((g, d), np.int64)
    for tid in range(K_THREADS):
        if fixed and tid >= groups * d:
            continue
        col, g0 = tid % d, tid // d
        for h in range(heads):
            if h * groups >= g:
                break
            head = g0 + h * groups
            if head < g:
                owners[head, col] += 1
    return owners


@pytest.mark.parametrize("d", [64, 80, 128])
def test_kernel_thread_map_owns_each_head_column_once(d):
    for g in range(1, K_MAX_G + 1):
        assert (pv_owners(d, g) == 1).all(), (d, g)
    if d == 80:  # the map before the repair: threads 240-255 (g0 = 3)
        # race threads 0-15 on columns 0-15 of heads 3, 6, 9 and 12, and no
        # thread owns columns 16-79 of head 15
        old = pv_owners(d, K_MAX_G, fixed=False)
        assert (old[[3, 6, 9, 12], :16] == 2).all()
        assert (old[15, 16:] == 0).all() and (old[15, :16] == 1).all()
        assert (old == 1).sum() == K_MAX_G * d - 4 * 16 - 64
    else:  # where d divides 256 the two maps are one
        assert (pv_owners(d, K_MAX_G, fixed=False) == 1).all()


def test_kernel_source_has_the_specified_thread_map():
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "csrc" / "mp_attention.cu").read_text()
    for line in ("constexpr int kThreads = 256;", "constexpr int kMaxG = 16;",
                 "constexpr int kGroups = kThreads / D;",
                 "constexpr int kHeads = (kMaxG + kGroups - 1) / kGroups;",
                 "const int col = tid % D, g0 = tid / D;",
                 "const bool owns = tid < kGroups * D;",
                 "if (!owns || h * kGroups >= G) break;",
                 "const int g = g0 + h * kGroups;",
                 "case 80: return launch<QT, KT, 80>(a);"):
        assert line in src, line
