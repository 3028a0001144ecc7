"""The launch plans of the port's redesigned kernels and the split-KV chunk
combine, on the CPU.

blocked_potrf: the grid path's panel schedule (kernels/blocked_potrf/
blocked_potrf.py: plan).  mp_attention: the (B, n_split) grid's chunks
(kernels/mp_attention/mp_attention.py: split_plan), and the
plain counterpart of the CUDA combine step (ref.flash_decode_segment_split,
ref.combine_chunks) held to the unsplit ref.flash_decode_segment and to the
JAX flash_decode_segment (Pallas interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mp_attention.mp_attention import (
    flash_decode_segment as j_segment)
from repro_torch.kernels.blocked_potrf import blocked_potrf as potrf_kernel
from repro_torch.kernels.blocked_potrf import phase_profile
from repro_torch.kernels.mp_attention import mp_attention as attn_kernel
from repro_torch.kernels.mp_attention import ops, ref

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

# (b, g, d, sn, sf, blk): tests/test_kernels.py and verify/conformance.py
SHAPES = [(2, 4, 64, 128, 256, 128), (1, 8, 128, 256, 128, 64),
          (4, 1, 64, 128, 128, 128)]
SCALES = (0.5, 1.0, 2.0)
# (rows, keys, blk) of the served llama3.2-1b cache: far and near segments
SERVED = [(32, 7168, 128), (32, 1152, 128)]


# ---------------------------- blocked_potrf ---------------------------

@pytest.mark.parametrize("nb", [1, 63, 64, 65, 128, 129, 520, 1000, 1024])
def test_potrf_plan_covers_every_column_row_and_tile_once(nb):
    p = potrf_kernel.plan(nb)
    assert p["grid_path"] == (nb > potrf_kernel.SMEM_TILE_MAX)
    cols = []
    for k0, w, chunks, tiles in p["panels"]:
        assert k0 % p["panel"] == 0 and 1 <= w <= p["panel"]
        cols.extend(range(k0, k0 + w))
        below = nb - k0 - w
        assert w == p["panel"] or below == 0  # only the last panel is narrow
        # the solve's chunks of PANEL rows hold every row below exactly once
        rows = [r for c in range(chunks)
                for r in range(k0 + w + c * w, min(k0 + w + (c + 1) * w, nb))]
        assert rows == list(range(k0 + w, nb))
        # one block per lower-triangle tile of the trailing matrix
        assert tiles == chunks * (chunks + 1) // 2
        assert p["blocks"] >= max(chunks, tiles, 1)
    assert cols == list(range(nb))


def test_potrf_plan_at_the_main_path_fits_one_wave():
    # nb = 1024: 16 panels; the first update has 15 x 16 / 2 = 120 tiles,
    # fewer than the H100's 132 SMs, so every phase runs in one wave
    p = potrf_kernel.plan(1024)
    assert len(p["panels"]) == 16 and p["blocks"] == 120


def test_potrf_phase_profile_stamps_every_phase_of_the_source():
    # the profile instruments csrc/blocked_potrf.cu at fixed lines: each
    # must still be there, once, with its stamp after it
    src = phase_profile.instrumented_source()
    assert src.count("clock64()") == 6
    assert "read_stamps" in src


@pytest.mark.parametrize("nb", [0, -1, 1025, 4096])
def test_potrf_plan_refuses_nb_outside_the_kernel(nb):
    with pytest.raises(ValueError, match="outside"):
        potrf_kernel.plan(nb)


# ---------------------------- mp_attention ----------------------------

@pytest.mark.parametrize("b,s,blk", SERVED + [(1, 7168, 128), (2, 256, 128),
                                              (1, 256, 64), (4, 128, 128),
                                              (3, 0, 128), (300, 1024, 64)])
def test_split_plan_puts_every_key_in_one_blk_aligned_chunk(b, s, blk):
    chunk, n_split = attn_kernel.split_plan(b, s, blk)
    assert chunk >= blk and chunk % blk == 0
    # block (row, i) of the kernel's grid reads keys [i chunk, min(.., s))
    bounds = [(i * chunk, min((i + 1) * chunk, s)) for i in range(n_split)]
    keys = [j for c0, c1 in bounds for j in range(c0, c1)]
    assert keys == list(range(s))
    assert all(c0 % blk == 0 and (c1 - c0) % blk == 0 for c0, c1 in bounds)
    # no more chunks than blk-blocks of keys, no empty chunk beside others
    assert n_split <= max(1, s // blk)
    assert all(c1 > c0 for c0, c1 in bounds) or s == 0


@pytest.mark.parametrize("b,s,blk", SERVED)
def test_split_plan_fills_the_card_at_the_served_shape(b, s, blk):
    # at least two blocks per SM of the H100 (132 SMs) for each segment
    _, n_split = attn_kernel.split_plan(b, s, blk)
    assert b * n_split >= 264


def test_split_plan_gives_one_row_one_chunk_per_key_block():
    # B*KV = 1 cannot reach 264 blocks: every blk block is its own chunk
    assert attn_kernel.split_plan(1, 7168, 128) == (128, 56)


@pytest.mark.parametrize("b,s,blk", [(0, 256, 128), (2, 200, 128),
                                     (2, 256, 96), (2, 256, 32), (2, -128, 128)])
def test_split_plan_refuses_bad_chunking(b, s, blk):
    with pytest.raises(ValueError):
        attn_kernel.split_plan(b, s, blk)


def test_split_ref_refuses_bad_chunks():
    q = torch.zeros((1, 1, 64))
    kv = torch.zeros((1, 256, 64))
    for chunk in (64, 192, 0):  # below blk, not a multiple of blk
        with pytest.raises(ValueError, match="multiple"):
            ref.flash_decode_segment_split(q, kv, kv, None,
                                           torch.tensor([256]), chunk=chunk)


def _lengths(case, b, s, blk):
    """seg_len per row: every key valid; ragged (ending mid-chunk, with
    whole chunks past the end where the segment has them); one valid key
    (every later chunk wholly past the end); none."""
    if case == "full":
        return np.full((b,), s, np.int32)
    if case == "ragged":
        pattern = [s - 5, blk // 2 + 3, s - blk - 7 if s > blk else s - 9,
                   blk + 1 if s > blk else 1]
        return np.array([pattern[i % 4] for i in range(b)], np.int32)
    if case == "past_end":
        return np.ones((b,), np.int32)
    return np.zeros((b,), np.int32)


@pytest.mark.parametrize("case", ["full", "ragged", "past_end", "empty"])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunk_combine_matches_unsplit_and_pallas_interpret(shape, scale, case):
    b, g, d, sn, sf, blk = shape
    rng = np.random.default_rng(11)
    q = (scale * rng.standard_normal((b, g, d))).astype(np.float32)
    kn, vn = (rng.standard_normal((b, sn, d)).astype(np.float32) for _ in range(2))
    kf, vf = (torch.from_numpy(rng.standard_normal((b, sf, d)).astype(np.float32))
              for _ in range(2))
    kq, vq, sc = ops.quantize_kv(kf, vf, blk=blk)
    sm = 1.0 / np.sqrt(d)
    segments = [(torch.from_numpy(kn), torch.from_numpy(vn), None, sn),
                (kq, vq, sc, sf)]  # the near (fp32) and far (int8) kinds
    for k, v, scales, s in segments:
        seg_len = _lengths(case, b, s, blk)
        tq, tl = torch.from_numpy(q), torch.from_numpy(seg_len)
        kw = dict(blk=blk, sm_scale=sm)
        # the most chunks the kernel could take (one blk block each) and the
        # kernel's own plan at this shape
        chunks = {blk, attn_kernel.split_plan(b, s, blk)[0]}
        whole = ref.flash_decode_segment(tq, k, v, scales, tl, **kw)
        want = j_segment(jnp.asarray(q), jnp.asarray(k.numpy()),
                         jnp.asarray(v.numpy()),
                         None if scales is None else jnp.asarray(scales.numpy()),
                         jnp.asarray(seg_len), interpret=True, **kw)
        for chunk in sorted(chunks):
            got = ref.flash_decode_segment_split(tq, k, v, scales, tl,
                                                 chunk=chunk, **kw)
            for name, o, u, w in zip(("acc", "m", "l"), got, whole, want):
                assert o.dtype == torch.float32 and o.shape == u.shape, name
                assert bool(torch.isfinite(o).all()), name
                # fp32 sums over <= 256 keys in another order: 2e-5, the
                # tolerance of the unsplit plain version against JAX
                torch.testing.assert_close(o, u, rtol=2e-5, atol=2e-5,
                                           msg=name)
                np.testing.assert_allclose(o.numpy(), np.asarray(w),
                                           rtol=2e-5, atol=2e-5, err_msg=name)
        if case == "empty":  # every chunk read its keys: l = S, m = -1e30
            assert bool((got[1] == -1e30).all()) and bool((got[2] == s).all())


def test_combine_chunks_weights_a_wholly_past_chunk_by_zero():
    rng = np.random.default_rng(12)
    acc = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((2, 3, 1)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 5, (2, 3, 1)).astype(np.float32))
    past = (torch.zeros_like(acc), torch.full_like(m, -1e30), torch.zeros_like(l))
    for parts in ([(acc, m, l), past], [past, (acc, m, l), past]):
        got = ref.combine_chunks(parts)
        for o, w in zip(got, (acc, m, l)):
            torch.testing.assert_close(o, w, rtol=0, atol=0)
