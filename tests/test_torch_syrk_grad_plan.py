"""The specification, on the CPU, of mp_syrk_grad's redesigned dataflow
(csrc/mp_syrk.cu, the backward): a pre-pass writes D + D^T in hi for each
diagonal tile D of dU and, under the split pairs, lo(dU) for each lower
off-band tile, packed in row order, and lo(P); the off-band class sums
lo(S) lo(P) in fp32 over its K chunks (a tile left of the band from the
packed tile (ti, tj) as it is, one right of it from the packed tile
(tj, ti) transposed) and rounds the sum once to lo; the band sums
S_band P in hi (dU[r][j] left of the diagonal, the D + D^T tile, dU[j][r]
right of it); dP = hi(band) + hi(lo(off)).  Written out here chunk by chunk from
the plan below (the CUDA source is its one implementation) and the
wrapper's `grad_scratch_layout`, it is held to ref.mp_syrk_grad within
chip_smoke.syrk_grad_err's tolerance and to reading no upper tile of dU,
and the plan to covering every dP block and every K range exactly once."""

import itertools

import pytest
import torch

from repro_torch.kernels.mp_gemm import ref as syrk_ref
from repro_torch.kernels.mp_gemm.mp_gemm import (PAIRS, SPLIT_PAIRS,
                                                 grad_scratch_layout)
from test_torch_mle_adam import _chip_smoke

torch.set_num_threads(1)


# The specification of the device's block and chunk plan, written out in
# Python; csrc/mp_syrk.cu is the one implementation (grad_block,
# packed_index, each engine's K loop).
GRAD_CHUNK = {"fp32": 32, "dmma": 16, "wgmma": 64}   # K columns per stage


def grad_band(m, tile, band_blocks, pair):
    """The backward's band in tiles: every tile for the all-hi pairs."""
    n_t = m // tile
    return min(band_blocks, n_t) if pair in SPLIT_PAIRS else n_t


def packed_index(a, b, band):
    """Index of the lower off-band tile (a, b), a - b >= band, among the
    packed lo tiles, in row order: rows before a hold x (x + 1) / 2 of
    them, x = a - band."""
    x = a - band
    return x * (x + 1) // 2 + b


def grad_block(idx, m, kdim, tile):
    """(r0, c0, bm, bn) of the idx-th block of the engines' 1-D grid: bm x
    bn outputs of dP, 128 where that divides the tile (kdim) else 64; the
    kdim / bn blocks of a row next to each other."""
    bm = 128 if tile % 128 == 0 else 64
    bn = 128 if kdim % 128 == 0 else 64
    nbn = kdim // bn
    return (idx // nbn) * bm, (idx % nbn) * bn, bm, bn


def grad_chunks(ti, n_t, tile, band, chunk, off):
    """The K chunks of a dP block in tile row ti, in the kernels' order:
    (j, source, packed tile) for S's columns j .. j + chunk.  The band
    (off=False): [b0, b1) from "left" (dU[r][j], staged transposed),
    "diag" (the D + D^T tile) and "right" (dU[j][r]); the off-band: [0, b0)
    from "lo_left" (packed tile (ti, tj), read K-major or transposed) then
    [b1, m) from "lo_right" (packed tile (tj, ti), read MN-major)."""
    b0, b1 = max(0, ti - band + 1) * tile, min(n_t, ti + band) * tile
    js = (list(range(0, b0, chunk)) + list(range(b1, n_t * tile, chunk))
          if off else list(range(b0, b1, chunk)))
    out = []
    for j in js:
        tj = j // tile
        if off:
            out.append((j, "lo_left", packed_index(ti, tj, band)) if tj < ti
                       else (j, "lo_right", packed_index(tj, ti, band)))
        else:
            out.append((j, "left" if tj < ti else "diag" if tj == ti
                        else "right", None))
    return out

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
PAIR_LIST = [(F32, BF16, F32), (F32, F32, F32), (F64, F32, F32),
             (F64, F64, F64)]
TILE, KDIM = 64, 64
N_TILES = [1, 2, 5, 9]


def _pair_id(pair):
    return "-".join(str(d).split(".")[-1] for d in pair)


def _dataflow(g, p, tile, band_blocks, pair):
    """dP as the kernels compute it, chunk by chunk (each chunk's products
    summed by a matmul, in chunk order)."""
    hi, lo, accum = pair
    code = PAIRS[pair]
    m, kdim = p.shape
    n_t = m // tile
    band = grad_band(m, tile, band_blocks, code)
    layout = grad_scratch_layout(m, kdim, tile, band_blocks, code)
    tiles = lambda a, b: g[a * tile:(a + 1) * tile, b * tile:(b + 1) * tile]  # noqa: E731
    # the pre-pass: only lower tiles (a >= b) of dU are read
    dd = [tiles(i, i) + tiles(i, i).T for i in range(n_t)]
    packed = [None] * layout["n_packed"]
    for a in range(n_t):
        for b in range(a - band + 1):
            packed[packed_index(a, b, band)] = tiles(a, b).to(lo)
    assert all(t is not None for t in packed)
    p_lo = p.to(lo)
    off_chunk = GRAD_CHUNK["wgmma" if lo == BF16 else "fp32"]
    band_chunk = GRAD_CHUNK["fp32" if hi == F32 else "dmma"]
    out = torch.empty_like(p)
    for ti in range(n_t):
        rows = slice(ti * tile, (ti + 1) * tile)
        off = None
        if layout["n_packed"]:  # the off-band kernel writes every row
            acc = torch.zeros((tile, kdim), dtype=accum)
            for j, src, q in grad_chunks(ti, n_t, tile, band, off_chunk, True):
                jl = j % tile
                a = (packed[q][:, jl:jl + off_chunk] if src == "lo_left"
                     else packed[q][jl:jl + off_chunk].T)
                acc += a.to(accum) @ p_lo[j:j + off_chunk].to(accum)
            off = acc.to(lo).to(hi)
        acc = torch.zeros((tile, kdim), dtype=hi)
        for j, src, _ in grad_chunks(ti, n_t, tile, band, band_chunk, False):
            tj, jl, cols = j // tile, j % tile, slice(j, j + band_chunk)
            a = {"left": lambda: g[rows, cols],
                 "diag": lambda: dd[ti][jl:jl + band_chunk].T,
                 "right": lambda: g[cols, rows].T}[src]()
            assert (src == "left") == (tj < ti) and (src == "diag") == (tj == ti)
            acc += a @ p[cols]
        out[rows] = acc if off is None else acc + off
    return out


@pytest.mark.parametrize("band", [1, 2, 3, "n_t"])
@pytest.mark.parametrize("n_t", N_TILES)
@pytest.mark.parametrize("pair", PAIR_LIST, ids=_pair_id)
def test_dataflow_matches_ref(pair, n_t, band):
    """The dataflow against ref.mp_syrk_grad within syrk_grad_err's
    tolerance, and the same bits with dU's upper tiles NaN as with them
    zero: no upper tile is read."""
    hi = pair[0]
    band = n_t if band == "n_t" else band
    m = TILE * n_t
    gen = torch.Generator().manual_seed(100 * n_t + band)
    p = torch.randn((m, KDIM), generator=gen, dtype=hi)
    g = torch.randn((m, m), generator=gen, dtype=hi)
    t = torch.arange(m) // TILE
    upper = t[:, None] < t[None, :]
    g_low = torch.where(upper, 0, g)
    got = _dataflow(torch.where(upper, float("nan"), g), p, TILE, band, pair)
    assert got.dtype == hi and torch.isfinite(got).all()
    assert torch.equal(got, _dataflow(g_low, p, TILE, band, pair))
    want = syrk_ref.mp_syrk_grad(g, p, tile=TILE, band_blocks=band,
                                 hi=pair[0], lo=pair[1], accum=pair[2])
    ratio, _ = _chip_smoke().syrk_grad_err(got, want, g, p, TILE, band, pair)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("band", [1, 2, 3, 9])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunks_cover_each_k_range_once(chunk, band):
    """Per tile row: the off-band chunks cover [0, b0) then [b1, m), the
    band's [b0, b1), together every column of S once; each off-band chunk
    names the packed tile of its (lower) tile, each band chunk its side."""
    n_t, tile = 9, 128
    m = n_t * tile
    for ti in range(n_t):
        off = grad_chunks(ti, n_t, tile, band, chunk, True)
        inb = grad_chunks(ti, n_t, tile, band, chunk, False)
        cols = [c for j, _, _ in off + inb for c in range(j, j + chunk)]
        assert sorted(cols) == list(range(m))
        b0, b1 = max(0, ti - band + 1) * tile, min(n_t, ti + band) * tile
        assert [j for j, _, _ in off] == sorted(j for j, _, _ in off)
        assert all(j < b0 or j >= b1 for j, _, _ in off)
        assert all(b0 <= j < b1 for j, _, _ in inb)
        for j, src, q in off:
            tj = j // tile
            a, b = (ti, tj) if src == "lo_left" else (tj, ti)
            assert a - b >= band and q == packed_index(a, b, band)
        assert all(j % tile + chunk <= tile for j, _, _ in off + inb)


@pytest.mark.parametrize("n_t,band", [(1, 1), (2, 1), (9, 2), (39, 2), (40, 8)])
def test_packed_index_is_a_bijection(n_t, band):
    """The lower off-band tiles onto range(n_packed), in row order."""
    tiles = [(a, b) for a in range(n_t) for b in range(a - band + 1)]
    qs = [packed_index(a, b, band) for a, b in tiles]
    n_packed = (n_t - band) * (n_t - band + 1) // 2
    assert qs == list(range(n_packed))
    if n_t == 39 and band == 2:
        assert n_packed == 703  # the tile path's step 0


@pytest.mark.parametrize("m,kdim,tile", [(39_936, 1_024, 1_024),
                                         (640, 192, 64), (768, 320, 192),
                                         (1_280, 128, 128)])
def test_blocks_cover_dp_once(m, kdim, tile):
    """The engines' 1-D grid: every bm x bn block of dP once, each inside
    one tile row, bm = 128 where it divides the tile."""
    bm = 128 if tile % 128 == 0 else 64
    bn = 128 if kdim % 128 == 0 else 64
    n = (m // bm) * (kdim // bn)
    blocks = [grad_block(i, m, kdim, tile) for i in range(n)]
    assert {b[2:] for b in blocks} == {(bm, bn)}
    assert sorted(b[:2] for b in blocks) == list(itertools.product(
        range(0, m, bm), range(0, kdim, bn)))
    assert all(r0 // tile == (r0 + bm - 1) // tile for r0, _, _, _ in blocks)
    # the kdim / bn blocks of a row slab are next to each other
    assert all(blocks[i][0] == blocks[i - i % (kdim // bn)][0]
               for i in range(n))


@pytest.mark.parametrize("pair", PAIR_LIST, ids=_pair_id)
def test_scratch_layout_at_step0(pair):
    """The scratch at the tile path's step 0 (39,936 x 1,024, band 2):
    disjoint 1,024-aligned parts; the D + D^T tiles (39 tiles in hi) and,
    for a split pair, 703 packed lo tiles and lo(P): 1.60 GiB for {fp32,
    bf16}, 3.20 GiB for the paper pair, under one lo copy of dU's square
    (2.97 and 5.94 GiB), the rise in peak memory phase 10.3 (b) allows."""
    code = PAIRS[pair]
    m, kdim, tile = 39_936, 1_024, 1_024
    lay = grad_scratch_layout(m, kdim, tile, 2, code)
    hi, lo = (torch.finfo(d).bits // 8 for d in pair[:2])
    parts = [lay[k] for k in ("dd", "s_lo", "p_lo") if k in lay]
    assert lay["dd"] == (0, 39 * tile * tile * hi)
    for (o0, n0), (o1, _) in zip(parts, parts[1:]):
        assert o1 % 1024 == 0 and o1 >= o0 + n0
    assert lay["total"] == sum(parts[-1])
    if code in (0, 2):
        assert lay["n_packed"] == 703
        assert lay["s_lo"][1] == 703 * tile * tile * lo
        assert lay["p_lo"][1] == m * kdim * lo
        assert lay["total"] <= m * m * lo
        assert lay["total"] / 2 ** 30 == pytest.approx(
            1.6016 if code == 0 else 3.2031, abs=1e-4)
    else:
        assert lay["n_packed"] == 0 and len(parts) == 1
