"""The CUDA SYRK's host side on the CPU: the specification of its tile plan
(csrc/mp_syrk.cu launches each kernel over exactly the lower blocks of its
class and writes each with its mirror), the symmetry of the JAX kernel's U
that makes the mirror faithful, the wrapper's refusals before any build,
and chip_smoke.py's reading of the kernels' ptxas and SASS facts."""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mp_gemm.ops import mp_syrk as j_syrk
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.mp_gemm import mp_gemm as syrk_kernel
from test_torch_kernels import _syrk_offband_bound

torch.set_num_threads(1)


# The specification of the device's grids and block mapping, written out in
# Python; csrc/mp_syrk.cu is the one implementation (mp_syrk_launch sizes
# the grids from band_row_start / off_row_start, and each block finds its
# (bi, bj) with tile_row_of, band_block and off_block).  Here the
# specification is held to covering the square once.
def _band_row_start(r: int, band: int, t: int) -> int:
    """Band blocks in tile rows < t: tile row ti holds the lower half of its
    diagonal tile (r (r + 1) / 2 blocks) and min(ti, band - 1) whole tiles."""
    b1 = band - 1
    whole = t * (t - 1) // 2 if t <= b1 + 1 else b1 * (b1 + 1) // 2 + (t - b1 - 1) * b1
    return t * r * (r + 1) // 2 + whole * r * r


def _off_row_start(r: int, band: int, t: int) -> int:
    """Off-band blocks in tile rows < t: tile row ti holds max(0, ti - band
    + 1) whole tiles."""
    x = max(0, t - band)
    return x * (x + 1) // 2 * r * r


def _plan(m: int, tile: int, band_blocks: int, bm: int, lo=torch.bfloat16):
    """The two kernels' 1-D grids over the lower blocks of one call: `band`
    and `off` lower blocks (bi >= bj) of bm x bm, r = tile // bm along each
    side of a tile; with lo = fp32 every block is in the band."""
    n_tiles = m // tile
    band = n_tiles if lo == torch.float32 else min(band_blocks, n_tiles)
    r = tile // bm
    return dict(bm=bm, r=r, n_tiles=n_tiles, band_blocks=band,
                band=_band_row_start(r, band, n_tiles),
                off=_off_row_start(r, band, n_tiles))


def _tile_row(start, idx, n_tiles):
    lo, hi = 0, n_tiles - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if start(mid) <= idx:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _band_block(pl, idx):
    """Tile row ti holds, per block row a, min(ti, band - 1) r whole-tile
    blocks and a + 1 blocks of its diagonal tile, in column order."""
    r, band = pl["r"], pl["band_blocks"]
    start = lambda t: _band_row_start(r, band, t)  # noqa: E731
    ti = _tile_row(start, idx, pl["n_tiles"])
    q = idx - start(ti)
    wr = min(ti, band - 1) * r
    a = 0
    while a + 1 < r and q >= wr + a + 1:
        q -= wr + a + 1
        a += 1
    return ti * r + a, ti * r - wr + q


def _off_block(pl, idx):
    """Tile row ti holds its off-band tiles' blocks column-major."""
    r, band = pl["r"], pl["band_blocks"]
    start = lambda t: _off_row_start(r, band, t)  # noqa: E731
    ti = _tile_row(start, idx, pl["n_tiles"])
    q = idx - start(ti)
    return ti * r + q % r, q // r


def _syrk_products(n_t, t):
    """(in-band, off-band) lower tile products, diagonal included, as
    chip_smoke.py reckons them."""
    in_band = sum(min(i + 1, t) for i in range(n_t))
    return in_band, n_t * (n_t + 1) // 2 - in_band


@pytest.mark.parametrize("lo", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("band", [1, 2, 8, 70])
@pytest.mark.parametrize("n_tiles", [1, 2, 5, 63])
def test_plan_covers_the_square_once(n_tiles, band, bm, lo):
    tile = 256 if n_tiles < 63 else 128   # r = 4 or 2 blocks per tile side
    m = n_tiles * tile
    pl = _plan(m, tile, band, bm, lo)
    nb = m // bm
    seen = np.zeros((nb, nb), np.int64)
    band_eff = n_tiles if lo == torch.float32 else min(band, n_tiles)
    for kind, count, find in (("band", pl["band"], _band_block),
                              ("off", pl["off"], _off_block)):
        for idx in range(count):
            bi, bj = find(pl, idx)
            assert 0 <= bj <= bi < nb
            in_band = abs(bi // pl["r"] - bj // pl["r"]) < band_eff
            assert in_band == (kind == "band"), (kind, idx, bi, bj)
            seen[bi, bj] += 1
            if bi != bj:
                seen[bj, bi] += 1       # the mirror
    assert (seen == 1).all()
    # counts against the tile products: an off-band tile is r^2 blocks; a
    # diagonal tile is its r (r + 1) / 2 lower blocks, the rest mirrored
    r = tile // bm
    in_p, off_p = _syrk_products(n_tiles, band_eff)
    assert pl["off"] == off_p * r * r
    assert pl["band"] == in_p * r * r - n_tiles * r * (r - 1) // 2


@pytest.mark.parametrize("m_t", [63, 32, 8, 1])
def test_plan_at_the_main_path_steps(m_t):
    """The panel path's calls: P = (m_t 1024, 1024), tile 1024, band 8."""
    pl = _plan(m_t * 1024, 1024, 8, 128)
    in_p, off_p = _syrk_products(m_t, 8)
    if m_t == 63:
        assert (in_p, off_p) == (476, 1540)
    assert pl["off"] == off_p * 64 and pl["band"] == in_p * 64 - m_t * 28
    assert _band_block(pl, 0) == (0, 0)
    assert _band_block(pl, pl["band"] - 1) == (m_t * 8 - 1, m_t * 8 - 1)
    if pl["off"]:
        assert _off_block(pl, pl["off"] - 1) == (m_t * 8 - 1, (m_t - 8) * 8 - 1)


# the shapes of test_torch_kernels.py::test_mp_syrk_ref_matches_jax
@pytest.mark.parametrize("m,k,bm,bk,band", [
    (256, 128, 64, 64, 1), (256, 128, 64, 64, 2), (128, 256, 64, 128, 1),
    (256, 64, 128, 64, 4),
])
def test_jax_kernel_u_is_symmetric(m, k, bm, bk, band):
    """Mirroring the lower blocks keeps the TPU kernel's result: its own U
    equals U^T, in the band within rel 1e-5 and off the band within the
    off-band bound the parity tests use."""
    p = np.array(jax.random.normal(jax.random.PRNGKey(4), (m, k), jnp.float32))
    u = np.asarray(j_syrk(p, band_blocks=band, bm=bm, bk=bk), np.float64)
    tiles = np.arange(m) // bm
    in_band = np.abs(tiles[:, None] - tiles[None, :]) < band
    d = np.abs(u - u.T)
    assert d[in_band].max() <= 1e-5 * np.abs(u[in_band]).max()
    bound = _syrk_offband_bound(p, bk)
    assert np.all(d[~in_band] <= bound[~in_band])


def _plan_pair(m, tile, band_blocks, pair):
    """The C entry's two grids for a pair code (mp_gemm.PAIRS), both over
    blocks of the wrapper's `block` (128 where it divides the tile, else
    64): the band kernel's and the off-band kernel's; the all-hi pairs put
    every tile in the band."""
    bm = syrk_kernel.block(tile)
    lo = torch.float32 if pair in (1, 3) else torch.bfloat16
    return _plan(m, tile, band_blocks, bm, lo), _plan(m, tile, band_blocks, bm, lo)


@pytest.mark.parametrize("tile", [64, 128, 192, 256, 320, 512, 1024])
@pytest.mark.parametrize("pair", [2, 3])
@pytest.mark.parametrize("band", [1, 2, 8, None])
@pytest.mark.parametrize("n_tiles", [1, 2, 5, 9])
def test_fp64_pair_plans_cover_the_square_once(n_tiles, band, pair, tile):
    """The fp64 DMMA band kernel's and the fp32 off-band kernel's bm x bm
    blocks (bm = 128 where it divides the tile, else 64) cover U once, each
    lower block with its mirror, for every tile mp_gemm.launch accepts and
    bands from 1 to n_tiles (None)."""
    band = n_tiles if band is None else band
    m = n_tiles * tile
    pb, po = _plan_pair(m, tile, band, pair)
    bm = 128 if tile % 128 == 0 else 64
    assert pb["bm"] == po["bm"] == bm and pb["r"] == tile // bm
    band_eff = n_tiles if pair == 3 else min(band, n_tiles)
    cells = m // bm
    seen = np.zeros((cells, cells), np.int64)
    for pl, count, find in ((pb, pb["band"], _band_block),
                            (po, po["off"] if pair == 2 else 0, _off_block)):
        for idx in range(count):
            bi, bj = find(pl, idx)
            assert 0 <= bj <= bi
            in_band = abs(bi // pl["r"] - bj // pl["r"]) < band_eff
            assert in_band == (find is _band_block)
            seen[bi, bj] += 1
            if bi != bj:
                seen[bj, bi] += 1
    assert (seen == 1).all()
    if pair == 3:
        assert po["off"] == 0


@pytest.mark.parametrize("m_t,t", [(63, 8), (39, 2)])
def test_fp64_pair_plan_at_step_0(m_t, t):
    """The panel path's (63 tile rows, band 8) and the tile path's (39,
    band 2) step 0 at tile 1024: 8 x 8 blocks of 128 per tile for both the
    fp64 band and the fp32 off-band kernel."""
    pb, po = _plan_pair(m_t * 1024, 1024, t, 2)
    in_p, off_p = _syrk_products(m_t, t)
    assert pb["r"] == 8 and po["r"] == 8
    assert pb["band"] == in_p * 64 - m_t * 8 * 7 // 2
    assert po["off"] == off_p * 64
    assert _band_block(pb, 0) == (0, 0)
    assert _band_block(pb, pb["band"] - 1) == (m_t * 8 - 1, m_t * 8 - 1)
    assert _off_block(po, po["off"] - 1) == (m_t * 8 - 1, (m_t - t) * 8 - 1)


@pytest.mark.parametrize("m,kdim,tile,round_k", [
    (256, 128, 64, 32),     # round_k not a multiple of 64
    (256, 128, 64, 96),     # ... nor dividing kdim
    (256, 128, 32, 64),     # tile not a multiple of 64
    (256, 128, 96, 64),     # ... nor dividing m
    (256, 128, 64, 0),
])
def test_wrapper_refuses_shapes_before_any_build(m, kdim, tile, round_k):
    reset_launch_counts()
    with pytest.raises(ValueError, match="round_k % 64 == 0"):
        syrk_kernel.launch(torch.ones(m, kdim), tile=tile, round_k=round_k,
                           band_blocks=1, hi=torch.float32, lo=torch.bfloat16,
                           accum=torch.float32)
    assert launch_counts()["mp_syrk"] == 0



def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_MANGLED = "_ZN43_GLOBAL__N__8844ba60_10_mp_syrk_cu_3d279d5a{}"
_DMMA = _MANGLED.format("25syrk_band_f64_dmma_kernelILi128EEEvPKdPdiiNS_4GridE")
_BF16 = _MANGLED.format("30syrk_offband_bf16_wgmma_kernelILi64ELb1EEEv14CUtensorMap_stPfiiiNS_4GridE")
_F32 = _MANGLED.format("34syrk_offband_fp32_pipelined_kernelILi64EEEvPKfPdiiNS_4GridE")


def test_chip_smoke_reads_ptxas_usage(tmp_path):
    """The build line's registers and spills per mp_syrk instantiation,
    from ptxas -v's log; kernels of other sources are left out."""
    log = tmp_path / "nvcc.log"
    log.write_text("\n".join([
        "[nvcc mp_syrk.cu]",
        f"ptxas info    : Compiling entry function '{_DMMA}' for 'sm_90a'",
        f"ptxas info    : Function properties for {_DMMA}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 194 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{_BF16}' for 'sm_90a'",
        f"ptxas info    : Function properties for {_BF16}",
        "    56 bytes stack frame, 72 bytes spill stores, 60 bytes spill loads",
        "ptxas info    : Used 128 registers, used 2 barriers",
        "ptxas info    : Compiling entry function '_Z13other_kernelPf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 12 registers, used 0 barriers"]))
    cs = _chip_smoke()
    assert cs.ptxas_usage(log, cs.SYRK_KERNELS) == {
        "syrk_band_f64_dmma_kernel<128>": dict(stack=0, spill_stores=0,
                                               spill_loads=0, registers=194),
        "syrk_offband_bf16_wgmma_kernel<64,1>": dict(
            stack=56, spill_stores=72, spill_loads=60, registers=128)}


def test_chip_smoke_counts_sass_ops(monkeypatch):
    """The build line's DMMA / DFMA / FFMA counts per mp_syrk kernel, from
    cuobjdump -sass, which the fp64 band's DMMA check reads."""
    sass = "\n".join([
        "\tcode for sm_90a",
        f"\t\tFunction : {_DMMA}",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */",
        "        /*08f0*/                   DMMA.1684 R24, R116, R120, R24 ;",
        "        /*0900*/                   DMMA.1684 R28, R116, R122, R28 ;",
        f"\t\tFunction : {_F32}",
        "        /*0100*/                   FFMA R3, R4, R5, R3 ;",
        "\t\tFunction : _Z13other_kernelPf",
        "        /*0100*/                   DFMA R4, R6, R8, R4 ;"])
    cs = _chip_smoke()
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "_nvcc", lambda: "/cuda/bin/nvcc")
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout=sass)

    monkeypatch.setattr(cs.subprocess, "run", run)
    assert cs.sass_counts("lib.so", cs.SYRK_KERNELS) == {
        "syrk_band_f64_dmma_kernel<128>": dict(DMMA=2, DFMA=0, FFMA=0),
        "syrk_offband_fp32_pipelined_kernel<64>": dict(DMMA=0, DFMA=0, FFMA=1)}
    assert calls == [["/cuda/bin/cuobjdump", "-sass", "lib.so"]]
