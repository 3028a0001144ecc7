"""The yardstick's counts against shapes reckoned by hand."""

import pytest

from geobench import peaks
from geobench.counts import blocked_potrf, evaluation, matern_cov, mp_syrk


def cfg(n, nb, t, hi="float32", lo="bfloat16", solve="float32",
        locs="float32"):
    return dict(n=n, nb=nb, diag_thick=t, hi=hi, lo=lo, solve=solve,
                locations_dtype=locs)


def test_syrk_flops_by_hand():
    # 2 tile rows of side 2, band 1: two diagonal tiles (3 lower elements,
    # 4 operations each) in the band, one whole tile (4 elements) off it
    assert mp_syrk.flops(2, 2, 1) == (2 * 3 * 4, 4 * 4)
    # band 2 takes the off tile in: all 10 lower elements of the 4 x 4
    assert mp_syrk.flops(2, 2, 2) == (10 * 4, 0)


@pytest.mark.parametrize("n_t,nb,t", [(1, 4, 1), (5, 3, 2), (9, 2, 4),
                                      (7, 8, 7), (6, 4, 9)])
def test_syrk_flops_cover_the_lower_triangle_once(n_t, nb, t):
    m = n_t * nb
    band, off = mp_syrk.flops(n_t, nb, t)
    assert band + off == 2 * nb * m * (m + 1) // 2
    assert mp_syrk.products(n_t, t)[0] == sum(min(i + 1, t)
                                              for i in range(n_t))


def test_syrk_launches_and_least_time_by_hand():
    c = cfg(3 * 1024, 1024, 2)
    launches = mp_syrk.launches(c)
    assert len(launches) == 2                       # m_t = 2, 1
    ops, nbytes = launches[0]
    band_f, off_f = mp_syrk.flops(2, 1024, 2)
    assert ops == {"float32": band_f, "bfloat16": off_f}
    assert nbytes == (2048 * 1024 + 2048 ** 2) * 4
    want = max(band_f / 67e12, off_f / 989e12, nbytes / 3.35e12)
    assert peaks.least_seconds(ops, nbytes) == pytest.approx(want)
    # the paper pair: U and P in fp64, the off-band at IEEE fp32's peak
    pair = cfg(3 * 1024, 1024, 1, hi="float64", lo="float32",
               locs="float64")
    ops, nbytes = mp_syrk.launches(pair)[0]
    assert set(ops) == {"float64", "float32"}
    assert nbytes == (2048 * 1024 + 2048 ** 2) * 8


def test_potrf_launches():
    assert len(blocked_potrf.launches(cfg(8 * 64, 64, 2))) == 8
    ops, nbytes = blocked_potrf.launches(cfg(8 * 64, 64, 2))[0]
    assert ops == {"float32": 64 ** 3 / 3} and nbytes == 2 * 64 * 64 * 4
    assert blocked_potrf.launches(cfg(8 * 64, 64, 2, hi="float64",
                                      lo="float32", locs="float64")) == []


def test_matern_launches_by_hand():
    # p = 5, t = 2: band sub-diagonals of 5 and 4 tiles, 6 lower off tiles
    c = cfg(5 * 4, 4, 2)
    launches = matern_cov.launches(c)
    assert len(launches) == 3
    (ops0, b0), (ops1, b1), (ops2, b2) = launches
    assert ops0 == {"float32": 9 * 5 * 16}
    assert b0 == 5 * 16 * 4 + 2 * 5 * 4 * 2 * 4
    assert ops1 == {"float32": 9 * 4 * 16}
    assert ops2 == {"float32": 9 * 6 * 16} and b2 == 6 * 16 * 2 + 20 * 2 * 4


def test_evaluation_operations_by_hand():
    # n = 2, nb = 1, t = 1: POTRF 1/3 twice, one off TRSM (1), the SYRK's
    # one diagonal element (2), the solve n^2 = 4
    ops = evaluation.operations(cfg(2, 1, 1))
    assert ops["float32"] == pytest.approx(1 / 3 * 2 + 1 + 2 + 4)
    assert ops["bfloat16"] == 0


def test_evaluation_is_a_cholesky():
    # the forward's operations are n^3 / 3 and terms of lower order
    n, nb = 65_536, 1_024
    ops = evaluation.operations(cfg(n, nb, 8))
    assert sum(ops.values()) == pytest.approx(n ** 3 / 3, rel=3 * nb / n)
