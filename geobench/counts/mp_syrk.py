"""mp_syrk: U = P P^T of a step's panel column P = (m_t nb, nb) in hi, its
lower tiles inside the band in hi and outside it in lo; p - 1 launches an
evaluation (m_t = p - 1, ..., 1).

Copied from chip_smoke.py (`lower_band_tiles`, `syrk_products`,
`syrk_flops`, `syrk_step_numbers`): 2 nb operations per element of a lower
tile, a diagonal tile's lower triangle only; the bytes P read once and the
m_t nb square of U written once, in hi (chip_smoke counted fp32; here the
configuration's hi)."""

from .. import peaks
from . import geometry, summed_least_seconds


def lower_band_tiles(n_t: int, t: int) -> int:
    """Tile pairs (i, j) of an n_t x n_t grid with 0 <= i - j < t."""
    return sum(min(i + 1, t) for i in range(n_t))


def products(n_t: int, t: int):
    """(in-band, off-band) lower tile products, the diagonal among them."""
    in_band = lower_band_tiles(n_t, t)
    return in_band, n_t * (n_t + 1) // 2 - in_band


def flops(n_t: int, nb: int, t: int):
    """(in-band, off-band) operations of a SYRK of n_t tile rows."""
    in_band, off_band = products(n_t, t)
    whole, diag = nb * nb, nb * (nb + 1) // 2
    return (2 * nb * ((in_band - n_t) * whole + n_t * diag),
            2 * nb * off_band * whole)


def launches(cfg: dict):
    p, t, nb = geometry(cfg)
    hi, lo = cfg["hi"], cfg["lo"]
    out = []
    for m_t in range(p - 1, 0, -1):
        band_f, off_f = flops(m_t, nb, t)
        nbytes = (m_t * nb * nb + (m_t * nb) ** 2) * peaks.BYTES[hi]
        out.append(({hi: band_f, lo: off_f} if hi != lo else
                    {hi: band_f + off_f}, nbytes))
    return out


def least_seconds(cfg: dict) -> float:
    return summed_least_seconds(launches(cfg))
