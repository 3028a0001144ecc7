"""The operations one evaluation of the panel engine needs, by the
precision each runs in, and their least time at the data sheet's peaks:
the yardstick of `eval_mfu`.

Step k of p (m_t = p - k - 1 tile rows below the diagonal), as
`repro_torch.core.panel_cholesky` orders the algorithm (launch/costmodel.py
counts the same steps; the SYRK from `mp_syrk.flops`):
  POTRF of the diagonal tile: nb^3 / 3 in hi;
  TRSM of the min(t - 1, m_t) band panel tiles: nb^3 each in hi, and of the
  rest of the panel column: nb^3 each in the solve precision;
  the SYRK's lower tiles: in-band in hi, off-band in lo;
then the forward solve, n^2 in hi.  The covariance is counted in bytes
(`matern_cov`) and not here.

Each operation at the peak of its precision, summed over the evaluation:
the time the card would take doing nothing else at its data-sheet rates."""

from .. import peaks
from . import geometry, mp_syrk


def operations(cfg: dict) -> dict:
    """Operations of one evaluation by precision."""
    p, t, nb = geometry(cfg)
    n = cfg["n"]
    hi, lo, solve = cfg["hi"], cfg["lo"], cfg["solve"]
    ops = {hi: 0.0, lo: 0.0, solve: 0.0}
    tile3 = float(nb) ** 3
    for k in range(p):
        m_t = p - k - 1
        n_bp = min(t - 1, m_t)
        ops[hi] += tile3 / 3
        ops[hi] += n_bp * tile3
        ops[solve] += (m_t - n_bp) * tile3
        if m_t:
            band_f, off_f = mp_syrk.flops(m_t, nb, t)
            ops[hi] += band_f
            ops[lo] += off_f
    ops[hi] += float(n) ** 2
    return ops


def least_seconds(cfg: dict) -> float:
    return sum(f / peaks.FLOPS[d] for d, f in operations(cfg).items())
