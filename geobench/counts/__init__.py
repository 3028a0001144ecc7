"""Operations and bytes of each kernel of the port, and of a whole
evaluation, from the shapes of one evaluation of a configuration: the
yardstick of the roofline and MFU metrics.  One file per kernel, each
naming where its arithmetic was copied from.  `launches(cfg)` gives one
evaluation's launches of that kernel as (ops by precision, bytes) pairs;
`least_seconds(cfg)` their summed least time (`peaks.least_seconds`)."""

from .. import peaks


def geometry(cfg: dict):
    """(p, t, nb): the panel count, the band's tile sub-diagonals (cut to
    p) and the tile side."""
    nb = cfg["nb"]
    p = cfg["n"] // nb
    return p, min(cfg["diag_thick"], p), nb


def summed_least_seconds(launches) -> float:
    return sum(peaks.least_seconds(ops, nbytes) for ops, nbytes in launches)
