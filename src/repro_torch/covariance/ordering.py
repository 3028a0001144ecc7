"""Spatial location orderings (Morton and Hilbert space-filling curves).

Counterpart of `repro.covariance.ordering`: the same keys, and stable sorts,
so both packages give the same permutation.
"""

from __future__ import annotations

import numpy as np
import torch


def _part1by1(x):
    """Spread the low 16 bits of x over even bit positions."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def morton_key(locs, bits: int = 16):
    """Morton (Z-order) key per location. locs: (n, 2) in [0, 1)^2."""
    locs = torch.as_tensor(locs)
    scale = (1 << bits) - 1
    # clamp before the (truncating) cast: the reference's uint32 cast
    # saturates, int64 keys hold every 32-bit key without wrapping
    q = torch.clamp(locs * scale, 0, scale).to(torch.int64)
    return _part1by1(q[:, 0]) | (_part1by1(q[:, 1]) << 1)


def morton_order(locs, bits: int = 16):
    """Permutation that sorts locations along the Morton curve."""
    return torch.argsort(morton_key(locs, bits), stable=True)


def hilbert_key_np(locs: np.ndarray, bits: int = 16) -> np.ndarray:
    """Hilbert-curve key (host-side numpy; ordering is a preprocessing step).

    Classic xy -> d conversion with bitwise rotations, vectorized over n.
    """
    locs = np.asarray(locs, dtype=np.float64)
    side = 1 << bits
    x = np.clip((locs[:, 0] * side).astype(np.uint64), 0, side - 1)
    y = np.clip((locs[:, 1] * side).astype(np.uint64), 0, side - 1)
    d = np.zeros_like(x)
    s = np.uint64(side // 2)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((3 * rx) ^ ry)
        # rotate quadrant: if ry == 0 { if rx == 1 mirror; swap x <-> y }
        flip = (ry == 0) & (rx == 1)
        x = np.where(flip, s - 1 - x, x)
        y = np.where(flip, s - 1 - y, y)
        swap = ry == 0
        x, y = np.where(swap, y, x), np.where(swap, x, y)
        s = np.uint64(s // 2)
    return d


def hilbert_order(locs, bits: int = 16):
    """Permutation that sorts locations along the Hilbert curve."""
    locs = torch.as_tensor(locs)
    key = hilbert_key_np(locs.detach().cpu().numpy(), bits)
    return torch.from_numpy(np.argsort(key, kind="stable")).to(locs.device)


def apply_ordering(locs, z, perm):
    """Reorder locations and observations with the same permutation."""
    return locs[perm], (None if z is None else z[perm])


ORDERINGS = {
    "morton": morton_order,
    "hilbert": hilbert_order,
    "none": lambda locs, bits=16: torch.arange(
        locs.shape[0], device=torch.as_tensor(locs).device),
}
