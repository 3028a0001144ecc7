"""Plain PyTorch version of the banded mixed-precision SYRK."""

from __future__ import annotations

import torch


def mp_syrk(p, *, tile, round_k, band_blocks, hi=torch.float32,
            lo=torch.bfloat16, accum=torch.float32):
    """U = P P^T, (m, kdim) -> (m, m) in `hi`, with banded precision.

    Element (r, c) is in the band when |r // tile - c // tile| < band_blocks:
    a `hi` dot product.  Off the band: `lo` operands, products summed in
    `accum` over each `round_k` columns of K, each partial sum rounded to
    `lo`, and the rounded partials summed in `accum`.  Computed one row of
    tiles at a time, so the temporaries stay one (tile, m) slab.  Under the
    paper's pair (hi, lo, accum) = (fp64, fp32, fp32) the band is fp64 and
    the off-band fp32 sums stored as fp64: what the kernel's fp64 pair is
    held to (the reference's `mp_syrk_ref` sums in fp32 whatever hi is).
    """
    m, kdim = p.shape
    if m % tile or kdim % round_k:
        raise ValueError(f"m={m} must divide by tile={tile} and "
                         f"kdim={kdim} by round_k={round_k}")
    n_tiles = m // tile
    p_lo = p.to(lo).to(accum)
    p_hi = p.to(hi)
    out = torch.empty((m, m), dtype=hi, device=p.device)
    for i in range(n_tiles):
        rows = slice(i * tile, (i + 1) * tile)
        acc = torch.zeros((tile, m), dtype=accum, device=p.device)
        for k0 in range(0, kdim, round_k):
            ks = slice(k0, k0 + round_k)
            acc += (p_lo[rows, ks] @ p_lo[:, ks].T).to(lo).to(accum)
        out[rows] = acc.to(hi)
        band = slice(max(0, i - band_blocks + 1) * tile,
                     min(n_tiles, i + band_blocks) * tile)
        out[rows, band] = p_hi[rows] @ p_hi[band].T
    return out


def mp_syrk_grad(g, p, *, tile, band_blocks, hi=torch.float32,
                 lo=torch.bfloat16, accum=torch.float32):
    """The backward of `mp_syrk` in P: dU (m, m) in `hi`, P (m, kdim) ->
    dP (m, kdim) in P's dtype, what autograd through `mp_syrk` gives for a
    dU whose strictly upper tiles are zero.

    Only dU's lower tiles count, a diagonal tile whole: the engines read
    no other tile of U.  With S = L(dU) + L(dU)^T (L keeps the lower
    tiles), dP = S_band P in `hi`, plus the off-band's S rounded to `lo`
    times P rounded to `lo`, the products summed in `accum` over every
    off-band column and the sum rounded once to `lo` (the backward of
    `p.to(lo).to(accum)`), the two added in `hi`.  round_k plays no part:
    each rounded partial's cotangent is the same rounded dU.  Computed one
    row of tiles at a time, so the temporaries stay one (tile, m) slab.
    """
    m, kdim = p.shape
    if m % tile or g.shape != (m, m):
        raise ValueError(f"g {tuple(g.shape)} must be ({m}, {m}) and m={m} "
                         f"divide by tile={tile}")
    n_tiles = m // tile
    p_lo = p.to(lo).to(accum)
    p_hi = p.to(hi)
    g = g.to(hi)
    out = torch.empty((m, kdim), dtype=hi, device=p.device)
    for i in range(n_tiles):
        r0, r1 = i * tile, (i + 1) * tile
        diag = g[r0:r1, r0:r1]
        s = torch.cat([g[r0:r1, :r0], diag + diag.T, g[r1:, r0:r1].T], dim=1)
        b0 = max(0, i - band_blocks + 1) * tile
        b1 = min(n_tiles, i + band_blocks) * tile
        d_hi = s[:, b0:b1] @ p_hi[b0:b1]
        s_lo = s.to(lo).to(accum)
        s_lo[:, b0:b1] = 0
        d_lo = s_lo @ p_lo
        out[r0:r1] = d_hi + d_lo.to(lo).to(hi)
    return out.to(p.dtype)
