"""The benchmark's data: a frozen copy, in plain PyTorch, of the port's
synthetic generator (`repro_torch.covariance.generator`: the perturbed
grid and the exact field draw) and of its Morton ordering
(`repro_torch.covariance.ordering`).

Frozen so that a change to the program cannot change what the benchmark
feeds it: the same seed gives the same locations and field on any later
commit.  Everything is drawn on the generator's device.
"""

from __future__ import annotations

import math

import torch

ROWS_PER_CHUNK = 1024   # rows of the covariance built at a time


def locations(gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, 2) fp32 locations: a ceil(sqrt(n))^2 grid in (0, 1)^2, each
    point moved by uniform jitter of +-0.4 of the spacing, the first n."""
    m = math.ceil(math.sqrt(n))
    dev = gen.device
    xs, ys = torch.meshgrid(torch.arange(m, device=dev),
                            torch.arange(m, device=dev), indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).float()
    jitter = torch.rand((m * m, 2), generator=gen, dtype=torch.float32,
                        device=dev) * 0.8 - 0.4
    return ((grid + 0.5 + jitter) / m)[:n]


def _matern_half_integer(x: torch.Tensor, nu: float) -> torch.Tensor:
    if nu == 0.5:
        return torch.exp(-x)
    if nu == 1.5:
        return (1.0 + x) * torch.exp(-x)
    if nu == 2.5:
        return (1.0 + x + x * x / 3.0) * torch.exp(-x)
    raise ValueError(f"no closed form for nu={nu}")


def field(gen: torch.Generator, locs: torch.Tensor, theta0, nu: float,
          jitter: float) -> torch.Tensor:
    """z ~ N(0, Sigma(theta0) + jitter I) in fp32, exactly: Sigma built
    ROWS_PER_CHUNK rows at a time, its dense Cholesky factor L, z = L eps."""
    n = locs.shape[0]
    th1, th2 = float(theta0[0]), float(theta0[1])
    cov = torch.empty((n, n), dtype=torch.float32, device=locs.device)
    for r0 in range(0, n, ROWS_PER_CHUNK):
        a = locs[r0:r0 + ROWS_PER_CHUNK]
        dx = a[:, 0, None] - locs[None, :, 0]
        dy = a[:, 1, None] - locs[None, :, 1]
        r = torch.sqrt(dx * dx + dy * dy)
        c = th1 * _matern_half_integer(r / th2, nu)
        cov[r0:r0 + ROWS_PER_CHUNK] = torch.where(r == 0.0, th1, c)
    cov.diagonal().add_(jitter)
    chol = torch.linalg.cholesky(cov)
    del cov
    eps = torch.randn((n,), generator=gen, dtype=torch.float32,
                      device=locs.device)
    return chol @ eps


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def morton_order(locs: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """The permutation that sorts locations in [0, 1)^2 along the Morton
    (Z-order) curve, stable."""
    scale = (1 << bits) - 1
    q = torch.clamp(locs * scale, 0, scale).to(torch.int64)
    key = _part1by1(q[:, 0]) | (_part1by1(q[:, 1]) << 1)
    return torch.argsort(key, stable=True)


def make(seed: int, cfg: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(locs (n, 2), z (n,)), fp32, Morton-ordered, drawn from `seed` on
    `device` under the configuration's n, theta0, nu and field_jitter."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    locs = locations(gen, cfg["n"])
    z = field(gen, locs, cfg["theta0"], cfg["nu"], cfg["field_jitter"])
    perm = morton_order(locs)
    return locs[perm].contiguous(), z[perm].contiguous()
