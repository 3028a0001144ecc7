"""Process grids for the distributed panel engine.

Counterpart of `repro.launch.mesh`: where the reference names a JAX mesh
with axes ("data", "model"), the port names a `Grid` of the ranks of an
initialized `torch.distributed` process group, rank r * model + c at grid
position (r, c).  The grid carries the process groups of each of its rows
and columns, created once, which the engine's collectives run over.

`make_smoke_grid()` is the 1 x 1 grid of one process with no process group:
the same engine code paths with every collective a no-op, as the reference's
1 x 1 smoke mesh runs its model code on one device.

`LAYOUT_RULES` is the part of `repro.models.sharding.DEFAULT_RULES` the
engine reads: each logical dimension of the geostatistics storage and the
grid dimensions it is split over, in order.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

GRID_DIMS = ("data", "model")
# logical dimension -> grid dimensions it is split over
# (repro.models.sharding.DEFAULT_RULES' geostat entries); None: whole
LAYOUT_RULES: dict[str | None, tuple[str, ...]] = {
    "geo_rows": ("data",),
    "geo_cols": ("model",),
    # the fori version: rows over both grid dimensions, columns whole
    "geo_rows2d": ("data", "model"),
    None: (),
}


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """A data x model grid of processes.

    group: the process group the grid spans (None: one process, no group);
    ranks: the global rank at each grid position, r * model + c;
    rank: this process's position in `ranks`;
    row_groups[r], col_groups[c]: the process groups of grid row r and
    grid column c (the grid's own group where a row or column is all of
    it); backend: the groups' backend ("gloo", "nccl"), None without one.
    """
    data: int
    model: int
    group: object = None
    ranks: tuple = (0,)
    rank: int = 0
    row_groups: tuple = (None,)
    col_groups: tuple = (None,)
    backend: str | None = None

    @property
    def size(self) -> int:
        return self.data * self.model

    def check_device(self, tensor: torch.Tensor, what: str = "tensor"):
        """Raise where the tensor's device does not match the backend: NCCL
        takes CUDA tensors, gloo CPU ones (gloo would stage a CUDA tensor
        through the host)."""
        if self.backend is None:
            return
        if (self.backend == "nccl") != tensor.is_cuda:
            raise ValueError(
                f"{what} is on {tensor.device}, but the grid's backend is "
                f"{self.backend}: NCCL takes CUDA tensors and gloo CPU tensors")


def make_grid(data: int, model: int, group=None) -> Grid:
    """The data x model grid over the ranks of `group` (the default group
    where None), which must hold data * model processes.  Every process of
    the default group calls it, in the same order (the rule of
    `torch.distributed.new_group`): it creates the row and column groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_grid needs an initialized torch.distributed "
                           "process group (make_smoke_grid needs none)")
    group = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(group)
    if data < 1 or model < 1 or size != data * model:
        raise ValueError(f"a {data} x {model} grid over {size} processes")
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not in the grid's group")
    ranks = tuple(dist.get_global_rank(group, i) for i in range(size))
    backend = str(dist.get_backend(group))

    def sub(members):
        members = list(members)
        if len(members) == size:
            return group
        return dist.new_group(members, backend=backend)
    rows = tuple(sub(ranks[r * model:(r + 1) * model]) for r in range(data))
    cols = tuple(sub(ranks[c::model]) for c in range(model))
    return Grid(data=data, model=model, group=group, ranks=ranks, rank=rank,
                row_groups=rows, col_groups=cols, backend=backend)


def make_smoke_grid() -> Grid:
    """1 x 1 grid of this process with no process group."""
    return Grid(data=1, model=1)


def grid_num_ranks(grid: Grid) -> int:
    return grid.size
