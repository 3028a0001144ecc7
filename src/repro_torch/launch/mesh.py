"""Process grids for the distributed panel engine.

Counterpart of `repro.launch.mesh`: where the reference names a JAX mesh
with axes ("data", "model"), the port names a `Grid` of the ranks of an
initialized `torch.distributed` process group, rank r * model + c at grid
position (r, c).  The grid carries the process groups of each of its rows
and columns, created once, which the engine's collectives run over.

`make_smoke_grid()` is the 1 x 1 grid of one process with no process group:
the same engine code paths with every collective a no-op, as the reference's
1 x 1 smoke mesh runs its model code on one device.

`LAYOUT_RULES` is the part of `models.sharding.DEFAULT_RULES` the engine
reads: each logical dimension of the geostatistics storage and the grid
dimensions it is split over, in order.

The planner's meshes are shapes, not processes: `make_production_mesh`
((16, 16) or (2, 16, 16), the reference's axis names) and
`make_smoke_mesh` (1 x 1) give objects with `axis_names` and
`devices.shape`, which `models.sharding` resolves specs on and
`launch/dryrun.py` plans cells for.  Beside them the rates the roofline
divides by: `H100` (the card the port runs on) and `V5E` (the reference's
TPU v5e numbers, which its cost model was written for).
"""

from __future__ import annotations

import dataclasses
import math
import types

import torch
import torch.distributed as dist

from ..models.sharding import DEFAULT_RULES

GRID_DIMS = ("data", "model")
# logical dimension -> grid dimensions it is split over: DEFAULT_RULES'
# geostat entries (the fori version's "geo_rows2d": rows over both grid
# dimensions, columns whole); None: whole
LAYOUT_RULES: dict[str | None, tuple[str, ...]] = {
    k: DEFAULT_RULES[k] for k in ("geo_rows", "geo_cols", "geo_rows2d", None)}


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


# ---------------------------------------------------------------------
# the planner's meshes and rates
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh as the planner reads one: axis names and their sizes, no
    processes and no devices (`devices` carries only a shape)."""
    shape: tuple
    axis_names: tuple

    @property
    def devices(self):
        return types.SimpleNamespace(shape=self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_smoke_mesh() -> MeshShape:
    """1 x 1 with the production axis names: the one mesh one card can
    check."""
    return MeshShape((1, 1), ("data", "model"))


def mesh_num_devices(mesh) -> int:
    return math.prod(mesh.devices.shape)


# dtype -> the rate name its products run at
_RATE_OF = {torch.bfloat16: "bf16", torch.float16: "bf16",
            torch.float32: "fp32", torch.float64: "fp64",
            torch.float8_e4m3fn: "fp8", torch.float8_e5m2: "fp8"}


@dataclasses.dataclass(frozen=True)
class Rates:
    """One chip's peak rates for the roofline.

    flops: rate name ("bf16", "fp32", "fp64", "fp8") -> dense FLOP/s;
    hbm_bw: device memory B/s; link_bw: B/s a chip of the slowest fabric a
    mesh axis crosses; hbm_bytes: device memory a chip; tier_weight: fixed
    bf16-equivalent weights of the precision tiers "hi", "lo", "lo2" and
    "scores" (the LM's q k^T product, which the port computes in fp32):
    the reference's TIER_WEIGHT, or None to weigh each by its dtype's rate;
    source: where the numbers come from; nvlink_bw: NVLink's B/s a
    direction a GPU, recorded beside link_bw (a 16-way axis crosses the
    slower fabric), not divided by."""
    name: str
    flops: dict
    hbm_bw: float
    link_bw: float
    hbm_bytes: float
    source: str
    tier_weight: dict | None = None
    nvlink_bw: float | None = None

    @property
    def peak_bf16(self) -> float:
        return self.flops["bf16"]

    def weight(self, tier: str, dtype) -> float:
        """The bf16-equivalent cost of one FLOP of precision tier `tier`
        ("hi", "lo", "lo2") computed in `dtype`: the fixed weight where the
        rates carry one, else the bf16 peak over the dtype's peak."""
        if self.tier_weight is not None:
            return self.tier_weight[tier]
        return self.flops["bf16"] / self.flops[_RATE_OF[dtype]]


# NVIDIA H100 SXM5 (80 GB HBM3): the H100 Tensor Core GPU data sheet's dense
# rates (no sparsity): bf16 989.4 TFLOP/s, fp8 1,978.9, fp64 on the tensor
# cores 67, fp32 67 (IEEE fp32, no TF32: the port keeps TF32 off); 3.35 TB/s
# HBM3 and 80 GB.  The link: a 16-way mesh axis spans two 8-GPU NVLink
# nodes, joined by one 400 Gb/s InfiniBand NIC a GPU (the DGX H100 data
# sheet: eight ConnectX-7 at 400 Gb/s): 50e9 B/s a GPU; NVLink itself
# moves 450e9 B/s a direction a GPU (900 GB/s both ways).
H100 = Rates(
    name="H100",
    flops={"bf16": 989e12, "fp32": 67e12, "fp64": 67e12, "fp8": 1979e12},
    hbm_bw=3.35e12, link_bw=50e9, hbm_bytes=80e9,
    source="NVIDIA H100 Tensor Core GPU data sheet (SXM5: dense bf16 989 "
           "TFLOP/s, fp8 1,979, fp64 tensor core 67, fp32 67, HBM3 3.35 "
           "TB/s, 80 GB); DGX H100 data sheet (400 Gb/s InfiniBand a GPU "
           "across nodes: 50 GB/s; NVLink 450 GB/s a direction)",
    nvlink_bw=450e9)

# The reference's TPU v5e numbers (repro.launch.mesh, .costmodel): bf16
# 197e12 FLOP/s, 819e9 B/s HBM, 50e9 B/s an ICI link, 16 GiB a chip; its
# MXU weights fp32 ~6x bf16 and fp8 ~0.5x.  Kept so that the cost model can
# be held to the reference's numbers; none of them is the card's.
V5E = Rates(
    name="V5E",
    flops={"bf16": 197e12, "fp32": 197e12 / 6.0, "fp8": 197e12 / 0.5},
    hbm_bw=819e9, link_bw=50e9, hbm_bytes=16 * 2 ** 30,
    source="the reference's TPU v5e constants (repro.launch.mesh: bf16 "
           "197e12 FLOP/s, HBM 819e9 B/s, ICI link 50e9 B/s; 16 GiB a chip)",
    tier_weight={"hi": 6.0, "lo": 1.0, "lo2": 0.5, "scores": 1.0})
