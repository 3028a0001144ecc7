"""Logical-axis sharding: model code declares WHAT each dim is, the mesh
layer decides WHERE it goes (MaxText-style logical axis rules).

The port of `repro.models.sharding`.  Every param of the model zoo has
logical axes (`transformer.lm_axes`): a packed string of names, one per
dim (`ax`).  `resolve_spec` maps them onto a mesh's axes with the
reference's divisibility fallback, so one set of rules serves the 1 x 1
smoke mesh, the 16 x 16 pod and the 2 x 16 x 16 multi-pod mesh.

A "mesh" is anything with `axis_names` and `devices.shape`, as the
reference reads it (`launch/mesh.py` builds process-free ones).  A spec is
the port's own `PartitionSpec`, a tuple with one entry per dim: None, an
axis name, or a tuple of names.  Turning a spec into DTensor placements
waits for runs on more than one card (ROADMAP A 18).
"""

from __future__ import annotations

import math

from ..optim.adamw import tree_map

# logical axis -> preferred physical axes, in priority order (the
# reference's table, entry for entry).  "fsdp" rules shard parameters over
# the data axis (ZeRO-3 style).
DEFAULT_RULES: dict[str | None, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),                    # activations: unsharded by default
    "seq_shard": ("data",),       # long-context KV/state sharding (SP)
    "embed": ("data",),           # fsdp dim of params
    "embed_no_fsdp": (),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ffn": ("model",),
    "experts": ("model",),        # EP
    "expert_ffn": ("model",),     # fallback TP when n_experts < model axis
                                  # (grok-1: 8 experts on a 16-way axis)
    "ssm_inner": ("model",),
    "ssm_state": (),
    "conv": (),
    "cycles": (),                 # stacked cycle layers: never sharded
    "frames": (),
    # activation constraints (see constrain() below)
    "act_batch": ("pod", "data"),
    "act_vocab": ("model",),
    "act_ffn": ("model",),
    "act_heads": ("model",),
    "act_experts": ("model",),
    "act_expert_cap": ("data",),  # MoE dispatch-capacity dim
    "act_expert_flat": ("model", "data"),  # flattened (E*C) dispatch dim
    "act_tokens": ("pod", "data"),         # flattened (B*S) token dim
    "act_moe_groups": ("pod", "data"),     # GShard routing-group dim
    # geostat distributed Cholesky (core/distributed.py, launch/mesh.py)
    "geo_rows": ("data",),
    "geo_cols": ("model",),
    # fori variant: rows take BOTH axes, columns whole
    "geo_rows2d": ("data", "model"),
    None: (),
}


class PartitionSpec(tuple):
    """One entry per dim: None (whole), a mesh axis name, or a tuple of
    names (the dim split over their product), normalized as
    `jax.sharding.PartitionSpec` normalizes them: a tuple of one name is
    the name, an empty one None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else (e[0] if len(e) == 1 else tuple(e))
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def shard_count(spec, mesh) -> int:
    """The number of pieces a leaf with `spec` is cut into on `mesh`: the
    product of the sizes of the axes its entries name."""
    sizes = axis_sizes(mesh)
    count = 1
    for entry in spec:
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                count *= sizes[name]
    return count


# ---------------------------------------------------------------------
# Activation sharding constraints.
#
# The reference pins the batch / ffn / vocab dims of key activations so
# that GSPMD does not resolve an FSDP conflict by replicating the batch.
# The port has no SPMD partitioner: with no mesh installed constrain() is
# the identity (it returns its input object), on a one-rank mesh it checks
# the names and returns its input, and on a mesh of more than one rank it
# raises, since laying activations out across cards waits for ROADMAP A 18.
# ---------------------------------------------------------------------

_ACTIVATION_MESH: list = [None]


def set_activation_mesh(mesh):
    """Install (or clear, with None) the mesh used by constrain()."""
    _ACTIVATION_MESH[0] = mesh


def activation_mesh():
    """The mesh constrain() reads (None when none is installed)."""
    return _ACTIVATION_MESH[0]


def constrain(x, logical_axes: str, *, allow_uneven: bool = False):
    mesh = _ACTIVATION_MESH[0]
    if mesh is None:
        return x
    resolve_spec(logical_axes, mesh, shape=tuple(x.shape),
                 allow_uneven=allow_uneven)
    ranks = math.prod(mesh.devices.shape)
    if ranks > 1:
        raise NotImplementedError(
            f"an activation constraint ({logical_axes!r}) on a mesh of "
            f"{ranks} ranks: laying activations out across cards waits for "
            "ROADMAP A 18")
    return x


def ax(*names: str) -> str:
    """Pack logical dim names into a single string: ax("embed", "heads",
    "head_dim") -> "embed heads head_dim".  "." (or None) means
    unsharded."""
    return " ".join(n if n is not None else "." for n in names)


def resolve_spec(logical_axes: str, mesh, rules=None, shape=None,
                 allow_uneven: bool = False) -> PartitionSpec:
    """Map packed logical axis names to a PartitionSpec on `mesh`.

    Divisibility fallback: a physical axis is only used if the dim size is
    divisible by the axis size (checked when `shape` is provided), and each
    axis at most once.  allow_uneven (activation constraints only): accept
    non-divisible dims when dim >= axis size (llava's 56 heads on a
    16-way axis)."""
    rules = rules or DEFAULT_RULES
    names = logical_axes.split(" ") if logical_axes else []
    sizes = axis_sizes(mesh)
    used = set()
    spec = []
    for i, name in enumerate(names):
        cands = rules.get(name, ()) if name != "." else ()
        placed = ()
        for axname in cands:
            if axname not in sizes or axname in used:
                continue
            if shape is not None and shape[i] % sizes[axname] != 0:
                if not (allow_uneven and shape[i] >= sizes[axname]):
                    continue
            placed = placed + (axname,)
            used.add(axname)
        if len(placed) == 0:
            spec.append(None)
        elif len(placed) == 1:
            spec.append(placed[0])
        else:
            spec.append(placed)
    return PartitionSpec(*spec)


def tree_resolve_shardings(params, logical_tree, mesh, rules=None):
    """params tree (tensors, meta ones too) + the parallel logical-axes tree
    -> the tree of their PartitionSpecs on `mesh`."""
    return tree_map(lambda arr, axes: resolve_spec(axes, mesh, rules,
                                                   shape=tuple(arr.shape)),
                    params, logical_tree)


def batch_spec(mesh, *, seq_sharded: bool = False) -> PartitionSpec:
    """Input batch sharding: batch over (pod, data); optionally the seq dim
    over data (long-context cells where batch < n_data)."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    if seq_sharded:
        return PartitionSpec(None, tuple(a for a in ("data",)
                                         if a in mesh.axis_names))
    return PartitionSpec(tuple(axes))
