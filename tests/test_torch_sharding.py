"""The port's logical axes and spec resolution (`repro_torch.models.sharding`,
`transformer.lm_axes`) against `repro.models.sharding` and the reference's
`init_lm` axes: every arch's axes tree leaf for leaf, at SMOKE and at full
size (init_lm traced by `jax.eval_shape`, the axes taken out by a side
channel, as the reference's dry-run takes them; llama's SMOKE also from the
reference's `init_train_state`, which calls it), one name a dim of the port's meta
params, the specs on (16, 16) and (2, 16, 16) fake meshes over every leaf,
the reference test's MoE cases, allow_uneven, batch_spec, the dry-run's
cache and input rules, and `constrain` with and without a mesh.

Specs compare as tuples: jax's PartitionSpec and the port's hold the same
entries."""

import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS, SMOKE_ARCHS
from repro.models import sharding as js
from repro.models.transformer import init_lm as j_init_lm
from repro_torch.configs import LM_CONFIGS, LM_SMOKE_CONFIGS, SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm_axes
from repro_torch.models import sharding as ts
from repro_torch.models.transformer import forward_lm, init_lm

torch.set_num_threads(1)

ARCHS = list(ALL_ARCHS)


class FakeMesh:
    """A mesh as both packages read one (tests/test_sharding.py's)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], pre + (k,))
    else:
        yield pre, tree


_REF = {}


def _ref_traced(cfg):
    """(the reference's axes tree, its params' shapes): init_lm traced by
    jax.eval_shape, the axes (strings) taken out by a side channel, as
    the reference's dry-run takes them; nothing is drawn."""
    box = {}

    def params_only(key):
        p, a = j_init_lm(key, cfg)
        box["axes"] = a
        return p
    shapes = jax.eval_shape(params_only, jax.random.PRNGKey(0))
    return box["axes"], shapes


def _ref_full(arch):
    if arch not in _REF:
        _REF[arch] = _ref_traced(ALL_ARCHS[arch])
    return _REF[arch]


def _jax_dryrun():
    """repro.launch.dryrun, imported without leaving its 512-device
    XLA_FLAGS behind."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_equal_the_reference_at_full_size(arch):
    ref, _ = _ref_full(arch)
    assert dict(_flat(lm_axes(LM_CONFIGS[arch]))) == dict(_flat(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_equal_the_reference_at_smoke(arch):
    """At SMOKE size (init_lm called directly, with its draws, in
    test_init_train_state_returns_the_axes)."""
    ref, _ = _ref_traced(SMOKE_ARCHS[arch])
    assert dict(_flat(lm_axes(LM_SMOKE_CONFIGS[arch]))) == dict(_flat(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_name_every_dim_of_the_meta_params(arch):
    """The axes tree has the params tree's structure and one name a dim,
    the stacked leaves "cycles" first."""
    cfg = LM_CONFIGS[arch]
    params = dict(_flat(init_lm(torch.Generator(), cfg, device="meta")))
    axes = dict(_flat(lm_axes(cfg)))
    assert set(params) == set(axes)
    for path, x in params.items():
        names = axes[path].split(" ")
        assert len(names) == x.ndim, (path, axes[path], tuple(x.shape))
        assert (names[0] == "cycles") == (path[0] in ("cycles", "enc_cycles"))


def test_init_train_state_returns_the_axes():
    from repro.train import TrainConfig as JTC, init_train_state as j_init
    from repro_torch.train import TrainConfig, init_train_state
    cfg = LM_SMOKE_CONFIGS["llama3.2-1b"]
    state, axes = init_train_state(torch.Generator().manual_seed(0), cfg,
                                   TrainConfig(), device="cpu")
    _, j_axes = j_init(jax.random.PRNGKey(0), SMOKE_ARCHS["llama3.2-1b"],
                       JTC())
    assert axes == lm_axes(cfg)
    assert dict(_flat(axes)) == dict(_flat(j_axes))
    assert set(dict(_flat(axes))) == set(dict(_flat(state["params"])))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference_over_every_leaf(arch, mesh, monkeypatch):
    """resolve_spec leaf by leaf and tree_resolve_shardings (the
    reference's NamedSharding replaced by its spec: a fake mesh backs
    none) on the full-size tree."""
    fake = FakeMesh(*MESHES[mesh])
    ref_axes, shapes = _ref_full(arch)
    monkeypatch.setattr(js, "NamedSharding", lambda m, spec: spec)
    ref = dict(_flat(js.tree_resolve_shardings(shapes, ref_axes, fake)))
    params = init_lm(torch.Generator(), LM_CONFIGS[arch], device="meta")
    axes = lm_axes(LM_CONFIGS[arch])
    mine = dict(_flat(ts.tree_resolve_shardings(params, axes, fake)))
    assert set(mine) == set(ref)
    for path, spec in mine.items():
        assert tuple(spec) == tuple(ref[path]), path
    flat_axes, flat_params = dict(_flat(axes)), dict(_flat(params))
    for path, a in flat_axes.items():
        shape = tuple(flat_params[path].shape)
        assert tuple(ts.resolve_spec(a, fake, shape=shape)) == tuple(
            js.resolve_spec(a, fake, shape=shape))


@pytest.mark.parametrize("axes, shape, mesh", [
    (("kv_heads", "head_dim"), (8, 128), "16x16"),
    (("experts", "embed", "expert_ffn"), (8, 6144, 32768), "16x16"),
    (("experts", "embed", "expert_ffn"), (128, 2048, 768), "16x16"),
    (("batch", "."), (256, 128), "2x16x16"),
    (("act_expert_flat", "."), (327680, 6144), "2x16x16"),
    (("geo_rows2d", "."), (524288, 8192), "16x16"),
])
def test_the_reference_tests_cases(axes, shape, mesh):
    """tests/test_sharding.py's cases (grok-1's 8 experts on a 16-way axis
    fall back to TP on expert_ffn; qwen3-moe's 128 take EP) and the
    geostat rows over both axes."""
    fake = FakeMesh(*MESHES[mesh])
    got = ts.resolve_spec(ts.ax(*axes), fake, shape=shape)
    assert tuple(got) == tuple(js.resolve_spec(js.ax(*axes), fake,
                                               shape=shape))


@pytest.mark.parametrize("shape", [(4, 56, 128, 128), (4, 40, 32, 32),
                                   (2, 8, 16, 16), (32, 16, 64, 64)])
@pytest.mark.parametrize("uneven", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_allow_uneven_matches(shape, uneven, mesh):
    """The attention scores' constraint (llava's 56 heads, qwen3's 40): with
    allow_uneven a dim at least the axis size takes it unevenly."""
    fake = FakeMesh(*MESHES[mesh])
    a = ts.ax("act_batch", "act_heads", ".", ".")
    assert tuple(ts.resolve_spec(a, fake, shape=shape,
                                 allow_uneven=uneven)) == tuple(
        js.resolve_spec(a, fake, shape=shape, allow_uneven=uneven))


@pytest.mark.parametrize("mesh", ["1x1", "16x16", "2x16x16"])
@pytest.mark.parametrize("seq", [False, True])
def test_batch_spec_matches(mesh, seq):
    fake = (FakeMesh((1, 1), ("data", "model")) if mesh == "1x1"
            else FakeMesh(*MESHES[mesh]))
    assert tuple(ts.batch_spec(fake, seq_sharded=seq)) == tuple(
        js.batch_spec(fake, seq_sharded=seq))


def test_rules_and_layout_rules():
    assert ts.DEFAULT_RULES == js.DEFAULT_RULES
    assert tmesh.LAYOUT_RULES == {k: js.DEFAULT_RULES[k] for k in
                                  ("geo_rows", "geo_cols", "geo_rows2d", None)}


def test_planner_meshes():
    single, multi = (tmesh.make_production_mesh(multi_pod=m)
                     for m in (False, True))
    assert (single.devices.shape, single.axis_names) == ((16, 16),
                                                         ("data", "model"))
    assert (multi.devices.shape, multi.axis_names) == (
        (2, 16, 16), ("pod", "data", "model"))
    assert tmesh.mesh_num_devices(single) == 256
    assert tmesh.mesh_num_devices(multi) == 512
    assert tmesh.mesh_num_devices(tmesh.make_smoke_mesh()) == 1


def _cache_cells():
    return [(arch, s) for arch in ARCHS for s, shape in SHAPES.items()
            if shape.kind == "decode"
            and LM_CONFIGS[arch].attention_is_subquadratic | (s != "long_500k")]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch, shape", _cache_cells())
def test_dryrun_cache_and_input_rules_match(arch, shape, mesh, monkeypatch):
    """The dry-run's greedy cache sharding and input sharding on each
    decode cell's meta cache and tokens against the reference's on its
    eval_shape'd ones."""
    from repro.configs import input_specs as j_specs
    from repro_torch.configs import input_specs
    from repro_torch.launch import dryrun
    jd = _jax_dryrun()
    monkeypatch.setattr(jd, "NamedSharding", lambda m, spec: spec)
    fake = FakeMesh(*MESHES[mesh])
    j = j_specs(jd.arch_for_cell(arch), jd.SHAPES[shape])
    t = input_specs(dryrun.arch_for_cell(arch), SHAPES[shape])
    ref = dict(_flat(jax.tree.map(lambda s: jd._greedy_cache_sharding(fake, s),
                                  j["cache"])))
    mine = dict(_flat(ts.tree_map(
        lambda x: dryrun._greedy_cache_sharding(fake, x), t["cache"])))
    assert set(mine) == set(ref)
    for path in mine:
        assert tuple(mine[path]) == tuple(ref[path]), path
    for key in ("tokens",):
        assert tuple(dryrun._batch_shardings(fake, {key: t[key]})[key]) == \
            tuple(jd._batch_shardings(fake, {key: j[key]})[key])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-tiny",
                                  "llava-next-34b"])
def test_dryrun_input_rules_match_on_train_batches(arch, monkeypatch):
    from repro.configs import input_specs as j_specs
    from repro_torch.configs import input_specs
    from repro_torch.launch import dryrun
    jd = _jax_dryrun()
    monkeypatch.setattr(jd, "NamedSharding", lambda m, spec: spec)
    for mesh in MESHES.values():
        fake = FakeMesh(*mesh)
        j = jd._batch_shardings(fake, j_specs(jd.arch_for_cell(arch),
                                              jd.SHAPES["train_4k"]))
        t = dryrun._batch_shardings(fake, input_specs(
            dryrun.arch_for_cell(arch), SHAPES["train_4k"]))
        assert {k: tuple(v) for k, v in t.items()} == {
            k: tuple(v) for k, v in j.items()}


def test_constrain_returns_its_input_without_a_mesh():
    ts.set_activation_mesh(None)
    x = torch.ones((4, 4))
    assert ts.constrain(x, ts.ax("act_batch", ".")) is x


def test_constrain_checks_and_passes_on_one_rank():
    ts.set_activation_mesh(tmesh.make_smoke_mesh())
    try:
        x = torch.ones((4, 4))
        assert ts.constrain(x, ts.ax("act_batch", ".")) is x
    finally:
        ts.set_activation_mesh(None)


def test_constrain_raises_on_a_multi_rank_mesh():
    """A 2 x 2 mesh installed: constrain raises (ROADMAP A 18), and so does
    forward_lm at its first constraint; no tensor passes through silently."""
    ts.set_activation_mesh(FakeMesh((2, 2), ("data", "model")))
    try:
        with pytest.raises(NotImplementedError, match="A 18"):
            ts.constrain(torch.ones((4, 4)), ts.ax("act_batch", "."))
        cfg = LM_SMOKE_CONFIGS["llama3.2-1b"]
        params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="A 18"):
            forward_lm(params, torch.zeros((2, 8), dtype=torch.long), cfg,
                       compute_dtype=torch.float32)
    finally:
        ts.set_activation_mesh(None)


def test_constraints_leave_the_forward_unchanged():
    """The constraint sites (the cycle carries, the logits, the MLP, the
    MoE dispatch) hand their tensors on: a forward with the one-rank mesh
    installed is the forward without one, bit for bit."""
    for arch in ("llama3.2-1b", "qwen3-moe-30b-a3b"):
        cfg = LM_SMOKE_CONFIGS[arch]
        params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
        toks = torch.randint(0, cfg.vocab, (2, 16),
                             generator=torch.Generator().manual_seed(1))
        a, _ = forward_lm(params, toks, cfg, compute_dtype=torch.float32)
        ts.set_activation_mesh(tmesh.make_smoke_mesh())
        try:
            b, _ = forward_lm(params, toks, cfg, compute_dtype=torch.float32)
        finally:
            ts.set_activation_mesh(None)
        assert torch.equal(a, b)
