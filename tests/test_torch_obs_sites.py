"""The port's telemetry call sites against the reference's: each workflow
runs in both packages under `recording()`, on the same numpy inputs, and
records the same multiset of span names with their non-timing attributes,
the same counters and the same histograms with the same counts.  In
particular no engine span fires inside a region the reference traces (its
batch engine's jitted evaluations, `fit_mle(jit=True)`, gradients).

The workflows: the eager tile engine (n = 256, nb = 32, tpu(2)); the panel
engine and its likelihood step (n = 256, nb = 64); `BatchEngine`'s four
entry points on its tile and panel paths (B = 4, n = 128); `fit_mle`
(jit=True, jit=False, batched) and `fit_mle_grid`; the runtime's
`simulate` and `scheduled_tile_cholesky` (p = 6, nb = 16, W = 2); one
problem of each sweep of `verify.conformance`.  The JAX side runs once per
workflow (`functools.lru_cache`), under `jax.enable_x64(True)` only where
the reference means fp64 (its conformance sweep's paper pair and oracles)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import interop
from repro_torch import obs

# pytest runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

THETAS = np.array([[1.0, 0.10, 0.5], [0.7, 0.15, 0.5], [1.3, 0.05, 0.5],
                   [0.9, 0.20, 0.5]], np.float32)
THETA = [1.0, 0.1, 0.5]
OBS, NEW = slice(0, 96), slice(96, None)


def _summary(rec):
    """(sorted (span name, attributes)), counters, {histogram: count})."""
    snap = rec.snapshot()
    spans = sorted(((s.name, tuple(sorted(s.attrs.items())))
                    for s in snap["spans"]), key=repr)
    return (spans, snap["counters"],
            {k: h["count"] for k, h in snap["histograms"].items()})


def _data(n, seed):
    from repro.covariance import make_dataset
    d = make_dataset(jax.random.PRNGKey(seed), n, THETA, nu_static=0.5)
    return np.array(d.locs), np.array(d.z)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------
# the workflows, once in each package
# ---------------------------------------------------------------------

def _tile(pkg):
    from repro.verify.generators import spd_matrix
    a = np.asarray(spd_matrix(3, 256, cond=100.0), np.float32)
    if pkg == "jax":
        from repro.core import PrecisionPolicy as JP, tile_cholesky
        tile_cholesky(jnp.asarray(a), 32, JP.tpu(2)).block_until_ready()
    else:
        from repro_torch.core import PrecisionPolicy, tile_cholesky
        tile_cholesky(torch.from_numpy(a.copy()), 32, PrecisionPolicy.tpu(2))


def _panel(pkg):
    locs, z = _data(256, 7)
    if pkg == "jax":
        from repro.core import PrecisionPolicy as JP
        from repro.core import panel_cholesky as pc
        pol = JP.tpu(2)
        band, off = pc.build_banded_covariance(jnp.asarray(locs), THETA,
                                               nb=64, policy=pol,
                                               nu_static=0.5)
        band, off = pc.panel_cholesky_banded(band, off, pol)
        band.block_until_ready()
        float(pc.geostat_loglik_step(jnp.asarray(locs), jnp.asarray(z),
                                     jnp.asarray(THETA), nb=64, policy=pol,
                                     nu_static=0.5))
    else:
        from repro_torch.core import PrecisionPolicy
        from repro_torch.core import panel_cholesky as pc
        pol = PrecisionPolicy.tpu(2)
        locs_t, z_t = _t(locs, z)
        band, off = pc.build_banded_covariance(locs_t, THETA, nb=64,
                                               policy=pol, nu_static=0.5)
        pc.panel_cholesky_banded(band, off, pol)
        float(pc.geostat_loglik_step(locs_t, z_t, THETA, nb=64, policy=pol,
                                     nu_static=0.5))


def _batch(pkg, path):
    locs, z = _data(128, 5)
    if pkg == "jax":
        from repro.core import BatchEngine, BatchPlan, PrecisionPolicy as JP
        engine = BatchEngine(jnp.asarray(locs[OBS]), jnp.asarray(z[OBS]),
                             BatchPlan(policy=JP.tpu(2), nb=32,
                                       nu_static=0.5, path=path),
                             locs_new=jnp.asarray(locs[NEW]),
                             y_true=jnp.asarray(z[NEW]))
        thetas = jnp.asarray(THETAS)
    else:
        from repro_torch.core import BatchEngine, BatchPlan, PrecisionPolicy
        engine = BatchEngine(*_t(locs[OBS], z[OBS]),
                             BatchPlan(policy=PrecisionPolicy.tpu(2), nb=32,
                                       nu_static=0.5, path=path),
                             locs_new=torch.from_numpy(locs[NEW]),
                             y_true=torch.from_numpy(z[NEW]))
        thetas = THETAS
    np.asarray(engine.loglik(thetas))
    engine.loglik_sequential(thetas)
    np.asarray(engine.krige_pmse(thetas))
    engine.evaluate(thetas)


def _mle(pkg):
    locs, z = _data(128, 5)
    bounds = [(0.5, 2.0), (0.03, 0.3)]
    if pkg == "jax":
        from repro.core import (BatchEngine, BatchPlan, PrecisionPolicy as JP,
                                fit_mle, fit_mle_grid, make_loglik)
        locs_j, z_j = jnp.asarray(locs), jnp.asarray(z)
        pol = JP.tpu(2)
        ll = make_loglik(locs_j, z_j, pol, nb=32, nu_static=0.5,
                         use_tiles=True)
        engine = BatchEngine(locs_j, z_j, BatchPlan(policy=pol, nb=32,
                                                    nu_static=0.5))
    else:
        from repro_torch.core import (BatchEngine, BatchPlan, PrecisionPolicy,
                                      fit_mle, fit_mle_grid, make_loglik)
        locs_t, z_t = _t(locs, z)
        pol = PrecisionPolicy.tpu(2)
        ll = make_loglik(locs_t, z_t, pol, nb=32, nu_static=0.5,
                         use_tiles=True)
        engine = BatchEngine(locs_t, z_t, BatchPlan(policy=pol, nb=32,
                                                    nu_static=0.5))
    fits = [fit_mle(ll, THETA, max_iters=3, jit=True),
            fit_mle(ll, THETA, max_iters=2, jit=False),
            fit_mle(None, THETA, max_iters=2,
                    batched_loglik_fn=engine.loglik),
            fit_mle_grid(engine.loglik, bounds, num=3, refine=2)]
    return [f.n_evals for f in fits]


def _sched(pkg):
    from repro.verify.generators import spd_matrix
    a = np.asarray(spd_matrix(5, 96, cond=100.0), np.float32)
    if pkg == "jax":
        from repro.core import PrecisionPolicy as JP
        from repro.sched.config import SchedConfig
        from repro.sched.runtime import (build_graph, scheduled_tile_cholesky,
                                         simulate)
        pol, a = JP.tpu(2), jnp.asarray(a)
    else:
        from repro_torch.core import PrecisionPolicy
        from repro_torch.sched.config import SchedConfig
        from repro_torch.sched.runtime import (build_graph,
                                               scheduled_tile_cholesky,
                                               simulate)
        pol, a = PrecisionPolicy.tpu(2), torch.from_numpy(a.copy())
    simulate(build_graph("tile", 6, pol), SchedConfig(backend="sim",
                                                      workers=2))
    scheduled_tile_cholesky(a, 16, pol, SchedConfig(backend="real",
                                                    workers=2))


def _conformance(pkg, sweep):
    from repro.verify.generators import matern_problem
    jp = matern_problem(128, "medium")
    if pkg == "jax":
        from repro.verify import conformance as c
        # the reference's sweeps call jax.experimental.enable_x64, which
        # this JAX removed (ROADMAP C 4): give them its successor
        had = "enable_x64" in vars(jax.experimental)
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
        try:
            return len(getattr(c, sweep)(*([] if sweep == "sweep_kernels"
                                           else [[jp]])))
        finally:
            if not had:
                del jax.experimental.enable_x64
    from repro_torch.verify import conformance as c
    if sweep == "sweep_kernels":
        return len(c.sweep_kernels(device="cpu"))
    tp = interop.problem_from_numpy(jp.name, jp.n, jp.nb, jp.regime,
                                    jp.theta, jp.locs, jp.z, jp.cov,
                                    device="cpu")
    return len(getattr(c, sweep)([tp], device="cpu"))


WORKFLOWS = {
    "tile_cholesky": _tile,
    "panel": _panel,
    "batch_tile": functools.partial(_batch, path="tile"),
    "batch_panel": functools.partial(_batch, path="panel"),
    "mle": _mle,
    "sched": _sched,
    "sweep_cholesky": functools.partial(_conformance, sweep="sweep_cholesky"),
    "sweep_kriging": functools.partial(_conformance, sweep="sweep_kriging"),
    "sweep_kernels": functools.partial(_conformance, sweep="sweep_kernels"),
}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    with jobs.recording() as rec:
        out = WORKFLOWS[name]("jax")
    return out, _summary(rec)


@pytest.mark.parametrize("name", list(WORKFLOWS))
def test_call_sites_record_what_the_reference_records(name):
    want_out, (want_spans, want_counters, want_hists) = _jax_run(name)
    with obs.recording() as rec:
        out = WORKFLOWS[name]("torch")
    spans, counters, hists = _summary(rec)
    assert out == want_out
    assert spans == want_spans
    assert counters == want_counters
    assert hists == want_hists
    assert spans        # every workflow records something


def test_batch_engine_records_no_engine_span():
    """The reference jits the batch engine's evaluations: only `batch.*`
    spans, and `batch.candidates` counts each candidate once per
    evaluation (the non-fused evaluate counts in its nested loglik)."""
    for name in ("batch_tile", "batch_panel"):
        _, (spans, counters, _) = _jax_run(name)
        assert {s for s, _ in spans} <= {"batch.loglik",
                                         "batch.loglik_sequential",
                                         "batch.krige_pmse", "batch.evaluate"}
        assert counters == {"batch.candidates": 2 * len(THETAS)}


def test_traced_regions_are_the_references():
    """fit_mle(jit=True) records no engine span, fit_mle(jit=False) one
    `core.tile_cholesky` per evaluation, in both packages."""
    (n_jit, n_eager, _, _), (spans, _, hists) = _jax_run("mle")
    tile = [a for s, a in spans if s == "core.tile_cholesky"]
    assert len(tile) == n_eager
    assert hists["mle.eval_seconds"] == n_jit + n_eager


def test_panel_gradient_records_no_engine_span():
    """A theta that requires grad: the reference's jax.grad traces
    geostat_loglik_step, so neither it nor the panel factorization inside
    records a span; without grad both do."""
    from repro_torch.core import PrecisionPolicy, geostat_loglik_step
    locs, z = _t(*_data(256, 7))
    theta = torch.tensor(THETA, requires_grad=True)
    with obs.recording() as rec:
        ll = geostat_loglik_step(locs, z, theta, nb=64,
                                 policy=PrecisionPolicy.tpu(2), nu_static=0.5)
        ll.backward()
        assert rec.spans == []
        geostat_loglik_step(locs, z, theta.detach(), nb=64,
                            policy=PrecisionPolicy.tpu(2), nu_static=0.5)
    assert sorted(s.name for s in rec.spans) == ["core.panel_cholesky",
                                                 "core.panel_loglik_step"]
    assert theta.grad is not None and torch.isfinite(theta.grad).all()
