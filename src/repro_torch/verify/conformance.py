"""Kernel + Cholesky-variant conformance sweep against the fp64 oracles.

Counterpart of `repro.verify.conformance`, with the same record ids and
fields.  Every record is a flat dict (JSON-serializable) with an `id`, the
registry key components, and the measured metrics, so the same sweep
output feeds

  * the bound check (`check_records`),
  * the paper's claims (`claim_failures`), and
  * the golden regression gate (golden.py).

Coverage (acceptance floor: >= 3 problem sizes x 3 conditioning regimes):

  sweep_cholesky   tile_cholesky under every registered policy mode and the
                   paper's pair, the banded panel_cholesky performance path,
                   and the dst_cholesky tapering baseline, on the canonical
                   SIZES x REGIMES grid of Matern problems.
  sweep_kernels    all four kernel pairs (matern_cov, mp_syrk,
                   blocked_potrf, mp_attention) ops.py vs ref.py, each
                   across >= 3 shapes x 3 conditioning knobs.
  sweep_kriging    held-out kriging PMSE vs the fp64 exact predictor for
                   the full and mixed policies on every grid problem.

On a CUDA tensor `ops` launches each kernel; on a CPU tensor it runs the
plain version, so the CPU's kernel records compare the plain version with
itself (0, or the rounding of the attention oracle's one-pass softmax).
The oracle is computed once per problem (the reference recomputes it per
record).  `impl` ("kernel" by default) goes through to the engines.  Each
record's computation is a `verify.cell` telemetry span (`obs`) with the
record's `id` and `kind`, as the reference's.
"""

from __future__ import annotations

import statistics

import torch

from .. import obs
from ..core.likelihood import build_covariance, dst_loglik, loglik_from_factor
from ..core.panel_cholesky import (
    assemble_from_banded,
    banded_loglik,
    build_banded_covariance,
    panel_cholesky_banded,
)
from ..core.precision import PrecisionPolicy
from ..core.tile_cholesky import dst_assemble, dst_cholesky, tile_cholesky
from ..core.kriging import krige_pmse
from ..covariance import random_locations
from ..covariance.matern import matern_covariance
from ..kernels.blocked_potrf import ops as potrf_ops, ref as potrf_ref
from ..kernels.matern_cov import ops as matern_ops, ref as matern_ref
from ..kernels.mp_attention import ops as attn_ops, ref as attn_ref
from ..kernels.mp_gemm import ops as syrk_ops, ref as syrk_ref
from .bounds import dtype_pair, lookup_bound
from .generators import (
    CONDITIONS,
    CholeskyProblem,
    attention_problem,
    cholesky_problems,
    spd_matrix,
)
from .oracles import (
    backward_error,
    exact_factor,
    exact_kriging_pmse,
    loglik_drift,
    loglik_of_factor,
    pmse_drift,
    rel_frobenius,
)


# The policy set under test: one entry per paper variant (plus the bf16 and
# three-tier beyond-paper policies).  diag_thick=2 on the p in {2, 4, 6}
# grid covers the degenerate band >= p case at p = 2 and genuinely banded
# factorizations at p >= 4.
#
# three_tier uses diag_thick2=3, not 2: fp8(e4m3) tiles one sub-diagonal
# off the band quantize O(1) correlation mass coarsely enough to make the
# strongly-correlated n=192 problem indefinite (NaN factor).  The sweep
# pins the widest-known-good setting; the NaN cliff is a measured property
# of the fp8 far field, recorded here so nobody "fixes" it by loosening a
# bound.
def default_policies() -> dict[str, PrecisionPolicy]:
    return {
        "full_f32": PrecisionPolicy.full(torch.float32),
        "mixed_f32f32_t2": PrecisionPolicy(mode="mixed", hi=torch.float32,
                                           lo=torch.float32, diag_thick=2),
        "mixed_f32bf16_t1": PrecisionPolicy.tpu(diag_thick=1),
        "mixed_f32bf16_t2": PrecisionPolicy.tpu(diag_thick=2),
        "three_tier_t1_t3": PrecisionPolicy.three_tier(diag_thick=1,
                                                       diag_thick2=3),
    }


_DST_THICK = 2
PAPER_PAIR = "paper_f64f32_t2"


def oracle(prob: CholeskyProblem):
    """(L_ref, ll_ref): the fp64 factor of the problem's fp32 Sigma and its
    exact log-likelihood, on the problem's device."""
    l_ref = exact_factor(prob.cov)
    return l_ref, loglik_of_factor(l_ref, prob.z)


def _chol_record(rid: str, prob: CholeskyProblem, policy_mode: str,
                 pair: str, diag_thick, l, ll, ref) -> dict:
    l_ref, ll_ref = ref
    return {
        "id": rid,
        "kind": "cholesky",
        "mode": policy_mode,
        "pair": pair,
        "diag_thick": diag_thick,
        "regime": prob.regime,
        "n": prob.n,
        "factor_rel": rel_frobenius(l, l_ref),
        "backward_rel": backward_error(l, prob.cov),
        "loglik_drift": loglik_drift(ll, ll_ref),
    }


def _tile_record(rid, prob, pol, ref, impl):
    # the engine stores each tile in its dtype, so the paper pair gets the
    # fp32 Sigma where the reference passes its fp64 upcast: the band tiles
    # are upcast, the off-band's exact fp32 values kept, the same bits
    # without an n^2 fp64 copy (13.4 GB at n = 40,960)
    with obs.span("verify.cell", id=rid, kind="cholesky"):
        l = tile_cholesky(prob.cov, prob.nb, pol, impl=impl)
        ll = float(loglik_from_factor(l, prob.z))
    return _chol_record(rid, prob, pol.mode, dtype_pair(pol), pol.diag_thick,
                        l, ll, ref)


def _panel_record(rid, prob, pol, ref, impl):
    with obs.span("verify.cell", id=rid, kind="cholesky"):
        band, off = build_banded_covariance(
            prob.locs, prob.theta, nb=prob.nb, policy=pol, nu_static=0.5,
            jitter=1e-6, impl=impl)
        t = min(pol.diag_thick, prob.p)
        band, off, failed = panel_cholesky_banded(band, off, pol, impl=impl)
        l_panel = assemble_from_banded(band, off, t)
        ll_panel = float(banded_loglik(band, off, prob.z, t, failed))
    return _chol_record(rid, prob, pol.mode, dtype_pair(pol), pol.diag_thick,
                        l_panel, ll_panel, ref)


def _dst_record(rid, prob, ref):
    with obs.span("verify.cell", id=rid, kind="cholesky"):
        blocks = dst_cholesky(prob.cov, prob.nb, diag_thick=_DST_THICK)
        l_dst = dst_assemble(blocks, prob.n)
        ll_dst = float(dst_loglik(blocks, prob.z))
    return _chol_record(rid, prob, "dst",
                        dtype_pair(PrecisionPolicy.dst(_DST_THICK)),
                        _DST_THICK, l_dst, ll_dst, ref)


def sweep_cholesky(problems=None, policies=None, *, paper_pair: bool = True,
                   panel: bool = True, impl: str = "kernel",
                   device="cuda") -> list[dict]:
    """tile / panel / dst variants x the policy set x the problem grid
    (`cholesky_problems(device=device)` by default).  Each record's factor
    is freed before the next is made."""
    problems = cholesky_problems(device=device) if problems is None else problems
    policies = default_policies() if policies is None else policies
    records = []
    for prob in problems:
        ref = oracle(prob)
        # --- faithful tile engine, every policy ---------------------------
        for label, pol in policies.items():
            records.append(_tile_record(f"chol/tile/{label}/{prob.name}",
                                        prob, pol, ref, impl))
        # --- the paper's literal pair (fp64 band / fp32 off-band) --------
        if paper_pair:
            records.append(_tile_record(
                f"chol/tile/{PAPER_PAIR}/{prob.name}", prob,
                PrecisionPolicy.paper_cpu(diag_thick=2), ref, impl))
        # --- banded panel performance path (production mixed pair) -------
        if panel:
            pol = policies.get("mixed_f32bf16_t2") or PrecisionPolicy.tpu(2)
            records.append(_panel_record(
                f"chol/panel/mixed_f32bf16_t2/{prob.name}", prob, pol, ref,
                impl))
        # --- DST tapering baseline ---------------------------------------
        records.append(_dst_record(f"chol/dst/t{_DST_THICK}/{prob.name}",
                                   prob, ref))
        del ref
    return records


def sweep_kriging(problems=None, policies=None, *, impl: str = "kernel",
                  device="cuda") -> list[dict]:
    """Held-out kriging PMSE drift vs the fp64 exact predictor."""
    problems = cholesky_problems(device=device) if problems is None else problems
    if policies is None:
        pols = default_policies()
        policies = {k: pols[k] for k in ("full_f32", "mixed_f32bf16_t2")}
    records = []
    for prob in problems:
        n_new = prob.nb                       # hold out one tile row
        n_obs = prob.n - n_new
        locs_o, locs_n = prob.locs[:n_obs], prob.locs[n_obs:]
        z_o, y = prob.z[:n_obs], prob.z[n_obs:]
        cov_oo = build_covariance(locs_o, prob.theta, nu_static=0.5,
                                  jitter=1e-6, dtype=torch.float32, impl=impl)
        sigma_no = matern_covariance(locs_n, locs_o, torch.tensor(
            prob.theta, device=locs_o.device), nu_static=0.5)
        ref = exact_kriging_pmse(cov_oo, z_o, sigma_no, y)
        for label, pol in policies.items():
            with obs.span("verify.cell", id=f"krige/{label}/{prob.name}",
                          kind="kriging"):
                score = float(krige_pmse(locs_o, z_o, locs_n, y, prob.theta,
                                         pol, nb=prob.nb, nu_static=0.5,
                                         jitter=1e-6, impl=impl))
            records.append({
                "id": f"krige/{label}/{prob.name}",
                "kind": "kriging",
                "mode": pol.mode,
                "pair": dtype_pair(pol),
                "diag_thick": pol.diag_thick,
                "regime": prob.regime,
                "n": prob.n,
                "pmse_rel": pmse_drift(score, ref),
            })
    return records


# ---------------------------------------------------------------------------
# kernel pairs (ops.py vs ref.py)
# ---------------------------------------------------------------------------


def _kernel_record(rid, kernel, out, ref, **extra) -> dict:
    diff = (out.to(torch.float64) - ref.to(torch.float64)).abs().max()
    scale = ref.to(torch.float64).abs().max()
    rec = {
        "id": rid,
        "kind": "kernel",
        "kernel": kernel,
        # max |out - ref| normalized by the reference magnitude scale
        "max_rel": float(diff) / max(float(scale), 1e-30),
        "max_abs": float(diff),
    }
    rec.update(extra)
    return rec


def sweep_kernels(device="cuda") -> list[dict]:
    """All four kernel pairs, each on >= 3 shapes x 3 regimes, at the
    reference's shapes: its mp_syrk(bm, bk) is tile=bm, round_k=bk here."""
    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    records = []

    # matern_cov: 3 tile shapes x 3 smoothness regimes (the reference's
    # bm x bn tiling is the kernel's own business here)
    for m, n in ((64, 64), (128, 64), (128, 128)):
        la = random_locations(gen(11), m)
        lb = random_locations(gen(12), n)
        for nu in (0.5, 1.5, 2.5):
            rid = f"kern/matern_cov/m{m}n{n}_nu{nu}"
            with obs.span("verify.cell", id=rid, kind="kernel"):
                theta = (1.3, 0.12, nu)
                out = matern_ops.matern_cov(la, lb, theta, nu=nu)
                ref = matern_ref.matern_cov(la, lb, theta, nu=nu)
            records.append(_kernel_record(rid, "matern_cov", out, ref))

    # mp_syrk: 3 shapes x 3 band widths (band width = precision regime)
    for m, k, bm, bk in ((128, 64, 64, 64), (256, 128, 64, 64),
                         (256, 64, 128, 64)):
        p = torch.randn((m, k), generator=gen(13), device=device)
        for band in (1, 2, 4):
            rid = f"kern/mp_syrk/m{m}k{k}_band{band}"
            with obs.span("verify.cell", id=rid, kind="kernel"):
                kw = dict(tile=bm, round_k=bk, band_blocks=band)
                out = syrk_ops.mp_syrk(p, **kw)
                ref = syrk_ref.mp_syrk(p, **kw)
            records.append(_kernel_record(rid, "mp_syrk", out, ref))

    # blocked_potrf: 3 sizes x 3 condition numbers
    for n in (32, 64, 128):
        for cname, cond in CONDITIONS.items():
            rid = f"kern/blocked_potrf/n{n}_{cname}"
            with obs.span("verify.cell", id=rid, kind="kernel"):
                a = spd_matrix(17 + n, n, cond=cond, device=device)
                out = potrf_ops.potrf(a)[0]
                ref = potrf_ref.potrf(a)[0]
            records.append(_kernel_record(
                rid, "blocked_potrf", out, ref,
                backward_rel=backward_error(out, a)))

    # mp_attention: 3 cache shapes x 3 logit scales (softmax sharpness)
    for i, (b, g, d, sn, sf, blk) in enumerate(
            ((2, 4, 64, 128, 256, 128), (1, 8, 128, 256, 128, 64),
             (4, 1, 64, 128, 128, 128))):
        for scale in (0.5, 1.0, 2.0):
            rid = f"kern/mp_attention/shape{i}_scale{scale}"
            with obs.span("verify.cell", id=rid, kind="kernel"):
                q, kn, vn, kf, vf = attention_problem(
                    21 + i, b, g, d, sn, sf, scale=scale, device=device)
                kq, vq, scales = attn_ops.quantize_kv(kf, vf, blk=blk)
                near_len = torch.full((b,), sn, dtype=torch.int32,
                                      device=device)
                far_len = torch.full((b,), sf, dtype=torch.int32,
                                     device=device)
                args = (q, kn, vn, near_len, kq, vq, scales, far_len)
                kw = dict(blk=blk, sm_scale=1.0 / d ** 0.5)
                out = attn_ops.banded_decode_attention(*args, **kw)
                ref = attn_ref.banded_decode_attention_ref(*args, **kw)
            rec = _kernel_record(rid, "mp_attention", out, ref)
            rec.pop("max_rel")  # softmax outputs are O(1); abs is the metric
            records.append(rec)
    return records


def run_conformance(*, problems=None, policies=None, kernels: bool = True,
                    impl: str = "kernel", device="cuda") -> list[dict]:
    """The full sweep: cholesky variants + kriging + kernel pairs."""
    problems = cholesky_problems(device=device) if problems is None else problems
    records = sweep_cholesky(problems, policies, impl=impl, device=device)
    records += sweep_kriging(problems, impl=impl, device=device)
    if kernels:
        records += sweep_kernels(device)
    return records


def record_bound(rec: dict):
    """The registered `AccuracyBound` of a sweep record."""
    if rec["kind"] == "kernel":
        return lookup_bound("kernel", rec["kernel"])
    return lookup_bound(rec["mode"], rec["pair"], rec.get("diag_thick"),
                        rec.get("regime"))


def check_records(records) -> list[tuple[str, str]]:
    """(record id, violation message) for every metric out of bounds."""
    return [(rec["id"], msg) for rec in records
            for msg in record_bound(rec).violations(rec)]


def claim_failures(records, problems) -> list[str]:
    """The paper's claims over a sweep of `problems`, as the reference's
    `tests/test_conformance_sweep.py` asserts them; one message per failure.

      1. no deterioration: the {fp32, bf16} t=2 tile factor within its
         registered factor_rel and loglik_drift, and DST at the same band
         width a magnitude (10x) worse in factor_rel where p >= 4 (at
         p = 2 the DST super-tile covers most of A);
      2. the paper pair: factor_rel < 1e-5 and loglik_drift < 1e-6;
      3. coverage: the three Cholesky variants and kriging on every
         problem, all four kernel pairs with >= 9 records each;
      4. the median loglik_drift of the mixed tile records below DST's.
    """
    recs = {r["id"]: r for r in records}
    out = []
    for prob in problems:
        ids = {v: f"{v}/{prob.name}" for v in (
            "chol/tile/full_f32", "chol/tile/mixed_f32bf16_t2",
            "chol/panel/mixed_f32bf16_t2", f"chol/dst/t{_DST_THICK}",
            "krige/mixed_f32bf16_t2")}
        lost = [rid for rid in ids.values() if rid not in recs]
        out += [f"sweep lost coverage of {rid}" for rid in lost]
        if lost:
            continue
        mixed = recs[ids["chol/tile/mixed_f32bf16_t2"]]
        dst = recs[ids[f"chol/dst/t{_DST_THICK}"]]
        bound = lookup_bound("mixed", "f32/bf16", 2, prob.regime)
        if not mixed["factor_rel"] <= bound.factor_rel:
            out.append(f"{prob.name}: mixed factor_rel {mixed['factor_rel']}"
                       f" > {bound.factor_rel}")
        if not mixed["loglik_drift"] <= bound.loglik_drift:
            out.append(f"{prob.name}: mixed loglik_drift "
                       f"{mixed['loglik_drift']} > {bound.loglik_drift}")
        if prob.p >= 4 and not dst["factor_rel"] > 10 * mixed["factor_rel"]:
            out.append(f"{prob.name}: DST should deteriorate, mixed should "
                       f"not -- dst={dst['factor_rel']:.2e} "
                       f"mixed={mixed['factor_rel']:.2e}")
    for rec in records:
        if rec["id"].startswith(f"chol/tile/{PAPER_PAIR}/") and not (
                rec["factor_rel"] < 1e-5 and rec["loglik_drift"] < 1e-6):
            out.append(f"{rec['id']}: factor_rel {rec['factor_rel']}, "
                       f"loglik_drift {rec['loglik_drift']}")
    kernels = {}
    for rec in records:
        if rec["kind"] == "kernel":
            kernels[rec["kernel"]] = kernels.get(rec["kernel"], 0) + 1
    if set(kernels) != {"matern_cov", "mp_syrk", "blocked_potrf",
                        "mp_attention"} or min(kernels.values()) < 9:
        out.append(f"kernel pairs covered: {kernels}")
    drifts = {pat: [r["loglik_drift"] for r in records
                    if r["id"].startswith(pat)]
              for pat in ("chol/tile/mixed_f32bf16_t2/", "chol/dst/")}
    if not all(drifts.values()) or not (
            statistics.median(drifts["chol/tile/mixed_f32bf16_t2/"])
            < statistics.median(drifts["chol/dst/"])):
        out.append("median loglik_drift: mixed is not below DST's")
    return out
