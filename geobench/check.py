"""The comparison that decides `correct`: the answers of the window
against a plain reference in fp64 on the same locations, z and theta.

An answer is (l, l of the first t nb observations alone, as the program's
factor gives it).  The numbers compared, each held to the cell's limit
(limits/<cell>.json, which names the numbers the cell compares):
  ll_gap        max over a sample of the answers, drawn from the seed, of
                |l - l_ref| / c_ref against the dense reference
                (reference/gaussian.py), c_ref the scale of the terms l
                sums: l cancels them to a small part, which a relative gap
                would divide by;
  ll_gap_tiled  the same against the configuration's tile algorithm with
                its stated rounding points (reference/mixed.py) in fp64:
                where the off-band is kept in a low precision, its rounding
                parts l from the dense reference's far more than the
                program's own arithmetic does;
  lead_gap      the same over every answer of the window, of the first
                t nb observations' l against the dense reference's l of
                those observations alone (cheap: t nb rows).  The factor's
                first t tile rows are the band's alone, so this sees the
                band's precision under any off-band.
A NaN answer reads as an infinite gap.
"""

from __future__ import annotations

import math

import torch

from .reference import gaussian, mixed


def reference(cfg: dict, locs32, z32, theta, names) -> dict:
    """The reference's answers at theta that the numbers `names` compare
    with, each beside the scale of its terms (key + "_scale"), in fp64 from
    the fp32 locations and z the program's were made from: "ll" (ll_gap),
    "ll_tiled" (ll_gap_tiled), "lead" (lead_gap)."""
    locs, z = locs32.double(), z32.double()
    kw = dict(nu=cfg["nu"], jitter=cfg["jitter"])
    out = {}
    with gaussian.precision(False):
        if "ll_gap" in names:
            out["ll"], out["ll_scale"] = gaussian.loglik(locs, z, theta, **kw)
        if "ll_gap_tiled" in names:
            out["ll_tiled"], out["ll_tiled_scale"], _, _ = mixed.loglik(
                locs, z, theta, nb=cfg["nb"], t=cfg["diag_thick"],
                lo=getattr(torch, cfg["lo"]), **kw)
        if "lead_gap" in names:
            m = min(cfg["diag_thick"] * cfg["nb"], cfg["n"])
            out["lead"], out["lead_scale"] = gaussian.loglik(
                locs[:m], z[:m], theta, **kw)
    return out


def _gap(got, want, scale):
    if got is None or not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / scale


def numbers(cfg: dict, locs32, z32, thetas, answers, sample,
            names) -> dict:
    """The compared numbers `names` of the window's answers to thetas:
    ll_gap and ll_gap_tiled over the answers `sample` indexes, lead_gap
    over all."""
    out = {}
    # (number, the reference's key, the answer's part, the answers it reads)
    for name, key, part, index in (
            ("ll_gap", "ll", 0, sample),
            ("ll_gap_tiled", "ll_tiled", 0, sample),
            ("lead_gap", "lead", 1, range(len(answers)))):
        if name in names:
            refs = [reference(cfg, locs32, z32, thetas[i], [name])
                    for i in index]
            out[name] = max((_gap(answers[i][part], r[key], r[key + "_scale"])
                             for i, r in zip(index, refs)),
                            default=math.inf)
    return out


def judge(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number within its
    limit, and a number for every limit."""
    checks = {k: {"value": values.get(k, math.inf), "limit": limits[k]}
              for k in limits if not k.startswith("_")}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
