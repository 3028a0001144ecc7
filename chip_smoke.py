#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run (one card)
    python3 chip_smoke.py --quick    # small shapes: build and check only

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. environment: the card (nvidia-smi), torch, CUDA, TF32 flags (off);
  2. build: every CUDA kernel from csrc/, one nvcc per source in parallel;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes, with errors, tolerances and CUDA-event times
     (kernel, plain version, one library call where one computes the same
     function) and the bound: the least time the card could take;
  4. main path: geostat_loglik_step at n = 65536, nb = 1024, band t = 8,
     {fp32 band, bf16 off-band}, three requests (theta), each through the
     kernels and through the plain versions; launch counts, log-likelihoods,
     seconds per evaluation and peak memory;
  5. a small input held against the plain path on the CPU;
  6. a short Nelder-Mead MLE (fit_mle) through the kernel path;
then the card's name and power limit, one JSON line of every kernel's
numbers, and last the result line.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

QUICK = dict(n=8_192, nb=512, t=4, nu=0.5, off_update="square")
MLE = dict(n=8_192, nb=512, t=4, max_iters=15)
WEAK = (1.0, 0.03, 0.5)
MEDIUM = (1.0, 0.10, 0.5)


def emit(**obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps=5):
    """Median CUDA-event time of fn() over `reps` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    import torch
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def scale_rel(out, ref):
    """max |out - ref| over max |ref| (the conformance sweep's max_rel)."""
    d = (out.double() - ref.double()).abs().max()
    return float(d / ref.double().abs().max().clamp_min(1e-30))


def lower_band_tiles(n_t, t):
    """Tile pairs (i, j) of an n_t x n_t grid with 0 <= i - j < t."""
    return sum(min(i + 1, t) for i in range(n_t))


def syrk_products(n_t, t):
    """(in-band, off-band) tile products a SYRK of n_t tile rows needs: the
    lower triangle with its diagonal, since U = P P^T is symmetric."""
    in_band = lower_band_tiles(n_t, t)
    return in_band, n_t * (n_t + 1) // 2 - in_band


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_matern(locs_t, theta, t, nu_main, results):
    import torch
    from repro_torch.kernels.matern_cov import ops, ref
    p, nb, _ = locs_t.shape
    worst = 0.0
    # the main path's band launches: sub-diagonals written into the strided
    # (p, t, nb, nb) band storage (tile stride t nb^2); the rest stays zero
    out = torch.zeros((p, t, nb, nb), device=locs_t.device)
    want = torch.zeros_like(out)
    for d in range(t):
        args = (locs_t[d:], locs_t[:p - d], theta)
        ops.matern_cov_tiles(*args, nu=nu_main, out=out[d:, d])
        ref.matern_cov_tiles(*args, nu=nu_main, out=want[d:, d])
    err = (out - want).abs()
    rel = float((err / want.abs().clamp_min(1e-30)).max())
    require(rel <= 1e-5, f"matern band storage: rel {rel}")
    worst = float(err.max())
    emit(phase="kernels", kernel="matern_cov", launch="band storage",
         shape=[p, t, nb, nb], nu=nu_main, max_abs_err=worst, max_rel_err=rel)
    del out, want, err
    # the band launch of sub-diagonal 1 (p - 1 tile pairs), every nu and dtype
    for nu in (0.5, 1.5, 2.5):
        for dt in (torch.float32, torch.bfloat16):
            args = (locs_t[1:], locs_t[:p - 1], theta)
            out = ops.matern_cov_tiles(*args, nu=nu, out_dtype=dt)
            want = ref.matern_cov_tiles(*args, nu=nu, out_dtype=dt)
            err = (out.float() - want.float()).abs()
            if dt == torch.float32:
                # same IEEE operations up to exp: rel 1e-5 per element
                rel = float((err / want.abs().clamp_min(1e-30)).max())
                require(rel <= 1e-5, f"matern fp32 nu={nu}: rel {rel}")
            else:
                # both round one fp32 value to bf16: within 1 bf16 ulp
                ulps = float((err / bf16_ulp(torch.maximum(out.float().abs(),
                                                           want.float().abs()))).max())
                require(ulps <= 1.0, f"matern bf16 nu={nu}: {ulps} ulp")
            worst = max(worst, float(err.max()))
            emit(phase="kernels", kernel="matern_cov", launch="band d=1",
                 tiles=p - 1, nb=nb, nu=nu, dtype=str(dt),
                 max_abs_err=float(err.max()))
    band_ms = time_ms(lambda: ops.matern_cov_tiles(
        locs_t[1:], locs_t[:p - 1], theta, nu=nu_main, out_dtype=torch.float32))
    # the full off-band launch of the main path: bf16 tiles with i - j >= t,
    # compared one tile row at a time to keep the fp32 temporaries small
    out = ops.matern_cov_lower(locs_t, theta, nu=nu_main, min_lag=t,
                               out_dtype=torch.bfloat16)
    want = ref.matern_cov_lower(locs_t, theta, nu=nu_main, min_lag=t,
                                out_dtype=torch.bfloat16)
    ulps = 0.0
    for i in range(p):
        o, w = out[i].float(), want[i].float()
        err = (o - w).abs()
        ulps = max(ulps, float((err / bf16_ulp(torch.maximum(o.abs(), w.abs()))).max()))
        worst = max(worst, float(err.max()))
    require(ulps <= 1.0, f"matern off-band launch: {ulps} ulp")
    del out, want, o, w, err
    ms = time_ms(lambda: ops.matern_cov_lower(
        locs_t, theta, nu=nu_main, min_lag=t, out_dtype=torch.bfloat16))
    plain_ms = time_ms(lambda: ref.matern_cov_lower(
        locs_t, theta, nu=nu_main, min_lag=t, out_dtype=torch.bfloat16))
    lower_elems = (p - t) * (p - t + 1) // 2 * nb * nb
    bytes_moved = locs_t.numel() * 4 + p * p * nb * nb * 2
    flops = 9 * lower_elems  # 2 sub, 2 mul, add, sqrt, div, exp, mul
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    emit(phase="kernels", kernel="matern_cov", launch="off-band",
         shape=[p, p, nb, nb], max_bf16_ulps=ulps, ms=ms, plain_ms=plain_ms,
         band_d1_ms=band_ms, bound_ms=bound_ms)
    results["matern_cov"] = dict(
        name="matern_cov", route="cuda", source="src/repro_torch/csrc/matern_cov.cu",
        replaces="src/repro/kernels/matern_cov/matern_cov.py:44",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS
        else "operations", library_ms=None)


def spd_batch(gen, b, nb, *, indefinite=False):
    """(b, nb, nb) SPD tiles with eigenvalues log-spaced on [1, 100]."""
    import torch
    q, _ = torch.linalg.qr(torch.randn((b, nb, nb), generator=gen,
                                       device="cuda", dtype=torch.float64))
    eigs = torch.logspace(0.0, 2.0, nb, dtype=torch.float64, device="cuda")
    if indefinite:
        eigs = eigs.clone()
        eigs[nb // 2] = -1.0
    return ((q * eigs) @ q.mT).float().contiguous()


def check_potrf(gen, nb_main, results):
    import torch
    from repro_torch.kernels.blocked_potrf import ops, ref
    worst = 0.0
    for nb in sorted({32, 128, 1024, nb_main}):
        a = spd_batch(gen, 8, nb)
        l, info = ops.potrf(a)
        want, info_ref = ref.potrf(a)
        require(int(info.abs().sum()) == 0 and int(info_ref.abs().sum()) == 0,
                f"potrf nb={nb}: SPD tiles flagged")
        # bounds.py ("kernel", "blocked_potrf"): max_rel 1e-3, backward 1e-4
        rel = scale_rel(l, want)
        l64, a64 = l.double(), a.double()
        back = float(((l64 @ l64.mT - a64).norm(dim=(-2, -1))
                      / a64.norm(dim=(-2, -1))).max())
        require(rel <= 1e-3 and back <= 1e-4,
                f"potrf nb={nb}: max_rel {rel}, backward {back}")
        worst = max(worst, float((l - want).abs().max()))
        emit(phase="kernels", kernel="blocked_potrf", nb=nb, batch=8,
             max_rel=rel, backward_rel=back)
    a = spd_batch(gen, 2, 128, indefinite=True)
    l, info = ops.potrf(a)
    _, info_ref = ref.potrf(a)
    require(bool((info > 0).all()) and bool((info_ref > 0).all()),
            f"potrf indefinite: info {info.tolist()} / {info_ref.tolist()}")
    require(bool(torch.isnan(l).all()), "potrf indefinite: factor not NaN")
    emit(phase="kernels", kernel="blocked_potrf", indefinite=True,
         info=info.tolist(), info_plain=info_ref.tolist())
    # timing at the main path's shape: one tile of nb_main per launch
    a1 = spd_batch(gen, 1, nb_main)[0]
    ms = time_ms(lambda: ops.potrf(a1))
    plain_ms = time_ms(lambda: ref.potrf(a1))
    library_ms = time_ms(lambda: torch.linalg.cholesky(a1))
    flops = nb_main ** 3 / 3
    bytes_moved = 2 * 4 * nb_main ** 2
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    emit(phase="kernels", kernel="blocked_potrf", nb=nb_main, batch=1, ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms)
    results["blocked_potrf"] = dict(
        name="blocked_potrf", route="cuda",
        source="src/repro_torch/csrc/blocked_potrf.cu",
        replaces="src/repro/kernels/blocked_potrf/blocked_potrf.py:48",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if flops / FP32_FLOPS >= bytes_moved / HBM_BYTES_PER_S
        else "bytes", library_ms=library_ms)


def _syrk_errors(out, want, p, *, tile, round_k, band):
    """(in-band max_rel, off-band worst |err| / tol, max abs err), row slab
    by row slab.  Off-band tolerance per element: one bf16 ulp of each
    rounded partial sum (two where it sits at a power of two), plus twice
    the fp32 summation bound gamma_k |p_i| |p_j| of each partial, since the
    kernel and cuBLAS sum in different orders."""
    import torch
    m, kdim = p.shape
    gamma = round_k * 2.0 ** -24 / (1 - round_k * 2.0 ** -24)
    p_lo = p.to(torch.bfloat16).float()
    tiles = torch.arange(m, device=p.device) // tile
    band_num = band_den = off_ratio = max_abs = 0.0
    for r0 in range(0, m, tile):
        rows = slice(r0, r0 + tile)
        d = (out[rows].double() - want[rows].double()).abs()
        max_abs = max(max_abs, float(d.max()))
        in_band = (tiles[rows, None] - tiles[None, :]).abs() < band
        band_num = max(band_num, float(d[in_band].max()))
        band_den = max(band_den, float(want[rows][in_band].abs().max()))
        if bool(in_band.all()):
            continue
        tol = torch.zeros((tile, m), dtype=torch.float64, device=p.device)
        for k0 in range(0, kdim, round_k):
            pc = p_lo[:, k0:k0 + round_k]
            part = pc[rows] @ pc.T
            nrm = pc.norm(dim=1)
            tol += 2 * bf16_ulp(part) + 2 * gamma * nrm[rows, None] * nrm[None, :]
        off = ~in_band
        off_ratio = max(off_ratio, float((d[off] / tol[off]).max()))
        if round_k == kdim:  # one rounding: every off-band value is a bf16
            o = out[rows][off]
            require(bool((o == o.to(torch.bfloat16).float()).all()),
                    "mp_syrk: off-band value not bf16-rounded")
    return band_num / max(band_den, 1e-30), off_ratio, max_abs


def check_syrk(gen, m_main, nb, t, results):
    import torch
    from repro_torch.kernels.mp_gemm import ops, ref
    # the conformance sweep's small shapes (m, k, bm = tile, bk = round_k)
    worst = 0.0
    for m, k, bm, bk in ((128, 64, 64, 64), (256, 128, 64, 64),
                         (256, 64, 128, 64)):
        p = torch.randn((m, k), generator=gen, device="cuda")
        for band in (1, 2, 4):
            kw = dict(tile=bm, round_k=bk, band_blocks=band)
            out, want = ops.mp_syrk(p, **kw), ref.mp_syrk(p, **kw)
            rel, ratio, mx = _syrk_errors(out, want, p, tile=bm, round_k=bk,
                                          band=band)
            require(rel <= 1e-5 and ratio <= 1.0,
                    f"mp_syrk m={m} k={k} band={band}: rel {rel} off {ratio}")
            worst = max(worst, mx)
            emit(phase="kernels", kernel="mp_syrk", m=m, k=k, tile=bm,
                 round_k=bk, band=band, inband_rel=rel, offband_err_over_tol=ratio)
    # step 0 of the main path: P is (m_main, nb), tile = round_k = nb
    p = torch.randn((m_main, nb), generator=gen, device="cuda")
    kw = dict(tile=nb, round_k=nb, band_blocks=t)
    out = ops.mp_syrk(p, **kw)
    want = ref.mp_syrk(p, **kw)
    rel, ratio, mx = _syrk_errors(out, want, p, tile=nb, round_k=nb, band=t)
    require(rel <= 1e-5 and ratio <= 1.0,
            f"mp_syrk step-0 shape: rel {rel} off {ratio}")
    worst = max(worst, mx)
    del out, want
    ms = time_ms(lambda: ops.mp_syrk(p, **kw))
    plain_ms = time_ms(lambda: ref.mp_syrk(p, **kw))
    n_t = m_main // nb
    pb = p.to(torch.bfloat16)
    lib_bf16_ms = time_ms(lambda: torch.matmul(pb, pb.T))

    def fp32_band():
        for i in range(n_t):
            cols = slice(max(0, i - t + 1) * nb, min(n_t, i + t) * nb)
            torch.matmul(p[i * nb:(i + 1) * nb], p[cols].T)
    lib_fp32_ms = time_ms(fp32_band)
    in_band, off_band = syrk_products(n_t, t)
    in_flops = 2 * nb * in_band * nb * nb
    off_flops = 2 * nb * off_band * nb * nb
    ops_s = in_flops / FP32_FLOPS + off_flops / BF16_FLOPS
    bytes_s = (p.numel() * 4 + m_main * m_main * 4) / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(ops_s, bytes_s)
    emit(phase="kernels", kernel="mp_syrk", m=m_main, k=nb, tile=nb,
         round_k=nb, band=t, inband_rel=rel, offband_err_over_tol=ratio, ms=ms,
         plain_ms=plain_ms, library_bf16_square_ms=lib_bf16_ms,
         library_fp32_band_ms=lib_fp32_ms, bound_ms=bound_ms,
         inband_bound_ms=1e3 * in_flops / FP32_FLOPS,
         offband_bound_ms=1e3 * off_flops / BF16_FLOPS)
    results["mp_syrk"] = dict(
        name="mp_syrk", route="cuda", source="src/repro_torch/csrc/mp_syrk.cu",
        replaces="src/repro/kernels/mp_gemm/mp_gemm.py:52",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_s >= bytes_s else "bytes",
        library_ms=lib_bf16_ms + lib_fp32_ms)


# ---------------------------------------------------------------------------
# phases 4-6: the main path, a small CPU-held input, the MLE
# ---------------------------------------------------------------------------

def main_path(ds, cfg, results):
    import torch
    from repro_torch.core import PrecisionPolicy, geostat_loglik_step
    from repro_torch.kernels import launch_counts, reset_launch_counts
    n, nb, t = cfg["n"], cfg["nb"], cfg["t"]
    p = n // nb
    policy = PrecisionPolicy.tpu(t)
    expected = {"blocked_potrf": p, "mp_syrk": p - 1, "matern_cov": t + 1}
    th0 = [float(v) for v in ds.theta0.tolist()]
    requests = [th0, [th0[0], th0[1] * 0.8, th0[2]],
                [th0[0], th0[1] * 1.25, th0[2]]]
    total = dict.fromkeys(expected, 0)
    n_finite = 0
    for theta in requests:
        lls, secs, peaks, launched = {}, {}, {}, {}
        for impl in ("kernel", "plain"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            ll = geostat_loglik_step(ds.locs, ds.z, theta, nb=nb, policy=policy,
                                     nu_static=cfg["nu"],
                                     off_update=cfg["off_update"], impl=impl)
            lls[impl] = float(ll)  # waits for the device
            secs[impl] = time.perf_counter() - t0
            counts = launched[impl] = launch_counts()
            peaks[impl] = torch.cuda.max_memory_allocated() / 2 ** 30
            if impl == "kernel":
                require(counts == expected,
                        f"launches {counts}, expected {expected} per evaluation")
                for k in total:
                    total[k] += counts[k]
            else:
                require(sum(counts.values()) == 0, f"plain path launched {counts}")
        a, b = lls["kernel"], lls["plain"]
        both_nan = math.isnan(a) and math.isnan(b)
        close = (math.isfinite(a) and math.isfinite(b)
                 and abs(a - b) <= 1e-3 * abs(b))
        require(both_nan or close, f"theta {theta}: kernel {a} vs plain {b}")
        n_finite += close
        emit(phase="main", n=n, nb=nb, t=t, theta=theta, loglik_kernel=a,
             loglik_plain=b, rel_diff=abs(a - b) / abs(b) if close else None,
             seconds_kernel=secs["kernel"], seconds_plain=secs["plain"],
             peak_gib_kernel=peaks["kernel"], peak_gib_plain=peaks["plain"],
             launches_kernel=launched["kernel"], launches_plain=launched["plain"])
    require(n_finite >= 1, "no request gave a finite log-likelihood")
    for k in total:
        results[k]["launches"] = total[k]
    profile_evaluation(ds, cfg, policy, th0)


def profile_evaluation(ds, cfg, policy, theta):
    """One more kernel-path evaluation under torch.profiler: device time
    by kernel name, and the device's idle share of the evaluation's wall
    time (one stream, so kernel times do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import geostat_loglik_step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(geostat_loglik_step(ds.locs, ds.z, theta, nb=cfg["nb"],
                                  policy=policy, nu_static=cfg["nu"],
                                  off_update=cfg["off_update"]))
        wall = time.perf_counter() - t0
    per_kernel = {}  # device-side events only: kernels, copies, sets
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            count, ms = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (count + 1, ms + e.time_range.elapsed_us() / 1e3)
    rows = sorted(((k, c, ms) for k, (c, ms) in per_kernel.items()),
                  key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    require(0 < busy <= 1e3 * wall, f"device busy {busy} ms in {wall} s")
    # the evaluation's SYRK work: lower-triangle tile products in and off
    # the band, summed over the p - 1 steps, and their bounds at the fp32
    # and bf16 peaks
    nb = cfg["nb"]
    p, t = cfg["n"] // nb, min(cfg["t"], cfg["n"] // nb)
    products = [syrk_products(m_t, t) for m_t in range(1, p)]
    in_band = sum(i for i, _ in products)
    off_band = sum(o for _, o in products)
    flops = 2 * nb ** 3
    emit(phase="profile", wall_ms=wall * 1e3, device_busy_ms=busy,
         idle_share=1 - busy / (wall * 1e3),
         syrk_products_in_band=in_band, syrk_products_off_band=off_band,
         syrk_in_band_bound_ms=1e3 * in_band * flops / FP32_FLOPS,
         syrk_off_band_bound_ms=1e3 * off_band * flops / BF16_FLOPS,
         top=[{"name": k[:90], "count": c, "ms": ms} for k, c, ms in rows[:14]])


def small_vs_cpu():
    """A small input through the kernels on the card and through the plain
    versions on the CPU.  fp32 alone agrees to fp32 summation noise; with
    the bf16 off-band a change in the last fp32 bit can flip bf16
    roundings, hence weak correlation and 1e-3 there."""
    import torch
    from repro_torch.core import PrecisionPolicy, geostat_loglik_step
    from repro_torch.covariance import make_dataset
    n, nb = 4096, 256
    gen = torch.Generator(device="cuda").manual_seed(3)
    ds = make_dataset(gen, n, WEAK, nu_static=0.5)
    for policy, tol in ((PrecisionPolicy.full(torch.float32), 1e-5),
                        (PrecisionPolicy.tpu(2), 1e-3)):
        kw = dict(nb=nb, policy=policy, nu_static=0.5)
        ll_gpu = float(geostat_loglik_step(ds.locs, ds.z, WEAK, **kw))
        ll_cpu = float(geostat_loglik_step(ds.locs.cpu(), ds.z.cpu(), WEAK, **kw))
        rel = abs(ll_gpu - ll_cpu) / abs(ll_cpu)
        require(math.isfinite(ll_gpu) and rel <= tol,
                f"small input {policy.mode}: card {ll_gpu} vs CPU {ll_cpu}")
        emit(phase="small_vs_cpu", n=n, nb=nb, mode=policy.mode,
             t=min(policy.diag_thick, n // nb), loglik_card=ll_gpu,
             loglik_cpu_plain=ll_cpu, rel_diff=rel, tol=tol)


def mle():
    import torch
    from repro_torch.core import PrecisionPolicy, fit_mle, geostat_loglik_step
    from repro_torch.covariance import make_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    gen = torch.Generator(device="cuda").manual_seed(1)
    ds = make_dataset(gen, MLE["n"], MEDIUM, nu_static=0.5)
    policy = PrecisionPolicy.tpu(MLE["t"])

    def loglik(th):
        return geostat_loglik_step(ds.locs, ds.z, [th[0], th[1], 0.5],
                                   nb=MLE["nb"], policy=policy, nu_static=0.5)
    start = [0.8, 0.05]  # off the theta1/theta2 ridge, weaker correlation
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fit_mle(loglik, start, max_iters=MLE["max_iters"])
    secs = time.perf_counter() - t0
    require(bool(math.isfinite(res.loglik)) and res.loglik >= float(loglik(start)),
            f"MLE did not improve on its start: {res.loglik}")
    emit(phase="mle", n=MLE["n"], nb=MLE["nb"], t=MLE["t"], theta0=MEDIUM[:2],
         start=start, theta_hat=res.theta.tolist(), loglik=res.loglik,
         n_evals=res.n_evals, n_iters=res.n_iters, seconds=secs,
         seconds_per_eval=secs / res.n_evals, launches=launch_counts())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small main-path shape, no MLE: a build-and-check run")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card only")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: no src/repro_torch beside {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import GEOSTAT_CONFIGS
    from repro_torch.core.precision import require_ieee_fp32
    from repro_torch.covariance import make_dataset
    from repro_torch.kernels import _build

    require_ieee_fp32()
    smi = smi_line()
    print(smi, flush=True)
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    emit(phase="build", seconds=time.perf_counter() - t0,
         library=str(lib.relative_to(ROOT)))

    main_cfg = GEOSTAT_CONFIGS["geostat_65k"]  # geostat_500k with n cut
    cfg = QUICK if args.quick else dict(
        n=main_cfg.n, nb=main_cfg.nb, t=main_cfg.diag_thick, nu=main_cfg.nu,
        off_update=main_cfg.off_update)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    ds = make_dataset(gen, cfg["n"], WEAK, nu_static=cfg["nu"])
    torch.cuda.synchronize()
    emit(phase="data", n=cfg["n"], theta0=WEAK, seconds=time.perf_counter() - t0,
         z_finite=bool(torch.isfinite(ds.z).all()))
    require(bool(torch.isfinite(ds.z).all()), "simulated field is not finite")

    results = {}
    p = cfg["n"] // cfg["nb"]
    locs_t = ds.locs.reshape(p, cfg["nb"], 2)
    check_matern(locs_t, ds.theta0.tolist(), cfg["t"], cfg["nu"], results)
    check_potrf(gen, cfg["nb"], results)
    check_syrk(gen, cfg["n"] - cfg["nb"], cfg["nb"], cfg["t"], results)
    torch.cuda.empty_cache()

    main_path(ds, cfg, results)
    del ds, locs_t
    torch.cuda.empty_cache()
    small_vs_cpu()
    if not args.quick:
        mle()

    print(smi_line(), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
