#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run (one card)
    python3 chip_smoke.py --quick    # small shapes: build and check only
                                     # (phase 9: evaluations and kernels)
    python3 chip_smoke.py --e2e-ab DIR  # only phases 4, 8.1, 9.1 and 10.1's
                                     # evaluations, the checkout at DIR and
                                     # this one in turns (DIR, this, this, DIR)

Phases, each printing JSON lines; any failure raises and exits non-zero:
  1. environment: the card (nvidia-smi), torch, CUDA, TF32 flags (off);
  2. build: every CUDA kernel from csrc/, one nvcc per source in parallel,
     with ptxas's registers and spill bytes of each mp_syrk kernel (the
     paper pair's two must not spill) and its DMMA, DFMA and FFMA counts
     in cuobjdump's SASS (the fp64 band: DMMA and no DFMA), and the same
     of all 36 matern_cov instantiations (forward general and symmetric,
     backward) with their MUFU, F2F, DFMA, FFMA and STG counts;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes, with errors, tolerances and CUDA-event times
     (kernel, plain version, one library call where one computes the same
     function) and the bound: the least time the card could take;
     blocked_potrf at nb in {32, 128, 520, 1000, 1024} (batch 8; 520, 1000
     and 1024 also batch 1), and indefinite tiles at nb = 128 and at
     nb = 1024 with the bad pivot in the last panel; mp_syrk at the
     conformance sweep's shapes and with round_k < kdim, lo bf16 and fp32,
     each U equal to its transpose, and at the main path's step 0 (U = U^T
     slab by slab, bit for bit), timed at m_t in {63, 32, 8} tile rows
     with the device time of each of its kernels at step 0; the same
     checks under the paper pair (hi, lo, accum) = (fp64, fp32, fp32) and
     all-hi fp64, and its step 0 timed beside its yardstick and bound, and
     each of its two kernels (fp64 DMMA band, fp32 off-band) beside its
     half of the yardstick and its own bound;
     matern_cov's symmetric form (the band's diagonal tiles) at every nu
     and output dtype, equal bit for bit to the general form and to its
     transpose, both timed; matern_cov's fp64 forms of phase 4's
     paper-pair request at every nu: fp64 band storage, and the off-band
     computed in fp64 and rounded once to fp32;
     3b. mp_attention (banded-precision flash decode) against its plain
     version on the kernel tests' shapes, logit scales, ragged lengths
     (an empty far segment among them) and fp32 / bf16 near K/V, and at
     the served segment sizes with B*KV = 1 and 32: ragged lengths that
     end mid-chunk, chunks wholly past the end, seg_len = 0;
  4. main path: geostat_loglik_step at n = 65536, nb = 1024, band t = 8,
     {fp32 band, bf16 off-band}, three requests (theta), each through the
     kernels and through the plain versions; launch counts, log-likelihoods,
     seconds per evaluation and peak memory; then one request under the
     paper pair paper_cpu(8) (fp64 band, fp32 off-band) on the same field
     in fp64;
  5. small inputs held against the plain path on the CPU: the likelihood,
     and llama3.2-1b's SMOKE model (fp32 compute) through forward_lm,
     prefill, generate and decode_step;
  6. a short Nelder-Mead MLE (fit_mle) through the kernel path;
  7. serving: llama3.2-1b at full width and depth (random weights from a
     seed), batch 4 x 8,192-token prompts, 64 greedy tokens (bf16 compute),
     then every layer's served cache through the banded-precision attention
     (near 1,024 positions bf16, the rest int8 blocks of 128) against its
     plain version and exact attention, with launch counts, times and the
     device time of the segment launches under the profiler;
  8. fidelity: the Algorithm 1 tile engine, likelihood, kriging and batch
     engine at n_obs = 40,960 observed of 45,056 points (every 11th held
     out: 4,096 prediction sites), nb = 1,024 (p = 40): one evaluation per
     policy through the kernels and through the plain versions on a
     medium (theta0 = (1, 0.1, 0.5)) and a weak (1, 0.03, 0.5) field
     (launch counts, log-likelihoods, seconds, peak memory, device busy
     and idle shares); on the weak field, fit_mle_grid + batched
     Nelder-Mead through BatchEngine for DP(100%), DP(10%) and DST,
     kriging with variance and 10-fold PMSE at each theta-hat, and
     BatchEngine.loglik on 8 candidates against loglik_sequential; the
     tile path at n = 2,048 on the card and on the CPU; a general-nu
     haversine covariance against fp64; each kernel at the tile path's
     shapes (Sigma from matern_cov's symmetric form equal to its transpose
     and to the general form's bit for bit, both timed); nb = 96 refused
     on the card;
  9. the paper pair: an fp64 medium field (theta0 = (1, 0.1, 0.5)) at
     n_obs = 40,960 of 45,056, nb = 1,024: full(fp64) dense and through the
     tiles, paper_cpu at DP(10%) and DP(40%), each through the kernels and
     the plain versions (launch counts, kernel vs plain, drift against
     full(fp64), seconds, peak), a profiled DP(10%) evaluation and tpu(2)
     on the same field; fit_mle_grid + batched Nelder-Mead (one candidate
     per chunk) for full(fp64) and DP(10%), theta-hat within 0.25; kriging
     with variance at 4,096 sites, PMSE within 0.2; mp_syrk (fp64, fp32)
     at the tile path's step 0 and matern_cov in fp64 for Sigma and
     Sigma_no against their plain versions (every row slab), timed, Sigma
     in both forms as in phase 8;
 10. the gradient path: matern_cov_grad (the hand-written backward of
     matern_cov) against its plain version, fp32 and fp64 at every nu, on a
     4,096^2 G and on phase 8's (fp32) and phase 9's (fp64) Sigma, in its
     symmetric form (the same bits twice) and its general form, timed
     against its byte bound; one value-and-gradient evaluation of dense
     full(fp32) on phase 8's weak field and full(fp64) on phase 9's field
     (n_obs cut to a multiple of 1,024 if its predicted peak passes 70 GiB)
     through the kernels and the plain versions (launch counts, the
     log-likelihood equal to the no-grad one, gradients kernel vs plain,
     seconds forward and backward, peak, matern_cov_grad once under the
     profiler); fit_mle_adam as tests/test_mle_kriging.py runs it (120
     steps, lr 0.05) at n = 8,192 on phase 6's field against fit_mle, and
     at n_obs for as many steps as fit in 60 s; tile_cholesky and
     geostat_loglik_step refusing a theta that requires grad;
then the card's name and power limit, one JSON line of every kernel's
numbers (the fp64 instantiations in rows of their own), and last the
result line.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense; NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
FP64_TC_FLOPS = 67e12   # fp64 on the tensor cores (DMMA)
FP64_FLOPS = 34e12      # fp64 FMA outside the tensor cores

# the kernels of one mp_syrk call, as the profiler names them: the fp32
# band and bf16 off-band of the {fp32, bf16} pair, the fp64 DMMA band and
# fp32 off-band of the paper pair, and the two passes that write P in lo
SYRK_KERNELS = ("syrk_band_lower_kernel", "syrk_offband_bf16_wgmma_kernel",
                "to_bf16_kernel", "syrk_band_f64_dmma_kernel",
                "syrk_offband_fp32_pipelined_kernel", "to_fp32_kernel")
# matern_cov's kernels (forward general and symmetric, backward), keyed with
# their template's types, and the SASS instructions counted in each
MATERN_KERNELS = ("matern_cov_kernel", "matern_cov_sym_kernel",
                  "matern_cov_grad_kernel")
MATERN_SASS_OPS = ("MUFU", "F2F", "DFMA", "FFMA", "STG")
# idle seconds at each end of a profiler trace (device_profile)
PROFILE_PAD_S = 0.3
QUICK = dict(n=8_192, nb=512, t=4, nu=0.5, off_update="square")
# phase 7: batch, prompt length, generated tokens, near window, key block
SERVE = dict(batch=4, prompt=8_192, new=64, near=1_024, blk=128)
SERVE_QUICK = dict(batch=2, prompt=1_024, new=8, near=256, blk=128)
# phase 3b: (b, g, d, sn, sf, blk) of tests/test_kernels.py and the
# conformance sweep, its logit scales, and the bound of verify/bounds.py
ATTN_SHAPES = ((2, 4, 64, 128, 256, 128), (1, 8, 128, 256, 128, 64),
               (4, 1, 64, 128, 128, 128))
ATTN_SCALES = (0.5, 1.0, 2.0)
ATTN_MAX_ABS = 1e-3
MLE = dict(n=8_192, nb=512, t=4, max_iters=15)
# phase 8: every hold-th of n_all points held out, the first n_obs of the
# rest observed (n_obs = p nb); the fields of 8.1; the estimation's engine
# chunk, grid and Nelder-Mead iterations; k-fold; phase 8.4's candidates.
# --quick leaves out the medium field: at nb = 128 its bf16 likelihood is
# finite but so sensitive that reordering a sum moves it by 2e-3
FIDELITY = dict(n_all=45_056, hold=11, n_obs=40_960, nb=1_024,
                fields=("medium", "weak"), chunk=3, grid=3, refine=2,
                nm_iters=20, kfold=10, batch=8)
FIDELITY_QUICK = dict(n_all=5_632, hold=11, n_obs=5_120, nb=128,
                      fields=("weak",), chunk=3, grid=3, refine=2,
                      nm_iters=3, kfold=10, batch=8)
# phase 8.6: max relative error of the fp32 general-nu covariance against
# fp64, the bound tests/test_torch_covariance.py holds it to on the CPU
GENERAL_NU_MAX_REL = 1e-4
WEAK = (1.0, 0.03, 0.5)
MEDIUM = (1.0, 0.10, 0.5)
# phase 9: the paper pair on an fp64 medium field, split as phase 8's; the
# estimation's grid and Nelder-Mead iterations (phase 8.2's); --quick runs
# the evaluations and the kernels only
PAPER = dict(n_all=45_056, hold=11, n_obs=40_960, nb=1_024, grid=3, refine=2,
             nm_iters=20, estimate=True)
PAPER_QUICK = dict(n_all=5_632, hold=11, n_obs=5_120, nb=128, grid=3,
                   refine=2, nm_iters=3, estimate=False)
# the paper pair's registered loglik_drift (src/repro/verify/bounds.py),
# measured at n of a few hundred; phase 9 reports against it
PAPER_LOGLIK_DRIFT = 1e-6
# phase 10: matern_cov_grad's check size; the Adam fits (the reference
# test's setting at n = 8,192 on phase 6's field, then n_obs for as many
# steps as fit in adam_seconds) and the Nelder-Mead iterations they are held
# against; the peak a full(fp64) value-and-gradient evaluation may reach
# before its n_obs is cut
GRAD = dict(check_n=4_096, adam_n=8_192, adam_steps=120, adam_lr=0.05,
            adam_seconds=60.0, nm_iters=60, peak_gib=70.0)
GRAD_QUICK = dict(check_n=1_024, adam_n=2_048, adam_steps=20, adam_lr=0.05,
                  adam_seconds=5.0, nm_iters=20, peak_gib=70.0)
# matern_cov_grad against its plain version, of the scale sum |G| dK/dtheta:
# the terms in fp32 differ by the exps' last bits (~2.4e-7 each at most),
# in fp64 by ~1e-16; the sums in fp64 in other orders
GRAD_KERNEL_TOL = {"torch.float32": 1e-6, "torch.float64": 1e-12}
# a value-and-gradient evaluation, kernel path against plain path (max
# gradient error over max |gradient|, and |ll| relative): Sigma differs by
# those last bits, which the Cholesky of an ill-conditioned Sigma amplifies
# in fp32 (phase 8.1 holds the log-likelihood to 1e-3 for the same reason)
GRAD_EVAL_TOL = {"torch.float32": 1e-3, "torch.float64": 1e-8}


def emit(**obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps=5, calls=1):
    """Median CUDA-event time of fn() over `reps` runs after one warm-up.
    With calls > 1 each run times that many calls back to back and gives
    the time per call: the device's own time once a call takes longer than
    the host needs to launch the next, where one call alone also holds the
    host's launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    import torch
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def fp32_ulp(x):
    """One fp32 ulp at |x| (24 significant bits), in fp64."""
    import torch
    _, e = torch.frexp(x.abs().double())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 24)


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


# template arguments in a mangled name: types (typed=True) and integers
_MANGLED_ARG = re.compile(r"13__nv_bfloat16|L[ib]\d+E|[fd]")
_TYPE_NAMES = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16"}


def _kernel_key(mangled, names, typed=False):
    """"name<template arguments>" of a mangled kernel whose name holds one of
    `names`, else None: its integer arguments, and with typed=True its types
    too (f32, f64, bf16) in their order."""
    name = next((n for n in names if n in mangled), None)
    if name is None:
        return None
    rest = mangled.split(name, 1)[1].split("Ev", 1)[0]
    if typed:
        args = [_TYPE_NAMES.get(a) or a[2:-1]
                for a in _MANGLED_ARG.findall(rest.removeprefix("I"))]
    else:
        args = re.findall(r"L[ib](\d+)E", rest)
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_usage(log_path, names, typed=False):
    """Registers, stack and spill bytes of every kernel instantiation whose
    name holds one of `names`, from ptxas -v's lines in the build's log."""
    usage, key = {}, None
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            key = _kernel_key(line.split("'")[1], names, typed)
            if key:
                usage[key] = {}
        elif key and "bytes stack frame" in line:
            stack, stores, loads = (int(x) for x in re.findall(r"(\d+) bytes", line))
            usage[key].update(stack=stack, spill_stores=stores, spill_loads=loads)
        elif key and "Used" in line and "registers" in line:
            usage[key]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
            key = None
    return usage


def sass_counts(lib, names, ops=("DMMA", "DFMA", "FFMA"), typed=False):
    """SASS instructions of each op in `ops` in every kernel instantiation
    whose name holds one of `names`, from cuobjdump -sass of the library."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            key = _kernel_key(line.split("Function :", 1)[1].strip(), names,
                              typed)
            if key:
                counts[key] = dict.fromkeys(ops, 0)
        elif key:
            for op in ops:
                counts[key][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


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
    # the band launch of sub-diagonal 0 (the diagonal tiles) is the
    # symmetric form: the same bits as the general form (the locations as
    # a copy), each tile its own transpose
    worst = max(worst, check_matern_sym(locs_t, theta, nu_main, "band d=0"))
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
    def band_d1():
        return ops.matern_cov_tiles(locs_t[1:], locs_t[:p - 1], theta, nu=nu_main,
                                    out_dtype=torch.float32)
    band_ms = time_ms(band_d1)
    band_device_ms = time_ms(band_d1, calls=10)
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
    band_elems = (p - 1) * nb * nb
    band_bound_ms = 1e3 * max((2 * (p - 1) * nb * 8 + 4 * band_elems) / HBM_BYTES_PER_S,
                              9 * band_elems / FP32_FLOPS)
    emit(phase="kernels", kernel="matern_cov", launch="off-band",
         shape=[p, p, nb, nb], max_bf16_ulps=ulps, ms=ms, plain_ms=plain_ms,
         band_d1_ms=band_ms, band_d1_back_to_back_ms=band_device_ms,
         band_d1_bound_ms=band_bound_ms, bound_ms=bound_ms)
    results["matern_cov"] = dict(
        name="matern_cov", route="cuda", source="src/repro_torch/csrc/matern_cov.cu",
        replaces="src/repro/kernels/matern_cov/matern_cov.py:44",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS
        else "operations", library_ms=None)


def check_matern_sym(locs_t, theta, nu_main, what):
    """The symmetric zip form on tiles (B, nb, 2) at every nu and output
    dtype: bit for bit the general form's output (the same locations as a
    copy) and each tile its own transpose, within the phase's tolerance of
    the plain version (fp32 rel 1e-5, bf16 1 ulp, fp64 1e-12 theta1, fp64 ->
    fp32 1 fp32 ulp); both forms timed at nu_main in the first dtype.
    Returns the largest error against the plain version."""
    import torch
    from repro_torch.kernels.matern_cov import matern_cov as mc_kernel
    from repro_torch.kernels.matern_cov import ops, ref
    f32, f64 = torch.float32, torch.float64
    dtypes = (f32, torch.bfloat16) if locs_t.dtype == f32 else (f64, f32)
    copy = locs_t.clone()
    require(mc_kernel.symmetric(locs_t, locs_t) and not mc_kernel.symmetric(locs_t, copy),
            "matern_cov symmetric dispatch")
    worst = 0.0
    for nu in (0.5, 1.5, 2.5):
        for dt in dtypes:
            out = ops.matern_cov_tiles(locs_t, locs_t, theta, nu=nu, out_dtype=dt)
            gen = ops.matern_cov_tiles(locs_t, copy, theta, nu=nu, out_dtype=dt)
            want = ref.matern_cov_tiles(locs_t, locs_t, theta, nu=nu, out_dtype=dt)
            same = bool(torch.equal(out, gen))
            sym = bool(torch.equal(out, out.transpose(1, 2)))
            err = (out.double() - want.double()).abs()
            if dt == torch.bfloat16:
                tol = bf16_ulp(torch.maximum(out.float().abs(), want.float().abs()))
            elif dt == f32 and locs_t.dtype == f64:
                tol = fp32_ulp(torch.maximum(out.double().abs(), want.double().abs()))
            elif dt == f32:
                tol = 1e-5 * want.double().abs()
            else:
                tol = torch.full_like(err, 1e-12 * theta[0])
            ratio = float((err / tol.double().clamp_min(1e-300)).max())
            require(same and sym and ratio <= 1.0,
                    f"matern_cov {what} symmetric {dt} nu={nu}: equal to general "
                    f"{same}, to its transpose {sym}, {ratio} of the tolerance")
            worst = max(worst, float(err.max()))
            line = dict(tiles=list(locs_t.shape[:2]), nu=nu, dtype=str(dt),
                        locs=str(locs_t.dtype), equal_to_general=same,
                        equal_to_transpose=sym, max_abs_err=float(err.max()),
                        err_over_tol=ratio)
            if nu == nu_main and dt == dtypes[0]:
                line["ms"] = time_ms(lambda: ops.matern_cov_tiles(
                    locs_t, locs_t, theta, nu=nu, out_dtype=dt))
                line["ms_general"] = time_ms(lambda: ops.matern_cov_tiles(
                    locs_t, copy, theta, nu=nu, out_dtype=dt))
            emit(phase="kernels", kernel="matern_cov", launch=f"{what} symmetric",
                 **line)
            del out, gen, want, err, tol
    return worst


def check_matern_fp64(locs_t, theta, t, results):
    """matern_cov's two fp64 forms on phase 4's paper_cpu(t) request, at
    every nu, on the main path's locations in fp64: the band storage written
    as fp64 (<= 1e-12 theta1 from the plain version), and the off-band
    lower form computed in fp64 and rounded once to fp32.  That fp32 output
    must equal the plain version's fp64 value rounded once, bit for bit,
    wherever the kernel's own fp64 value (the zip form on the same tile
    pairs) equals the plain one, and be within one fp32 ulp elsewhere; a
    kernel that computed in fp32 would differ on a large share of them.
    Compared one tile row at a time."""
    import torch
    from repro_torch.kernels.matern_cov import ops, ref
    f32, f64 = torch.float32, torch.float64
    locs_t = locs_t.double()
    p, nb, _ = locs_t.shape
    tol = 1e-12 * theta[0]
    worst = 0.0
    for nu in (0.5, 1.5, 2.5):
        out = torch.zeros((p, t, nb, nb), dtype=f64, device=locs_t.device)
        want = torch.zeros_like(out)
        for d in range(t):
            args = (locs_t[d:], locs_t[:p - d], theta)
            ops.matern_cov_tiles(*args, nu=nu, out_dtype=f64, out=out[d:, d])
            ref.matern_cov_tiles(*args, nu=nu, out_dtype=f64, out=want[d:, d])
        band_err = float((out - want).abs().max())
        del out, want
        require(band_err <= tol, f"matern fp64 band storage nu={nu}: {band_err}")
        if nu == 0.5:  # the symmetric d = 0 launch, every nu and output dtype
            worst = max(worst, check_matern_sym(locs_t, theta, nu, "band d=0 fp64"))
        low = ops.matern_cov_lower(locs_t, theta, nu=nu, min_lag=t,
                                   out_dtype=f32)
        require(low.dtype == f32, f"matern fp64 -> fp32 lower: {low.dtype}")
        off_err, ulps, differ, split = 0.0, 0.0, 0, 0
        for i in range(p):
            j = max(0, i - t + 1)  # tiles (i, jj) with i - jj >= t
            require(not bool(low[i, j:].any()),
                    f"matern fp64 -> fp32 lower nu={nu}: tile row {i} not zero")
            if j == 0:
                continue
            cols = locs_t[:j].reshape(-1, 2)
            w64 = ref.matern_cov(locs_t[i], cols, theta, nu=nu, out_dtype=f64)
            k64 = ops.matern_cov(locs_t[i], cols, theta, nu=nu, out_dtype=f64)
            o = low[i, :j].transpose(0, 1).reshape(nb, -1)
            w = w64.to(f32)
            ne = o != w
            differ += int(ne.sum())
            split += int((ne & (k64 == w64)).sum())
            d = (o.double() - w.double()).abs()
            off_err = max(off_err, float(d.max()))
            ulps = max(ulps, float((d / fp32_ulp(torch.maximum(
                o.double().abs(), w.double().abs()))).max()))
        del low, w64, k64, o, w, ne, d
        torch.cuda.empty_cache()
        require(split == 0 and ulps <= 1.0,
                f"matern fp64 -> fp32 lower nu={nu}: {split} elements differ "
                f"where the fp64 values agree, {ulps} ulp")
        worst = max(worst, band_err, off_err)
        emit(phase="kernels", kernel="matern_cov", dtype=str(f64),
             launch="band storage fp64, off-band fp64 -> fp32", nu=nu,
             shape=[p, t, nb, nb], band_max_abs_err=band_err, tol=tol,
             offband_min_lag=t, offband_elements_differ=differ,
             offband_differ_where_fp64_agrees=split, offband_max_fp32_ulps=ulps,
             offband_max_abs_err=off_err)
    results.setdefault("matern_cov_fp64", {})["max_abs_err"] = worst


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


def indefinite_at(a, j):
    """a (nb, nb) SPD fp32 tile with a[j, j] lowered so that its (j + 1)-th
    pivot is -1 and the leading j pivots are those of a."""
    import torch
    a = a.clone()
    a64 = a.double()
    lead = torch.linalg.cholesky(a64[:j, :j])
    x = torch.linalg.solve_triangular(lead, a64[:j, j:j + 1], upper=False)
    a[j, j] = float(a64[j, j] - (x * x).sum() - 1.0)  # pivot d_j - d_j - 1
    return a


def check_potrf(gen, nb_main, results):
    import torch
    from repro_torch.kernels.blocked_potrf import ops, ref
    worst = 0.0
    # batch 8 at every size, batch 1 where the grid path's ragged last panel
    # (nb not a multiple of 64) or the main path's single tile is exercised
    cases = [(nb, 8) for nb in sorted({32, 128, 520, 1000, 1024, nb_main})]
    cases += [(520, 1), (1000, 1), (nb_main, 1)]
    for nb, batch in cases:
        a = spd_batch(gen, batch, nb)
        l, info = ops.potrf(a)
        want, info_ref = ref.potrf(a)
        require(int(info.abs().sum()) == 0 and int(info_ref.abs().sum()) == 0,
                f"potrf nb={nb}: SPD tiles flagged")
        # bounds.py ("kernel", "blocked_potrf"): max_rel 1e-3, backward 1e-4
        rel = scale_rel(l, want)
        l64, a64 = l.double(), a.double()
        back = float(((l64 @ l64.mT - a64).norm(dim=(-2, -1))
                      / a64.norm(dim=(-2, -1))).max())
        upper = bool((torch.triu(l, diagonal=1) == 0).all())
        require(rel <= 1e-3 and back <= 1e-4 and upper,
                f"potrf nb={nb} batch={batch}: max_rel {rel}, backward {back}, "
                f"upper zero {upper}")
        worst = max(worst, float((l - want).abs().max()))
        emit(phase="kernels", kernel="blocked_potrf", nb=nb, batch=batch,
             max_rel=rel, backward_rel=back)
    # indefinite tiles: at nb = 128 (one-block path) a negative eigenvalue;
    # at nb = 1024 (grid path) a bad pivot in the last panel, at column
    # 1001, beside an SPD tile: the same info as the plain version, and
    # only the failed tile all NaN
    a = spd_batch(gen, 2, 128, indefinite=True)
    l, info = ops.potrf(a)
    _, info_ref = ref.potrf(a)
    require(bool((info > 0).all()) and bool((info_ref > 0).all()),
            f"potrf indefinite: info {info.tolist()} / {info_ref.tolist()}")
    require(bool(torch.isnan(l).all()), "potrf indefinite: factor not NaN")
    emit(phase="kernels", kernel="blocked_potrf", indefinite=True, nb=128,
         info=info.tolist(), info_plain=info_ref.tolist())
    a = spd_batch(gen, 2, 1024)
    a[1] = indefinite_at(a[1], 1000)
    for batch in (2, 1):
        x = a[2 - batch:].contiguous()
        l, info = ops.potrf(x)
        want, info_ref = ref.potrf(x)
        require(info.tolist() == info_ref.tolist() and info[-1] == 1001,
                f"potrf nb=1024 indefinite: info {info.tolist()} / "
                f"{info_ref.tolist()}")
        require(bool(torch.isnan(l[-1]).all()), "potrf nb=1024: factor not NaN")
        if batch == 2:
            require(bool(torch.isfinite(l[0]).all())
                    and scale_rel(l[0], want[0]) <= 1e-3,
                    "potrf nb=1024: the SPD tile beside a failed one")
        emit(phase="kernels", kernel="blocked_potrf", indefinite=True, nb=1024,
             batch=batch, info=info.tolist(), info_plain=info_ref.tolist())
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


def syrk_flops(n_t, nb, t):
    """(in-band, off-band) flops of a SYRK of P = (n_t nb, nb), tile = nb:
    2 nb per dot product, nb^2 of them in a lower tile off the diagonal and
    nb (nb + 1) / 2 in a diagonal tile, since U is symmetric."""
    in_band, off_band = syrk_products(n_t, t)
    whole, diag = nb * nb, nb * (nb + 1) // 2
    return (2 * nb * ((in_band - n_t) * whole + n_t * diag),
            2 * nb * off_band * whole)


def syrk_bounds(n_t, nb, t):
    """Least ms of the two SYRK kernels on P = (n_t nb, nb), tile = nb: each
    the larger of its flops at the peak of their type (fp32 in the band,
    bf16 off it) and its bytes: P read once and its part of the fp32 square
    written, each lower tile and its mirror, a diagonal tile once."""
    in_band, off_band = syrk_products(n_t, t)
    band_f, off_f = syrk_flops(n_t, nb, t)
    tile_b, p_b = 4 * nb * nb, 4 * n_t * nb * nb
    band = max(band_f / FP32_FLOPS,
               (p_b + (2 * in_band - n_t) * tile_b) / HBM_BYTES_PER_S)
    off = max(off_f / BF16_FLOPS,
              (p_b + 2 * off_band * tile_b) / HBM_BYTES_PER_S) if off_band else 0.0
    return 1e3 * band, 1e3 * off


def syrk_library_ms(p, m_t, nb, t, lower=True):
    """The yardstick (torch.matmul, P cast to bf16 beforehand): per tile row
    its fp32 band slab and its bf16 slab left of the band, over the lower
    tiles as the kernels compute them; or (lower=False) a bf16 square and
    the fp32 band slabs on both sides."""
    import torch
    pt = p[:m_t * nb]
    pb = pt.to(torch.bfloat16)

    def run():
        if not lower:
            torch.matmul(pb, pb.T)
        for i in range(m_t):
            rows, c0 = slice(i * nb, (i + 1) * nb), max(0, i - t + 1) * nb
            c1 = (i + 1 if lower else min(m_t, i + t)) * nb
            torch.matmul(pt[rows], pt[c0:c1].T)
            if lower and c0:
                torch.matmul(pb[rows], pb[:c0].T)
    return time_ms(run)


def syrk_step_numbers(p, m_t, nb, t):
    """Kernel time, yardsticks and bound of the SYRK of the first m_t tile
    rows of P (tile = round_k = nb, band t)."""
    from repro_torch.kernels.mp_gemm import ops
    pt = p[:m_t * nb]
    kw = dict(tile=nb, round_k=nb, band_blocks=t)
    band_ms, off_ms = syrk_bounds(m_t, nb, t)
    band_f, off_f = syrk_flops(m_t, nb, t)
    # fp32 and bf16 run on separate units at once: the larger bounds
    ops_s = max(band_f / FP32_FLOPS, off_f / BF16_FLOPS)
    bytes_s = (pt.numel() + (m_t * nb) ** 2) * 4 / HBM_BYTES_PER_S
    return dict(ms=time_ms(lambda: ops.mp_syrk(pt, **kw)),
                library_ms=syrk_library_ms(p, m_t, nb, t, lower=True),
                library_full_ms=syrk_library_ms(p, m_t, nb, t, lower=False),
                bound_ms=1e3 * max(ops_s, bytes_s),
                bound_by="operations" if ops_s >= bytes_s else "bytes",
                band_bound_ms=band_ms, offband_bound_ms=off_ms)


def check_syrk(gen, m_main, nb, t, results):
    import torch
    from repro_torch.kernels.mp_gemm import ops, ref
    # the conformance sweep's small shapes (m, k, bm = tile, bk = round_k)
    # and round_k < kdim at a larger tile, with lo = bf16 and lo = fp32
    # (then every element is in the band); U must equal U^T exactly
    worst = 0.0
    for m, k, bm, bk, bands in ((128, 64, 64, 64, (1, 2, 4)),
                                (256, 128, 64, 64, (1, 2, 4)),
                                (256, 64, 128, 64, (1, 2, 4)),
                                (2048, 512, 512, 128, (1, 2))):
        p = torch.randn((m, k), generator=gen, device="cuda")
        for lo in (torch.bfloat16, torch.float32):
            for band in bands if lo == torch.bfloat16 else bands[:1]:
                kw = dict(tile=bm, round_k=bk, band_blocks=band, lo=lo)
                out, want = ops.mp_syrk(p, **kw), ref.mp_syrk(p, **kw)
                rel, ratio, mx = _syrk_errors(
                    out, want, p, tile=bm, round_k=bk,
                    band=band if lo == torch.bfloat16 else m // bm)
                sym = bool(torch.equal(out, out.T))
                require(rel <= 1e-5 and ratio <= 1.0 and sym,
                        f"mp_syrk m={m} k={k} round_k={bk} band={band} lo={lo}: "
                        f"rel {rel} off {ratio} symmetric {sym}")
                worst = max(worst, mx)
                emit(phase="kernels", kernel="mp_syrk", m=m, k=k, tile=bm,
                     round_k=bk, band=band, lo=str(lo), inband_rel=rel,
                     offband_err_over_tol=ratio, symmetric=sym)
    # step 0 of the main path: P is (m_main, nb), tile = round_k = nb
    p = torch.randn((m_main, nb), generator=gen, device="cuda")
    kw = dict(tile=nb, round_k=nb, band_blocks=t)
    out = ops.mp_syrk(p, **kw)
    want = ref.mp_syrk(p, **kw)
    rel, ratio, mx = _syrk_errors(out, want, p, tile=nb, round_k=nb, band=t)
    require(rel <= 1e-5 and ratio <= 1.0,
            f"mp_syrk step-0 shape: rel {rel} off {ratio}")
    worst = max(worst, mx)
    del want
    # U equals U^T bit for bit, one slab of tile rows at a time
    for r0 in range(0, m_main, nb):
        require(torch.equal(out[r0:r0 + nb], out[:, r0:r0 + nb].T),
                f"mp_syrk step-0 shape: U != U^T in rows {r0}..{r0 + nb}")
    del out
    n_t = m_main // nb

    # the kernel and the yardstick at steps of the main path (m_t tile
    # rows; --quick has fewer than 32), the plain version at step 0 only
    steps = {}
    for m_t in dict.fromkeys((n_t, min(32, n_t), min(8, n_t))):
        steps[m_t] = syrk_step_numbers(p, m_t, nb, t)
        emit(phase="kernels", kernel="mp_syrk", m_t=m_t, m=m_t * nb, k=nb,
             tile=nb, round_k=nb, band=t, **steps[m_t])
    plain_ms = time_ms(lambda: ref.mp_syrk(p, **kw))
    # device time of each of the call's kernels at step 0
    _, busy, rows = device_profile(lambda: ops.mp_syrk(p, **kw))
    device = {name: sum(ms_ for k_, _, ms_ in rows if name in k_)
              for name in SYRK_KERNELS}
    s0 = steps[n_t]
    emit(phase="kernels", kernel="mp_syrk", m=m_main, k=nb, tile=nb,
         round_k=nb, band=t, inband_rel=rel, offband_err_over_tol=ratio,
         symmetric=True, ms=s0["ms"], plain_ms=plain_ms,
         library_ms=s0["library_ms"], library_full_ms=s0["library_full_ms"],
         bound_ms=s0["bound_ms"], device_ms=device, device_busy_ms=busy,
         band_bound_ms=s0["band_bound_ms"],
         offband_bound_ms=s0["offband_bound_ms"])
    results["mp_syrk"] = dict(
        name="mp_syrk", route="cuda", source="src/repro_torch/csrc/mp_syrk.cu",
        replaces="src/repro/kernels/mp_gemm/mp_gemm.py:52",
        max_abs_err=worst, ms=s0["ms"], plain_ms=plain_ms,
        bound_ms=s0["bound_ms"], bound_by=s0["bound_by"],
        library_ms=s0["library_ms"])


def _syrk64_errors(out, want, *, tile, band):
    """The fp64 pair's U against its plain version, row slab by row slab:
    (in-band max |err| / max |U|, off-band max |err| / max |U|, max abs
    err, every off-band value an fp32 number)."""
    import torch
    m = out.shape[0]
    tiles = torch.arange(m, device=out.device) // tile
    scale = band_err = off_err = 0.0
    fp32_values = True
    for r0 in range(0, m, tile):
        rows = slice(r0, r0 + tile)
        o, w = out[rows], want[rows]
        d = (o - w).abs()
        in_band = (tiles[rows, None] - tiles[None, :]).abs() < band
        scale = max(scale, float(w.abs().max()))
        band_err = max(band_err, float(d[in_band].max()))
        if not bool(in_band.all()):
            off_err = max(off_err, float(d[~in_band].max()))
            ov = o[~in_band]
            fp32_values &= bool((ov == ov.float().double()).all())
    scale = max(scale, 1e-300)
    return band_err / scale, off_err / scale, max(band_err, off_err), fp32_values


def syrk64_numbers(p, nb, t, per_kernel=True):
    """Kernel time, yardstick and bound of the fp64 pair's SYRK of P =
    (n_t nb, nb), tile = round_k = nb, band t, and the same for each of its
    two kernels.  The yardstick is torch.matmul over the same lower tiles,
    fp64 for each tile row's band slab (its band half) and IEEE fp32 for its
    slab left of the band (its off-band half), each half also timed alone,
    beside the device time of its kernel under the profiler (per_kernel).
    The bounds: the fp64 band's operations at the fp64 tensor-core peak,
    the fp32 off-band's at the fp32 peak; the call's is the larger of the
    two (separate units) or the bytes of P and the fp64 U, whichever is
    larger."""
    import torch
    from repro_torch.kernels.mp_gemm import ops
    n_t = p.shape[0] // nb
    kw = dict(tile=nb, round_k=nb, band_blocks=t, hi=torch.float64,
              lo=torch.float32, accum=torch.float32)
    band_f, off_f = syrk_flops(n_t, nb, t)
    ops_s = max(band_f / FP64_TC_FLOPS, off_f / FP32_FLOPS)
    bytes_s = (p.numel() + p.shape[0] ** 2) * 8 / HBM_BYTES_PER_S
    p32 = p.float()

    def band_half():
        for i in range(n_t):
            rows, c0 = slice(i * nb, (i + 1) * nb), max(0, i - t + 1) * nb
            torch.matmul(p[rows], p[c0:(i + 1) * nb].T)

    def offband_half():
        for i in range(n_t):
            rows, c0 = slice(i * nb, (i + 1) * nb), max(0, i - t + 1) * nb
            if c0:
                torch.matmul(p32[rows], p32[:c0].T)

    def library():
        band_half()
        offband_half()

    call = lambda: ops.mp_syrk(p, **kw)  # noqa: E731
    nums = dict(ms=time_ms(call), library_ms=time_ms(library),
                bound_ms=1e3 * max(ops_s, bytes_s),
                bound_by="operations" if ops_s >= bytes_s else "bytes",
                band_library_ms=time_ms(band_half),
                band_bound_ms=1e3 * band_f / FP64_TC_FLOPS,
                offband_library_ms=time_ms(offband_half) if off_f else 0.0,
                offband_bound_ms=1e3 * off_f / FP32_FLOPS,
                band_gflop=band_f / 1e9, offband_gflop=off_f / 1e9)
    if per_kernel:
        _, busy, rows = device_profile(call)
        device = {name: sum(ms_ for k_, _, ms_ in rows if name in k_)
                  for name in SYRK_KERNELS}
        band_ms = device["syrk_band_f64_dmma_kernel"]
        off_ms = device["syrk_offband_fp32_pipelined_kernel"]
        nums.update(band_kernel_ms=band_ms, offband_kernel_ms=off_ms,
                    band_tflops=band_f / band_ms / 1e9 if band_ms else None,
                    offband_tflops=off_f / off_ms / 1e9 if off_ms else None,
                    device_ms=device, device_busy_ms=busy)
    return nums


def check_syrk_fp64(gen, m_main, nb, t, results):
    """mp_syrk under the paper pair (fp64, fp32, fp32) and all-hi fp64:
    the conformance shapes and round_k < kdim, then the panel path's step 0
    (band t); in-band elements within 1e-11 of max |U|, off-band within
    1e-5 and fp32 numbers, U = U^T bit for bit."""
    import torch
    from repro_torch.kernels.mp_gemm import ops, ref
    f32, f64 = torch.float32, torch.float64
    worst = 0.0
    for m, k, bm, bk, bands in ((128, 64, 64, 64, (1, 2, 4)),
                                (256, 128, 64, 64, (1, 2, 4)),
                                (256, 64, 128, 64, (1, 2, 4)),
                                (2048, 512, 512, 128, (1, 2))):
        p = torch.randn((m, k), generator=gen, device="cuda", dtype=f64)
        for lo in (f32, f64):
            for band in bands if lo == f32 else bands[:1]:
                kw = dict(tile=bm, round_k=bk, band_blocks=band, hi=f64, lo=lo,
                          accum=lo)
                out, want = ops.mp_syrk(p, **kw), ref.mp_syrk(p, **kw)
                brel, orel, mx, fp32_off = _syrk64_errors(
                    out, want, tile=bm, band=band if lo == f32 else m // bm)
                sym = bool(torch.equal(out, out.T))
                require(out.dtype == f64 and brel <= 1e-11 and orel <= 1e-5
                        and sym and fp32_off,
                        f"mp_syrk fp64 m={m} k={k} round_k={bk} band={band} "
                        f"lo={lo}: band {brel} off {orel} symmetric {sym} "
                        f"fp32 off-band {fp32_off}")
                worst = max(worst, mx)
                emit(phase="kernels", kernel="mp_syrk", hi=str(f64), lo=str(lo),
                     m=m, k=k, tile=bm, round_k=bk, band=band, inband_rel=brel,
                     offband_rel=orel, symmetric=sym)
    # step 0 of the panel path: P is (m_main, nb) fp64, tile = round_k = nb
    p = torch.randn((m_main, nb), generator=gen, device="cuda", dtype=f64)
    kw = dict(tile=nb, round_k=nb, band_blocks=t, hi=f64, lo=f32, accum=f32)
    out = ops.mp_syrk(p, **kw)
    want = ref.mp_syrk(p, **kw)
    brel, orel, mx, fp32_off = _syrk64_errors(out, want, tile=nb, band=t)
    require(brel <= 1e-11 and orel <= 1e-5 and fp32_off,
            f"mp_syrk fp64 step-0 shape: band {brel} off {orel} fp32 {fp32_off}")
    worst = max(worst, mx)
    del want
    for r0 in range(0, m_main, nb):
        require(torch.equal(out[r0:r0 + nb], out[:, r0:r0 + nb].T),
                f"mp_syrk fp64 step-0 shape: U != U^T in rows {r0}..{r0 + nb}")
    del out
    torch.cuda.empty_cache()
    nums = syrk64_numbers(p, nb, t)
    plain_ms = time_ms(lambda: ref.mp_syrk(p, **kw), reps=3)
    emit(phase="kernels", kernel="mp_syrk", hi=str(f64), lo=str(f32),
         m=m_main, k=nb, tile=nb, round_k=nb, band=t, inband_rel=brel,
         offband_rel=orel, symmetric=True, plain_ms=plain_ms, **nums)
    results.setdefault("mp_syrk_fp64", {}).update(
        name="mp_syrk (fp64, fp32)", route="cuda",
        source="src/repro_torch/csrc/mp_syrk.cu",
        replaces="src/repro/kernels/mp_gemm/mp_gemm.py:52",
        max_abs_err=worst, ms=nums["ms"], plain_ms=plain_ms,
        bound_ms=nums["bound_ms"], bound_by=nums["bound_by"],
        library_ms=nums["library_ms"])


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
    expected = {"blocked_potrf": p, "mp_syrk": p - 1, "matern_cov": t + 1,
                "matern_cov_grad": 0, "mp_attention": 0}
    th0 = [float(v) for v in ds.theta0.tolist()]
    requests = [th0, [th0[0], th0[1] * 0.8, th0[2]],
                [th0[0], th0[1] * 1.25, th0[2]]]
    total = {k: 0 for k, count in expected.items() if count}
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


def main_path_paper(ds, cfg, results):
    """Phase 4's paper-pair request: one geostat_loglik_step under
    paper_cpu(t) (fp64 band, fp32 off-band) on the main path's field in
    fp64, through the kernels and through the plain versions.  The fp64
    diagonal tiles go to cuSOLVER by dtype: no blocked_potrf launch."""
    import torch
    from repro_torch.core import PrecisionPolicy, geostat_loglik_step
    n, nb, t = cfg["n"], cfg["nb"], cfg["t"]
    p = n // nb
    policy = PrecisionPolicy.paper_cpu(t)
    locs, z = ds.locs.double(), ds.z.double()
    theta = [float(v) for v in ds.theta0.tolist()]
    expected = {"blocked_potrf": 0, "mp_syrk": p - 1, "matern_cov": t + 1,
                "matern_cov_grad": 0, "mp_attention": 0}
    out = {}
    for impl in ("kernel", "plain"):
        out[impl] = _evaluate(lambda th: geostat_loglik_step(
            locs, z, th, nb=nb, policy=policy, nu_static=cfg["nu"],
            off_update=cfg["off_update"], impl=impl), theta)
    (a, sa, pa, ca), (b, sb, pb, cb) = out["kernel"], out["plain"]
    require(ca == expected, f"paper_cpu({t}): launches {ca}, expected {expected}")
    require(sum(cb.values()) == 0, f"paper_cpu({t}) plain path launched {cb}")
    require(math.isfinite(a) and math.isfinite(b) and abs(a - b) <= 1e-5 * abs(b),
            f"paper_cpu({t}): kernel {a} vs plain {b}")
    emit(phase="main", policy=f"paper_cpu({t})", n=n, nb=nb, t=t, theta=theta,
         loglik_kernel=a, loglik_plain=b, rel_diff=abs(a - b) / abs(b), tol=1e-5,
         seconds_kernel=sa, seconds_plain=sb, peak_gib_kernel=pa,
         peak_gib_plain=pb, launches_kernel=ca, launches_plain=cb)
    results.setdefault("mp_syrk_fp64", {})["launches"] = ca["mp_syrk"]
    results.setdefault("matern_cov_fp64", {})["launches"] = ca["matern_cov"]


def device_profile(fn):
    """fn() under torch.profiler: (wall ms, device busy ms, rows of (name,
    count, ms) by device time).  fn ends in a host read or a sync; one
    stream, so the device events do not overlap.  The trace holds
    PROFILE_PAD_S of idle time before and after fn: on the card, a trace
    that ended right after a short call lost some or all of its device
    events once the process had run for a while, and a padded one did not
    (when the call held a PyTorch op; a trace of this library's launches
    alone still came back empty late in a run).  A trace with no device
    event or with more device time than wall time is taken again, up to
    three times, and then fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_PAD_S)
        per_kernel = {}  # device-side events only: kernels, copies, sets
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                count, ms = per_kernel.get(e.name, (0, 0.0))
                per_kernel[e.name] = (count + 1, ms + e.time_range.elapsed_us() / 1e3)
        busy = sum(ms for _, ms in per_kernel.values())
        if 0 < busy <= 1e3 * wall:
            break
    rows = sorted(((k, c, ms) for k, (c, ms) in per_kernel.items()),
                  key=lambda r: -r[2])
    require(0 < busy <= 1e3 * wall, f"device busy {busy} ms in {wall} s")
    return 1e3 * wall, busy, rows


def profile_evaluation(ds, cfg, policy, theta):
    """One more kernel-path evaluation under torch.profiler: device time
    by kernel name, and the device's idle share of the evaluation's wall
    time."""
    from repro_torch.core import geostat_loglik_step
    wall_ms, busy, rows = device_profile(lambda: float(geostat_loglik_step(
        ds.locs, ds.z, theta, nb=cfg["nb"], policy=policy, nu_static=cfg["nu"],
        off_update=cfg["off_update"])))
    # the evaluation's SYRK work: lower-triangle tile products in and off
    # the band, summed over the p - 1 steps, each kernel's device time and
    # its bound: the larger of operations at the peak of their type and the
    # bytes of its part of the fp32 square (lower and mirror), per step
    nb = cfg["nb"]
    p, t = cfg["n"] // nb, min(cfg["t"], cfg["n"] // nb)
    products = [syrk_products(m_t, t) for m_t in range(1, p)]
    bounds = [syrk_bounds(m_t, nb, t) for m_t in range(1, p)]
    emit(phase="profile", wall_ms=wall_ms, device_busy_ms=busy,
         idle_share=1 - busy / wall_ms,
         syrk_products_in_band=sum(i for i, _ in products),
         syrk_products_off_band=sum(o for _, o in products),
         syrk_in_band_bound_ms=sum(b for b, _ in bounds),
         syrk_off_band_bound_ms=sum(o for _, o in bounds),
         syrk_device_ms={name: sum(ms for k, _, ms in rows if name in k)
                         for name in SYRK_KERNELS},
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


# ---------------------------------------------------------------------------
# phase 3b: mp_attention against its plain version
# ---------------------------------------------------------------------------

def _attn_errors(q, segments, *, blk, sm_scale):
    """Kernel against plain partials and merged outputs, and the merged
    kernel output against the full-softmax oracle.  A partial (acc, m, l)
    is held per query head at rel 1e-4 of max(max |plain| over d, 1): acc
    sums thousands of signed terms at the served shapes, so one element
    can cancel to ~0 while its head's row is O(10).  Returns max |kernel -
    plain|, max |kernel - oracle|, the worst partial rel and the plain
    merged output; fails on a NaN or a wrongly masked segment."""
    import torch
    from repro_torch.kernels.mp_attention import ops, ref
    kn, vn, near_len, kf, vf, scales, far_len = segments
    kw = dict(blk=blk, sm_scale=sm_scale)
    parts, plain, part_rel = [], [], 0.0
    for k, v, sc, n in ((kn, vn, None, near_len), (kf, vf, scales, far_len)):
        got = ops.flash_decode_segment(q, k, v, sc, n, **kw)
        want = ref.flash_decode_segment(q, k, v, sc, n, **kw)
        for name, g, w in zip(("acc", "m", "l"), got, want):
            require(bool(torch.isfinite(g).all()), f"mp_attention {name}: not finite")
            rel = float(((g - w).abs().amax(-1)
                         / w.abs().amax(-1).clamp_min(1.0)).max())
            require(rel <= 1e-4, f"mp_attention partial {name}: rel {rel}")
            part_rel = max(part_rel, rel)
        empty = n <= 0  # no valid key: m = -1e30 and l = S, as the reference
        require(bool((got[1][empty] == -1e30).all())
                and bool((got[2][empty] == k.shape[1]).all()),
                "mp_attention: a fully masked segment is not (m=-1e30, l=S)")
        parts.append(got)
        plain.append(want)
    out = ops.merge_partials(parts)
    want = ops.merge_partials(plain)
    oracle = ref.banded_decode_attention_ref(q, *segments, **kw)
    require(bool(torch.isfinite(out).all()), "mp_attention output not finite")
    return dict(vs_plain=float((out - want).abs().max()),
                vs_oracle=float((out - oracle).abs().max()),
                partials_rel=part_rel, plain=want)


def check_attention(gen, results):
    import torch
    from repro_torch.kernels.mp_attention import ops

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    worst = 0.0
    for shape in ATTN_SHAPES:
        b, g, d, sn, sf, blk = shape
        for scale in ATTN_SCALES:
            for near_dt in (torch.float32, torch.bfloat16):
                for lengths in ("full", "ragged"):
                    q = scale * randn(b, g, d)
                    kn, vn = randn(b, sn, d).to(near_dt), randn(b, sn, d).to(near_dt)
                    kq, vq, sc = ops.quantize_kv(randn(b, sf, d), randn(b, sf, d),
                                                 blk=blk)
                    if lengths == "full":
                        near_len = torch.full((b,), sn, device="cuda")
                        far_len = torch.full((b,), sf, device="cuda")
                    else:  # row 0 has no far key (tests/test_kernels.py)
                        near_len = torch.randint(1, sn + 1, (b,), generator=gen,
                                                 device="cuda")
                        far_len = torch.randint(0, sf + 1, (b,), generator=gen,
                                                device="cuda")
                        far_len[0] = 0
                    segs = (kn, vn, near_len.int(), kq, vq, sc, far_len.int())
                    err = _attn_errors(q, segs, blk=blk, sm_scale=d ** -0.5)
                    vs_plain, vs_oracle = err["vs_plain"], err["vs_oracle"]
                    require(vs_plain <= ATTN_MAX_ABS and vs_oracle <= ATTN_MAX_ABS,
                            f"mp_attention {shape} scale {scale}: {vs_plain}, "
                            f"{vs_oracle} > {ATTN_MAX_ABS}")
                    worst = max(worst, vs_plain)
                    emit(phase="kernels", kernel="mp_attention", shape=shape,
                         logit_scale=scale, near_dtype=str(near_dt),
                         lengths=lengths, max_abs_vs_plain=vs_plain,
                         max_abs_vs_oracle=vs_oracle, bound=ATTN_MAX_ABS,
                         partials_rel=err["partials_rel"])
    # a bf16 query, once per head dim, and the widest G the kernel takes
    for (b, g, d, sn, sf, blk), q_dt in (
            (ATTN_SHAPES[0], torch.bfloat16), (ATTN_SHAPES[1], torch.bfloat16),
            ((2, 16, 128, 192, 384, 64), torch.float32),
            ((2, 16, 64, 192, 384, 64), torch.bfloat16)):
        q = randn(b, g, d).to(q_dt)
        kv = [randn(b, s_, d) for s_ in (sn, sn, sf, sf)]
        kq, vq, sc = ops.quantize_kv(kv[2], kv[3], blk=blk)
        segs = (kv[0].bfloat16(), kv[1].bfloat16(),
                torch.full((b,), sn, dtype=torch.int32, device="cuda"), kq, vq,
                sc, torch.full((b,), sf, dtype=torch.int32, device="cuda"))
        err = _attn_errors(q, segs, blk=blk, sm_scale=d ** -0.5)
        vs_plain, vs_oracle = err["vs_plain"], err["vs_oracle"]
        require(vs_plain <= ATTN_MAX_ABS and vs_oracle <= ATTN_MAX_ABS,
                f"mp_attention q {q_dt} G={g} d={d}: {vs_plain}, {vs_oracle}")
        worst = max(worst, vs_plain)
        emit(phase="kernels", kernel="mp_attention", shape=(b, g, d, sn, sf, blk),
             q_dtype=str(q_dt), max_abs_vs_plain=vs_plain,
             max_abs_vs_oracle=vs_oracle, bound=ATTN_MAX_ABS,
             partials_rel=err["partials_rel"])
    # the split-KV grid's schedules at the served segment sizes (near 1,152
    # bf16 slots, far 7,168 int8 keys, blk 128): B*KV = 1 (one chunk per
    # key block, the most chunks per row); B*KV = 32 with ragged lengths
    # that end mid-chunk and leave whole chunks past the end, and rows with
    # no valid key (seg_len = 0 over several chunks)
    from repro_torch.kernels.mp_attention.mp_attention import split_plan
    for b, lengths in ((1, "full"), (1, "ragged"), (1, "empty"),
                       (32, "ragged")):
        g, d, sn, sf, blk = 4, 64, 1152, 7168, 128
        q = randn(b, g, d)
        kn, vn = randn(b, sn, d).bfloat16(), randn(b, sn, d).bfloat16()
        kq, vq, sc = ops.quantize_kv(randn(b, sf, d), randn(b, sf, d), blk=blk)
        near_len = torch.full((b,), sn, dtype=torch.int32, device="cuda")
        far_len = torch.full((b,), sf, dtype=torch.int32, device="cuda")
        far_chunk = split_plan(b, sf, blk)[0]
        if lengths == "ragged":  # mid-chunk ends, chunks wholly past them
            near_len = torch.randint(1, sn + 1, (b,), generator=gen,
                                     device="cuda").int()
            far_len = (torch.randint(0, sf // far_chunk, (b,), generator=gen,
                                     device="cuda") * far_chunk
                       + far_chunk // 2 + 3).int()
            far_len[0] = 0 if b > 1 else far_len[0]
            near_len[-1] = 1
        elif lengths == "empty":
            far_len.zero_()
        segs = (kn, vn, near_len, kq, vq, sc, far_len)
        err = _attn_errors(q, segs, blk=blk, sm_scale=d ** -0.5)
        vs_plain, vs_oracle = err["vs_plain"], err["vs_oracle"]
        require(vs_plain <= ATTN_MAX_ABS and vs_oracle <= ATTN_MAX_ABS,
                f"mp_attention split B={b} {lengths}: {vs_plain}, {vs_oracle}")
        worst = max(worst, vs_plain)
        emit(phase="kernels", kernel="mp_attention", shape=(b, g, d, sn, sf, blk),
             lengths=lengths, n_split_near=split_plan(b, sn, blk)[1],
             n_split_far=split_plan(b, sf, blk)[1], max_abs_vs_plain=vs_plain,
             max_abs_vs_oracle=vs_oracle, bound=ATTN_MAX_ABS,
             partials_rel=err["partials_rel"])
    results["mp_attention"] = dict(
        name="mp_attention", route="cuda",
        source="src/repro_torch/csrc/mp_attention.cu",
        replaces="src/repro/kernels/mp_attention/mp_attention.py:78",
        max_abs_err=worst)


# ---------------------------------------------------------------------------
# phase 5b and 7: the LM serving path
# ---------------------------------------------------------------------------

def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def smoke_lm_vs_cpu():
    """llama3.2-1b's SMOKE model in fp32 compute on the card and on the CPU,
    the same weights and prompt: logits within 1e-4 of max |logit|, the same
    greedy ids.  The last decode step runs on both from the card's cache:
    each device rounds its own cache rows to bf16, and a row that rounds the
    other way moves the logits by ~1e-4 of their scale by itself."""
    import torch
    from repro_torch.configs import LM_SMOKE_CONFIGS
    from repro_torch.models import decode_step, forward_lm, init_lm, prefill
    from repro_torch.serve_lm import generate
    cfg = LM_SMOKE_CONFIGS["llama3.2-1b"]
    gen = torch.Generator().manual_seed(5)
    params = {"cpu": init_lm(gen, cfg, device="cpu")}
    params["cuda"] = _to_device(params["cpu"], "cuda")
    prompt = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    n_new = 8
    kw = dict(compute_dtype=torch.float32)
    out, caches = {}, {}
    for dev, p in params.items():
        tp = prompt.to(dev)
        ids, caches[dev] = generate(p, cfg, tp, n_new, **kw)
        out[dev] = dict(forward=forward_lm(p, tp, cfg, **kw)[0].cpu(),
                        prefill=prefill(p, tp, cfg, **kw)[0].cpu(), ids=ids.cpu())
    # the last id was never written: one more step fills the last slot
    last = out["cuda"]["ids"][:, -1:]
    for dev, p in params.items():
        cache = _to_device(caches["cuda"], "cpu")  # a copy: the step writes it
        step = decode_step(p, _to_device(cache, dev), last.to(dev),
                           prompt.shape[1] + n_new - 1, cfg, **kw)[0]
        out[dev]["step"] = step.cpu()
    rels = {}
    for name in ("forward", "prefill", "step"):
        g, w = out["cuda"][name], out["cpu"][name]
        require(bool(torch.isfinite(g).all()), f"SMOKE {name}: not finite")
        rels[name] = float((g - w).abs().max() / w.abs().max())
        require(rels[name] <= 1e-4, f"SMOKE {name}: card vs CPU {rels[name]}")
    same = bool((out["cuda"]["ids"] == out["cpu"]["ids"]).all())
    require(same, "SMOKE: greedy ids differ between the card and the CPU")
    emit(phase="small_vs_cpu", model=cfg.name + " SMOKE", compute="float32",
         prompt=list(prompt.shape), new_tokens=n_new, rel_diff=rels, tol=1e-4,
         same_ids=same, ids_card=out["cuda"]["ids"].tolist())


def _ids_checksum(ids) -> str:
    import hashlib
    return hashlib.sha256(ids.cpu().numpy().tobytes()).hexdigest()[:16]


def serving(scfg, results):
    """Phase 7: generate on llama3.2-1b, then every layer's served cache
    through the banded-precision attention, counted, compared and timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import LM_CONFIGS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.mp_attention import ops, ref
    from repro_torch.kernels.mp_attention.mp_attention import launch
    from repro_torch.models import decode_step, init_lm, prefill
    from repro_torch.serve_lm import (banded_kv_attention, cache_bytes_saved,
                                      fold_banded, generate)
    cfg = LM_CONFIGS["llama3.2-1b"]
    b, s, n_new = scfg["batch"], scfg["prompt"], scfg["new"]
    near, blk = scfg["near"], scfg["blk"]
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device="cuda").manual_seed(7)
    t0 = time.perf_counter()
    params = init_lm(gen, cfg)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    q = torch.randn((b * kv, g, hd), generator=gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    length = s + n_new - 1  # the last generated id is never written

    # the main path, counted: generate, then every layer's banded attention
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stats = {}
    ids, cache = generate(params, cfg, prompt, n_new, stats=stats)
    peak_gen = torch.cuda.max_memory_allocated() / 2 ** 30
    layer_k, layer_v = cache["b0"]["k"], cache["b0"]["v"]
    banded = [banded_kv_attention(layer_k[c], layer_v[c], q, length,
                                  near=near, blk=blk)
              for c in range(cfg.n_cycles)]
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {"matern_cov": 0, "matern_cov_grad": 0, "blocked_potrf": 0,
                "mp_syrk": 0, "mp_attention": 2 * cfg.n_cycles}
    require(counts == expected, f"serving launches {counts}, expected {expected}")
    require(tuple(ids.shape) == (b, n_new) and int(ids.min()) >= 0
            and int(ids.max()) < cfg.vocab, f"generated ids {tuple(ids.shape)}")
    require(tuple(layer_k.shape) == (cfg.n_cycles, b, s + n_new, kv, hd)
            and bool(torch.isfinite(layer_k[:, :, :length]).all())
            and bool(torch.isfinite(layer_v[:, :, :length]).all()),
            "served cache: wrong shape or not finite")

    # each layer: the kernel's partials against the plain version's at rel
    # 1e-4 and the merged outputs at ATTN_MAX_ABS (_attn_errors, at the
    # served shapes), the main path's output against the plain merge and
    # against exact attention
    sm_scale = hd ** -0.5
    kw = dict(blk=blk, sm_scale=sm_scale)
    layer_segs, vs_plain, vs_oracle, vs_exact, plain_vs_exact, plain_max = (
        [], 0.0, 0.0, 0.0, 0.0, 0.0)
    partials_rel = 0.0
    for c, (out, exact) in enumerate(banded):
        segs, _ = fold_banded(layer_k[c], layer_v[c], length, near=near, blk=blk)
        layer_segs.append(segs)
        err = _attn_errors(q, segs, **kw)
        plain = err["plain"]
        require(bool(torch.isfinite(out).all()), f"layer {c}: banded not finite")
        vs_plain = max(vs_plain, err["vs_plain"], float((out - plain).abs().max()))
        vs_oracle = max(vs_oracle, err["vs_oracle"])
        partials_rel = max(partials_rel, err["partials_rel"])
        vs_exact = max(vs_exact, float((out - exact).abs().max()))
        plain_vs_exact = max(plain_vs_exact, float((plain - exact).abs().max()))
        plain_max = max(plain_max, float(plain.abs().max()))
    require(vs_plain <= ATTN_MAX_ABS and vs_oracle <= ATTN_MAX_ABS,
            f"served cache: kernel vs plain {vs_plain}, vs oracle {vs_oracle} "
            f"> {ATTN_MAX_ABS}")
    # the int8 far blocks' cost against exact attention: ~1e-3 here, ~1e-2
    # on the kernel tests' inputs, which tests/test_kernels.py holds < 0.05
    require(vs_exact < 0.05, f"served cache: banded vs exact {vs_exact}")
    del banded

    # one more step fills the last slot: finite logits of the full vocab
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = decode_step(params, cache, ids[:, -1:], length, cfg)
    torch.cuda.synchronize()
    last_step_ms = 1e3 * (time.perf_counter() - t0)
    require(tuple(logits.shape) == (b, 1, cfg.vocab)
            and bool(torch.isfinite(logits).all()), "decode logits not finite")
    # where the time goes: one decode step (rewriting the last slot) and one
    # prefill under the profiler
    for what, fn in (
            ("decode_step", lambda: decode_step(params, cache, ids[:, -1:],
                                                length, cfg)),
            ("prefill", lambda: prefill(params, prompt, cfg))):
        wall_ms, busy, rows = device_profile(fn)
        emit(phase="serving_profile", what=what, wall_ms=wall_ms,
             device_busy_ms=busy, idle_share=1 - busy / wall_ms,
             kernels=sum(c for _, c, _ in rows),
             top=[{"name": k[:90], "count": c, "ms": ms} for k, c, ms in rows[:10]])
    del cache, layer_k, layer_v, params
    torch.cuda.empty_cache()

    # times: each layer in turn, so that each layer's ~39 MB of K/V come
    # from device memory (16 layers are 12x the 50 MB L2), per layer: the
    # two segment launches alone (the kernel's time), their plain versions,
    # and the whole banded call with its plain-PyTorch merge
    n_layers = len(layer_segs)

    def segments_all(fn):
        for kn, vn, near_len, kf, vf, sc, far_len in layer_segs:
            fn(q, kn, vn, None, near_len, **kw)
            fn(q, kf, vf, sc, far_len, **kw)
    ms = time_ms(lambda: segments_all(launch)) / n_layers
    # the same launches under the profiler: device time by kernel against
    # wall time says how much of `ms` is the wrapper's host work
    wall_ms, busy, rows = device_profile(lambda: segments_all(launch))
    emit(phase="serving_profile", what="mp_attention segments, all layers",
         wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
         top=[{"name": k[:90], "count": c, "ms": ms_} for k, c, ms_ in rows[:6]])
    plain_ms = time_ms(lambda: segments_all(ref.flash_decode_segment)) / n_layers
    merged_ms = time_ms(lambda: [ops.banded_decode_attention(q, *sg, **kw)
                                 for sg in layer_segs]) / n_layers

    # library yardstick: one SDPA call over the dequantized K/V (bf16) with
    # the validity mask, G query heads as G queries of one KV head
    sdpa_in = []
    for kn, vn, near_len, kf, vf, sc, far_len in layer_segs:
        nblk = kf.shape[1] // blk
        deq = [(x.float().reshape(x.shape[0], nblk, blk, hd)
                * sc[:, :, i, None, None]).reshape(x.shape).bfloat16()
               for i, x in enumerate((kf, vf))]
        k_all = torch.cat([deq[0], kn], dim=1)[:, None]
        v_all = torch.cat([deq[1], vn], dim=1)[:, None]
        pos = torch.arange(k_all.shape[2], device="cuda")
        mask = ((pos < far_len[0]) | ((pos >= kf.shape[1])
                                      & (pos < kf.shape[1] + near_len[0])))
        sdpa_in.append((k_all, v_all, mask[None, None, None, :].expand(
            k_all.shape[0], 1, 1, -1)))
    q_sdpa = q.bfloat16()[:, None]
    lib_out = F.scaled_dot_product_attention(q_sdpa, *sdpa_in[0][:2],
                                             attn_mask=sdpa_in[0][2])
    library_ms = time_ms(lambda: [
        F.scaled_dot_product_attention(q_sdpa, k_, v_, attn_mask=m_)
        for k_, v_, m_ in sdpa_in]) / n_layers
    kn, vn, near_len, kf, vf, sc, far_len = layer_segs[0]
    lib_vs_kernel = float((lib_out[:, 0].float() - ops.banded_decode_attention(
        q, *layer_segs[0], **kw)).abs().max())

    # bound: the bytes the two launches need per layer: q for each, the
    # filled K/V rows of each segment, the far scales, each (acc, m, l)
    rows = q.shape[0]
    near_n, far_n = int(near_len[0]), int(far_len[0])
    bytes_moved = (2 * q.numel() * 4
                   + 2 * rows * hd * (near_n * kn.element_size()
                                      + far_n * kf.element_size())
                   + sc.numel() * 4 + 2 * (q.numel() + 2 * rows * g) * 4)
    flops = 4 * rows * g * hd * (near_n + far_n)
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)
    saved = cache_bytes_saved(kn.shape[1], kf.shape[1])
    emit(phase="serving", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         batch=b, prompt=s, new_tokens=n_new, compute="bfloat16",
         init_seconds=init_s, prefill_seconds=stats["prefill_s"],
         decode_ms_per_step=1e3 * stats["decode_s"] / stats["decode_steps"],
         last_step_ms=last_step_ms, peak_gib=peak_gen,
         ids_sha256=_ids_checksum(ids), ids_head=ids[0, :8].tolist(),
         launches=counts)
    emit(phase="serving", banded="every layer's served cache", slots=s + n_new,
         filled=length, near_filled=near_n, near_slots=kn.shape[1],
         far_slots=far_n, far_blocks=far_n // blk, rows=rows, g=g, d=hd,
         max_abs_kernel_vs_plain=vs_plain, max_abs_kernel_vs_oracle=vs_oracle,
         bound=ATTN_MAX_ABS, partials_rel=partials_rel, partials_rel_bound=1e-4,
         max_abs_plain=plain_max,
         max_abs_banded_vs_exact=vs_exact, max_abs_plain_vs_exact=plain_vs_exact,
         max_abs_sdpa_vs_kernel=lib_vs_kernel, cache_bytes_saved=saved,
         kernel_ms_per_layer=ms, plain_ms_per_layer=plain_ms,
         banded_call_ms_per_layer=merged_ms, sdpa_ms_per_layer=library_ms,
         bound_ms=bound_ms, bytes=bytes_moved)
    r = results["mp_attention"]
    r.update(launches=counts["mp_attention"], ms=ms, plain_ms=plain_ms,
             bound_ms=bound_ms, library_ms=library_ms,
             bound_by="bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / FP32_FLOPS
             else "operations",
             max_abs_err=max(r["max_abs_err"], vs_plain))


# ---------------------------------------------------------------------------
# phase 8: the fidelity path (Algorithm 1 tile engine, likelihood, kriging)
# ---------------------------------------------------------------------------

def fidelity_policies(p):
    """(label, policy, use_tiles) of phase 8's one-evaluation comparison."""
    import torch
    from repro_torch.core import PrecisionPolicy as P
    full = P.full(torch.float32)
    return [("DP(100%) reference_cholesky", full, None),
            ("DP(100%) tiles", full, True),
            ("DP(10%)", P.from_dp_percent(p, 0.10), None),
            ("DP(40%)", P.from_dp_percent(p, 0.40), None),
            ("three_tier(2,20)", P.three_tier(2, 20), None),
            ("DST DP(70%)", P.dst(P.from_dp_percent(p, 0.70).diag_thick), None)]


def _tiled(policy, use_tiles):
    return policy.mode != "dst" and (
        use_tiles if use_tiles is not None else policy.mode != "full")


def _evaluate(fn, theta):
    """One evaluation from a synced start: (loglik, seconds, peak GiB,
    launch counts)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    ll = float(fn(theta))  # waits for the device
    return (ll, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30, launch_counts())


def fidelity_evaluations(locs, z, theta, fcfg, total, profile=True):
    """8.1: one evaluation per policy at theta through the kernels and
    through the plain versions on the card: launch counts (added to
    `total`), log-likelihoods, seconds, peak memory, and (with `profile`)
    the kernel path's device time under the profiler."""
    from repro_torch.core import make_loglik
    nb, p = fcfg["nb"], locs.shape[0] // fcfg["nb"]
    theta = list(theta)
    for label, pol, use_tiles in fidelity_policies(p):
        tiled = _tiled(pol, use_tiles)
        expected = {"matern_cov": 1, "blocked_potrf": p if tiled else 0,
                    "mp_syrk": p - 1 if tiled else 0, "matern_cov_grad": 0,
                    "mp_attention": 0}
        out = {}
        for impl in ("kernel", "plain"):
            fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5,
                             use_tiles=use_tiles, impl=impl)
            out[impl] = _evaluate(fn, theta)
        (a, sa, pa, ca), (b, sb, pb, cb) = out["kernel"], out["plain"]
        require(ca == expected, f"{label}: launches {ca}, expected {expected}")
        require(sum(cb.values()) == 0, f"{label}: plain path launched {cb}")
        for k in total:
            total[k] += ca[k]
        both_nan = math.isnan(a) and math.isnan(b)
        close = (math.isfinite(a) and math.isfinite(b)
                 and abs(a - b) <= 1e-3 * abs(b))
        require(both_nan or close, f"{label}: kernel {a} vs plain {b}")
        prof = {}
        if profile:
            fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5,
                             use_tiles=use_tiles)
            wall_ms, busy, rows = device_profile(lambda: float(fn(theta)))
            prof = dict(wall_ms=wall_ms, device_busy_ms=busy,
                        idle_share=1 - busy / wall_ms,
                        top=[{"name": k[:90], "count": c, "ms": ms}
                             for k, c, ms in rows[:8]])
        emit(phase="fidelity", step="evaluation", policy=label,
             mode=pol.mode, diag_thick=min(pol.diag_thick, p), tiles=tiled,
             n=locs.shape[0], nb=nb, theta=theta, loglik_kernel=a,
             loglik_plain=b, rel_diff=abs(a - b) / abs(b) if close else None,
             seconds_kernel=sa, seconds_plain=sb, peak_gib_kernel=pa,
             peak_gib_plain=pb, launches_kernel=ca, **prof)


def fidelity_refusals(locs, z, fcfg):
    """What the kernels do not take raises on the card, with no fallback:
    nb not a multiple of 64 (the paper pair's fp64 band runs: phase 9)."""
    from repro_torch.core import PrecisionPolicy, make_loglik
    pol, nb_bad = PrecisionPolicy.tpu(2), 96
    try:
        make_loglik(locs[:4 * nb_bad], z[:4 * nb_bad], pol, nb=nb_bad,
                    nu_static=0.5)(list(MEDIUM))
    except ValueError as e:
        emit(phase="fidelity", step="refused", mode=pol.mode, hi=str(pol.hi),
             nb=nb_bad, error=type(e).__name__, message=str(e)[:120])
    else:
        raise AssertionError(f"{pol.mode} nb={nb_bad}: no error on the card")


def fidelity_estimation(locs, z, fcfg):
    """8.2: fit_mle_grid then batched Nelder-Mead through BatchEngine, for
    DP(100%), DP(10%) and DST; theta-hat, evaluations and seconds.  The
    dense policies go one candidate at a time: cuSOLVER on a batch of
    three 40,960^2 matrices took 2.6x as long per candidate as on one
    (one H100; PERF.md)."""
    import torch
    from repro_torch.core import BatchEngine, BatchPlan, fit_mle, fit_mle_grid
    nb, p = fcfg["nb"], locs.shape[0] // fcfg["nb"]
    pols = {label: pol for label, pol, tiles in fidelity_policies(p)
            if tiles is None and label != "DP(40%)"
            and not label.startswith("three")}
    fits = {}
    for label, pol in pols.items():
        chunk = fcfg["chunk"] if _tiled(pol, None) else 1
        engine = BatchEngine(locs, z, BatchPlan(policy=pol, nb=nb, nu_static=0.5,
                                                chunk_size=chunk))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        coarse = fit_mle_grid(engine.loglik, [(0.2, 5.0), (0.02, 0.6)],
                              num=fcfg["grid"], refine=fcfg["refine"])
        res = fit_mle(None, coarse.theta, max_iters=fcfg["nm_iters"],
                      batched_loglik_fn=engine.loglik)
        secs = time.perf_counter() - t0
        evals = coarse.n_evals + res.n_evals
        require(math.isfinite(res.loglik) and res.loglik >= coarse.loglik,
                f"{label}: the polish lost ground ({res.loglik} < {coarse.loglik})")
        fits[label] = res
        emit(phase="fidelity", step="estimation", policy=label,
             chunk_size=chunk, grid=fcfg["grid"],
             refine=fcfg["refine"], nm_iters=res.n_iters,
             theta_grid=coarse.theta.tolist(), theta_hat=res.theta.tolist(),
             loglik=res.loglik, evaluations=evals, seconds=secs,
             seconds_per_evaluation=secs / evals,
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    dp, mp = fits["DP(100%) reference_cholesky"].theta, fits["DP(10%)"].theta
    gap = (abs(mp - dp) / abs(dp)).tolist()
    require(max(gap) <= 0.25, f"theta-hat MP {mp} vs DP {dp}: rel {gap} > 0.25")
    emit(phase="fidelity", step="estimation", theta_rel_gap_mp_vs_dp=gap,
         tol=0.25)
    return {label: (pols[label], fits[label].theta) for label in fits}


def fidelity_prediction(locs, z, locs_new, z_new, fits, fcfg):
    """8.3: kriging at the held-out sites with each policy's theta-hat:
    PMSE, the variance's range and k-fold PMSE."""
    from repro_torch.core import kfold_pmse, krige, pmse
    nb = fcfg["nb"]
    scores = {}
    for label, (pol, th) in fits.items():
        theta = [float(th[0]), float(th[1]), 0.5]
        t0 = time.perf_counter()
        mu, var = krige(locs, z, locs_new, theta, pol, nb=nb, nu_static=0.5,
                        return_var=True)
        score = float(pmse(mu, z_new))
        krige_s = time.perf_counter() - t0
        vmin, vmax = float(var.min()), float(var.max())
        require(-1e-4 <= vmin and vmax <= theta[0] + 1e-4 and math.isfinite(score),
                f"{label}: variance in [{vmin}, {vmax}], theta1 {theta[0]}")
        t0 = time.perf_counter()
        kscore, folds = kfold_pmse(locs, z, theta, pol, k=fcfg["kfold"], nb=nb,
                                   nu_static=0.5)
        scores[label] = (score, kscore)
        emit(phase="fidelity", step="prediction", policy=label, theta=theta,
             sites=locs_new.shape[0], pmse=score, var_min=vmin, var_max=vmax,
             krige_seconds=krige_s, kfold=fcfg["kfold"], kfold_pmse=kscore,
             kfold_folds=folds, kfold_seconds=time.perf_counter() - t0)
    dp, mp = scores["DP(100%) reference_cholesky"], scores["DP(10%)"]
    rel = [abs(m - d) / d for m, d in zip(mp, dp)]
    require(max(rel) <= 0.2, f"PMSE MP {mp} vs DP {dp}: rel {rel} > 0.2")
    emit(phase="fidelity", step="prediction", pmse_rel_mp_vs_dp=rel[0],
         kfold_pmse_rel_mp_vs_dp=rel[1], tol=0.2,
         dst_pmse=scores["DST DP(70%)"][0],
         dst_kfold_pmse=scores["DST DP(70%)"][1])


def fidelity_batch(locs, z, fcfg, theta_hat):
    """8.4: BatchEngine.loglik on 8 candidates against loglik_sequential."""
    import numpy as np
    import torch
    from repro_torch.core import BatchEngine, BatchPlan, PrecisionPolicy
    p = locs.shape[0] // fcfg["nb"]
    engine = BatchEngine(locs, z, BatchPlan(
        policy=PrecisionPolicy.from_dp_percent(p, 0.10), nb=fcfg["nb"],
        nu_static=0.5, chunk_size=fcfg["chunk"]))
    scale = np.exp(np.linspace(-0.2, 0.2, fcfg["batch"]))
    thetas = np.stack([theta_hat[0] * scale, theta_hat[1] * scale[::-1]], -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = engine.loglik(thetas).cpu().numpy().astype(np.float64)
    batched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = engine.loglik_sequential(thetas)
    seq_s = time.perf_counter() - t0
    rel = np.abs(batched - seq) / np.abs(seq)
    same_nan = np.isnan(batched) == np.isnan(seq)
    require(bool(same_nan.all()) and bool(np.all(rel[~np.isnan(seq)] <= 1e-5)),
            f"batched {batched} vs sequential {seq}")
    emit(phase="fidelity", step="batch_vs_sequential", candidates=len(thetas),
         chunk_size=fcfg["chunk"], max_rel_diff=float(np.nanmax(rel)),
         tol=1e-5, seconds_batched=batched_s, seconds_sequential=seq_s,
         logliks=batched.tolist())


def fidelity_small_vs_cpu():
    """8.5: the tile path at n = 2,048, nb = 256, tpu(2) on the card and on
    the CPU (plain versions there)."""
    import torch
    from repro_torch.core import PrecisionPolicy, make_loglik
    from repro_torch.covariance import make_dataset
    gen = torch.Generator(device="cuda").manual_seed(4)
    ds = make_dataset(gen, 2048, MEDIUM, nu_static=0.5)
    lls = {}
    for dev in ("cuda", "cpu"):
        fn = make_loglik(ds.locs.to(dev), ds.z.to(dev), PrecisionPolicy.tpu(2),
                         nb=256, nu_static=0.5)
        lls[dev] = float(fn(list(MEDIUM)))
    rel = abs(lls["cuda"] - lls["cpu"]) / abs(lls["cpu"])
    require(math.isfinite(lls["cuda"]) and rel <= 1e-3,
            f"tile path card {lls['cuda']} vs CPU {lls['cpu']}")
    emit(phase="fidelity", step="small_vs_cpu", n=2048, nb=256, mode="mixed",
         t=2, loglik_card=lls["cuda"], loglik_cpu=lls["cpu"], rel_diff=rel,
         tol=1e-3)


def fidelity_general_nu(n=4096, rows=256):
    """8.6: a general-nu (1.27, wind region R2) haversine covariance on the
    card against the CPU in fp64, on `rows` rows of it."""
    import torch
    from repro_torch.covariance import WIND_REGIONS, matern_covariance
    from repro_torch.covariance.generator import WIND_BOXES, random_locations
    gen = torch.Generator(device="cuda").manual_seed(6)
    lon0, lon1, lat0, lat1 = WIND_BOXES["R2"]
    unit = random_locations(gen, n)
    locs = torch.stack([lon0 + unit[:, 0] * (lon1 - lon0),
                        lat0 + unit[:, 1] * (lat1 - lat0)], -1)
    theta = torch.tensor(WIND_REGIONS["R2"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cov = matern_covariance(locs, locs, theta.cuda(), metric="haversine")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    l64 = locs.cpu().double()
    want = matern_covariance(l64[:rows], l64, theta.double(), metric="haversine")
    got = cov[:rows].cpu().double()
    rel = float(((got - want).abs() / want.abs()).max())
    require(bool(torch.isfinite(cov).all()) and rel <= GENERAL_NU_MAX_REL,
            f"general nu on the card: max rel {rel} > {GENERAL_NU_MAX_REL}")
    emit(phase="fidelity", step="general_nu", nu=WIND_REGIONS["R2"][2],
         metric="haversine", n=n, rows_checked=rows, max_rel=rel,
         tol=GENERAL_NU_MAX_REL, seconds_card=card_s)


def fidelity_kernels(locs, locs_new, fcfg, results):
    """8.7: each kernel at the tile path's shapes against its plain version,
    timed beside its yardstick and bound: mp_syrk at step 0 (band of
    DP(10%)), blocked_potrf on a chunk's diagonal tiles, matern_cov for
    Sigma and Sigma_no."""
    import torch
    from repro_torch.core import PrecisionPolicy
    from repro_torch.kernels.blocked_potrf import ops as potrf_ops
    from repro_torch.kernels.blocked_potrf import ref as potrf_ref
    from repro_torch.kernels.matern_cov import ops as mc_ops
    from repro_torch.kernels.matern_cov import ref as mc_ref
    from repro_torch.kernels.mp_gemm import ops as syrk_ops
    from repro_torch.kernels.mp_gemm import ref as syrk_ref
    nb = fcfg["nb"]
    n = locs.shape[0]
    p = n // nb
    t = PrecisionPolicy.from_dp_percent(p, 0.10).diag_thick
    gen = torch.Generator(device="cuda").manual_seed(8)
    # mp_syrk at step 0: P = ((p - 1) nb, nb)
    pm = torch.randn(((p - 1) * nb, nb), generator=gen, device="cuda")
    kw = dict(tile=nb, round_k=nb, band_blocks=t)
    out = syrk_ops.mp_syrk(pm, **kw)
    want = syrk_ref.mp_syrk(pm, **kw)
    rel, ratio, mx = _syrk_errors(out, want, pm, tile=nb, round_k=nb, band=t)
    require(rel <= 1e-5 and ratio <= 1.0, f"mp_syrk tile step 0: {rel} {ratio}")
    del out, want
    syrk = syrk_step_numbers(pm, p - 1, nb, t)
    syrk.update(plain_ms=time_ms(lambda: syrk_ref.mp_syrk(pm, **kw)),
                inband_rel=rel, offband_err_over_tol=ratio, max_abs_err=mx)
    emit(phase="fidelity", step="kernel", kernel="mp_syrk",
         m=(p - 1) * nb, k=nb, band=t, **syrk)
    del pm
    # blocked_potrf on a chunk's diagonal tiles
    a = spd_batch(gen, fcfg["chunk"], nb)
    l, info = potrf_ops.potrf(a)
    lw, _ = potrf_ref.potrf(a)
    prel = scale_rel(l, lw)
    require(int(info.abs().sum()) == 0 and prel <= 1e-3, f"potrf batch: {prel}")
    flops = fcfg["chunk"] * nb ** 3 / 3
    bytes_moved = fcfg["chunk"] * 2 * 4 * nb ** 2
    emit(phase="fidelity", step="kernel", kernel="blocked_potrf",
         batch=fcfg["chunk"], nb=nb, max_rel=prel,
         ms=time_ms(lambda: potrf_ops.potrf(a)),
         plain_ms=time_ms(lambda: potrf_ref.potrf(a)),
         library_ms=time_ms(lambda: torch.linalg.cholesky(a)),
         bound_ms=1e3 * max(flops / FP32_FLOPS, bytes_moved / HBM_BYTES_PER_S))
    del a, l, lw
    # matern_cov: Sigma (n x n) and Sigma_no (m x n), one tile each;
    # checked on row slabs (the plain version's temporaries are 4x the tile);
    # Sigma = C(locs, locs) is the symmetric form: equal to its transpose
    # and to the general form's (the locations as a copy) bit for bit, both
    # forms timed
    theta = list(MEDIUM)
    for what, la in (("Sigma", locs), ("Sigma_no", locs_new)):
        out = mc_ops.matern_cov(la, locs, theta, nu=0.5)
        rel = 0.0
        for r0 in (0, max(0, la.shape[0] - 2048)):
            w = mc_ref.matern_cov(la[r0:r0 + 2048], locs, theta, nu=0.5)
            rel = max(rel, float(((out[r0:r0 + 2048] - w).abs()
                                  / w.abs().clamp_min(1e-30)).max()))
        require(rel <= 1e-5, f"matern_cov {what}: rel {rel}")
        del w
        sym = _sigma_forms(out, la, locs, theta, torch.float32) if la is locs else {}
        del out
        elems = la.shape[0] * n
        bytes_moved = (la.shape[0] + n) * 8 + 4 * elems
        emit(phase="fidelity", step="kernel", kernel="matern_cov", what=what,
             shape=[la.shape[0], n], max_rel=rel,
             ms=time_ms(lambda: mc_ops.matern_cov(la, locs, theta, nu=0.5)),
             plain_ms=time_ms(lambda: mc_ref.matern_cov(la, locs, theta, nu=0.5),
                              reps=2),
             bound_ms=1e3 * max(bytes_moved / HBM_BYTES_PER_S,
                                9 * elems / FP32_FLOPS), **sym)
        torch.cuda.empty_cache()


def _sigma_forms(out, la, locs, theta, dtype):
    """Sigma = out from the symmetric form: equal to its transpose and to
    the general form's Sigma (la as a copy) bit for bit; the general form
    timed (ms_general)."""
    import torch
    from repro_torch.kernels.matern_cov import ops as mc_ops
    copy = la.clone()
    sym = bool(torch.equal(out, out.T))
    gen = mc_ops.matern_cov(copy, locs, theta, nu=0.5, out_dtype=dtype)
    same = bool(torch.equal(out, gen))
    del gen
    torch.cuda.empty_cache()
    require(sym and same, f"matern_cov Sigma {dtype}: equal to its transpose "
            f"{sym}, to the general form {same}")
    return dict(equal_to_transpose=sym, equal_to_general=same,
                ms_general=time_ms(lambda: mc_ops.matern_cov(
                    copy, locs, theta, nu=0.5, out_dtype=dtype)))


def _fidelity_data(gen, theta0, fcfg):
    """make_dataset at n_all points; every hold-th held out, the first n_obs
    of the rest observed: (locs, z, locs_new, z_new), contiguous."""
    import torch
    from repro_torch.covariance import make_dataset
    ds = make_dataset(gen, fcfg["n_all"], theta0, nu_static=0.5)
    idx = torch.arange(fcfg["n_all"], device="cuda")
    held = idx % fcfg["hold"] == fcfg["hold"] - 1
    new, obs = idx[held], idx[~held][:fcfg["n_obs"]]
    require(obs.numel() == fcfg["n_obs"], f"{obs.numel()} observations")
    return tuple(x.contiguous() for x in (ds.locs[obs], ds.z[obs],
                                          ds.locs[new], ds.z[new]))


def fidelity(fcfg, results):
    """Phase 8: the fidelity path at n_obs locations in nb-tiles (see the
    module docstring), sub-steps timed into one phase line.

    8.1 evaluates every policy on the medium-correlation field at its
    theta0, as the paper's estimation study sets it.  There the bf16
    off-band makes the covariance indefinite (NaN in both paths on one
    H100; PERF.md), so the estimation, the prediction and the batch check run
    on the weak-correlation field, where every pair's likelihood is
    defined; 8.1 runs there too.
    """
    import torch
    t_all = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    fields = {"medium": MEDIUM, "weak": WEAK}
    data = {name: _fidelity_data(gen, fields[name], fcfg)
            for name in fcfg["fields"]}
    torch.cuda.empty_cache()
    emit(phase="fidelity", step="data", n_all=fcfg["n_all"], n_obs=fcfg["n_obs"],
         sites=int(data["weak"][2].shape[0]), nb=fcfg["nb"],
         p=fcfg["n_obs"] // fcfg["nb"],
         theta0={name: fields[name] for name in fcfg["fields"]},
         seconds=time.perf_counter() - t_all)
    secs = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    total = {"matern_cov": 0, "blocked_potrf": 0, "mp_syrk": 0}
    locs, z, locs_new, z_new = data["weak"]
    for name in fcfg["fields"]:  # the profile on the weak field only
        step(f"8.1 evaluations, {name}", fidelity_evaluations,
             *data[name][:2], fields[name], fcfg, total, name == "weak")
    for k, v in total.items():
        results[k]["launches_fidelity"] = v
    step("8.1 refusals", fidelity_refusals, locs, z, fcfg)
    fits = step("8.2 estimation", fidelity_estimation, locs, z, fcfg)
    step("8.3 prediction", fidelity_prediction, locs, z, locs_new, z_new, fits,
         fcfg)
    step("8.4 batch", fidelity_batch, locs, z, fcfg, fits["DP(10%)"][1])
    step("8.5 small vs CPU", fidelity_small_vs_cpu)
    step("8.6 general nu", fidelity_general_nu)
    step("8.7 kernels", fidelity_kernels, locs, locs_new, fcfg, results)
    emit(phase="fidelity", step="seconds", **secs)
    return locs, z


# ---------------------------------------------------------------------------
# phase 9: the paper pair {fp64 band, fp32 off-band} on the fidelity path
# ---------------------------------------------------------------------------

def paper_policies(p):
    """(label, policy, use_tiles) of phase 9: full(fp64) dense and through
    the tiles, and the paper pair at DP(10%) and DP(40%)."""
    import torch
    from repro_torch.core import PrecisionPolicy as P
    full = P.full(torch.float64)
    return [("full(fp64) reference_cholesky", full, None),
            ("full(fp64) tiles", full, True),
            ("paper_cpu DP(10%)", P.from_dp_percent(p, 0.10, "paper_cpu"), None),
            ("paper_cpu DP(40%)", P.from_dp_percent(p, 0.40, "paper_cpu"), None)]


def _paper_data(gen, fcfg):
    """An fp64 field at the medium theta0: fp64 locations, the draw through
    an fp64 Cholesky, Morton order; split as `_fidelity_data`."""
    import torch
    from repro_torch.covariance import (ORDERINGS, apply_ordering,
                                        random_locations, simulate_field)
    locs = random_locations(gen, fcfg["n_all"], dtype=torch.float64)
    z = simulate_field(gen, locs, MEDIUM, nu_static=0.5)
    locs, z = apply_ordering(locs, z, ORDERINGS["morton"](locs))
    idx = torch.arange(fcfg["n_all"], device="cuda")
    held = idx % fcfg["hold"] == fcfg["hold"] - 1
    new, obs = idx[held], idx[~held][:fcfg["n_obs"]]
    require(obs.numel() == fcfg["n_obs"], f"{obs.numel()} observations")
    return tuple(x.contiguous() for x in (locs[obs], z[obs], locs[new], z[new]))


def paper_evaluations(locs, z, fcfg, total):
    """9.1: one evaluation per policy at the medium theta0 through the
    kernels and through the plain versions (exact launch counts, kernel
    against plain within 1e-5 |ll|, each paper pair against dense fp64
    within 1e-4 |ll|), the paper pair's drift beside its registered bound,
    one profiled DP(10%) evaluation, and tpu(2) on the same field."""
    import torch
    from repro_torch.core import PrecisionPolicy, make_loglik
    nb, p = fcfg["nb"], locs.shape[0] // fcfg["nb"]
    theta = list(MEDIUM)
    dense = None
    for label, pol, use_tiles in paper_policies(p):
        tiled = _tiled(pol, use_tiles)
        expected = {"matern_cov": 1, "blocked_potrf": 0,
                    "mp_syrk": p - 1 if tiled else 0, "matern_cov_grad": 0,
                    "mp_attention": 0}
        out = {}
        for impl in ("kernel", "plain"):
            fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5,
                             use_tiles=use_tiles, impl=impl)
            out[impl] = _evaluate(fn, theta)
        (a, sa, pa, ca), (b, sb, pb, cb) = out["kernel"], out["plain"]
        require(ca == expected, f"{label}: launches {ca}, expected {expected}")
        require(sum(cb.values()) == 0, f"{label}: plain path launched {cb}")
        require(math.isfinite(a) and math.isfinite(b)
                and abs(a - b) <= 1e-5 * abs(b), f"{label}: kernel {a} vs plain {b}")
        extra = {}
        if dense is None:
            dense = a
        else:  # fp64 through the tiles: within the fp64 pair's own bound
            drift = abs(a - dense) / abs(dense)
            tol = 1e-4 if pol.mode == "mixed" else PAPER_LOGLIK_DRIFT
            require(drift <= tol, f"{label}: {a} vs full(fp64) {dense}")
            extra = dict(drift_vs_full_fp64=drift, drift_tol=tol,
                         registered_loglik_drift=PAPER_LOGLIK_DRIFT,
                         within_registered=drift <= PAPER_LOGLIK_DRIFT)
        if pol.mode == "mixed":
            for k in total:
                total[k] += ca[k]
        emit(phase="paper", step="evaluation", policy=label, mode=pol.mode,
             diag_thick=min(pol.diag_thick, p), tiles=tiled, n=locs.shape[0],
             nb=nb, theta=theta, loglik_kernel=a, loglik_plain=b,
             rel_diff=abs(a - b) / abs(b), tol=1e-5, seconds_kernel=sa,
             seconds_plain=sb, peak_gib_kernel=pa, peak_gib_plain=pb,
             launches_kernel=ca, **extra)
    pol = PrecisionPolicy.from_dp_percent(p, 0.10, "paper_cpu")
    fn = make_loglik(locs, z, pol, nb=nb, nu_static=0.5)
    wall_ms, busy, rows = device_profile(lambda: float(fn(theta)))
    emit(phase="paper", step="profile", policy="paper_cpu DP(10%)",
         wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
         top=[{"name": k[:90], "count": c, "ms": ms} for k, c, ms in rows[:10]])
    # the {fp32, bf16} pair on the same field (its locations and data in
    # fp32): NaN at this theta0, where the paper pair is finite
    pol = PrecisionPolicy.tpu(2)
    ll, secs, peak, counts = _evaluate(make_loglik(
        locs.float(), z.float(), pol, nb=nb, nu_static=0.5), theta)
    require(counts["mp_syrk"] == p - 1 and counts["blocked_potrf"] == p,
            f"tpu(2): launches {counts}")
    emit(phase="paper", step="evaluation", policy="tpu(2) DP(10%)",
         mode=pol.mode, diag_thick=2, tiles=True, theta=theta,
         loglik_kernel=ll, finite=math.isfinite(ll), seconds_kernel=secs,
         peak_gib_kernel=peak, launches_kernel=counts)


def paper_estimation(locs, z, fcfg):
    """9.2: fit_mle_grid then batched Nelder-Mead through BatchEngine (one
    candidate per chunk: three fp64 Sigma with their U pass 80 GB) for
    full(fp64) dense and the paper pair at DP(10%), from phase 8.2's grid;
    theta-hat within rel 0.25 per component."""
    import torch
    from repro_torch.core import BatchEngine, BatchPlan, fit_mle, fit_mle_grid
    nb, p = fcfg["nb"], locs.shape[0] // fcfg["nb"]
    pols = {label: pol for label, pol, tiles in paper_policies(p)
            if tiles is None and "40%" not in label}
    fits = {}
    for label, pol in pols.items():
        engine = BatchEngine(locs, z, BatchPlan(policy=pol, nb=nb, nu_static=0.5,
                                                chunk_size=1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        coarse = fit_mle_grid(engine.loglik, [(0.2, 5.0), (0.02, 0.6)],
                              num=fcfg["grid"], refine=fcfg["refine"])
        res = fit_mle(None, coarse.theta, max_iters=fcfg["nm_iters"],
                      batched_loglik_fn=engine.loglik)
        secs = time.perf_counter() - t0
        evals = coarse.n_evals + res.n_evals
        require(math.isfinite(res.loglik) and res.loglik >= coarse.loglik,
                f"{label}: the polish lost ground ({res.loglik} < {coarse.loglik})")
        fits[label] = (pol, res.theta)
        emit(phase="paper", step="estimation", policy=label, chunk_size=1,
             grid=fcfg["grid"], refine=fcfg["refine"], nm_iters=res.n_iters,
             theta_grid=coarse.theta.tolist(), theta_hat=res.theta.tolist(),
             theta1_over_theta2=float(res.theta[0] / res.theta[1]),
             loglik=res.loglik, evaluations=evals, seconds=secs,
             seconds_per_evaluation=secs / evals,
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    dp = fits["full(fp64) reference_cholesky"][1]
    mp = fits["paper_cpu DP(10%)"][1]
    gap = (abs(mp - dp) / abs(dp)).tolist()
    ratio_gap = abs(mp[0] / mp[1] - dp[0] / dp[1]) / (dp[0] / dp[1])
    require(max(gap) <= 0.25, f"theta-hat paper {mp} vs fp64 {dp}: rel {gap} > 0.25")
    emit(phase="paper", step="estimation", theta_rel_gap_vs_fp64=gap, tol=0.25,
         theta1_over_theta2_rel_gap=float(ratio_gap))
    return fits


def paper_prediction(locs, z, locs_new, z_new, fits, fcfg):
    """9.3: kriging with variance at the held-out sites at each theta-hat;
    the paper pair's PMSE within rel 0.2 of full(fp64)'s."""
    from repro_torch.core import krige, pmse
    scores = {}
    for label, (pol, th) in fits.items():
        theta = [float(th[0]), float(th[1]), 0.5]
        t0 = time.perf_counter()
        mu, var = krige(locs, z, locs_new, theta, pol, nb=fcfg["nb"],
                        nu_static=0.5, return_var=True)
        scores[label] = score = float(pmse(mu, z_new))
        vmin, vmax = float(var.min()), float(var.max())
        require(-1e-6 <= vmin and vmax <= theta[0] + 1e-6 and math.isfinite(score),
                f"{label}: variance in [{vmin}, {vmax}], theta1 {theta[0]}")
        emit(phase="paper", step="prediction", policy=label, theta=theta,
             sites=locs_new.shape[0], pmse=score, var_min=vmin, var_max=vmax,
             dtype=str(mu.dtype), seconds=time.perf_counter() - t0)
    dp, mp = scores["full(fp64) reference_cholesky"], scores["paper_cpu DP(10%)"]
    rel = abs(mp - dp) / dp
    require(rel <= 0.2, f"PMSE paper {mp} vs fp64 {dp}: rel {rel} > 0.2")
    emit(phase="paper", step="prediction", pmse_rel_vs_fp64=rel, tol=0.2)


def paper_kernels(locs, locs_new, fcfg, results):
    """9.4: the fp64 kernels at the tile path's shapes: mp_syrk (fp64, fp32)
    at step 0 (band of DP(10%)) and matern_cov in fp64 for Sigma and
    Sigma_no, each against its plain version (compared on row slabs) with
    its time, yardstick and bound."""
    import torch
    from repro_torch.core import PrecisionPolicy
    from repro_torch.kernels.matern_cov import ops as mc_ops
    from repro_torch.kernels.matern_cov import ref as mc_ref
    from repro_torch.kernels.mp_gemm import ops as syrk_ops
    from repro_torch.kernels.mp_gemm import ref as syrk_ref
    f32, f64 = torch.float32, torch.float64
    nb = fcfg["nb"]
    n = locs.shape[0]
    p = n // nb
    t = PrecisionPolicy.from_dp_percent(p, 0.10, "paper_cpu").diag_thick
    gen = torch.Generator(device="cuda").manual_seed(9)
    pm = torch.randn(((p - 1) * nb, nb), generator=gen, device="cuda", dtype=f64)
    kw = dict(tile=nb, round_k=nb, band_blocks=t, hi=f64, lo=f32, accum=f32)
    out = syrk_ops.mp_syrk(pm, **kw)
    want = syrk_ref.mp_syrk(pm, **kw)
    brel, orel, mx, fp32_off = _syrk64_errors(out, want, tile=nb, band=t)
    sym = bool(torch.equal(out, out.T))
    require(brel <= 1e-11 and orel <= 1e-5 and fp32_off and sym,
            f"mp_syrk fp64 tile step 0: {brel} {orel} {fp32_off} {sym}")
    del out, want
    torch.cuda.empty_cache()
    # no trace of the call here: late in a run, three traces that held
    # only this library's launches came back without device events
    # (device_profile); phase 3 traces the same kernels at the panel's step
    # 0, and 9.1's profiled evaluation at every step of this path
    nums = syrk64_numbers(pm, nb, t, per_kernel=False)
    emit(phase="paper", step="kernel", kernel="mp_syrk", hi=str(f64),
         lo=str(f32), m=(p - 1) * nb, k=nb, band=t, inband_rel=brel,
         offband_rel=orel, max_abs_err=mx, symmetric=sym,
         plain_ms=time_ms(lambda: syrk_ref.mp_syrk(pm, **kw), reps=3), **nums)
    del pm
    theta = list(MEDIUM)
    row = None
    for what, la in (("Sigma", locs), ("Sigma_no", locs_new)):
        out = mc_ops.matern_cov(la, locs, theta, nu=0.5, out_dtype=f64)
        require(out.dtype == f64, f"matern_cov {what}: {out.dtype}")
        err = 0.0
        for r0 in range(0, la.shape[0], 2048):
            w = mc_ref.matern_cov(la[r0:r0 + 2048], locs, theta, nu=0.5,
                                  out_dtype=f64)
            err = max(err, float((out[r0:r0 + 2048] - w).abs().max()))
        require(err <= 1e-12 * theta[0], f"matern_cov fp64 {what}: {err}")
        del w
        sym = _sigma_forms(out, la, locs, theta, f64) if la is locs else {}
        del out
        elems = la.shape[0] * n
        bytes_moved = (la.shape[0] + n) * 16 + 8 * elems
        by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S, 9 * elems / FP64_FLOPS
        line = dict(shape=[la.shape[0], n], max_abs_err=err,
                    tol=1e-12 * theta[0],
                    ms=time_ms(lambda: mc_ops.matern_cov(la, locs, theta, nu=0.5,
                                                         out_dtype=f64)),
                    plain_ms=time_ms(lambda: mc_ref.matern_cov(
                        la, locs, theta, nu=0.5, out_dtype=f64), reps=2),
                    bound_ms=1e3 * max(by_bytes, by_ops),
                    bound_by="bytes" if by_bytes >= by_ops else "operations")
        row = row or line  # the row of the kernels line: Sigma
        emit(phase="paper", step="kernel", kernel="matern_cov", what=what,
             dtype=str(f64), **line, **sym)
        torch.cuda.empty_cache()
    res = results.setdefault("matern_cov_fp64", {})
    res.update(
        name="matern_cov (fp64)", route="cuda",
        source="src/repro_torch/csrc/matern_cov.cu",
        replaces="src/repro/kernels/matern_cov/matern_cov.py:44",
        max_abs_err=max(row["max_abs_err"], res.get("max_abs_err", 0.0)),
        ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None)


def paper(fcfg, results):
    """Phase 9: the paper pair on an fp64 medium field at n_obs locations
    in nb-tiles (see the module docstring), sub-steps timed into one line."""
    import torch
    t_all = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(16)
    locs, z, locs_new, z_new = _paper_data(gen, fcfg)
    torch.cuda.empty_cache()
    emit(phase="paper", step="data", n_all=fcfg["n_all"], n_obs=fcfg["n_obs"],
         sites=int(locs_new.shape[0]), nb=fcfg["nb"],
         p=fcfg["n_obs"] // fcfg["nb"], theta0=MEDIUM, dtype=str(locs.dtype),
         seconds=time.perf_counter() - t_all)
    secs = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    total = {"matern_cov": 0, "blocked_potrf": 0, "mp_syrk": 0}
    step("9.1 evaluations", paper_evaluations, locs, z, fcfg, total)
    require(total["mp_syrk"] > 0 and total["matern_cov"] > 0,
            f"the paper pair launched {total}")
    results.setdefault("mp_syrk_fp64", {})["launches_paper"] = total["mp_syrk"]
    results.setdefault("matern_cov_fp64", {})["launches_paper"] = total["matern_cov"]
    if fcfg["estimate"]:
        fits = step("9.2 estimation", paper_estimation, locs, z, fcfg)
        step("9.3 prediction", paper_prediction, locs, z, locs_new, z_new,
             fits, fcfg)
    step("9.4 kernels", paper_kernels, locs, locs_new, fcfg, results)
    emit(phase="paper", step="seconds", **secs)
    return locs, z


# ---------------------------------------------------------------------------
# phase 10: the gradient path (fit_mle_adam through matern_cov's backward)
# ---------------------------------------------------------------------------

def grad_bound(rows, cols, dtype):
    """(bound ms, bound_by) of one matern_cov_grad call on a (rows, cols) G:
    G and the locations read once (bytes), against 16 operations per
    element in the locations' precision (the forward's 9, the derivative's
    at most 5, two conversions) and 4 fp64 flops (two multiply-adds)."""
    import torch
    size = torch.finfo(dtype).bits // 8
    elems = rows * cols
    by_bytes = (elems + 2 * (rows + cols)) * size / HBM_BYTES_PER_S
    peak = FP32_FLOPS if dtype == torch.float32 else FP64_FLOPS
    by_ops = 16 * elems / peak + 4 * elems / FP64_FLOPS
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def check_matern_grad(fields, gcfg, results):
    """10.0: matern_cov_grad against its plain version on the card, fp32 and
    fp64 at every nu, on a (check_n, check_n) G and on the fidelity path's
    Sigma (phase 8's weak field in fp32, phase 9's field in fp64), G drawn
    from a seed.  Each sum's error is held against its scale, sum |G|
    dK/dtheta_k (the plain version on |G|), and a second launch must give
    the same bits; the kernel is timed with CUDA events at every nu on the
    large G, the plain version at nu = 0.5.  The calls pass one location
    tensor twice: the symmetric form.  The general form (the locations as a
    copy) is held to the same tolerance against the plain version and
    against the symmetric form, and timed beside it on the large G."""
    import torch
    from repro_torch.kernels.matern_cov import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(10)
    for dtype, locs, theta in fields:
        worst, main = 0.0, None
        tol = GRAD_KERNEL_TOL[str(dtype)]
        for n in (gcfg["check_n"], locs.shape[0]):
            la = locs[:n].contiguous()
            copy = la.clone()
            g = torch.randn((n, n), generator=gen, device="cuda", dtype=dtype)
            for nu in (0.5, 1.5, 2.5):
                got = ops.matern_cov_grad(la, la, theta, g, nu=nu)
                # no float atomics: the same bits from run to run
                require(torch.equal(got, ops.matern_cov_grad(la, la, theta, g,
                                                             nu=nu)),
                        f"matern_cov_grad {dtype} n={n} nu={nu}: two runs differ")
                want = ref.matern_cov_grad(la, la, theta, g, nu=nu)
                scale = ref.matern_cov_grad(la, la, theta, g.abs(), nu=nu)
                err = (got.double() - want.double()).abs()
                ratio = float((err / scale.double()).max())
                require(got.dtype == dtype and ratio <= tol,
                        f"matern_cov_grad {dtype} n={n} nu={nu}: {got.tolist()} "
                        f"vs {want.tolist()}, {ratio} of the scale > {tol}")
                general = ops.matern_cov_grad(la, copy, theta, g, nu=nu)
                gen_ratio = float(((general.double() - want.double()).abs()
                                   / scale.double()).max())
                sym_ratio = float(((got.double() - general.double()).abs()
                                   / scale.double()).max())
                require(max(gen_ratio, sym_ratio) <= tol,
                        f"matern_cov_grad {dtype} n={n} nu={nu}: general "
                        f"{general.tolist()}, {gen_ratio} of the scale from the "
                        f"plain version, {sym_ratio} from the symmetric form")
                worst = max(worst, float(err.max()))
                line = dict(n=n, nu=nu, dtype=str(dtype), grad=got.tolist(),
                            grad_plain=want.tolist(), scale=scale.tolist(),
                            max_abs_err=float(err.max()), err_over_scale=ratio,
                            tol=tol, general_err_over_scale=gen_ratio,
                            symmetric_vs_general_over_scale=sym_ratio)
                if n == locs.shape[0]:
                    line["ms"] = time_ms(lambda: ops.matern_cov_grad(
                        la, la, theta, g, nu=nu))
                    line["ms_general"] = time_ms(lambda: ops.matern_cov_grad(
                        la, copy, theta, g, nu=nu))
                    line["bound_ms"], line["bound_by"] = grad_bound(n, n, dtype)
                    if nu == 0.5:
                        line["plain_ms"] = time_ms(lambda: ref.matern_cov_grad(
                            la, la, theta, g, nu=nu), reps=2)
                        main = line
                emit(phase="gradient", step="kernel", kernel="matern_cov_grad",
                     **line)
            del g, copy
            torch.cuda.empty_cache()
        key = "matern_cov_grad" + ("" if dtype == torch.float32 else "_fp64")
        results.setdefault(key, {}).update(
            name="matern_cov_grad" + ("" if dtype == torch.float32 else " (fp64)"),
            route="cuda", source="src/repro_torch/csrc/matern_cov.cu",
            replaces="src/repro/kernels/matern_cov/matern_cov.py:44",
            max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=None)


def _value_and_grad(fn, theta):
    """ll and its gradient in a host fp32 theta, as fit_mle_adam takes them:
    (ll, grad list, forward s, backward s, peak GiB, launch counts)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    th = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    t0 = time.perf_counter()
    ll = fn(th)
    value = float(ll.detach())  # waits for the device
    t1 = time.perf_counter()
    (g,) = torch.autograd.grad(ll, th)  # a host tensor: waits
    t2 = time.perf_counter()
    return (value, g.tolist(), t1 - t0, t2 - t1,
            torch.cuda.max_memory_allocated() / 2 ** 30, launch_counts())


def gradient_evaluation(label, locs, z, theta, results, key):
    """10.1: one value-and-gradient evaluation of dense full(locations'
    dtype) at theta through the kernels and through the plain versions:
    launch counts (matern_cov and matern_cov_grad once each), the kernel
    path's log-likelihood equal to the no-grad evaluation's bit for bit,
    gradients kernel against plain, seconds forward and backward, peak, and
    the kernel path under the profiler (matern_cov_grad_kernel once)."""
    import torch
    from repro_torch.core import PrecisionPolicy, make_loglik
    pol = PrecisionPolicy.full(locs.dtype)
    expected = {"matern_cov": 1, "matern_cov_grad": 1, "blocked_potrf": 0,
                "mp_syrk": 0, "mp_attention": 0}
    out = {}
    for impl in ("kernel", "plain"):
        fn = make_loglik(locs, z, pol, nu_static=0.5, impl=impl)
        out[impl] = _value_and_grad(fn, theta)
    (a, ga, fa, ba, pa, ca), (b, gb, fb, bb, pb, cb) = out["kernel"], out["plain"]
    require(ca == expected, f"{label}: launches {ca}, expected {expected}")
    require(sum(cb.values()) == 0, f"{label}: plain path launched {cb}")
    fn = make_loglik(locs, z, pol, nu_static=0.5)
    with torch.no_grad():  # the same fp32 theta, no autograd
        no_grad = float(fn(torch.tensor(theta, dtype=torch.float32)))
    require(a == no_grad, f"{label}: ll {a} with grad, {no_grad} without")
    tol = GRAD_EVAL_TOL[str(locs.dtype)]
    scale = max(abs(v) for v in gb)
    err = max(abs(x - y) for x, y in zip(ga, gb)) / scale
    require(math.isfinite(a) and all(map(math.isfinite, ga)) and ga[2] == 0.0
            and abs(a - b) <= tol * abs(b) and err <= tol,
            f"{label}: kernel {a} {ga} vs plain {b} {gb}")
    wall_ms, busy, rows = device_profile(lambda: _value_and_grad(fn, theta))
    grad_rows = [(k, c, ms) for k, c, ms in rows if "matern_cov_grad_kernel" in k]
    require(sum(c for _, c, _ in grad_rows) == 1,
            f"{label}: matern_cov_grad_kernel launched {grad_rows} in one evaluation")
    emit(phase="gradient", step="evaluation", policy=label, n=locs.shape[0],
         theta=list(theta), loglik_kernel=a, loglik_plain=b,
         loglik_no_grad=no_grad, grad_kernel=ga, grad_plain=gb,
         grad_err_over_max=err, tol=tol, seconds_forward_kernel=fa,
         seconds_backward_kernel=ba, seconds_forward_plain=fb,
         seconds_backward_plain=bb, peak_gib_kernel=pa, peak_gib_plain=pb,
         launches_kernel=ca, wall_ms=wall_ms, device_busy_ms=busy,
         idle_share=1 - busy / wall_ms,
         matern_cov_grad_device_ms=sum(ms for _, _, ms in grad_rows),
         top=[{"name": k[:90], "count": c, "ms": ms} for k, c, ms in rows[:10]])
    results.setdefault(key, {})["launches"] = ca["matern_cov_grad"]
    return fa + ba, pa


def fp64_grad_n(n_obs, peak32, limit):
    """The largest multiple of 1,024, at most n_obs, whose full(fp64)
    value-and-gradient evaluation is predicted to peak under `limit` GiB:
    twice the fp32 evaluation's peak at n_obs (the same tensors in twice the
    bytes), scaled by n^2."""
    if 2 * peak32 <= limit:
        return n_obs
    return int(n_obs * math.sqrt(limit / (2 * peak32)) // 1024 * 1024)


def gradient_adam(gcfg, locs, z, t_eval):
    """10.2: fit_mle_adam on dense full(fp32) as the reference's test runs
    it (120 steps at lr 0.05 from 0.8 theta0) at n = adam_n on phase 6's
    field, against fit_mle on the same likelihood (theta2-hat within rel
    0.1); then Adam at n_obs on phase 8's weak field for as many steps as
    fit in adam_seconds (t_eval: 10.1's seconds per evaluation), with the
    log-likelihood of every step."""
    import torch
    from repro_torch.core import (PrecisionPolicy, fit_mle, fit_mle_adam,
                                  make_loglik)
    from repro_torch.covariance import make_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    pol = PrecisionPolicy.full(torch.float32)
    nu = torch.tensor([0.5])
    gen = torch.Generator(device="cuda").manual_seed(1)  # phase 6's field
    ds = make_dataset(gen, gcfg["adam_n"], MEDIUM, nu_static=0.5)
    ll = make_loglik(ds.locs, ds.z, pol, nu_static=0.5)
    start = [0.8 * MEDIUM[0], 0.8 * MEDIUM[1]]
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fit_mle_adam(lambda th: ll(torch.cat([th, nu])), start,
                       steps=gcfg["adam_steps"], lr=gcfg["adam_lr"])
    adam_s = time.perf_counter() - t0
    counts = launch_counts()
    require(counts["matern_cov_grad"] == gcfg["adam_steps"]
            and counts["matern_cov"] == gcfg["adam_steps"] + 1,
            f"Adam launches {counts}")
    t0 = time.perf_counter()
    nm = fit_mle(lambda th: ll([th[0], th[1], 0.5]), start,
                 max_iters=gcfg["nm_iters"])
    nm_s = time.perf_counter() - t0
    rel = abs(float(res.theta[1]) - nm.theta[1]) / nm.theta[1]
    require(math.isfinite(res.loglik) and rel <= 0.1,
            f"Adam theta2 {res.theta[1]} vs Nelder-Mead {nm.theta[1]}: rel {rel}")
    emit(phase="gradient", step="adam", n=gcfg["adam_n"], start=start,
         steps=gcfg["adam_steps"], lr=gcfg["adam_lr"],
         theta_adam=res.theta.tolist(), loglik_adam=res.loglik,
         history=[(h[0].tolist(), h[1]) for h in res.history],
         seconds_adam=adam_s, seconds_per_step=adam_s / gcfg["adam_steps"],
         theta_nm=nm.theta.tolist(), loglik_nm=nm.loglik, nm_evals=nm.n_evals,
         seconds_nm=nm_s, theta2_rel_gap=rel, tol=0.1, launches_adam=counts)
    del ll, ds
    torch.cuda.empty_cache()
    # as many steps at n_obs as fit in adam_seconds: steps are cut, not n
    steps = max(1, int(gcfg["adam_seconds"] // t_eval))
    ll = make_loglik(locs, z, pol, nu_static=0.5)
    values = []

    def traced(th):
        v = ll(torch.cat([th, nu]))
        values.append(float(v.detach()))
        return v
    start = [0.8 * WEAK[0], 0.8 * WEAK[1]]
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fit_mle_adam(traced, start, steps=steps, lr=gcfg["adam_lr"])
    secs = time.perf_counter() - t0
    counts = launch_counts()
    # the reference's lr is sized for n = 256: at n_obs Adam's first steps
    # may cross the theta1 / theta2 ridge, so no climb is required here
    require(counts["matern_cov_grad"] == steps and all(map(math.isfinite, values)),
            f"Adam at n_obs: {counts} {values}")
    emit(phase="gradient", step="adam", n=locs.shape[0], start=start,
         steps=steps, lr=gcfg["adam_lr"], loglik_per_step=values[:steps],
         loglik_best=max(values), loglik_final=res.loglik,
         theta=res.theta.tolist(), seconds=secs,
         seconds_per_step=secs / steps,
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=counts)


def gradient_guard(locs, z):
    """10.3: the engines whose kernels have no backward raise on the card
    for a theta that requires grad, before any of those kernels runs."""
    import torch
    from repro_torch.core import PrecisionPolicy, geostat_loglik_step, make_loglik
    from repro_torch.kernels import launch_counts, reset_launch_counts
    n, nb, pol = 2_048, 256, PrecisionPolicy.tpu(2)
    th = torch.tensor(list(WEAK), requires_grad=True)
    calls = {
        "tile_cholesky (make_loglik, tpu(2))": lambda: make_loglik(
            locs[:n], z[:n], pol, nb=nb, nu_static=0.5)(th),
        "geostat_loglik_step (tpu(2))": lambda: geostat_loglik_step(
            locs[:n], z[:n], th, nb=nb, policy=pol, nu_static=0.5)}
    reset_launch_counts()
    for what, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            emit(phase="gradient", step="refused", what=what,
                 error=type(e).__name__, message=str(e)[:160])
        else:
            raise AssertionError(f"{what}: a theta that requires grad ran")
    counts = launch_counts()
    require(counts["blocked_potrf"] == counts["mp_syrk"]
            == counts["matern_cov_grad"] == 0, f"guard launches {counts}")


def gradient(gcfg, weak, fp64_field, results):
    """Phase 10: the gradient path on the card (see the module docstring),
    sub-steps timed into one phase line."""
    import torch
    secs = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    (locs, z), (locs64, z64) = weak, fp64_field
    step("10.0 kernel", check_matern_grad,
         [(torch.float32, locs, list(WEAK[:2])),
          (torch.float64, locs64, list(MEDIUM[:2]))], gcfg, results)
    t_eval, peak32 = step("10.1 full(fp32)", gradient_evaluation, "full(fp32)",
                          locs, z, WEAK, results, "matern_cov_grad")
    n64 = fp64_grad_n(locs64.shape[0], peak32, gcfg["peak_gib"])
    emit(phase="gradient", step="fp64 size", n_obs=locs64.shape[0], n=n64,
         peak_gib_fp32=peak32, predicted_peak_gib_fp64=2 * peak32 * (
             n64 / locs64.shape[0]) ** 2, limit_gib=gcfg["peak_gib"])
    _, peak64 = step("10.1 full(fp64)", gradient_evaluation, "full(fp64)",
                     locs64[:n64].contiguous(), z64[:n64].contiguous(), MEDIUM,
                     results, "matern_cov_grad_fp64")
    require(peak64 <= gcfg["peak_gib"] + 1, f"full(fp64) peak {peak64} GiB")
    step("10.2 Adam", gradient_adam, gcfg, locs, z, t_eval)
    step("10.3 guard", gradient_guard, locs, z)
    emit(phase="gradient", step="seconds", **secs)


# ---------------------------------------------------------------------------
# --e2e-ab: two versions of the port, end to end, in one run on one card
# ---------------------------------------------------------------------------

E2E_REPS = 3  # timed evaluations of each, after one warm-up


def _median_seconds(fn, reps=E2E_REPS):
    """Median host seconds of fn() ending in a device sync, after a warm-up."""
    import torch
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out), out


def e2e_times(src):
    """--e2e-src: the main evaluations of phases 4, 8.1, 9.1 and 10.1 through
    the port under `src` (a checkout's src/ directory), each from the same
    seeds and shapes as its phase: geostat_loglik_step at n = 65,536 (tpu(8),
    theta0), DP(10%) on phase 8's weak field, paper_cpu DP(10%) on phase 9's
    fp64 medium field, and dense full(fp32)'s value and gradient on phase
    8's weak field.  One JSON line of median seconds per evaluation."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    import repro_torch
    from repro_torch.configs import GEOSTAT_CONFIGS
    from repro_torch.core import (PrecisionPolicy, geostat_loglik_step,
                                  make_loglik)
    from repro_torch.covariance import make_dataset
    from repro_torch.kernels import _build
    _build.library()
    cfg = GEOSTAT_CONFIGS["geostat_65k"]
    secs, runs = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    ds = make_dataset(gen, cfg.n, WEAK, nu_static=cfg.nu)
    th0 = [float(v) for v in ds.theta0.tolist()]
    pol = PrecisionPolicy.tpu(cfg.diag_thick)
    secs["4"], runs["4"] = _median_seconds(lambda: float(geostat_loglik_step(
        ds.locs, ds.z, th0, nb=cfg.nb, policy=pol, nu_static=cfg.nu,
        off_update=cfg.off_update)))
    del ds
    torch.cuda.empty_cache()
    fcfg = FIDELITY
    gen = torch.Generator(device="cuda").manual_seed(11)
    medium = _fidelity_data(gen, MEDIUM, fcfg)  # drawn first, as in phase 8
    locs, z, _, _ = _fidelity_data(gen, WEAK, fcfg)
    del medium
    torch.cuda.empty_cache()
    p = fcfg["n_obs"] // fcfg["nb"]
    fn = make_loglik(locs, z, PrecisionPolicy.from_dp_percent(p, 0.10),
                     nb=fcfg["nb"], nu_static=0.5)
    secs["8.1"], runs["8.1"] = _median_seconds(lambda: float(fn(list(WEAK))))
    fn = make_loglik(locs, z, PrecisionPolicy.full(torch.float32), nu_static=0.5)

    def value_and_grad():
        th = torch.tensor(WEAK, dtype=torch.float32, requires_grad=True)
        torch.autograd.grad(fn(th), th)
    secs["10.1"], runs["10.1"] = _median_seconds(value_and_grad)
    del fn, locs, z
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(16)
    locs, z, _, _ = _paper_data(gen, PAPER)
    p = PAPER["n_obs"] // PAPER["nb"]
    fn = make_loglik(locs, z, PrecisionPolicy.from_dp_percent(p, 0.10, "paper_cpu"),
                     nb=PAPER["nb"], nu_static=0.5)
    secs["9.1"], runs["9.1"] = _median_seconds(lambda: float(fn(list(MEDIUM))))
    emit(phase="e2e", src=str(Path(repro_torch.__file__).parents[1]),
         library=str(_build.build()), seconds=secs, runs=runs)


def e2e_ab(other):
    """--e2e-ab: e2e_times of the checkout at `other` and of this one in
    turns (other, this, this, other), each in a process of its own, on one
    card; each phase's seconds per evaluation beside the spread of each
    version's two processes."""
    order = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    lines = []
    for label, root in order:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--e2e-src",
             str(Path(root) / "src")], check=True, capture_output=True, text=True,
            timeout=900).stdout
        line = json.loads([x for x in out.splitlines() if '"e2e"' in x][-1])
        line["version"] = label
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {}
    for ph in lines[0]["seconds"]:
        by = {v: [ln["seconds"][ph] for ln in lines if ln["version"] == v]
              for v in ("other", "this")}
        spread = max(abs(a - b) / min(a, b) for a, b in by.values())
        summary[ph] = dict(other=by["other"], this=by["this"],
                           this_over_other=statistics.mean(by["this"])
                           / statistics.mean(by["other"]),
                           spread=spread)
    emit(phase="e2e_ab", other=str(other), summary=summary)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="small main-path and serving shapes, no MLE: a "
                    "build-and-check run")
    ap.add_argument("--e2e-ab", metavar="DIR",
                    help="only time phases 4, 8.1, 9.1 and 10.1's evaluations "
                    "through the checkout at DIR and this one, in turns")
    ap.add_argument("--e2e-src", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card only")
    if args.e2e_src:
        e2e_times(args.e2e_src)
        return
    if args.e2e_ab:
        print(smi_line(), flush=True)
        e2e_ab(Path(args.e2e_ab).resolve())
        print(smi_line(), flush=True)
        return
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
    usage = ptxas_usage(lib.parent / _build.LOG_NAME, SYRK_KERNELS)
    sass = sass_counts(lib, SYRK_KERNELS)
    emit(phase="build", seconds=time.perf_counter() - t0,
         library=str(lib.relative_to(ROOT)), ptxas=usage, sass=sass)
    paper_pair = [k for k in usage if k.startswith(("syrk_band_f64_dmma_kernel",
                                                    "syrk_offband_fp32_pipelined"))]
    require(len(paper_pair) == 4 and all(usage[k]["spill_stores"] == 0
                                         for k in paper_pair),
            f"the paper pair's mp_syrk kernels: {paper_pair} spill or are missing")
    dmma = {k: v for k, v in sass.items() if k.startswith("syrk_band_f64_dmma_kernel")}
    require(len(dmma) == 2 and all(v["DMMA"] > 0 and v["DFMA"] == 0 for v in dmma.values()),
            f"the fp64 band kernel is not on the fp64 tensor cores: {dmma}")
    # matern_cov: 4 dtype pairs x 3 nu, general and symmetric; the backward
    # 2 dtypes x 3 nu x (general, symmetric)
    musage = ptxas_usage(lib.parent / _build.LOG_NAME, MATERN_KERNELS, typed=True)
    msass = sass_counts(lib, MATERN_KERNELS, MATERN_SASS_OPS, typed=True)
    emit(phase="build", kernel="matern_cov", ptxas=musage, sass=msass)
    require(len(musage) == len(msass) == 36,
            f"matern_cov kernels: {len(musage)} in ptxas, {len(msass)} in SASS")

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

    results, seconds = {}, {}

    def timed(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t0
        return out


    p = cfg["n"] // cfg["nb"]
    locs_t = ds.locs.reshape(p, cfg["nb"], 2)
    timed("3 matern_cov", check_matern, locs_t, ds.theta0.tolist(), cfg["t"],
          cfg["nu"], results)
    timed("3 matern_cov fp64", check_matern_fp64, locs_t,
          [float(v) for v in ds.theta0.tolist()], cfg["t"], results)
    torch.cuda.empty_cache()
    timed("3 blocked_potrf", check_potrf, gen, cfg["nb"], results)
    timed("3 mp_syrk", check_syrk, gen, cfg["n"] - cfg["nb"], cfg["nb"],
          cfg["t"], results)
    timed("3 mp_syrk fp64", check_syrk_fp64, gen, cfg["n"] - cfg["nb"],
          cfg["nb"], cfg["t"], results)
    torch.cuda.empty_cache()
    timed("3b mp_attention", check_attention, gen, results)
    torch.cuda.empty_cache()

    timed("4 main path", main_path, ds, cfg, results)
    torch.cuda.empty_cache()
    timed("4 paper pair", main_path_paper, ds, cfg, results)
    del ds, locs_t
    torch.cuda.empty_cache()
    timed("5 likelihood vs CPU", small_vs_cpu)
    timed("5 SMOKE LM vs CPU", smoke_lm_vs_cpu)
    if not args.quick:
        timed("6 MLE", mle)
    timed("7 serving", serving, SERVE_QUICK if args.quick else SERVE, results)
    torch.cuda.empty_cache()
    weak = timed("8 fidelity", fidelity,
                 FIDELITY_QUICK if args.quick else FIDELITY, results)
    torch.cuda.empty_cache()
    fp64_field = timed("9 paper pair", paper,
                       PAPER_QUICK if args.quick else PAPER, results)
    torch.cuda.empty_cache()
    timed("10 gradient", gradient, GRAD_QUICK if args.quick else GRAD, weak,
          fp64_field, results)
    emit(phase="seconds", **seconds)

    print(smi_line(), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + ("launches_fidelity", "launches_paper")
         if k in r}
        for r in results.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
