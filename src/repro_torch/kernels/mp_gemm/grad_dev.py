"""mp_syrk_grad on the card without the rest of chip_smoke.py: the quick
call after a change to the backward's kernels (csrc/mp_syrk.cu).

    python -m repro_torch.kernels.mp_gemm.grad_dev kernels   # ~90 s
    python -m repro_torch.kernels.mp_gemm.grad_dev 10.3      # ~3 minutes

`kernels`: the build's ptxas and SASS facts of every mp_syrk_grad kernel,
then mp_syrk_grad against its plain version for the four pairs at small
shapes (every block shape of its engines, several bands), at 4,096 rows
and at the tile path's step 0 (39,936 x 1,024, band 2), one JSON line a
case: chip_smoke.syrk_grad_err, the same bits on a second launch and with
dU's upper tiles zeroed, the band alone and its band-in-lo control, and at
step 0 the CUDA-event time, each kernel's device time under the profiler,
the rate, the bound and the memory the call adds.  Each group of shapes
runs in a process of its own under a time limit, so a kernel that hangs
ends its process and not the call.
`10.3`: chip_smoke.py's phase 10.3 (a)-(c) alone, on phase 8's weak field
and phase 9's fp64 field made as those phases make them.

Both use chip_smoke.py's own checks, loaded from the checkout's root.  On
a CUDA device only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[4]
# (m, tile, kdim, bands) of `kernels`, by group
SHAPES = {"small": ((640, 64, 192, (1, 2, 3, 10)), (768, 192, 320, (1, 2)),
                    (1_280, 128, 128, (1, 3)), (4_096, 1_024, 1_024, (1, 2, 4))),
          "step0": ((39_936, 1_024, 1_024, (2,)),)}
N64 = 38_912   # phase 10.1's fp64 n_obs at 40,960 (its 70 GiB cut)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_case(cs, m, tile, kdim, t, pair, gen, timed):
    """One `kernels` case: a dict of what it measured (`error` if it
    raised)."""
    import torch
    from . import ops, ref
    hi, lo, accum = pair
    kw = dict(tile=tile, band_blocks=t, hi=hi, lo=lo, accum=accum)
    line = dict(m=m, tile=tile, kdim=kdim, band=t, pair=[str(d) for d in pair])
    p = torch.randn((m, kdim), generator=gen, device="cuda", dtype=hi)
    g = torch.randn((m, m), generator=gen, device="cuda", dtype=hi)
    got = ops.mp_syrk_grad(g, p, **kw)
    line["same_bits"] = bool(torch.equal(got, ops.mp_syrk_grad(g, p, **kw)))
    lower = torch.arange(m, device="cuda") // tile
    g_low = torch.where(lower[:, None] >= lower[None, :], g, 0)
    line["upper_ignored"] = bool(torch.equal(got, ops.mp_syrk_grad(g_low, p, **kw)))
    del g_low
    want = ref.mp_syrk_grad(g, p, **kw)
    line["err_over_tol"], line["max_abs"] = cs.syrk_grad_err(got, want, g, p,
                                                             tile, t, pair)
    del got, want
    if timed:
        call = lambda: ops.mp_syrk_grad(g, p, **kw)  # noqa: E731
        line["ms"] = cs.time_ms(call, reps=3)
        _, line["busy_ms"], rows = cs.device_profile(lambda: call().sum())
        line["device_ms"] = {k[:70]: ms for k, _, ms in rows
                             if cs.syrk_grad_class(k)}
        n_t = m // tile
        band_f, off_f = cs.syrk_grad_flops(n_t, tile, n_t if lo == hi else t)
        line["tflops"] = (band_f + off_f) / line["ms"] / 1e9
        line["bound_ms"] = cs.syrk_grad_bound(n_t, tile, t, pair)[0]
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        call()
        line["extra_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    g = cs.band_only(g, tile, t)
    want = ref.mp_syrk_grad(g, p, **kw)
    line["band_only"], _ = cs.syrk_grad_err(ops.mp_syrk_grad(g, p, **kw), want,
                                            g, p, tile, t, pair)
    if lo != hi:
        lo_band = ref.mp_syrk_grad(g, p, **dict(kw, band_blocks=0))
        line["control"], _ = cs.syrk_grad_err(lo_band, want, g, p, tile, t,
                                              pair)
    line["ok"] = (line["same_bits"] and line["upper_ignored"]
                  and line["err_over_tol"] <= 1 and line["band_only"] <= 1
                  and line.get("control", 2) > 1)
    return line


def kernels_group(group):
    """The cases of one group of SHAPES; True if every one passed."""
    import torch
    from .mp_gemm import PAIRS
    cs = chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(20)
    ok = True
    for m, tile, kdim, bands in SHAPES[group]:
        for pair in PAIRS:
            for t in bands:
                try:
                    line = check_case(cs, m, tile, kdim, t, pair, gen,
                                      timed=group == "step0")
                except Exception:  # noqa: BLE001 -- reported, the run goes on
                    line = dict(m=m, tile=tile, kdim=kdim, band=t,
                                pair=[str(d) for d in pair], ok=False,
                                error=traceback.format_exc()[-1500:])
                ok &= line["ok"]
                cs.emit(**line)
                torch.cuda.empty_cache()
    return ok


def phase_10_3():
    """chip_smoke.py's phase 10.3 (a)-(c) on phases 8's and 9's fields."""
    import torch
    cs = chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(11)  # phase 8's order
    cs._fidelity_data(gen, cs.MEDIUM, cs.FIDELITY)
    weak = cs._fidelity_data(gen, cs.WEAK, cs.FIDELITY)[:2]
    gen = torch.Generator(device="cuda").manual_seed(16)  # phase 9's
    fp64 = cs._paper_data(gen, cs.PAPER)[:2]
    torch.cuda.empty_cache()
    results, secs = {}, {}
    for name, fn, args in (
            ("10.3a", cs.check_syrk_grad, (cs.GRAD, results)),
            ("10.3b", cs.tile_gradient, (cs.GRAD, weak, fp64, N64, results)),
            ("10.3c", cs.tile_grad_adam, (cs.GRAD,))):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
    cs.emit(phase="gradient", step="seconds", **secs)
    print(json.dumps({"kernels": list(results.values())}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("kernels", "10.3", "small", "step0"),
                    help="small and step0: one group of `kernels` (the "
                    "processes it starts)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("grad_dev: no CUDA device; it runs on the card only")
    if args.what in SHAPES:
        sys.exit(0 if kernels_group(args.what) else 1)
    from ...core.precision import require_ieee_fp32
    from .. import _build
    require_ieee_fp32()
    cs = chip_smoke()
    print(cs.smi_line(), flush=True)
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    cs.emit(phase="build", seconds=time.perf_counter() - t0)
    cs.check_syrk_grad_build(lib)
    if args.what == "10.3":
        phase_10_3()
    else:
        for group, limit in (("small", 240), ("step0", 400)):
            try:
                rc = subprocess.run([sys.executable, "-m", __spec__.name,
                                     group], timeout=limit).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
            cs.emit(stage=group, rc=rc)
            if rc:
                sys.exit(1)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main()
