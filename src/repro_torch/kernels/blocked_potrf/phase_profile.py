"""Where the grid path of the tile POTRF kernel spends its time, per panel.

    python -m repro_torch.kernels.blocked_potrf.phase_profile [--nb 1024]

Builds a copy of csrc/blocked_potrf.cu with clock64() stamps taken by
thread 0 of block 0 at each phase boundary of the grid path, factors one
SPD nb x nb tile on the card, and prints one JSON line: SM cycles per
panel of the panel sweep (diagonal block and block 0's rows below it), the
write-back of the solved rows, the first grid barrier with the L11 write,
the trailing update and the second grid barrier, and their sums.  Block 0's
clock only: other blocks wait in the barriers for the slowest one.  Runs on
a CUDA device only; the kernel library itself is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from .._build import ARCH, BUILD_ROOT, CSRC, _nvcc
from .blocked_potrf import plan

PHASES = ("sweep", "write_back", "barrier_1_and_l11", "update", "barrier_2")
# (source line after which a stamp goes, stamp slot); slots 0..5 bound the
# five phases of a panel
ANCHORS = (
    ("      const int n_chunks = (m + P - 1) / P;  // 64-row chunks of the panel solve\n", 0),
    ("        const int bad = factor_panel(A, nb, nb, k0, w, r0, buf0, buf1, colbuf, &s_bad);\n", 1),
    ("        __syncthreads();  // buf1 is restaged by the block's next chunk\n", 2),
    ("      if (m > 0) grid.sync();\n", 3),
    ("      if (m <= 0) break;\n", 4),
)
UPDATE_END = "        update_tile(A, nb, nb, k0, ti, t - ti * (ti + 1) / 2, buf0, buf1);\n      }\n"
STAMP = ("if (blockIdx.x == 0 && threadIdx.x == 0) "
         "g_stamps[(k0 / P) * 8 + {slot}] = clock64();\n")


def instrumented_source() -> str:
    src = (CSRC / "blocked_potrf.cu").read_text()
    src = src.replace("namespace {\n", "__device__ long long g_stamps[2048];\nnamespace {\n", 1)
    for anchor, slot in ANCHORS + ((UPDATE_END, 5),):
        if anchor not in src:
            raise RuntimeError(f"phase_profile: anchor not in the source: {anchor!r}")
        src = src.replace(anchor, anchor + STAMP.format(slot=slot), 1)
    return src + ('\nextern "C" int read_stamps(void* host) {\n'
                  "  return cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n")


def build() -> ctypes.CDLL:
    out = BUILD_ROOT / "phase_profile"
    out.mkdir(parents=True, exist_ok=True)
    (out / "blocked_potrf_stamped.cu").write_text(instrumented_source())
    lib = out / "libblocked_potrf_stamped.so"
    subprocess.run([_nvcc(), *ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib), str(out / "blocked_potrf_stamped.cu")], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.blocked_potrf_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    dll.read_stamps.argtypes = [ctypes.c_void_p]
    return dll


def profile(nb: int = 1024, seed: int = 0) -> dict:
    """Cycles per panel and phase of one factorization of an SPD tile."""
    p = plan(nb)
    if not p["grid_path"]:
        raise ValueError(f"nb={nb} takes the one-block path, not the grid path")
    dll = build()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((nb, nb), generator=gen, device="cuda",
                                       dtype=torch.float64))
    a = ((q * torch.logspace(0.0, 2.0, nb, dtype=torch.float64, device="cuda"))
         @ q.T).float().contiguous()
    out = torch.empty_like(a)
    info = torch.empty((1,), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):  # the last run's stamps are read
        status = dll.blocked_potrf_launch(a.data_ptr(), out.data_ptr(), info.data_ptr(),
                                          1, nb, p["blocks"], stream)
        if status:
            raise RuntimeError(f"blocked_potrf_launch: CUDA error {status}")
    torch.cuda.synchronize()
    stamps = (ctypes.c_longlong * 2048)()
    if dll.read_stamps(stamps):
        raise RuntimeError("read_stamps failed")
    panels = []
    for k in range(len(p["panels"])):
        t = [stamps[8 * k + i] for i in range(6)]
        if k + 1 == len(p["panels"]):  # the last panel has no update
            panels.append([t[1] - t[0], t[2] - t[1], 0, 0, 0])
        else:
            panels.append([t[1] - t[0], t[2] - t[1], t[4] - t[2], t[5] - t[4],
                           stamps[8 * (k + 1)] - t[5]])
    totals = {name: sum(row[i] for row in panels) for i, name in enumerate(PHASES)}
    return dict(nb=nb, grid_blocks=p["blocks"], info=int(info.item()),
                device=torch.cuda.get_device_name(0), cycles_total=totals,
                cycles_all=sum(totals.values()),
                cycles_per_panel=[dict(zip(PHASES, row)) for row in panels])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nb", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("phase_profile: no CUDA device")
    result = profile(args.nb)
    result["smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
