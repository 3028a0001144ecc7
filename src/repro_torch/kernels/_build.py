"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source is compiled by its own `nvcc` process (all started
together) for `sm_90a` into an object file, and the objects are linked into
one shared library with a plain C interface, loaded with `ctypes`.  The
library links libcuda (`-lcuda`) for `cuTensorMapEncodeTiled`.  The
library goes to `build/repro_torch_kernels/<hash>/` at the repository root,
keyed by a hash of the sources and flags, so a changed source is rebuilt
and an unchanged one is loaded as it is.  The compilers' output, with
`ptxas -v`'s registers, shared memory and spills of every kernel, is kept
beside it in `nvcc.log`.

Nothing here runs when the module is imported: the first kernel launch
calls `library()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"
LOG_NAME = "nvcc.log"   # the compilers' output (ptxas -v) beside the library

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double

# C entry points: name -> argtypes.  Each returns cudaGetLastError().
SIGNATURES = {
    # locs_i, locs_j, out, plan, n_pairs, n_cols_j, rows, cols,
    # out_tile_stride, th1, th2, two_nu, dtypes, sym, stream
    "matern_cov_launch": [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong,
                          _D, _D, _I, _I, _I, _P],
    # locs_a, locs_b, grad, partials, n_partials, out, rows, cols, th1, th2,
    # two_nu, fp64, sym, stream
    "matern_cov_grad_launch": [_P, _P, _P, _P, ctypes.c_longlong, _P, _I, _I,
                               _D, _D, _I, _I, _I, _P],
    # a, out, info, batch, nb, max_blocks, stream
    "blocked_potrf_launch": [_P, _P, _P, _I, _I, _I, _P],
    # p, scratch, out, m, kdim, tile, round_k, band_blocks, pair, bm,
    # stream
    "mp_syrk_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # g, p, dp, scratch, scratch_bytes, m, kdim, tile, band_blocks, pair,
    # stream
    "mp_syrk_grad_launch": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I,
                            _I, _I, _P],
    # q, k, v, scales, seg_len, acc, m, l, ws_acc, ws_m, ws_l, batch, g, d,
    # s, blk, chunk, sm_scale, q_bf16, kv_dtype, stream
    "mp_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _I, _I, _F, _I, _I, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources (if not built yet) and return the library path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed, logs = [], []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"[nvcc {src.name}]\n{log}")
            if verbose or proc.returncode:
                print(logs[-1], file=sys.stderr, flush=True)
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        (out_dir / LOG_NAME).write_text("\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
                        *(str(obj) for _, obj, _ in procs), "-lcudart",
                        "-lcuda"],
                       check=True)
        os.replace(tmp_lib, lib)  # atomic: a reader never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")
