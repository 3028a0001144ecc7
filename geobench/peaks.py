"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full 700 W power limit): operations per second by the precision an
operation runs in, and HBM bytes per second."""

FLOPS = {
    "float32": 67e12,    # IEEE fp32 on the CUDA cores (TF32 off)
    "tfloat32": 495e12,  # TF32 on the tensor cores
    "bfloat16": 989e12,  # bf16 on the tensor cores, fp32 sums
    "float64": 67e12,    # fp64 on the tensor cores (DMMA)
    "float64_simt": 34e12,  # fp64 FMA outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12

BYTES = {"float32": 4, "bfloat16": 2, "float64": 8}


def least_seconds(ops: dict, nbytes: float) -> float:
    """The least time of one launch: its operations at the peak of the
    precision of each (classes on separate units run at once, so the
    slowest class) against its bytes at the HBM rate."""
    by_ops = max((f / FLOPS[d] for d, f in ops.items() if f), default=0.0)
    return max(by_ops, nbytes / HBM_BYTES_PER_S)
