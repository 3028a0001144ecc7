"""torch_ops_ms (ms): device milliseconds an evaluation spends in kernels
the port's CUDA library did not launch: cuBLAS and cuSOLVER (the TRSMs, an
fp64 band's POTRF, the solve), PyTorch's elementwise kernels (the
subtracts, casts, the Cholesky adjoint's products), copies and sets."""

from geobench.metrics import device_seconds

# every __global__ kernel of src/repro_torch/csrc/*.cu
LIBRARY = (
    "blocked_potrf_kernel", "potrf_grid_kernel",
    "matern_cov_kernel", "matern_cov_sym_kernel", "matern_cov_grad_kernel",
    "matern_grad_sum_kernel",
    "syrk_band_lower_kernel", "syrk_offband_bf16_wgmma_kernel",
    "to_bf16_kernel", "syrk_band_f64_dmma_kernel",
    "syrk_offband_fp32_pipelined_kernel", "to_fp32_kernel",
    "mp_syrk_grad_diag_kernel", "mp_syrk_grad_lo_tiles_kernel",
    "mp_syrk_grad_lo_p_kernel", "mp_syrk_grad_offband_wgmma_kernel",
    "mp_syrk_grad_fp32_kernel", "mp_syrk_grad_dmma_kernel",
    "flash_chunk_kernel", "combine_chunks_kernel",
)


def read(run):
    if run.trace is None or not run.answered:
        return None
    total = sum(row[1] for row in run.trace.kernels.values())
    if not total:
        return None
    return 1e3 * (total - device_seconds(run, LIBRARY)) / run.answered
