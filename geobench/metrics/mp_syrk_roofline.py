"""mp_syrk_roofline (%): the trailing update's SYRK launches against their
least time (counts/mp_syrk.py)."""

from geobench.counts import mp_syrk
from geobench.metrics import roofline

# the kernels of one mp_syrk launch (csrc/mp_syrk.cu), as the profiler
# names them: the fp32 band and bf16 off-band of {fp32, bf16}, the fp64
# DMMA band and IEEE fp32 off-band of the paper pair, the passes writing P
# in lo
KERNELS = ("syrk_band_lower_kernel", "syrk_offband_bf16_wgmma_kernel",
           "to_bf16_kernel", "syrk_band_f64_dmma_kernel",
           "syrk_offband_fp32_pipelined_kernel", "to_fp32_kernel")


def read(run):
    return roofline(run, KERNELS, mp_syrk.least_seconds(run.config))
