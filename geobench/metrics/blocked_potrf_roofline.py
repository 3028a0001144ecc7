"""blocked_potrf_roofline (%): the diagonal tiles' factor launches against
their least time (counts/blocked_potrf.py); none where the band is fp64
(cuSOLVER factors those tiles)."""

from geobench.counts import blocked_potrf
from geobench.metrics import roofline

# csrc/blocked_potrf.cu: one block per tile, or the cooperative grid form
KERNELS = ("blocked_potrf_kernel", "potrf_grid_kernel")


def read(run):
    return roofline(run, KERNELS, blocked_potrf.least_seconds(run.config))
