"""matern_cov_roofline (%): the covariance build's launches against their
least time (counts/matern_cov.py)."""

from geobench.counts import matern_cov
from geobench.metrics import roofline

# csrc/matern_cov.cu's forward kernels: the general and the symmetric form
KERNELS = ("matern_cov_kernel", "matern_cov_sym_kernel")


def read(run):
    return roofline(run, KERNELS, matern_cov.least_seconds(run.config))
