"""Hand-written CUDA kernels for the H100 and their plain PyTorch versions.

Each kernel package keeps the reference's layout:
  <name>.py -- the CUDA kernel's launch wrapper (sources in `csrc/`);
  ref.py    -- the plain PyTorch version of the same function;
  ops.py    -- the public function: on a CPU tensor it runs ref.py, on a
               CUDA tensor it launches the kernel or raises.

`LAUNCHES` counts the kernel launches of each wrapper (`count_launch`,
under a lock: the task runtime launches from several threads); a run sets
the counts to 0 (`reset_launch_counts`) and reads them afterwards to show
that it went through the kernels.
"""

import threading

LAUNCHES = {"matern_cov": 0, "matern_cov_grad": 0, "blocked_potrf": 0,
            "mp_syrk": 0, "mp_syrk_grad": 0, "mp_attention": 0}


_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
