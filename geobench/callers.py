"""The one general generator of the benchmark's traffic: it reads a mix's
parameters from traffic/<name>.json and draws from the seed what the
caller sends.

A mix's keys:
  caller      "closed": one caller, the next request sent only after the
              last answer reached the host (a Nelder-Mead or gradient fit's
              loop);
  entry       "value": l(theta), as the program's entry (program.py) gives
              it;
  theta_box   per leading component of theta, the [low, high] factors of
              theta0's that a request's theta is drawn from, uniform and
              independent; the other components stay theta0's;
  theta_dtype the dtype every theta is rounded to before either side sees
              it ("float32": the program's and the reference's theta are
              the same numbers);
  check_sample  how many answers of the window, drawn from the seed, the
              reference recomputes.
"""

from __future__ import annotations

import numpy as np

MAX_REQUESTS = 4096   # thetas drawn per run; a window sends far fewer


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def thetas(mix: dict, theta0, seed: int, count: int = MAX_REQUESTS):
    """The requests' thetas in the order they are sent (lists of floats)."""
    theta0 = np.asarray(theta0, dtype=np.float64)
    box = np.asarray(mix["theta_box"], dtype=np.float64)
    factors = _rng(seed, 0).uniform(box[:, 0], box[:, 1],
                                    size=(count, len(box)))
    th = np.tile(theta0, (count, 1))
    th[:, :len(box)] *= factors
    th = th.astype(np.dtype(mix["theta_dtype"])).astype(np.float64)
    return th.tolist()


def check_sample(mix: dict, seed: int, answered: int) -> list[int]:
    """Indices of the answers the reference recomputes, drawn from the
    seed among the `answered` of the window, ascending."""
    k = min(int(mix["check_sample"]), answered)
    return sorted(int(i) for i in _rng(seed, 1).choice(answered, size=k,
                                                        replace=False))
