"""Fault-tolerant training loop: checkpoint/restart, failure injection and
a straggler bound.

The port of `repro.runtime.fault_tolerance`.  A node loss restarts from the
latest checkpoint; a step slower than `step_timeout` counts as a failure
(re-dispatch); the counter-based data pipeline (data/pipeline.py) makes the
resumed stream exact.  One save is in flight at a time, the newest
`keep_last` checkpoints are kept, and the last step is saved synchronously.

`init_state` is the restart point until the first checkpoint lands, so the
train step must leave the state it is given as it was: the port's
`make_train_step` returns new tensors, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Callable, Optional

from ..checkpoint import checkpoint as ckpt


@dataclasses.dataclass
class LoopConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_steps: int = 200
    step_timeout: float = 600.0       # straggler bound (s)
    max_restarts: int = 3
    keep_last: int = 2


class FaultTolerantLoop:
    def __init__(self, lc: LoopConfig, train_step: Callable, source,
                 init_state, *, device=None,
                 failure_injector: Optional[Callable] = None):
        self.lc = lc
        self.train_step = train_step
        self.source = source
        self.init_state = init_state
        self.device = device
        self.failure_injector = failure_injector
        self.restarts = 0
        self.metrics_log = []

    def _resume_state(self):
        last = ckpt.latest_step(self.lc.ckpt_dir)
        if last is None:
            return self.init_state, 0
        state = ckpt.restore(self.lc.ckpt_dir, last, self.init_state,
                             device=self.device)
        return state, last

    def run(self):
        """Run to max_steps, surviving failures via restart."""
        while True:
            state, start = self._resume_state()
            try:
                return self._run_from(state, start)
            except RuntimeError as e:  # injected / real step failure
                self.restarts += 1
                if self.restarts > self.lc.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.lc.max_restarts}") from e
                # fall through: loop resumes from the latest checkpoint

    def _run_from(self, state, start_step: int):
        pending = None
        for step in range(start_step, self.lc.max_steps):
            if self.failure_injector is not None:
                self.failure_injector(step)
            batch = self.source.batch_at(step)
            t0 = time.monotonic()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])  # the step's device sync
            dt = time.monotonic() - t0
            if dt > self.lc.step_timeout:
                raise RuntimeError(f"straggler: step {step} took {dt:.1f}s")
            self.metrics_log.append({"step": step, "loss": loss, "time": dt})
            if (step + 1) % self.lc.ckpt_every == 0:
                if pending is not None:
                    pending.result()  # backpressure: one in flight
                pending = ckpt.save(self.lc.ckpt_dir, step + 1, state)
                self._gc(step + 1)
        if pending is not None:
            pending.result()
        ckpt.save(self.lc.ckpt_dir, self.lc.max_steps, state,
                  async_=False).result()
        return state

    def _gc(self, newest: int):
        if not os.path.isdir(self.lc.ckpt_dir):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.lc.ckpt_dir)
                       if d.startswith("step_"))
        for s in steps[:-self.lc.keep_last]:
            shutil.rmtree(os.path.join(self.lc.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)


def make_failure_injector(fail_at_steps):
    """Raise a simulated node failure the FIRST time each step is reached."""
    remaining = set(fail_at_steps)

    def inject(step):
        if step in remaining:
            remaining.discard(step)
            raise RuntimeError(f"injected node failure at step {step}")
    return inject
