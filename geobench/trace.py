"""The `--trace 1` run's profiler trace and its reduction.

The measured window runs under torch.profiler (CPU and CUDA activity),
padded with PAD_S of idle at each end: on this card a trace that ended
right after the work lost device events once a process had run for a while
(`chip_smoke.py`'s `device_profile`, whose padding this copies).  The raw
Kineto events are read directly (`chip_smoke.py`'s `stream_profile`):
building the profiler's FunctionEvents for ~10^5 launches takes longer than
the window.

`reduce` gives what the per-layer readers take: the device time by kernel
name, the device's busy seconds (the union of its kernel and copy
intervals), and the idle gaps between them, each labelled with what the
host was doing in its middle: the host event begun last of those that
cover it (an ATen operator, a CUDA runtime call), the innermost where they
nest.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field

PAD_S = 0.3


@dataclass
class Reduced:
    kernels: dict = field(default_factory=dict)   # name -> [count, seconds]
    busy_s: float = 0.0
    gaps: list = field(default_factory=list)      # (seconds, host label)
    device_events: int = 0


class Profiled:
    """with Profiled() as p: <window>; p.events: the raw Kineto events."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(PAD_S)
        return self

    def __exit__(self, *exc):
        time.sleep(PAD_S)
        self._prof.__exit__(*exc)
        return False

    def events(self):
        """(is_device, name, start_ns, end_ns) of every event."""
        from torch.autograd import DeviceType
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            yield (e.device_type() == DeviceType.CUDA, e.name(), start,
                   start + e.duration_ns())


def reduce(events) -> Reduced:
    """Device time by name, busy seconds and labelled idle gaps from
    (is_device, name, start_ns, end_ns) events."""
    out = Reduced()
    spans, host = [], []
    for is_device, name, start, end in events:
        if is_device:
            spans.append((start, end))
            row = out.kernels.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += (end - start) / 1e9
        else:
            host.append((start, end, name))
    out.device_events = len(spans)
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    out.busy_s = sum(e - s for s, e in merged) / 1e9
    # sweep the gaps' middles in order, keeping the host events begun by
    # then in a heap by latest start; one that ended before a middle ended
    # before every later one too
    host.sort()
    active, h = [], 0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        while h < len(host) and host[h][0] <= mid:
            heapq.heappush(active, (-host[h][0], host[h][1], host[h][2]))
            h += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        out.gaps.append(((s1 - e0) / 1e9,
                         active[0][2] if active else "no host event"))
    return out


def breakdown(red: Reduced, top: int = 10) -> dict:
    """The result line's breakdown: the device operations that took most
    time, and the idle seconds summed by what the host was doing."""
    ops = sorted(red.kernels.items(), key=lambda kv: -kv[1][1])[:top]
    idle = {}
    for seconds, label in red.gaps:
        idle[label] = idle.get(label, 0.0) + seconds
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:160], row[1]] for name, row in ops],
            "idle_gaps": [[name[:160], s] for name, s in gaps]}
