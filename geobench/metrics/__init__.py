"""Per-layer metric readers, one file each, named as in BENCHMARK.json:
`read(run)` returns the metric's value from the `--trace 1` run, or None
where the run has nothing to read (no launch of the kernel, no trace)."""

import re


def device_seconds(run, names) -> float:
    """Device seconds of the traced window's kernels named in `names`
    (their function names, matched as whole words)."""
    pats = [re.compile(rf"\b{n}\b") for n in names]
    return sum(row[1] for k, row in run.trace.kernels.items()
               if any(p.search(k) for p in pats))


def roofline(run, names, least_seconds_per_eval: float):
    """100 x the summed least time of the kernels' launches over the
    window over their summed device time; None with no launch."""
    if run.trace is None or not least_seconds_per_eval:
        return None
    spent = device_seconds(run, names)
    if not spent:
        return None
    return 100.0 * least_seconds_per_eval * run.answered / spent
