"""eval_mfu (%): an evaluation's least time (counts/evaluation.py: each
operation the algorithm needs at the data-sheet peak of its precision)
over its measured time in the traced window."""

from geobench.counts import evaluation


def read(run):
    if not run.answered:
        return None
    least = evaluation.least_seconds(run.config)
    return 100.0 * least * run.answered / run.window_s
