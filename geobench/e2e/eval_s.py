"""eval_s: the measured window's seconds over the evaluations answered in
it.  An evaluation is one call of the cell's entry, its value on the host;
the window runs from the first call to the last answer, so every stall in
it counts."""


def read(run):
    return run.window_s / run.answered if run.answered else None
