"""device_idle (%): the share of the traced window in which no kernel or
copy ran on the card."""


def read(run):
    if run.trace is None or not run.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
