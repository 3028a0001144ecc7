"""setup_s: seconds from the start of run.py to the first timed call:
imports, the data drawn on the card, the kernels built or loaded, one
warm-up evaluation."""


def read(run):
    return run.setup_s
