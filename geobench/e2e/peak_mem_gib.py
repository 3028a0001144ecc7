"""peak_mem_gib: torch.cuda.max_memory_allocated() over the warm-up and the
window, reset once the inputs are made, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
