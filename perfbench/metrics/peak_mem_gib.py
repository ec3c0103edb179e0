"""peak_mem_gib (GiB, lower): ``torch.cuda.max_memory_allocated()`` over
set-up and window, from a peak reset at the run's start: the index plus
one call's workspace."""


def read(run):
    return run["peak_bytes"] / 2 ** 30 if run["peak_bytes"] else None
