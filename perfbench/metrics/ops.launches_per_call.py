"""ops.launches_per_call (count). Layer: kernels.ops. Source:
program_counter. Moves: qps. Launches of the port's kernels a call of
the window (the sum of ``ops.launch_counts()``)."""


def read(run):
    return run["launches"] if run["calls"] else None
