"""qps (queries/s, higher): every query answered in the measured window
over the window's seconds, first call's start to last call's end, on the
host's clock."""


def read(run):
    return run["queries"] / run["window_s"] if run["calls"] else None
