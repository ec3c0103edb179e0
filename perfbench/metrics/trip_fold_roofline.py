"""trip_fold_roofline (%). Layer: kernels/csrc. Source: device_trace.
Moves: qps. The least time the traced calls need of the trip fold
(``perfbench/kernels/trip_fold.py``) over its device time in the
trace."""
from perfbench.kernels import peaks, trip_fold


def read(run):
    return peaks.roofline_pct(run, trip_fold)
