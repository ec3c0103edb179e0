"""dist_h_roofline (%). Layer: kernels/csrc. Source: device_trace. Moves:
qps. The least time the traced calls need of Dist.H
(``perfbench/kernels/dist_h.py``) over its device time in the trace."""
from perfbench.kernels import dist_h, peaks


def read(run):
    return peaks.roofline_pct(run, dist_h)
