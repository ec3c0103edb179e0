"""Dist.H (``repro_torch/kernels/csrc/dist_h.cu``): squared L2 between
gathered high-dimensional rows and their query, float32.

What one search call needs of it: each Dist.H the search counts
(``dist_h_evals``: a valid, unvisited candidate, the entry point, or a row
of the deferred re-rank) reads one D-wide float32 row and writes one
distance; each query row is read once a launch that serves it (the entry
launch and one a step with per-step re-rank; the one re-rank launch when
deferred). Three operations an element (subtract, multiply, add). Rows
of finished queries and invalid candidates are launched but not needed,
so they count nothing."""
KERNEL = "dist_h_kernel"


def need(c: dict) -> tuple:
    D = c["dim"]
    rows = c["dist_h_evals"]
    queries = c["queries"] if c["deferred"] \
        else c["queries"] + sum(c["steps"])
    return rows * (4 * D + 4) + queries * 4 * D, 3 * rows * D
