"""The trip fold (``repro_torch/kernels/csrc/trip_fold.cu``): a trip's
pop, accept test and the sorted merges into F (ef wide), C (cap = ef +
kk) and the C_pca heap (k wide), for the kk = W * k candidates of the
trip.

What one search call needs of it: each expansion step of a query (the
counting call's ``steps_per_layer``) folds one row, reading F and C (a
distance and an id a slot), the heap and the feed rows (dh and the ids,
plus the filter distances when the traversal orders by Dist.H), and
writing F, C and the heap. Operations are comparisons: the rank sort of
each sorted feed row (kk squared) and the three merges (their lengths).
Rows of finished queries are launched but not needed."""
KERNEL = "trip_fold_kernel"


def row_need(ef: int, k: int, kk: int, kv_row: bool) -> tuple:
    """(bytes, operations) of one folded row."""
    cap = max(ef + kk, 8)
    state = 8 * ef + 8 * cap + 4 * k
    feeds = 3 if kv_row else 2
    sorted_rows = 2 if kv_row else 1
    ops = sorted_rows * kk * kk + (ef + kk) + (cap + kk) + (k + kk)
    return 2 * state + 4 * feeds * kk, ops


def need(c: dict) -> tuple:
    n_bytes = n_ops = 0
    for S, ef, k in zip(c["steps"], c["ef"], c["k"]):
        b, o = row_need(ef, k, c["expand_width"] * k, not c["deferred"])
        n_bytes += S * b
        n_ops += S * o
    return n_bytes, n_ops
