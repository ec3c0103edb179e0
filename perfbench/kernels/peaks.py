"""Published peaks of one H100 SXM (NVIDIA's data sheet, dense), as the
port's ``bench/kernel_footprint.py`` states them. They assume the card's
full 700 W; each run records the card's power limit beside its numbers."""
PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32_OPS_PER_S = 67e12      # float32 outside the tensor cores


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S)


def roofline_pct(run: dict, kernel) -> float:
    """A kernel's share of its roofline in the traced calls: the least
    time the calls need of it (``kernel.need`` on the counting call's
    counts, once a traced call) over its device time in the trace. None
    where the trace shows no launch of it."""
    tr = run.get("trace")
    if not tr or "counts" not in run:
        return None
    secs = sum(s for name, s in tr["kernel_s"].items()
               if kernel.KERNEL in name)
    if secs <= 0:
        return None
    n_bytes, n_ops = kernel.need(run["counts"])
    return 100.0 * least_seconds(n_bytes, n_ops) * tr["calls"] / secs
