"""Bytes and operations that the port's kernels need for one call of the
search, from the counts of a counting call (``run.counting``), and the
H100's peaks. One file a kernel; each names the kernel as the device trace
shows it (``KERNEL``) and gives ``need(counts) -> (bytes, operations)``."""
