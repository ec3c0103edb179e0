"""index.bytes_per_vec (B). Layer: index (PackedDB layout (3)). Source:
program_counter. Moves: peak_mem_gib. Bytes of the packed index's device
tensors (adjacency and inline low-dimensional rows of every layer, the
payload and the high-dimensional table) over the points."""


def read(run):
    return run["db_bytes"] / run["n_points"]
