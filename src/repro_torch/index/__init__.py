from repro_torch.index.mutable import MutableIndex
from repro_torch.index.sharded import ShardedMutableIndex

__all__ = ["MutableIndex", "ShardedMutableIndex"]
