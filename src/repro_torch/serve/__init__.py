"""The serving plane (port of ``repro/serve``): the vector-search
service and its replica set. The continuous-batching scheduler and the
LM generation engine are not ported yet (ROADMAP.md A7, A10)."""
from repro_torch.serve.replica import ReplicaSet
from repro_torch.serve.vector_service import ServiceStats, VectorSearchService

__all__ = ["ReplicaSet", "ServiceStats", "VectorSearchService"]
