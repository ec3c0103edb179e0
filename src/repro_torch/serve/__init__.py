"""The serving plane (port of ``repro/serve``): the vector-search
service. ``ReplicaSet`` (``serve/replica.py``), the continuous-batching
scheduler and the LM generation engine are not ported yet (ROADMAP.md
A6, A7, A10)."""
from repro_torch.serve.vector_service import ServiceStats, VectorSearchService

__all__ = ["ServiceStats", "VectorSearchService"]
