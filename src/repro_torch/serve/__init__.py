"""The serving plane (port of ``repro/serve``): the vector-search
service, its continuous-batching scheduler (``StreamScheduler``, behind
``VectorSearchService.run_stream`` and ``scheduler()``) and its replica
set. The LM generation engine is not ported yet (ROADMAP.md A10)."""
from repro_torch.serve.replica import ReplicaSet
from repro_torch.serve.scheduler import (Completion, SchedulerUnsupported,
                                         StreamScheduler)
from repro_torch.serve.vector_service import ServiceStats, VectorSearchService

__all__ = ["Completion", "ReplicaSet", "SchedulerUnsupported",
           "ServiceStats", "StreamScheduler", "VectorSearchService"]
