"""The serving plane (port of ``repro/serve``): the vector-search
service, its continuous-batching scheduler (``StreamScheduler``, behind
``VectorSearchService.run_stream`` and ``scheduler()``), its replica set,
and the LM generation engine (``GenerationEngine``, the dense and vlm
families)."""
from repro_torch.serve.engine import GenerationEngine, GenerationResult
from repro_torch.serve.replica import ReplicaSet
from repro_torch.serve.scheduler import (Completion, SchedulerUnsupported,
                                         StreamScheduler)
from repro_torch.serve.vector_service import ServiceStats, VectorSearchService

__all__ = ["Completion", "GenerationEngine", "GenerationResult",
           "ReplicaSet", "SchedulerUnsupported", "ServiceStats",
           "StreamScheduler", "VectorSearchService"]
