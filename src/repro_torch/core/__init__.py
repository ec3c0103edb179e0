"""The port's core (``repro/core``): PCA, graph construction, filters,
the host oracle, the batched search on the card, the cost model and the
k-schedule sweep."""
from repro_torch.core.pca import PCA, fit_pca
from repro_torch.core.graph import (HNSWGraph, build_hnsw, build_hnsw_ref,
                                    cached_graph)
from repro_torch.core.build import build_hnsw_wave, graph_invariants
from repro_torch.core.filters import (FilterSpec, IdentityFilter, PCAFilter,
                                      PQFilter, make_filter)
from repro_torch.core.search_ref import (SearchStats, search_hnsw,
                                         search_phnsw, search_filtered,
                                         search_sharded, run_queries,
                                         recall_at)
from repro_torch.core.search_torch import (PackedDB, build_packed,
                                           search_batched)
from repro_torch.core.cost_model import (DDR4, HBM, PROCESSOR, QueryCost,
                                         query_cost, table3,
                                         hw_variant_stats)
from repro_torch.core.kselect import select_schedule, sweep_k0, sweep_k1

__all__ = [
    "PCA", "fit_pca", "HNSWGraph", "build_hnsw", "build_hnsw_ref",
    "build_hnsw_wave", "graph_invariants", "cached_graph",
    "FilterSpec", "IdentityFilter", "PCAFilter", "PQFilter",
    "make_filter", "SearchStats", "search_hnsw", "search_phnsw",
    "search_filtered", "search_sharded", "run_queries",
    "recall_at", "PackedDB", "build_packed", "search_batched",
    "DDR4", "HBM", "PROCESSOR", "QueryCost", "query_cost", "table3",
    "hw_variant_stats", "select_schedule", "sweep_k0", "sweep_k1",
]
