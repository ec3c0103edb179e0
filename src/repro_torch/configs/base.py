"""The pHNSW configuration (port of ``PHNSWConfig`` from
``repro/configs/base.py``; the LM ``ModelConfig`` is not ported yet).
It holds every field of the reference's ``PHNSWConfig``, with the same
names, defaults and methods, so that ``core/graph._cfg_fingerprint``
hashes a config to the same cache key in both packages."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class PHNSWConfig:
    """Configuration of the paper's SIFT1M experiment (Section V)."""
    name: str = "sift1m"
    n_points: int = 1_000_000
    dim: int = 128              # SIFT descriptor dim
    d_low: int = 15             # PCA dim (paper Step 1: 128 -> 15)
    n_layers: int = 6           # six-layer search graph
    M: int = 16                 # graph degree, layers 1..5
    M0: int = 32                # graph degree at layer 0 (2M)
    ef_upper: int = 1           # ef for layers 1..5
    ef0: int = 10               # ef for layer 0
    # per-layer top-k filter sizes (paper Section III-B):
    #   layers 2..5 -> 3 (3x ef per pKNN recommendation), layer1 -> 8,
    #   layer0 -> 16
    k_schedule: Tuple[int, ...] = (16, 8, 3, 3, 3, 3)
    ef_construction: int = 100
    recall_at: int = 10
    # the reference's field; no ported path reads it, but the cache key
    # of core/graph.cached_graph hashes every field
    dtype: str = "float32"
    # ---- construction pipeline (core/build.py) ----
    # "wave": batched device-accelerated builder — insert in waves of
    # ``wave_size``, one fused-kernel beam search per wave against the
    # current snapshot, vectorized diversity selection + bidirectional
    # linking over the whole wave. "ref": the sequential host builder
    # (build_hnsw_ref), kept as the recall/structure oracle.
    builder: str = "wave"
    # vectors per construction wave. Larger waves amortize the per-wave
    # snapshot + probe overhead; smaller waves reduce snapshot staleness
    # (wave members probe a graph that predates the wave — the
    # intra-wave distance block covers wave-internal neighbors).
    wave_size: int = 2048
    # upper-layer beam width of the wave builder's device probe (layers
    # >= 1 mostly supply descent seeds; the sequential oracle descends
    # with ef=1, and M upper-layer links only need ~M candidates — the
    # intra-wave block supplements them). None = full ef_construction
    # at every layer. Does NOT apply to MutableIndex inserts (their
    # probe keeps the full beam).
    wave_ef_upper: Optional[int] = 16
    # ---- filter stage (core/filters.py) ----
    # which low-cost filter ranks candidates before (or instead of)
    # high-dim re-ranking: "pca" (the paper's dense low-dim projection),
    # "pq" (Flash-style product quantization, scored by the ADC expand
    # kernel), "cascade" (PQ-traverse -> PCA-promote -> one deferred
    # Dist.H pass; requires deferred_rerank), or "none" (filter bypass:
    # every neighbor goes straight to Dist.H, the HNSW-Std behavior)
    filter_kind: str = "pca"
    # PQ filter shape: n_sub subspaces x 256 centroids = n_sub bytes/vec
    pq_n_sub: int = 16
    pq_train_iters: int = 8
    # cascade promote stage: the layer-0 traversal keeps
    # promote_mult * ef0 PQ-space candidates, the PCA mid-stage score
    # (batched, once per layer-0 exit) trims them to rerank_mult * ef0
    # for the single final Dist.H pass
    promote_mult: int = 6
    # ---- re-ranking mode ----
    # "deferred" traverses purely on filter distances and re-ranks only
    # the final list in high dim: ONE batched Dist.H call per query
    # instead of k per expansion step. rerank_mult widens the layer-0
    # result list to rerank_mult * ef0 filter-space candidates before
    # that single re-rank.
    deferred_rerank: bool = False
    rerank_mult: int = 3
    # storage dtype of the inline low-dim vectors in layout (3)
    # ("bfloat16" halves the dominant HBM stream and the paper's ~2.9x
    # memory blow-up; distances still accumulate in f32)
    low_dtype: str = "float32"
    # per-layer expansion-step budgets for the batched engine (layer 0
    # first). None -> the default linear-in-ef budget. Tune from the
    # steps_mean/steps_p99 telemetry in BENCH_table3.json: the batch
    # convoys on its slowest query, so capping tail steps trades a
    # bounded recall loss for wall-clock.
    step_budget: Optional[Tuple[int, ...]] = None
    # batched engine: expand the W nearest frontier candidates per loop
    # iteration (DESIGN.md). Exact w.r.t. the per-candidate expansion
    # rule (a popped candidate beyond F.max can never re-qualify) and
    # cuts while_loop trips ~W-fold, but widens every per-iteration
    # matrix ~W-fold — a win only where fixed per-iteration overhead
    # dominates element throughput (measured: not on CPU; revisit per
    # backend via BENCH_table3.json).
    expand_width: int = 1
    # top-k width of the construction probe (the wave builder passes it
    # as the probe's k; the identity-filter probe keeps W*M0 survivors
    # whatever its value)
    ef_construction_k: int = 16
    # ---- mutable index (src/repro_torch/index/) ----
    # upserts are chunked into device probes of this many vectors
    insert_batch: int = 128
    # compact() auto-triggers when deleted/live crosses this fraction
    compact_tombstone_frac: float = 0.25
    # PCA-drift report flags a refit when the frozen projection captures
    # this much less variance on the live distribution than at fit time
    pca_drift_tol: float = 0.10
    # capacity floor for the power-of-two buffer growth schedule
    min_capacity: int = 1024

    def k_for_layer(self, layer: int) -> int:
        return self.k_schedule[min(layer, len(self.k_schedule) - 1)]

    def k_schedule_for(self, filter_kind: str,
                       deferred: bool) -> Tuple[int, ...]:
        """Effective default per-layer expansion k for a filter kind.
        The deferred CASCADE keeps ALL M0 neighbors at layer 0 (no
        kSort.L pruning): its in-loop distances are ~free ADC lookups,
        but 256-way sub-codebooks rank too coarsely for a tight
        per-step top-k — pruned edges are exactly how true neighbors
        become unreachable, and no promote/re-rank width can recover a
        node the traversal never visited. In per-step mode k also
        bounds the per-expansion Dist.H count, so the configured
        schedule stands there. An explicit ``k_schedule=`` argument to
        any search entry point overrides this default verbatim."""
        if deferred and filter_kind == "cascade":
            return (max(self.k_schedule[0], self.M0),) \
                + tuple(self.k_schedule[1:])
        return tuple(self.k_schedule)

    def ef_for_layer(self, layer: int) -> int:
        return self.ef0 if layer == 0 else self.ef_upper

    def degree(self, layer: int) -> int:
        return self.M0 if layer == 0 else self.M

    def max_steps_for_layer(self, layer: int) -> int:
        if self.step_budget is not None:
            return self.step_budget[min(layer, len(self.step_budget) - 1)]
        return 4 * self.ef_for_layer(layer) + 16
