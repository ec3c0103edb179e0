"""Configurations (port of ``repro/configs/base.py``): the LM model
configs of the ten architectures (``ModelConfig`` with its ``MoEConfig``
and ``RetrievalConfig``), the input-shape suite (``ShapeConfig``,
``SHAPES``), ``smoke_config``, and the paper's pHNSW config. Each holds
every field of the reference's class, with the same names, defaults and
methods, so that ``core/graph._cfg_fingerprint`` hashes a ``PHNSWConfig``
to the same cache key in both packages and a model config means the same
model in both."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_tok: int
    # router options
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class RetrievalConfig:
    """pHNSW retrieval-attention config (the paper's technique applied to
    long-context decode): PCA-project keys to ``d_low``, filter ``topk``
    candidates in low-dim space, exact attention over re-ranked set."""
    enabled: bool = False
    d_low: int = 16            # PCA dim (paper: 128 -> 15 for SIFT1M)
    topk: int = 128            # candidates kept after low-dim filter
    block: int = 128           # KV positions grouped per index entry
    # cache partitions: the filter is partition-LOCAL (top-k within each
    # partition, softmax-merged across) so a sequence-sharded cache never
    # gathers globally. Set to the number of cache shards on the
    # production mesh (data x model = 256 for batch-1 long-context).
    partitions: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | encdec | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free families
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    mlp: str = "swiglu"         # swiglu | gelu | geglu | rwkv
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0             # sliding-window attention size; 0 = full
    moe: Optional[MoEConfig] = None
    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 1500      # stubbed audio frontend output length
    # --- vlm ---
    vis_tokens: int = 0         # stubbed patch-embedding count
    # --- hybrid (recurrentgemma): repeating block pattern ---
    pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    local_window: int = 2048
    lru_width: int = 0          # 0 -> d_model
    # --- retrieval attention (paper technique integration) ---
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # the reference's attention implementation switch ("xla" or "flash");
    # kept for the same fields, unread by the port, which dispatches by
    # tensor device (a CUDA tensor launches the flash and decode kernels)
    attn_impl: str = "xla"
    remat: str = "full"         # full | none | dots
    # int8 KV cache (per-token-per-head absmax scales): halves decode
    # cache reads
    kv_quant: bool = False
    # parameter-sharding profile of the reference's mesh: "tp" =
    # FSDP(data) x tensor-parallel (model); "fsdp" = pure FSDP over
    # (data x model) jointly, no TP
    shard_profile: str = "tp"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports long_500k natively (bounded state or
        bounded attention window)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.window > 0:
            return True
        return self.retrieval.enabled

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND
        MODEL_FLOPS accounting."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":                      # rwkv6
            # time-mix: r,k,v,g,o ~ 5 d*d + decay loras;
            # channel-mix ~ 2 d*f + d*d
            per_layer = 5 * d * d + 2 * d * f + d * d
        else:
            attn = d * self.n_heads * hd + 2 * d * self.kv_heads * hd \
                + self.n_heads * hd * d
            if self.moe is not None:
                mlp = self.moe.n_experts * 3 * d * f + d * self.moe.n_experts
            elif self.mlp in ("swiglu", "geglu"):
                mlp = 3 * d * f
            else:
                mlp = 2 * d * f
            per_layer = attn + mlp
            if self.family == "hybrid" and self.pattern:
                # mix of recurrent + attn blocks; recurrent block
                # ~ 2*d*lru + lru*d + gates
                lru = self.lru_width or d
                rec = 2 * d * lru + lru * d + 2 * lru
                frac_rec = self.pattern.count("rec") / len(self.pattern)
                per_layer = (frac_rec * (rec + mlp)
                             + (1 - frac_rec) * (attn + mlp))
        total = emb + self.n_layers * per_layer
        if self.enc_layers:
            total += self.enc_layers * per_layer
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE uses experts_per_tok of n_experts)."""
        if self.moe is None:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense = self.n_params() \
            - self.n_layers * self.moe.n_experts * 3 * d * f
        active = self.n_layers * self.moe.experts_per_tok * 3 * d * f
        return int(dense + active)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


# The assigned LM shape suite (applies to every architecture).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: tiny depth/width/
    experts/vocab, same structural features (GQA ratio, MoE, pattern...)."""
    kw = dict(
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab=256,
        head_dim=16,
        enc_frames=8 if cfg.enc_layers else 1500,
        vis_tokens=4 if cfg.vis_tokens else 0,
        lru_width=64 if cfg.family == "hybrid" else 0,
        local_window=8,
        window=8 if cfg.window else 0,
        dtype="float32",
        remat="none",
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["kv_heads"] = max(1, round(4 * cfg.kv_heads / cfg.n_heads))
    if cfg.enc_layers:
        kw["enc_layers"] = 2
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=4,
                              experts_per_tok=min(2, cfg.moe.experts_per_tok))
    if cfg.pattern:
        kw["pattern"] = cfg.pattern
        kw["n_layers"] = 3   # one full pattern group
    if cfg.retrieval.enabled:
        kw["retrieval"] = RetrievalConfig(enabled=True, d_low=4, topk=8,
                                          block=8, partitions=2)
    return cfg.replace(**kw)



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
