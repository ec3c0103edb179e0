"""Reference (host, numpy) search implementations with instrumentation
(port of ``repro/core/search_ref.py``: the same arithmetic, line for
line, over the port's graph, PCA and filters; it never touches a tensor,
so it runs on the host whatever device the batched engine uses).

Three searchers over the same HNSW graph:
  * ``search_hnsw``   — standard HNSW (paper baseline [2]): all neighbor
    distances in HIGH-dim space; per expansion the neighbor index list is
    one sequential burst, then M irregular high-dim vector fetches.
  * ``search_phnsw``  — Algorithm 1: neighbor distances in LOW-dim space,
    top-k filter (kSort.L), only k candidates re-ranked in high-dim.
    ``layout="packed"`` = paper layout (3): indices + low-dim vectors
    inline -> ONE sequential burst per expansion. ``layout="separate"`` =
    pKNN layout (4): index burst + M irregular low-dim fetches.

Every searcher fills a ``SearchStats`` with algorithmic counts and DRAM
access events; ``core/cost_model.py`` turns those into QPS / energy for
the pHNSW processor configurations of Table III / Fig 5. The filters
are the port's (``core/filters.py``): only their host halves, ``prepare``,
``dists`` and ``mid_dists``, run here.

Interpretation note on Algorithm 1 (documented deviation): the paper
carries ``C_pca`` across iterations as the filter threshold heap (lines
5, 20, 24) but does not pin its capacity; we bound it at k (matching the
fixed-size kSort.L register file) and use its max as ``f_pca``. Ties in
the filter are broken by index, making the top-k deterministic.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field, asdict
from typing import List, Literal, Optional, Tuple

import numpy as np

from repro_torch.configs.base import PHNSWConfig
from repro_torch.core.graph import HNSWGraph
from repro_torch.core.pca import PCA

IDX_BYTES = 4
F32 = 4


@dataclass
class SearchStats:
    """Algorithmic + memory-event counters for ONE query."""
    expansions: int = 0          # node expansions (step-2 loops)
    dist_high: int = 0           # high-dim distance computations
    dist_low: int = 0            # low-dim (in-loop filter) distances
    dist_mid: int = 0            # cascade promote-stage distances
    ksort_calls: int = 0         # kSort.L invocations
    minh_calls: int = 0          # Min.H invocations
    visit_checks: int = 0        # Visit&Raw SPM reads
    f_updates: int = 0           # F-list inserts (RMF on eviction)
    evictions: int = 0
    seq_bursts: int = 0          # sequential DRAM bursts
    seq_bytes: int = 0
    rand_accesses: int = 0       # irregular DRAM accesses
    rand_bytes: int = 0

    def add(self, other: "SearchStats"):
        for k, v in asdict(other).items():
            setattr(self, k, getattr(self, k) + v)

    def as_dict(self):
        return asdict(self)


def _d2(a, b):
    d = a - b
    return float(np.dot(d, d))


def _d2_rows(x, q):
    d = x - q
    return np.einsum("ij,ij->i", d, d)


# ---------------------------------------------------------------------------
# standard HNSW layer search (baseline [2] / HNSW-Std hardware variant)
# ---------------------------------------------------------------------------

def _hnsw_layer(g: HNSWGraph, q: np.ndarray, eps: List[int], ef: int,
                layer: int, st: SearchStats,
                hw_mode: bool = False,
                deleted: Optional[np.ndarray] = None) -> List[Tuple[float, int]]:
    """hw_mode=True models the HNSW-Std accelerator baseline ([5],[6] as
    characterized in Section IV-B2): the DMA fetches high-dim data for
    ALL M neighbors of the expanded node before the visited check (the
    V-list lives with the raw data in SPM), so fetch/distance counts are
    per-neighbor, not per-unvisited-neighbor. The traversal itself is
    identical.

    ``deleted`` ([N] bool, optional): tombstone semantics — deleted
    nodes are traversed (pushed to the candidate heap, expanded) but
    never enter the result heap."""
    adj = g.layers[layer]
    dim = g.x.shape[1]
    live = (lambda e: True) if deleted is None \
        else (lambda e: not deleted[e])
    visited = set(eps)
    cand = []
    best = []
    for e in eps:
        d = _d2(g.x[e], q)
        st.dist_high += 1
        st.rand_accesses += 1
        st.rand_bytes += dim * F32
        heapq.heappush(cand, (d, e))
        if live(e):
            heapq.heappush(best, (-d, e))
    while cand:
        d_c, c = heapq.heappop(cand)
        d_f = -best[0][0] if best else np.inf
        if d_c > d_f and len(best) >= ef:
            break
        st.expansions += 1
        neigh = adj[c]
        neigh = neigh[neigh >= 0]
        # one sequential burst for the index list
        st.seq_bursts += 1
        st.seq_bytes += adj.shape[1] * IDX_BYTES
        new = [int(e) for e in neigh if e not in visited]
        st.visit_checks += len(neigh)
        visited.update(new)
        # irregular fetches + high-dim distances: all M neighbors in
        # hw_mode, unvisited only in software mode
        n_fetch = len(neigh) if hw_mode else len(new)
        st.rand_accesses += n_fetch
        st.rand_bytes += n_fetch * dim * F32
        st.dist_high += n_fetch
        if not new:
            continue
        ds = _d2_rows(g.x[new], q)
        for d_e, e in zip(ds, new):
            d_f = -best[0][0] if best else np.inf
            if d_e < d_f or len(best) < ef:
                heapq.heappush(cand, (float(d_e), e))
                if live(e):
                    heapq.heappush(best, (-float(d_e), e))
                    st.f_updates += 1
                    if len(best) > ef:
                        heapq.heappop(best)
                        st.evictions += 1
    return sorted([(-d, e) for d, e in best])


def search_hnsw(g: HNSWGraph, q: np.ndarray, *, ef0: Optional[int] = None,
                hw_mode: bool = False,
                deleted: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, SearchStats]:
    cfg = g.cfg
    st = SearchStats()
    ep = [g.entry]
    top = int(g.levels.max())
    for layer in range(top, 0, -1):
        res = _hnsw_layer(g, q, ep, cfg.ef_for_layer(layer), layer, st,
                          hw_mode)
        ep = [res[0][1]]
    # only the output layer filters tombstones; upper layers just route
    res = _hnsw_layer(g, q, ep, ef0 or cfg.ef0, 0, st, hw_mode,
                      deleted=deleted)
    return np.array([e for _, e in res], np.int64), st


# ---------------------------------------------------------------------------
# pHNSW Algorithm 1, generalized over the pluggable filter stage
# ---------------------------------------------------------------------------

def _filter_layer(g: HNSWGraph, filt, payload: np.ndarray, q: np.ndarray,
                  qprep: np.ndarray, eps: List[int], ef: int, k: int,
                  layer: int, st: SearchStats,
                  layout: Literal["packed", "separate"],
                  deleted: Optional[np.ndarray] = None,
                  deferred: bool = False) -> List[Tuple[float, int]]:
    """One Algorithm-1 layer for any ``core.filters.FilterSpec`` with a
    real filter stage ("pca"/"pq"; the identity bypass routes through
    ``_hnsw_layer`` instead).

    Per-step mode (the paper): C/F are keyed on HIGH-dim distances,
    the filter only prunes which neighbors get re-ranked. ``deferred``
    keys the whole traversal (C, F, the acceptance bound) on FILTER
    distances and computes no high-dim distance at all — the caller
    re-ranks the final list once."""
    adj = g.layers[layer]
    M = adj.shape[1]
    dim = g.x.shape[1]
    pb = filt.bytes_per_vec         # layout-(3) inline payload bytes
    live = (lambda e: True) if deleted is None \
        else (lambda e: not deleted[e])
    visited = set(eps)
    C: List[Tuple[float, int]] = []      # candidate min-heap
    F: List[Tuple[float, int]] = []      # final max-heap (neg dist)
    C_pca: List[Tuple[float, int]] = []  # filter-threshold max-heap
    for e in eps:
        dl = float(filt.dists(qprep, payload[[e]])[0])
        st.dist_low += 1
        if deferred:
            key = dl
        else:
            key = _d2(g.x[e], q)
            st.dist_high += 1
            st.rand_accesses += 1
            st.rand_bytes += dim * F32
        heapq.heappush(C, (key, e))
        if live(e):
            heapq.heappush(F, (-key, e))
        heapq.heappush(C_pca, (-dl, e))
    while C:
        d_c, c = heapq.heappop(C)
        d_f = -F[0][0] if F else np.inf
        if d_c > d_f and len(F) >= ef:
            break                                     # lines 7-8
        st.expansions += 1
        neigh = adj[c]
        neigh = neigh[neigh >= 0]
        if layout == "packed":
            # layout (3): indices + inline payload in ONE burst
            st.seq_bursts += 1
            st.seq_bytes += M * (IDX_BYTES + pb)
        else:
            # layout (4): index burst + M irregular payload fetches
            st.seq_bursts += 1
            st.seq_bytes += M * IDX_BYTES
            st.rand_accesses += len(neigh)
            st.rand_bytes += len(neigh) * pb
        if len(neigh) == 0:
            continue
        # ---- step 2: filter distances + top-k filter (lines 10-13) ----
        nl = [int(e) for e in neigh]
        dls = filt.dists(qprep, payload[nl])
        st.dist_low += len(nl)
        # threshold is only meaningful once the k-bounded heap is full
        f_pca = -C_pca[0][0] if len(C_pca) >= k else np.inf
        keep = [(float(d), e) for d, e in zip(dls, nl) if d < f_pca]
        st.ksort_calls += 1                           # kSort.L, 7 cycles
        keep.sort()                                   # deterministic top-k
        topk = keep[:k]
        # ---- step 3: the k survivors — high-dim re-rank per step, or
        # filter-space acceptance when deferred (lines 15-23) ----
        for dl_m, m in topk:
            st.visit_checks += 1
            if m in visited:
                continue
            visited.add(m)
            if deferred:
                key_m = dl_m
            else:
                st.rand_accesses += 1                 # high-dim fetch
                st.rand_bytes += dim * F32
                key_m = _d2(g.x[m], q)
                st.dist_high += 1
                st.minh_calls += 1
            d_f = -F[0][0] if F else np.inf
            if key_m < d_f or len(F) < ef:
                heapq.heappush(C, (key_m, m))
                if live(m):
                    heapq.heappush(F, (-key_m, m))
                    st.f_updates += 1
                    if len(F) > ef:
                        heapq.heappop(F)
                        st.evictions += 1
                # C_pca_tmp: bounded-k filter threshold heap (line 20/24)
                heapq.heappush(C_pca, (-dl_m, m))
                if len(C_pca) > k:
                    heapq.heappop(C_pca)
    return sorted([(-d, e) for d, e in F])


def _promote_trim(filt, qprep, payload_mid, ids, n_keep: int,
                  st: SearchStats) -> np.ndarray:
    """The cascade's promote stage, host oracle: score the candidates'
    side-car PCA rows against the projected query and keep the best
    ``n_keep`` (stable sort — exact mid-score ties keep the incoming
    PQ-space order, mirroring the batched engine's slot-order
    tie-break). Accounts one irregular side-car fetch + one low-dim
    distance per candidate."""
    mids = payload_mid[ids]
    dm = filt.mid_dists(qprep, mids)
    st.dist_mid += len(ids)
    st.rand_accesses += len(ids)
    st.rand_bytes += len(ids) * filt.mid_bytes_per_vec
    return ids[np.argsort(dm, kind="stable")][:n_keep]


def search_filtered(g: HNSWGraph, filt, payload: Optional[np.ndarray],
                    q: np.ndarray, *,
                    layout: Literal["packed", "separate"] = "packed",
                    k_schedule: Optional[Tuple[int, ...]] = None,
                    ef0: Optional[int] = None,
                    deleted: Optional[np.ndarray] = None,
                    deferred: bool = False, rerank_mult: int = 1,
                    promote_mult: int = 1,
                    payload_mid: Optional[np.ndarray] = None,
                    final_rerank: bool = True
                    ) -> Tuple[np.ndarray, SearchStats]:
    """Reference search under any filter x rerank combination — the
    host oracle the batched engine is tested against.

    ``payload = filt.encode(x)`` is passed in (encoded once per
    database, like the graph). The identity filter routes to the plain
    HNSW traversal (its 'filter distance' IS the high-dim distance, so
    deferred mode is a no-op). Deferred mode widens the layer-0 result
    list to ``rerank_mult * ef0`` filter-space candidates, then
    re-ranks them with high-dim distances in one batch;
    ``final_rerank=False`` skips that re-rank and returns the WIDE
    filter-space list (ascending filter distance) — the sharded oracle
    merges per-shard lists first and re-ranks once globally.

    The deferred CASCADE (``filt.kind == "cascade"``; needs
    ``payload_mid = filt.encode_mid(x)``) widens layer 0 further to
    ``promote_mult * ef0`` PQ-space candidates and trims them back to
    ``rerank_mult * ef0`` with the PCA mid-stage score (ONE batch per
    query) before the single Dist.H pass."""
    cfg = g.cfg
    if filt.kind == "none":
        return search_hnsw(g, q, ef0=ef0, deleted=deleted)
    cascade = deferred and filt.kind == "cascade"
    if cascade:
        assert payload_mid is not None, \
            "the deferred cascade oracle needs payload_mid"
        promote_mult = max(int(promote_mult), int(rerank_mult))
    st = SearchStats()
    qprep = filt.prepare(q[None])[0]
    ks = k_schedule or cfg.k_schedule_for(filt.kind, deferred)
    k_of = lambda l: ks[min(l, len(ks) - 1)]
    ep = [g.entry]
    top = int(g.levels.max())
    for layer in range(top, 0, -1):
        res = _filter_layer(g, filt, payload, q, qprep, ep,
                            cfg.ef_for_layer(layer), k_of(layer), layer,
                            st, layout, deferred=deferred)
        ep = [res[0][1]]
    # tombstones filter only at the output layer (upper layers route)
    ef_out = ef0 or cfg.ef0
    wide_mult = promote_mult if cascade else rerank_mult
    ef_run = ef_out * wide_mult if deferred else ef_out
    res = _filter_layer(g, filt, payload, q, qprep, ep, ef_run, k_of(0),
                        0, st, layout, deleted=deleted, deferred=deferred)
    ids = np.array([e for _, e in res], np.int64)
    if deferred and not final_rerank:
        return ids, st
    if cascade and len(ids):
        ids = _promote_trim(filt, qprep, payload_mid, ids,
                            ef_out * rerank_mult, st)
    if deferred and len(ids):
        # the deferred high-dim re-rank: ONE batch of Dist.H over the
        # final filter-space list (stable sort keeps the filter order
        # on exact ties, mirroring the batched engine's slot order)
        dim = g.x.shape[1]
        dh = _d2_rows(g.x[ids], q)
        st.dist_high += len(ids)
        st.rand_accesses += len(ids)
        st.rand_bytes += len(ids) * dim * F32
        ids = ids[np.argsort(dh, kind="stable")][:ef_out]
    return ids, st


def search_phnsw(g: HNSWGraph, x_low: np.ndarray, pca: PCA, q: np.ndarray,
                 *, layout: Literal["packed", "separate"] = "packed",
                 k_schedule: Optional[Tuple[int, ...]] = None,
                 ef0: Optional[int] = None,
                 deleted: Optional[np.ndarray] = None,
                 deferred: bool = False, rerank_mult: int = 1
                 ) -> Tuple[np.ndarray, SearchStats]:
    """The seed API: pHNSW with the paper's PCA filter (a thin wrapper
    over ``search_filtered``)."""
    from repro_torch.core.filters import PCAFilter
    filt = PCAFilter(pca, low_dtype=g.cfg.low_dtype)
    return search_filtered(g, filt, x_low, q, layout=layout,
                           k_schedule=k_schedule, ef0=ef0,
                           deleted=deleted, deferred=deferred,
                           rerank_mult=rerank_mult)


# ---------------------------------------------------------------------------
# sharded oracle (host mirror of core/distributed.py)
# ---------------------------------------------------------------------------

def search_sharded(graphs, filt, payloads, q: np.ndarray, *,
                   k_schedule: Optional[Tuple[int, ...]] = None,
                   ef0: Optional[int] = None,
                   deleted=None,
                   deferred: bool = False, rerank_mult: int = 1,
                   promote_mult: int = 1, payload_mids=None
                   ) -> Tuple[np.ndarray, SearchStats]:
    """The sharded reference: ``search_filtered`` per shard + the
    host-side cross-shard merge, mirroring ``distributed_search``
    exactly — per-shard lists (high-dim keyed normally, WIDE
    filter-space keyed when deferred), a global merge with ties broken
    by (lower shard, lower slot), and when deferred ONE global high-dim
    re-rank over the merged list. The deferred cascade (needs
    ``payload_mids``, per-shard ``filt.encode_mid`` rows) merges the
    per-shard ``promote_mult * ef0`` lists on PQ distances, runs the
    PCA promote trim ONCE globally over the merged list, then the
    single global Dist.H pass — promote and re-rank both happen after
    the cross-shard merge, exactly like the device path's psum stages.

    ``graphs``: per-shard ``HNSWGraph`` (independent builds over ONE
    shared ``filt``); ``payloads``: per-shard ``filt.encode`` rows;
    ``deleted``: per-shard [n_s] bool masks or None. Returned ids are
    GLOBAL (shard offset = cumulative shard sizes)."""
    cfg = graphs[0].cfg
    ef_out = ef0 or cfg.ef0
    deferred = deferred and filt.kind != "none"
    cascade = deferred and filt.kind == "cascade"
    if cascade:
        promote_mult = max(int(promote_mult), int(rerank_mult))
    wide_mult = promote_mult if cascade else rerank_mult
    E = ef_out * wide_mult if deferred else ef_out
    qprep = filt.prepare(q[None])[0] if filt.kind != "none" else None
    tot = SearchStats()
    keys, shards, slots, gids, locs = [], [], [], [], []
    offset = 0
    for s, g in enumerate(graphs):
        dele = deleted[s] if deleted is not None else None
        ids, st = search_filtered(g, filt, payloads[s], q,
                                  k_schedule=k_schedule, ef0=ef0,
                                  deleted=dele, deferred=deferred,
                                  rerank_mult=rerank_mult,
                                  promote_mult=promote_mult,
                                  payload_mid=None if payload_mids is
                                  None else payload_mids[s],
                                  final_rerank=False)
        tot.add(st)
        if len(ids):
            if deferred:
                k = filt.dists(qprep, payloads[s][ids])
            else:
                k = _d2_rows(g.x[ids], q)
            keys.append(k.astype(np.float64))
            shards.append(np.full(len(ids), s))
            slots.append(np.arange(len(ids)))
            gids.append(ids + offset)
            locs.append(ids)
        offset += len(g.x)
    if not keys:
        # every shard came back empty (e.g. a fully tombstoned index);
        # the batched engine returns pad ids for the same input
        return np.empty(0, np.int64), tot
    key = np.concatenate(keys)
    shard = np.concatenate(shards)
    slot = np.concatenate(slots)
    gid = np.concatenate(gids)
    loc = np.concatenate(locs)
    order = np.lexsort((slot, shard, key))[:E]
    if cascade:
        # the GLOBAL promote trim: PCA mid-stage scores over the merged
        # PQ-space list (stable — merge-order ties preserved)
        mids = np.stack([payload_mids[shard[i]][loc[i]] for i in order])
        dm = filt.mid_dists(qprep, mids)
        tot.dist_mid += len(order)
        tot.rand_accesses += len(order)
        tot.rand_bytes += len(order) * filt.mid_bytes_per_vec
        order = order[np.argsort(dm, kind="stable")][
            :ef_out * rerank_mult]
    if deferred:
        # ONE global batched Dist.H over the merged filter-space list
        xh = np.stack([graphs[shard[i]].x[loc[i]] for i in order])
        dh = _d2_rows(xh, q)
        tot.dist_high += len(order)
        tot.rand_accesses += len(order)
        tot.rand_bytes += len(order) * q.shape[0] * F32
        order = order[np.argsort(dh, kind="stable")][:ef_out]
    return gid[order], tot


# ---------------------------------------------------------------------------
# batch helpers
# ---------------------------------------------------------------------------

def recall_at(found: np.ndarray, truth: np.ndarray, at: int) -> float:
    """found: [k_found] indices; truth: [at] ground-truth indices."""
    return len(set(found[:at].tolist()) & set(truth[:at].tolist())) / at


def run_queries(g: HNSWGraph, queries: np.ndarray, truth: np.ndarray,
                *, algo: str = "phnsw", x_low=None, pca=None,
                layout="packed", k_schedule=None, hw_mode: bool = False,
                deleted: Optional[np.ndarray] = None,
                filt=None, payload=None, deferred: bool = False,
                rerank_mult: int = 1, promote_mult: int = 1,
                payload_mid=None):
    """Run all queries; returns (mean recall@cfg.recall_at, total
    stats). ``algo="filtered"`` (with ``filt``/``payload``) runs the
    generalized filter x rerank oracle; "phnsw"/"hnsw" keep the seed
    behavior."""
    cfg = g.cfg
    tot = SearchStats()
    recs = []
    for i, q in enumerate(queries):
        if algo == "hnsw":
            found, st = search_hnsw(g, q, hw_mode=hw_mode,
                                    deleted=deleted)
        elif algo == "filtered":
            found, st = search_filtered(g, filt, payload, q,
                                        layout=layout,
                                        k_schedule=k_schedule,
                                        deleted=deleted,
                                        deferred=deferred,
                                        rerank_mult=rerank_mult,
                                        promote_mult=promote_mult,
                                        payload_mid=payload_mid)
        else:
            found, st = search_phnsw(g, x_low, pca, q, layout=layout,
                                     k_schedule=k_schedule,
                                     deleted=deleted, deferred=deferred,
                                     rerank_mult=rerank_mult)
        tot.add(st)
        recs.append(recall_at(found, truth[i], cfg.recall_at))
    return float(np.mean(recs)), tot
