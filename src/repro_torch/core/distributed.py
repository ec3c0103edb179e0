"""Sharded pHNSW search on one device (port of the host path and the
resilient per-shard path of ``repro/core/distributed.py``).

Scheme, as in the reference:
  * the dataset is partitioned into P shards (the ``n % P`` remainder
    spread over the first shards, no tail dropped); each shard gets its
    own HNSW graph over ONE shared filter (PCA projection / PQ codebook
    fitted on the full dataset, so filter distances are comparable
    across shards);
  * each shard runs the batched search (``search_torch``) over its own
    rows; tombstones ride along as the per-shard word-packed ``deleted``
    bitmap (traversed, never returned);
  * the per-shard lists are stacked and merged with one kSort.L pass
    (the ``ksort_l`` kernel; global id = shard offset + local id, ties
    to the lower shard, then the lower slot);
  * under DEFERRED re-ranking each shard hands back its WIDE
    filter-space list, the merge runs on filter distances, and ONE
    global Dist.H pass re-ranks the merged list: each shard scores the
    merged candidates it owns and the sum over shards assembles the row
    (exactly one term per slot is non-zero, so the sum is exact);
  * the deferred CASCADE merges ``promote_mult * ef0`` PQ-space
    candidates and inserts a GLOBAL promote stage (each shard scores its
    own candidates against its PCA side-car rows) that trims the list to
    ``rerank_mult * ef0`` before that Dist.H pass.

``shard_search_host`` is the reference's meshless twin: a Python loop
over shards plus the merge. ``live`` ([P] bool) serves DEGRADED from
the surviving shards; a dead shard is not searched and its lists are
(INF, -1), which gives the reference's bits. The resilient path probes
shards one at a time (``probe_shard``, fault-injectable through
``repro_torch.distributed.faults``), checks each answer
(``check_shard_result``) and merges whatever answered
(``merge_surviving``); ``index/sharded.py`` publishes its mutable
shards as a ``ShardedDB`` and searches it through this path.

``distributed_search`` is the collective path over a device ``Mesh``
(``make_mesh``), with the reference's single-controller API: one
process calls it and gets the global answer. Shard s of the batch's
row r runs on mesh device (r, s); the reference's ``all_gather``
becomes a copy of each shard's lists to the row's first device, and
its ``psum`` of the owned Dist.H / mid-stage rows a sum in shard order
on that device (exactly one shard owns each slot, so the sum has the
reference's bits in any order). The shards' searches run in lockstep
(``search_torch._lockstep``): each issues its trips before any of them
reads its ``done`` flags on the host, so the cards compute at once.
``torch.distributed`` (one process per rank, NCCL collectives) would
need every rank to make the call, a different API from the reference's;
the copies here are a few KB per batch ([B, E] lists and [B, E]
partial rows), so nothing needs the collectives.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import PHNSWConfig
from repro_torch.constants import INF
from repro_torch.core.graph import build_hnsw
from repro_torch.core.pca import PCA
from repro_torch.core.search_torch import (PackedDB, PackedLayer,
                                           _cascade_qpca, _check_device,
                                           _drain, _gather_rows, _key,
                                           _lockstep,
                                           _rank_sort_with_payload,
                                           _search_gen, build_packed,
                                           pack_bitmap, tensor_from_numpy)
from repro_torch.kernels import ops


def shard_bounds(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """[start, end) per shard: ``n // P`` each, the ``n % P`` remainder
    spread one per shard from the front, so every vector is owned by
    exactly one shard."""
    per, rem = divmod(n, n_shards)
    out, start = [], 0
    for s in range(n_shards):
        size = per + (1 if s < rem else 0)
        out.append((start, start + size))
        start += size
    assert start == n
    return out


@dataclass
class ShardedDB:
    """Stacked per-shard databases: every device tensor has leading dim
    P. Shards may hold unequal counts; rows are padded to a uniform
    height (pad rows have no adjacency, so they are unreachable).
    ``counts[s]`` is shard s's owned row span (the ownership test of the
    global re-rank), ``offsets[s]`` maps its local ids to global ids;
    both, and ``entries``, are host int32 arrays. ``deleted`` (optional)
    stacks the per-shard tombstone words. ``filter_kind`` says what the
    payload is, as on ``PackedDB``."""
    adj: List[torch.Tensor]          # per layer: [P, N, M_l] int32
    packed_low: List[torch.Tensor]   # per layer: [P, N, M_l, pl]
    low: torch.Tensor                # [P, N, pl]
    high: torch.Tensor               # [P, N, D]
    entries: np.ndarray              # [P] int32
    offsets: np.ndarray              # [P] int32 global-id offset per shard
    counts: np.ndarray               # [P] int32 rows owned per shard
    cfg: PHNSWConfig
    deleted: Optional[torch.Tensor] = None   # [P, ceil(N/32)] int32
    low2: Optional[torch.Tensor] = None      # [P, N, d_low] f32 side-car
    filter_kind: str = "pca"

    @property
    def n_shards(self) -> int:
        return int(self.high.shape[0])

    @property
    def device(self) -> torch.device:
        return self.high.device

    @property
    def nbytes(self) -> int:
        """Bytes of every stacked device tensor (padding included)."""
        ts = [*self.adj, *self.packed_low, self.low, self.high,
              self.deleted, self.low2]
        return sum(t.numel() * t.element_size() for t in ts
                   if t is not None)

    def shard_db(self, s: int) -> PackedDB:
        """The PackedDB of one shard: views into the stacks, no copy."""
        layers = [PackedLayer(adj=a[s], packed_low=p[s])
                  for a, p in zip(self.adj, self.packed_low)]
        return PackedDB(layers=layers, low=self.low[s], high=self.high[s],
                        entry=int(self.entries[s]), cfg=self.cfg,
                        deleted=None if self.deleted is None
                        else self.deleted[s],
                        low2=None if self.low2 is None else self.low2[s],
                        filter_kind=self.filter_kind)

    def select(self, keep) -> "ShardedDB":
        """The survivor-only twin of a degraded db: the ``keep`` shards,
        each with its ORIGINAL global offset, so global ids and the
        merge's tie order (lower shard first) are preserved. Searching it
        is the oracle that degraded (live-masked) results are held
        bit-equal against."""
        k = np.atleast_1d(np.asarray(keep, np.int64))
        kt = torch.as_tensor(k, device=self.device)
        return dataclasses.replace(
            self,
            adj=[a[kt] for a in self.adj],
            packed_low=[p[kt] for p in self.packed_low],
            low=self.low[kt], high=self.high[kt],
            entries=self.entries[k], offsets=self.offsets[k],
            counts=self.counts[k],
            deleted=None if self.deleted is None else self.deleted[kt],
            low2=None if self.low2 is None else self.low2[kt])


def stacked_db_view(sdb: ShardedDB) -> PackedDB:
    """The STACKED PackedDB view of a ShardedDB: every leaf keeps its
    leading shard dim P (``shard_db`` strips it for one shard; this
    keeps all of them), as views with no copy; ``entry`` is the [P] host
    entries. Not searchable directly (``search_batched`` refuses it): it
    is the operand of the slotted sharded programs
    (``search_torch._slot_step_sharded`` and the other three), which run
    every shard's slots in one pass over the stacked leaves, the rows
    shard-major (row r of a [P * S] bank reads shard r // S)."""
    return PackedDB(
        layers=[PackedLayer(adj=a, packed_low=p)
                for a, p in zip(sdb.adj, sdb.packed_low)],
        low=sdb.low, high=sdb.high, entry=sdb.entries, cfg=sdb.cfg,
        deleted=sdb.deleted, low2=sdb.low2, filter_kind=sdb.filter_kind)


def _pad_rows(a, n: int, fill):
    """Pad axis 0 of ``a`` (a tensor or a numpy array) to ``n`` rows
    with ``fill``."""
    if a.shape[0] == n:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_full((n - a.shape[0],) + a.shape[1:],
                                        fill)])
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])


def build_sharded(x: np.ndarray, cfg: PHNSWConfig, filt, n_shards: int, *,
                  deleted: Optional[np.ndarray] = None, graphs=None,
                  payloads=None, seed: int = 0,
                  builder: Optional[str] = None,
                  device="cuda") -> ShardedDB:
    """Partition ``x`` into ``n_shards`` (``shard_bounds``), build one
    HNSW graph per shard (seed ``seed + s``), and stack the packed
    databases on ``device``. ``filt`` is the SHARED filter: any
    ``core.filters.FilterSpec`` fitted on the full dataset, or a bare
    ``PCA`` (adopted as a ``PCAFilter``). ``deleted`` ([n] bool,
    optional) seeds the per-shard tombstone bitmaps. ``graphs``
    (per-shard ``HNSWGraph``s over exactly the ``shard_bounds``
    partition) skips the builds: graphs do not depend on the filter, so
    callers comparing filter kinds build once. ``payloads`` (per-shard
    ``filt.encode`` of each shard's rows) skips the encoding, so a PQ
    filter's codes can be encoded once for every shard. A pca payload is
    stored in the graphs' ``cfg.low_dtype`` (bfloat16 or float32), as
    the reference stores it."""
    from repro_torch.core.filters import PCAFilter
    if isinstance(filt, PCA):
        filt = PCAFilter(filt, low_dtype=cfg.low_dtype)
    bounds = shard_bounds(len(x), n_shards)
    n_max = max(e - s for s, e in bounds)
    dbs, dels = [], []
    for s, (a, b) in enumerate(bounds):
        xs = x[a:b]
        if graphs is not None:
            g = graphs[s]
            assert len(g.x) == b - a, "graphs must match shard_bounds"
        else:
            g = build_hnsw(xs, cfg, seed=seed + s, builder=builder,
                           device=device)
        # keep layer counts uniform across shards for stacking
        pay = filt.encode(xs) if payloads is None else payloads[s]
        dbs.append(build_packed(g, pay, filt=filt,
                                drop_empty_layers=False, device=device))
        if deleted is not None:
            # pad slots are marked deleted too (unreachable, but the
            # bitmap shape must stack)
            d = _pad_rows(np.asarray(deleted[a:b], bool), n_max, True)
            dels.append(torch.as_tensor(pack_bitmap(d), device=device))
    n_layers = len(dbs[0].layers)
    stack = lambda get, fill: torch.stack([_pad_rows(get(db), n_max, fill)
                                           for db in dbs])
    return ShardedDB(
        adj=[stack(lambda db: db.layers[l].adj, -1)
             for l in range(n_layers)],
        packed_low=[stack(lambda db: db.layers[l].packed_low, 0)
                    for l in range(n_layers)],
        low=stack(lambda db: db.low, 0),
        high=stack(lambda db: db.high, 0),
        entries=np.asarray([db.entry for db in dbs], np.int32),
        offsets=np.asarray([a for a, _ in bounds], np.int32),
        counts=np.asarray([b - a for a, b in bounds], np.int32),
        cfg=cfg,
        deleted=None if deleted is None else torch.stack(dels),
        low2=None if dbs[0].low2 is None else stack(lambda db: db.low2, 0),
        filter_kind=filt.kind)


def from_reference(sdb_np: dict, cfg: PHNSWConfig, *,
                   device="cuda") -> ShardedDB:
    """The port's ShardedDB from a reference ``ShardedDB``'s arrays as
    numpy: ``{"adj": [..], "packed_low": [..], "low", "high",
    "entries", "offsets", "counts", "filter_kind"}`` and, where present,
    ``"deleted"`` and ``"low2"`` — so both engines search the very same
    state (bfloat16 payloads included)."""
    t = lambda a: tensor_from_numpy(a, device)
    opt = lambda key: None if sdb_np.get(key) is None else t(sdb_np[key])
    i32 = lambda key: np.asarray(sdb_np[key], np.int32)
    return ShardedDB(
        adj=[t(a).to(torch.int32) for a in sdb_np["adj"]],
        packed_low=[t(p) for p in sdb_np["packed_low"]],
        low=t(sdb_np["low"]), high=t(sdb_np["high"]),
        entries=i32("entries"), offsets=i32("offsets"),
        counts=i32("counts"), cfg=cfg, deleted=opt("deleted"),
        low2=opt("low2"), filter_kind=sdb_np["filter_kind"])


# ---------------------------------------------------------------------------
# the per-shard lists, the merge, and the global promote / re-rank
# ---------------------------------------------------------------------------

def _shard_lists(db: PackedDB, offset: int, queries, qprep, *, ef0, ks,
                 deferred, rerank_mult, promote_mult=1):
    """One shard's pre-merge candidate lists: ([B, E] dists ascending,
    [B, E] GLOBAL ids). High-dim dists normally; the WIDE
    (rerank_mult * ef0, promote_mult * ef0 for the cascade) filter-space
    list when deferred."""
    return _drain(_shard_lists_gen(db, offset, queries, qprep, ef0=ef0,
                                   ks=ks, deferred=deferred,
                                   rerank_mult=rerank_mult,
                                   promote_mult=promote_mult))


def _shard_lists_gen(db: PackedDB, offset: int, queries, qprep, *, ef0,
                     ks, deferred, rerank_mult, promote_mult=1):
    """``_shard_lists`` as a generator (``search_torch._search_gen``)."""
    fd, fi, _, _ = yield from _search_gen(
        db, queries, qprep, ef0=ef0, k_schedule=ks, deferred=deferred,
        rerank_mult=rerank_mult, promote_mult=promote_mult,
        final_rerank=False)
    return fd, torch.where(fi >= 0, fi + offset, -1)


def _merge_lists(fd_all, fi_all, k: int):
    """Cross-shard merge: [P, B, E] stacked per-shard ascending lists ->
    the global top-k ([B, k] dists, [B, k] ids) with one kSort.L pass
    (ties: lower shard, then lower slot)."""
    Pn, B, E = fd_all.shape
    fd_c = fd_all.permute(1, 0, 2).reshape(B, Pn * E)
    fi_c = fi_all.permute(1, 0, 2).reshape(B, Pn * E)
    vals, sel = ops.ksort_l(fd_c, k)
    return vals, torch.gather(fi_c, 1, sel.long())


def _owned(offset: int, count: int, gids):
    own = (gids >= offset) & (gids < offset + count)
    return own, torch.where(own, gids - offset, 0)


def _owned_dist_h(high, offset: int, count: int, gids, queries):
    """One shard's part of the global deferred re-rank: Dist.H for the
    merged candidates THIS shard owns, zeros elsewhere."""
    own, loc = _owned(offset, count, gids)
    return torch.where(own, ops.dist_h(_gather_rows(high, loc), queries),
                       0.0)


def _owned_dist_mid(low2, offset: int, count: int, gids, qpca):
    """One shard's part of the global cascade promote: PCA mid-stage
    dists (against the ``low2`` side-car) for the merged candidates THIS
    shard owns, zeros elsewhere."""
    own, loc = _owned(offset, count, gids)
    return torch.where(own, ops.dist_l(_gather_rows(low2, loc), qpca), 0.0)


def _global_promote(mi, dm, n_keep: int):
    """Sort the merged PQ-space list by the assembled mid-stage dists
    (stable: merge-order ties kept) and trim to ``n_keep = rerank_mult
    * ef0``, the width the global Dist.H pass then pays."""
    dm = torch.where(mi >= 0, dm, INF)
    pd, pi = _rank_sort_with_payload(dm, torch.where(mi >= 0, mi, -1))
    return pd[:, :n_keep], pi[:, :n_keep]


def _global_rerank(md, mi, dh, ef0: int):
    """Sort the merged list by the assembled high-dim dists (stable on
    ties) and trim to ef0."""
    dh = torch.where(mi >= 0, dh, INF)
    rd, ri = _rank_sort_with_payload(dh, torch.where(mi >= 0, mi, -1))
    return rd[:, :ef0], ri[:, :ef0]


def _normalize(sdb: ShardedDB, ef0, k_schedule, deferred, rerank_mult,
               promote_mult=None):
    """Defaults and the reference's no-op normalisation, as in
    ``search_batched``."""
    cfg = sdb.cfg
    ef0 = int(ef0 or cfg.ef0)
    if deferred is None:
        deferred = cfg.deferred_rerank
    ks = tuple(k_schedule
               or cfg.k_schedule_for(sdb.filter_kind, bool(deferred)))
    if rerank_mult is None:
        rerank_mult = cfg.rerank_mult
    if promote_mult is None:
        promote_mult = cfg.promote_mult
    if sdb.filter_kind == "none":
        deferred = False
    if not deferred:
        rerank_mult = 1
    if not (deferred and sdb.filter_kind == "cascade"):
        promote_mult = 1          # dead knob outside the cascade
    else:
        # the promote pool is never narrower than the re-rank pool
        promote_mult = max(int(promote_mult), int(rerank_mult))
    return ef0, ks, bool(deferred), int(rerank_mult), int(promote_mult)


@dataclass
class _Owner:
    """One live shard's side of the global promote and re-rank: its rows,
    its ownership span and the batch's queries (and, for the cascade,
    their PCA projection), all on the shard's device."""
    high: torch.Tensor
    low2: Optional[torch.Tensor]
    offset: int
    count: int
    queries: torch.Tensor
    qpca: Optional[torch.Tensor]


def _owners(sdb: ShardedDB, live, queries, qprep, cascade: bool) -> list:
    """The ``_Owner`` of every live shard of ``sdb``, on the db's device."""
    qpca = _cascade_qpca(qprep, sdb.low.shape[-1]) if cascade else None
    return [_Owner(sdb.high[s], None if sdb.low2 is None else sdb.low2[s],
                   int(sdb.offsets[s]), int(sdb.counts[s]), queries, qpca)
            for s in np.nonzero(live)[0]]


def _merge_and_rerank(fds, gis, owners, *, ef0: int, deferred: bool,
                      cascade: bool, rerank_mult: int):
    """The merge, the global promote (deferred cascade) and the global
    re-rank (deferred) over per-shard lists on one device whose dead
    shards are already (INF, -1). The merged ids go to each live
    shard's device (``owners``), and its owned contributions come back
    and are summed in shard order."""
    md, mi = _merge_lists(torch.stack(fds), torch.stack(gis),
                          fds[0].shape[1])
    dev = md.device
    if cascade:
        dm = torch.zeros_like(md)
        for o in owners:
            dm = dm + _owned_dist_mid(o.low2, o.offset, o.count,
                                      mi.to(o.high.device), o.qpca).to(dev)
        md, mi = _global_promote(mi, dm, ef0 * rerank_mult)
    if deferred:
        dh = torch.zeros_like(md)
        for o in owners:
            dh = dh + _owned_dist_h(o.high, o.offset, o.count,
                                    mi.to(o.high.device), o.queries).to(dev)
        return _global_rerank(md, mi, dh, ef0)
    return md, mi


def _list_width(sdb: ShardedDB, ef0: int, deferred: bool, rm: int,
                pm: int) -> int:
    """E, the width of every shard's pre-merge list."""
    if not deferred:
        return ef0
    return ef0 * (pm if sdb.filter_kind == "cascade" else rm)


def _prepare_qprep(sdb: ShardedDB, queries, q_low, filt):
    if q_low is not None:
        return torch.as_tensor(q_low, dtype=torch.float32,
                               device=sdb.device)
    if filt is not None:
        if filt.kind != sdb.filter_kind:
            raise ValueError(f"filter mismatch: sharded db carries a "
                             f"{sdb.filter_kind!r} payload, filt is "
                             f"{filt.kind!r}")
        return filt.prepare_torch(queries)
    if sdb.filter_kind == "none":
        return queries[:, :0]
    raise ValueError("q_low or filt required for the "
                     f"{sdb.filter_kind!r} filter")


def _norm_live(sdb: ShardedDB, live) -> np.ndarray:
    """[P] bool live mask on the host (default: every shard lives)."""
    if live is None:
        return np.ones(sdb.n_shards, bool)
    lv = np.asarray(live, bool).reshape(-1)
    if lv.shape != (sdb.n_shards,):
        raise ValueError(f"live mask of shape {lv.shape}, expected "
                         f"({sdb.n_shards},)")
    return lv


def shard_live_counts(sdb: ShardedDB) -> np.ndarray:
    """[P] live (owned, non-tombstoned) row counts per shard: each
    shard's ownership span minus the tombstone bits inside it (pad slots
    lie outside the span)."""
    counts = np.asarray(sdb.counts, np.int64)
    if sdb.deleted is None:
        return counts
    words = sdb.deleted.cpu().numpy().astype(np.uint32)     # [P, nw]
    bits = np.unpackbits(words.view(np.uint8), axis=1,
                         bitorder="little")                 # [P, nw*32]
    dead_in_span = np.array([int(bits[s, :counts[s]].sum())
                             for s in range(len(counts))], np.int64)
    return counts - dead_in_span


def coverage_stats(sdb: ShardedDB, live) -> dict:
    """The degraded-mode accounting of ``return_stats``: ``coverage`` =
    the fraction of the index's live vectors reachable through the
    surviving shards (exact, tombstone-aware), plus the raw mask and
    counts."""
    lc = shard_live_counts(sdb)
    lv = np.ones(sdb.n_shards, bool) if live is None \
        else _norm_live(sdb, live)
    total = int(lc.sum())
    reach = int(lc[lv].sum())
    return {"coverage": reach / max(total, 1),
            "degraded": bool(~lv.all()),
            "live_shards": int(lv.sum()),
            "n_shards": sdb.n_shards,
            "live_mask": lv,
            "reachable": reach, "total_live": total}


def shard_search_host(sdb: ShardedDB, queries, q_low=None, *, filt=None,
                      ef0: int = 0, k_schedule=None,
                      deferred: Optional[bool] = None,
                      rerank_mult: Optional[int] = None,
                      promote_mult: Optional[int] = None,
                      live=None, return_stats: bool = False,
                      device="cuda"):
    """Sharded batched search on one device: a loop over the shards,
    then the merge, the global promote (deferred cascade) and the global
    re-rank (deferred). queries: [B, D] (numpy or tensor; moved to the
    db's device, which must be ``device``); ``q_low`` is the filter's
    per-query prep (or pass ``filt``; the identity filter needs
    neither). Returns (dists [B, ef0], GLOBAL idx [B, ef0]); on one shard
    it equals ``search_batched`` in every filter and re-rank mode.
    ``live`` ([P] bool, optional) serves DEGRADED from the surviving
    shards only; with ``return_stats`` a third element carries the
    ``coverage_stats`` dict."""
    _check_device(sdb, device)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=sdb.device)
    qprep = _prepare_qprep(sdb, queries, q_low, filt)
    ef0, ks, deferred, rm, pm = _normalize(sdb, ef0, k_schedule,
                                           deferred, rerank_mult,
                                           promote_mult)
    lv = _norm_live(sdb, live)
    _search_keys["host"].add(_key((sdb, queries, qprep), dict(
        ef0=ef0, ks=ks, deferred=deferred, rm=rm, pm=pm)))
    B = queries.shape[0]
    E = _list_width(sdb, ef0, deferred, rm, pm)
    fds, gis = [], []
    for s in range(sdb.n_shards):
        if lv[s]:
            fd, gi = _shard_lists(sdb.shard_db(s), int(sdb.offsets[s]),
                                  queries, qprep, ef0=ef0, ks=ks,
                                  deferred=deferred, rerank_mult=rm,
                                  promote_mult=pm)
        else:
            # a dead shard's lists are (INF, -1): it is not searched
            fd = torch.full((B, E), INF, dtype=torch.float32,
                            device=sdb.device)
            gi = torch.full((B, E), -1, dtype=torch.int32,
                            device=sdb.device)
        fds.append(fd)
        gis.append(gi)
    cascade = deferred and sdb.filter_kind == "cascade"
    fd, fi = _merge_and_rerank(fds, gis,
                               _owners(sdb, lv, queries, qprep, cascade),
                               ef0=ef0, deferred=deferred, cascade=cascade,
                               rerank_mult=rm)
    if return_stats:
        return fd, fi, coverage_stats(sdb, lv)
    return fd, fi


# ---------------------------------------------------------------------------
# the collective path over a device mesh
# ---------------------------------------------------------------------------

# the mesh's axes: the batch axes (row-major in this order), then the
# shard axis, as the reference's ``b_ax`` and ``"model"``
MESH_AXES = ("pod", "data", "model")


def _as_device(d) -> torch.device:
    """``d`` as a torch.device with its index (a bare "cuda" is the
    current card), so that it compares equal to a tensor's device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _placed_db(sdb: ShardedDB, s: int, dev: torch.device) -> PackedDB:
    """Shard ``s`` of ``sdb`` on ``dev``: views into the stacks where
    ``dev`` is the db's own device, copies elsewhere."""
    db = sdb.shard_db(s)
    if dev == sdb.device:
        return db
    mv = lambda t: None if t is None else t.to(dev)
    return dataclasses.replace(
        db, layers=[PackedLayer(adj=mv(l.adj), packed_low=mv(l.packed_low))
                    for l in db.layers],
        low=mv(db.low), high=mv(db.high), deleted=mv(db.deleted),
        low2=mv(db.low2))


@dataclass(eq=False)
class Mesh:
    """A grid of ``torch.device``s with named axes (the port's
    ``jax.sharding.Mesh``; build one with ``make_mesh``). ``devices`` is
    an object array with one axis per name in ``axis_names``. A device
    may appear more than once: several shards then share it."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    _placed: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def key(self) -> tuple:
        """The mesh as plain data (axes, shape, devices)."""
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def grid(self) -> np.ndarray:
        """The devices as [R, P]: one row per batch block (the "pod" and
        "data" axes, row-major), one column per shard ("model")."""
        order = [self.axis_names.index(a) for a in MESH_AXES
                 if a in self.axis_names]
        return self.devices.transpose(order).reshape(
            -1, self.shape["model"])

    def placement(self, sdb: ShardedDB) -> list:
        """[R][P] ``PackedDB``s: shard s of ``sdb`` on grid device (r,
        s), each (shard, device) placed once. Cached per db object (a
        new epoch is a new object) until that object is collected."""
        hit = self._placed.get(id(sdb))
        if hit is not None and hit[0]() is sdb:
            return hit[1]
        grid = self.grid()
        by_dev = {}
        for (r, s), dev in np.ndenumerate(grid):
            if (s, dev) not in by_dev:
                by_dev[(s, dev)] = _placed_db(sdb, s, dev)
        placed = [[by_dev[(s, grid[r, s])] for s in range(grid.shape[1])]
                  for r in range(grid.shape[0])]
        self._placed[id(sdb)] = (weakref.ref(sdb), placed)
        weakref.finalize(sdb, self._placed.pop, id(sdb), None)
        return placed


def make_mesh(axis_shapes, axis_names, *, devices=None) -> Mesh:
    """A ``Mesh`` of ``prod(axis_shapes)`` devices laid out row-major
    over ``axis_names`` (as ``jax.make_mesh``); the names come from
    ``MESH_AXES`` and include "model", the shard axis. By default the
    first cards of ``torch.cuda.device_count()``: too few raise, the CPU
    never stands in for a missing card. ``devices`` names them
    explicitly and may repeat one (four shards on one card, or on
    "cpu")."""
    shape = tuple(int(n) for n in axis_shapes)
    names = tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} do "
                         f"not pair up")
    if "model" not in names or not set(names) <= set(MESH_AXES):
        raise ValueError(f"mesh axes {names}: expected names from "
                         f"{MESH_AXES}, including 'model'")
    if min(shape) < 1:
        raise ValueError(f"mesh shape {shape} has an empty axis")
    n = int(np.prod(shape))
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if have < n:
            raise ValueError(f"a mesh of shape {shape} needs {n} cards, "
                             f"{have} found; pass devices= to put several "
                             f"shards on one device")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [_as_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"{len(devs)} devices for a mesh of shape "
                         f"{shape}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return Mesh(grid.reshape(shape), names)


def distributed_search(mesh: Mesh, sdb: ShardedDB, queries, q_low=None,
                       *, filt=None, ef0: int = 0, k_schedule=None,
                       deferred: Optional[bool] = None,
                       rerank_mult: Optional[int] = None,
                       promote_mult: Optional[int] = None,
                       live=None, return_stats: bool = False):
    """Sharded batched search over ``mesh``. queries: [B, D] global (numpy
    or tensor), cut into contiguous blocks over the mesh's batch axes (B
    must divide); ``q_low`` is the filter's per-query prep (or pass
    ``filt``; the identity filter needs neither). Shard s of block r
    runs on grid device (r, s) (``Mesh.grid``), the searches of every
    block and live shard in lockstep; each block's lists are merged, and
    promoted and re-ranked when deferred, on the block's first device.
    Returns (dists [B, ef0], GLOBAL idx [B, ef0]) on the mesh's first
    device, bit-equal to ``shard_search_host`` on each block. ``live``
    ([P] bool) serves DEGRADED from the surviving shards (a dead shard is
    not searched); ``return_stats`` adds the ``coverage_stats`` dict.
    The mesh's "model" axis must have one device per shard."""
    grid = mesh.grid()
    R, Pm = grid.shape
    if Pm != sdb.n_shards:
        raise ValueError(f"the mesh's 'model' axis has {Pm} devices, the "
                         f"db {sdb.n_shards} shards")
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=sdb.device)
    B = queries.shape[0]
    if B % R:
        raise ValueError(f"{B} queries do not split into the mesh's {R} "
                         f"batch blocks")
    qprep = _prepare_qprep(sdb, queries, q_low, filt)
    ef0, ks, deferred, rm, pm = _normalize(sdb, ef0, k_schedule,
                                           deferred, rerank_mult,
                                           promote_mult)
    lv = _norm_live(sdb, live)
    _search_keys["mesh"].add(_key((sdb, queries, qprep), dict(
        mesh=mesh.key, ef0=ef0, ks=ks, deferred=deferred, rm=rm, pm=pm)))
    cascade = deferred and sdb.filter_kind == "cascade"
    placed = mesh.placement(sdb)
    b = B // R
    E = _list_width(sdb, ef0, deferred, rm, pm)
    alive = np.nonzero(lv)[0]
    tasks = [(r, s) for r in range(R) for s in alive]
    # block r's queries and prep on the device of each of its live shards
    blk = {(r, s): (queries[r * b:(r + 1) * b].to(grid[r, s]),
                    qprep[r * b:(r + 1) * b].to(grid[r, s]))
           for r, s in tasks}
    lists = dict(zip(tasks, _lockstep([
        _shard_lists_gen(placed[r][s], int(sdb.offsets[s]), *blk[r, s],
                         ef0=ef0, ks=ks, deferred=deferred,
                         rerank_mult=rm, promote_mult=pm)
        for r, s in tasks])))
    fds, fis = [], []
    for r in range(R):
        dev = grid[r, 0]
        fd_r = [torch.full((b, E), INF, dtype=torch.float32, device=dev)
                for _ in range(Pm)]
        gi_r = [torch.full((b, E), -1, dtype=torch.int32, device=dev)
                for _ in range(Pm)]
        owners = []
        for s in alive:
            fd_r[s], gi_r[s] = (t.to(dev) for t in lists[r, s])
            q, qp = blk[r, s]
            owners.append(_Owner(
                placed[r][s].high, placed[r][s].low2, int(sdb.offsets[s]),
                int(sdb.counts[s]), q,
                _cascade_qpca(qp, sdb.low.shape[-1]) if cascade else None))
        fd, fi = _merge_and_rerank(fd_r, gi_r, owners, ef0=ef0,
                                   deferred=deferred, cascade=cascade,
                                   rerank_mult=rm)
        fds.append(fd.to(grid[0, 0]))
        fis.append(fi.to(grid[0, 0]))
    fd, fi = torch.cat(fds), torch.cat(fis)
    if return_stats:
        return fd, fi, coverage_stats(sdb, lv)
    return fd, fi


# the distinct (static arguments, shapes) keys each search program has
# been called with: the counterpart of the reference's compiled-program
# caches, which kill / recover cycles and epoch swaps must not grow
_search_keys = {name: set() for name in ("mesh", "host", "probe",
                                         "merge")}


def search_cache_sizes() -> Tuple[int, int]:
    """(mesh, host): the distinct keys ``distributed_search`` and
    ``shard_search_host`` have been called with."""
    return len(_search_keys["mesh"]), len(_search_keys["host"])


# ---------------------------------------------------------------------------
# the resilient per-shard path: probe shards ONE AT A TIME so a failure
# costs exactly that shard's attempt, then merge whatever answered
# ---------------------------------------------------------------------------

def probe_shard(sdb: ShardedDB, s: int, queries, qprep, *, ef0: int = 0,
                k_schedule=None, deferred: Optional[bool] = None,
                rerank_mult: Optional[int] = None,
                promote_mult: Optional[int] = None, span=None
                ) -> Tuple[np.ndarray, np.ndarray, float]:
    """ONE shard's pre-merge candidate lists, timed and fault-injectable
    (``repro_torch.distributed.faults``: kill raises, stall sleeps,
    corrupt garbles the return). Returns (fd [B, E], gi [B, E] GLOBAL
    ids, wall seconds) on the host; the wall time feeds a straggler
    monitor. ``span`` (optional; anything with an ``event(name,
    **fields)`` method) receives a ``probe`` event with the wall time."""
    from repro_torch.distributed import faults as _faults
    ef0, ks, deferred, rm, pm = _normalize(sdb, ef0, k_schedule,
                                           deferred, rerank_mult,
                                           promote_mult)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=sdb.device)
    qprep = torch.as_tensor(qprep, dtype=torch.float32, device=sdb.device)
    _search_keys["probe"].add(_key((sdb, queries, qprep), dict(
        ef0=ef0, ks=ks, deferred=deferred, rm=rm, pm=pm)))
    plan = _faults.active()
    # the wall clock starts BEFORE the fault hook: an injected stall is
    # latency the coordinator observed
    t0 = time.monotonic()
    if plan is not None:
        plan.shard_query_hook(s)
    fd, gi = _shard_lists(sdb.shard_db(s), int(sdb.offsets[s]), queries,
                          qprep, ef0=ef0, ks=ks, deferred=deferred,
                          rerank_mult=rm, promote_mult=pm)
    if sdb.device.type == "cuda":
        torch.cuda.synchronize(sdb.device)
    wall = time.monotonic() - t0
    fd, gi = fd.cpu().numpy(), gi.cpu().numpy()
    if plan is not None:
        fd, gi = plan.corrupt_hook(s, fd, gi)
    if span is not None:
        span.event("probe", shard=s, wall_ms=wall * 1e3)
    return fd, gi, wall


def check_shard_result(fd: np.ndarray, gi: np.ndarray, offset: int,
                       count: int) -> bool:
    """Merge-boundary integrity check of one shard's candidate lists:
    distances not NaN, non-negative and ascending; ids either -1 (empty
    slot) or inside the shard's global ownership range. A shard failing
    it is treated as a ``ShardCorruptError``: its answer never reaches
    the merge."""
    fd = np.asarray(fd)
    gi = np.asarray(gi)
    if np.isnan(fd).any() or (fd < 0).any():
        return False
    if (np.diff(fd, axis=1) < 0).any():
        return False
    ok = (gi == -1) | ((gi >= offset) & (gi < offset + count))
    return bool(ok.all())


def merge_surviving(sdb: ShardedDB, fd_all, gi_all, live, queries, *,
                    qprep=None, ef0: int = 0, k_schedule=None,
                    deferred: Optional[bool] = None,
                    rerank_mult: Optional[int] = None,
                    promote_mult: Optional[int] = None):
    """Complete a request from the shards that answered: merge the
    stacked per-shard lists ([P, B, E]; dead or unanswered rows may hold
    anything, they are masked to (INF, -1) first) and run the global
    promote (deferred cascade; needs ``qprep``, the prep handed to
    ``probe_shard``) and the deferred global re-rank over the
    survivors. Returns ([B, ef0] dists, [B, ef0] GLOBAL ids), equal to
    ``shard_search_host(live=live)``."""
    ef0, ks, deferred, rm, pm = _normalize(sdb, ef0, k_schedule,
                                           deferred, rerank_mult,
                                           promote_mult)
    if deferred and sdb.filter_kind == "cascade" and qprep is None:
        raise ValueError("the deferred cascade merge needs qprep")
    lv = _norm_live(sdb, live)
    dev = sdb.device
    fd_all = torch.as_tensor(np.asarray(fd_all), dtype=torch.float32,
                             device=dev)
    gi_all = torch.as_tensor(np.asarray(gi_all), dtype=torch.int32,
                             device=dev)
    alive = torch.as_tensor(lv, device=dev)[:, None, None]
    fd_all = torch.where(alive, fd_all, INF)
    gi_all = torch.where(alive, gi_all, -1)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    if qprep is not None:
        qprep = torch.as_tensor(qprep, dtype=torch.float32, device=dev)
    cascade = deferred and sdb.filter_kind == "cascade"
    _search_keys["merge"].add(_key((fd_all, queries), dict(
        ef0=ef0, deferred=deferred, cascade=cascade, rerank_mult=rm)))
    return _merge_and_rerank(list(fd_all), list(gi_all),
                             _owners(sdb, lv, queries, qprep, cascade),
                             ef0=ef0, deferred=deferred, cascade=cascade,
                             rerank_mult=rm)


def resilient_cache_sizes() -> Tuple[int, int]:
    """(probe, merge): the distinct keys ``probe_shard`` and
    ``merge_surviving`` have been called with."""
    return len(_search_keys["probe"]), len(_search_keys["merge"])
