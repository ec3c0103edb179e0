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
shards as a ``ShardedDB`` and searches it through this path. The
collective path over several devices (``distributed_search``) is not
ported yet (ROADMAP.md A8).
"""
from __future__ import annotations

import dataclasses
import time
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
                                           _gather_rows,
                                           _rank_sort_with_payload,
                                           _search_batched_impl,
                                           build_packed, pack_bitmap,
                                           tensor_from_numpy)
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
    fd, fi, _, _ = _search_batched_impl(
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


def _merge_and_rerank(sdb: ShardedDB, fds, gis, live, queries, qprep, *,
                      ef0: int, deferred: bool, rerank_mult: int):
    """The merge, the global promote (deferred cascade) and the global
    re-rank (deferred) over per-shard lists whose dead shards are
    already (INF, -1); the owned contributions of the live shards are
    summed in shard order."""
    md, mi = _merge_lists(torch.stack(fds), torch.stack(gis),
                          fds[0].shape[1])
    if deferred and sdb.filter_kind == "cascade":
        qpca = _cascade_qpca(qprep, sdb.low.shape[-1])
        dm = torch.zeros_like(md)
        for s in np.nonzero(live)[0]:
            dm = dm + _owned_dist_mid(sdb.low2[s], int(sdb.offsets[s]),
                                      int(sdb.counts[s]), mi, qpca)
        md, mi = _global_promote(mi, dm, ef0 * rerank_mult)
    if deferred:
        dh = torch.zeros_like(md)
        for s in np.nonzero(live)[0]:
            dh = dh + _owned_dist_h(sdb.high[s], int(sdb.offsets[s]),
                                    int(sdb.counts[s]), mi, queries)
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
    fd, fi = _merge_and_rerank(sdb, fds, gis, lv, queries, qprep, ef0=ef0,
                               deferred=deferred, rerank_mult=rm)
    if return_stats:
        return fd, fi, coverage_stats(sdb, lv)
    return fd, fi


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
    return _merge_and_rerank(sdb, list(fd_all), list(gi_all), lv, queries,
                             qprep, ef0=ef0, deferred=deferred,
                             rerank_mult=rm)
