"""Sharded mutable pHNSW index: P shard-local ``MutableIndex``es behind
one mutable, globally-addressed front (port of
``repro/index/sharded.py``).

* **Global id space.** ``gid = shard * stride + local`` with ``stride``
  = the uniform per-shard buffer capacity (a power of two). Owner
  lookup is a divide — no routing table to keep consistent.
* **Routing.** Deletes and replace-upserts go to the owner shard
  (``gid // stride``); fresh inserts round-robin across shards
  (deterministic, keeps shards balanced).
* **Publication.** Every mutation republishes a stacked ``ShardedDB``
  (the per-shard device tensors stacked along a leading P dim — a
  copy, so earlier epochs stay frozen) under a bumped ``epoch``.
  Growth on ANY shard grows ALL shards (the stride must stay uniform)
  and RENUMBERS global ids: ``reserve()`` up front, as for
  ``MutableIndex``.
* **Compaction** is deliberately NOT auto-triggered (it would renumber
  one shard's local ids and corrupt the global id space mid-traffic);
  ``delete`` always runs shard-local ``auto_compact=False``.

Search runs ``core/distributed.shard_search_host`` on the index's
device, or ``distributed_search`` over a device mesh when ``mesh=`` is
given.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import PHNSWConfig
from repro_torch.core.distributed import (ShardedDB, distributed_search,
                                          shard_bounds, shard_search_host)
from repro_torch.core.filters import FilterSpec, make_filter
from repro_torch.core.graph import build_hnsw
from repro_torch.data.vectors import brute_force_topk
from repro_torch.distributed import faults as _faults
from repro_torch.index.mutable import (MutableIndex, read_snapshot,
                                       write_snapshot)
from repro_torch.obs.trace import NULL_SPAN

class ShardedMutableIndex:
    """P shard-local mutable indexes + one stacked device snapshot."""

    def __init__(self, shards: Sequence[MutableIndex], filt: FilterSpec,
                 cfg: PHNSWConfig):
        if not shards:
            raise ValueError("a sharded index needs at least one shard")
        self.shards: List[MutableIndex] = list(shards)
        if len({s.device for s in self.shards}) != 1:
            raise ValueError("every shard must live on one device")
        self.device = self.shards[0].device
        self.filt = filt
        self.cfg = cfg
        self.epoch = 0
        self._rr = 0                      # round-robin insert cursor
        self._align_capacity()
        self._publish()

    @classmethod
    def build(cls, x: np.ndarray, cfg: PHNSWConfig, n_shards: int, *,
              seed: int = 0, filt: Optional[FilterSpec] = None,
              builder: Optional[str] = None,
              device="cuda") -> "ShardedMutableIndex":
        """Fit ONE shared filter on the full dataset, partition
        (remainder spread over the first shards), and build each shard's
        graph (its probe on ``device``) + mutable index."""
        filt = filt or make_filter(cfg, x, seed=seed)
        shards = []
        for s, (a, b) in enumerate(shard_bounds(len(x), n_shards)):
            g = build_hnsw(x[a:b], cfg, seed=seed + s, builder=builder,
                           device=device)
            shards.append(MutableIndex.from_graph(
                g, filt, seed=seed + 101 * s + 1, device=device))
        return cls(shards, filt, cfg)

    # ------------------------------------------------------------------
    # id space / aggregates
    # ------------------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def stride(self) -> int:
        """Global-id stride = the uniform per-shard capacity. Changes
        only on capacity growth (which renumbers global ids)."""
        return self.shards[0].cap

    @property
    def n_live(self) -> int:
        return sum(s.n_live for s in self.shards)

    @property
    def tombstone_frac(self) -> float:
        n = sum(s.n for s in self.shards)
        return sum(s.n_deleted for s in self.shards) / max(n, 1)

    @property
    def sdb(self) -> ShardedDB:
        """The current epoch's stacked device snapshot."""
        return self._sdb

    def owner(self, gids: np.ndarray) -> np.ndarray:
        return np.asarray(gids, np.int64) // self.stride

    def live_global_ids(self) -> np.ndarray:
        """Global ids of live nodes across all shards, ascending."""
        return np.concatenate([s.live_ids() + i * self.stride
                               for i, s in enumerate(self.shards)])

    # the mutable-index surface, with GLOBAL ids
    live_ids = live_global_ids

    def pca_drift(self) -> dict:
        """The WORST per-shard drift report (every shard shares one
        frozen filter, so any shard crossing the refit threshold means
        the global projection needs a refit), with the per-shard
        reports attached."""
        reps = [s.pca_drift() for s in self.shards]
        worst = max(reps, key=lambda r: r["drift"] or 0.0)
        return {**worst, "per_shard": reps}

    def live_ground_truth(self, q: np.ndarray, at: int) -> np.ndarray:
        """Exact top-``at`` over the global LIVE set, as GLOBAL ids."""
        gids = self.live_global_ids()
        x = np.concatenate([s.x[s.live_ids()] for s in self.shards])
        return gids[brute_force_topk(x, q, at)]

    def is_deleted(self, gids: np.ndarray) -> np.ndarray:
        """Tombstone flags for global ids (pad slots count as deleted)."""
        gids = np.asarray(gids, np.int64)
        sh, loc = gids // self.stride, gids % self.stride
        return np.array([self.shards[int(s)].deleted[int(l)]
                         for s, l in zip(sh.ravel(), loc.ravel())],
                        bool).reshape(gids.shape)

    # ------------------------------------------------------------------
    # capacity / publication
    # ------------------------------------------------------------------

    def _align_capacity(self) -> None:
        cap = max(s.cap for s in self.shards)
        for s in self.shards:
            if s.cap < cap:
                s.reserve(cap)

    def reserve(self, per_shard_capacity: int) -> None:
        """Pre-grow EVERY shard (the stride must stay uniform): pay the
        growth and the global-id renumbering now, before traffic."""
        for s in self.shards:
            s.reserve(per_shard_capacity)
        self._align_capacity()
        self._publish()

    def _publish(self, span=NULL_SPAN) -> None:
        """Stack the per-shard device snapshots into a new epoch's
        ShardedDB (``torch.stack`` copies: the new epoch shares no
        storage with the shards' or earlier epochs' tensors). An
        installed ``FaultPlan``'s ``delay_swap`` event stretches the
        window between mutation and publication (readers keep the
        previous epoch; a trace span records the injected delay as a
        ``delay_swap`` event)."""
        pub = span.child("publish", epoch=self.epoch + 1)
        plan = _faults.active()
        if plan is not None:
            slept = plan.swap_delay_hook()
            if slept > 0.0:
                pub.event("delay_swap", seconds=slept)
        n_pub = max(s.top for s in self.shards) + 1
        per = [s.device_layers(n_pub) for s in self.shards]
        stride = self.stride
        Pn = self.n_shards
        self.epoch += 1
        self._sdb = ShardedDB(
            adj=[torch.stack([adj[l] for adj, _ in per])
                 for l in range(n_pub)],
            packed_low=[torch.stack([pck[l] for _, pck in per])
                        for l in range(n_pub)],
            low=torch.stack([s._dev_low for s in self.shards]),
            high=torch.stack([s._dev_high for s in self.shards]),
            entries=np.asarray([s.entry for s in self.shards], np.int32),
            offsets=np.asarray([i * stride for i in range(Pn)], np.int32),
            counts=np.asarray([stride] * Pn, np.int32),
            cfg=self.cfg,
            deleted=torch.stack([s._dev_deleted for s in self.shards]),
            low2=None if self.shards[0]._dev_low2 is None else
            torch.stack([s._dev_low2 for s in self.shards]),
            filter_kind=self.filt.kind,
        )
        pub.set(n_layers=n_pub)
        pub.end()

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def upsert(self, xs: np.ndarray,
               ids: Optional[np.ndarray] = None, *,
               span=NULL_SPAN) -> np.ndarray:
        """Insert vectors (with ``ids``: tombstone those global ids
        first — replace semantics). Fresh inserts round-robin across
        shards. Returns the new GLOBAL ids, aligned with ``xs``. If any
        shard had to grow, ALL shards grow and previously handed-out
        global ids are renumbered (reserve() up front to avoid).
        ``span`` records per-shard routing events and the publish."""
        if ids is not None:
            # publish once at the end — the intermediate post-delete
            # snapshot would never be served
            self._delete(ids, span=span)
        xs = np.asarray(xs, np.float32)
        Pn = self.n_shards
        assign = (self._rr + np.arange(len(xs))) % Pn
        self._rr = (self._rr + len(xs)) % Pn
        plan = _faults.active()
        locs = {}
        for s in range(Pn):
            m = assign == s
            if m.any():
                # a killed shard rejects its slice BEFORE any shard
                # state changes for it (typed ShardKilledError; slices
                # already applied to healthy shards stay applied — the
                # caller retries the batch or reroutes)
                if plan is not None:
                    plan.shard_mutation_hook(s)
                span.event("route_upsert", shard=s, n=int(m.sum()))
                locs[s] = (m, self.shards[s].upsert(xs[m]))
        # gids are computed AFTER the post-insert capacity alignment so
        # a mid-batch growth can't hand out ids under a stale stride
        self._align_capacity()
        stride = self.stride
        gids = np.empty(len(xs), np.int64)
        for s, (m, loc) in locs.items():
            gids[m] = s * stride + loc
        self._publish(span=span)
        return gids

    def delete(self, gids: np.ndarray, *, span=NULL_SPAN) -> int:
        """Tombstone global ids on their owner shards (idempotent,
        out-of-range ids ignored). Returns the number newly deleted.
        Never auto-compacts (compaction would renumber the global id
        space)."""
        n = self._delete(gids, span=span)
        if n:
            self._publish(span=span)
        return n

    def _delete(self, gids: np.ndarray, *, span=NULL_SPAN) -> int:
        """Shard-local tombstoning without the snapshot publish."""
        gids = np.atleast_1d(np.asarray(gids, np.int64))
        stride = self.stride
        plan = _faults.active()
        n = 0
        for s in range(self.n_shards):
            m = (gids >= 0) & (gids // stride == s)
            if m.any():
                if plan is not None:
                    plan.shard_mutation_hook(s)
                span.event("route_delete", shard=s, n=int(m.sum()))
                n += self.shards[s].delete(gids[m] % stride,
                                           auto_compact=False)
        return n

    # ------------------------------------------------------------------
    # snapshot (one npz for all shards)
    # ------------------------------------------------------------------

    def save(self, path) -> None:
        """Snapshot EVERY shard plus the global-id bookkeeping into one
        npz (per-shard arrays live under an ``s{i}_`` prefix), sealed by
        the same integrity envelope as ``MutableIndex.save``."""
        arrays = {"n_shards": np.int64(self.n_shards),
                  "rr": np.int64(self._rr),
                  "sharded_epoch": np.int64(self.epoch)}
        for i, s in enumerate(self.shards):
            for k, v in s._snapshot_arrays().items():
                arrays[f"s{i}_{k}"] = v
        write_snapshot(path, arrays)

    @classmethod
    def load(cls, path, cfg: PHNSWConfig, *, seed: int = 0,
             device="cuda") -> "ShardedMutableIndex":
        """Restore a ``save``d sharded index (the reference's too) onto
        ``device`` (``SnapshotCorruptError`` on integrity failure).
        Per-shard rng seeds are re-derived exactly as ``build`` derives
        them, so a restored index draws the same insert levels as one
        that lived through the same history from the same seed."""
        z = read_snapshot(path)
        Pn = int(z["n_shards"])
        shards = []
        for i in range(Pn):
            pre = f"s{i}_"
            zi = {k[len(pre):]: v for k, v in z.items()
                  if k.startswith(pre)}
            shards.append(MutableIndex._from_arrays(
                zi, cfg, seed=seed + 101 * i + 1, device=device))
        idx = cls(shards, shards[0].filt, cfg)
        idx._rr = int(z["rr"])
        idx.epoch = int(z["sharded_epoch"])
        return idx

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def search(self, queries: np.ndarray, *, mesh=None, **kw):
        """Batched sharded search over the current epoch: the collective
        path over ``mesh`` (a ``core.distributed.Mesh``) when given, the
        bit-equal shard loop on the index's device otherwise. Returns
        ([B, ef0] dists, [B, ef0] GLOBAL ids) tensors."""
        if mesh is not None:
            return distributed_search(mesh, self._sdb, queries,
                                      filt=self.filt, **kw)
        return shard_search_host(self._sdb, queries, filt=self.filt,
                                 device=self.device, **kw)
