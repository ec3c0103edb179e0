"""Mutable pHNSW index: online upserts, tombstone deletes, compaction,
snapshot/restore (port of ``repro/index/mutable.py``).

A living index on top of the packed layout-(3) ``PackedDB``, as in the
reference:

* **Capacity padding.** All buffers are allocated at a power-of-two
  capacity (``>= cfg.min_capacity``). Inserts fill pre-allocated slots;
  only when capacity is exhausted do the buffers double. Pad slots have
  no adjacency (never traversed) and are marked in the tombstone bitmap
  (never returned).
* **Batched insert.** A new vector's ef_construction neighborhood is
  found on the device by the search's own kernels
  (``search_torch.probe_neighborhoods``), one probe per insert
  sub-batch padded to ``cfg.insert_batch``; the host then links the
  whole batch at once with the vectorized diversity heuristic
  (``core/build.link_wave``), and the adjacency rows that changed are
  refreshed with their layout-(3) payload.
* **Tombstone deletes.** Deletes flip a bit in the word-packed bitmap
  that ships with the ``PackedDB``; deleted nodes keep routing traffic
  but are never returned.
* **Compaction.** Dead neighbours are replaced by live 2-hop candidates
  under the diversity heuristic, ids are remapped dense and the buffers
  reallocated at the shrunk capacity; a PCA-drift report says whether
  the frozen projection still captures the live distribution.
* **Snapshot/restore.** The whole index round-trips through one
  ``.npz`` under an integrity envelope, with the reference's array
  names, dtypes and shapes: a snapshot written by either package loads
  in the other, with the same checksum.

Every mutation publishes a NEW ``PackedDB`` under a bumped ``epoch``,
and a published tensor is never written again: refreshes build new
tensors (``Tensor.index_copy``, out of place), so a reader holding an
earlier epoch — a batch still running on the device included — keeps a
consistent frozen view, as the reference's functional arrays give it.
"""
from __future__ import annotations

import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import PHNSWConfig
from repro_torch.constants import INF
from repro_torch.core.build import link_wave, pairwise_sq
from repro_torch.core.filters import (CascadeFilter, FilterSpec,
                                      IdentityFilter, PCAFilter, PQFilter,
                                      make_filter)
from repro_torch.core.graph import (HNSWGraph, _select_heuristic,
                                    build_hnsw, sample_levels)
from repro_torch.core.pca import PCA
from repro_torch.core.pq import PQCodebook
from repro_torch.core.search_torch import (_TORCH_DTYPE, PackedDB,
                                           PackedLayer, pack_bitmap,
                                           probe_neighborhoods,
                                           search_batched)
from repro_torch.data.vectors import brute_force_topk
from repro_torch.distributed import faults as _faults
from repro_torch.distributed.faults import SnapshotCorruptError


def _as_filter(f, cfg: PHNSWConfig) -> FilterSpec:
    """Adopt a bare ``PCA`` as a ``PCAFilter``."""
    if isinstance(f, PCA):
        return PCAFilter(f, low_dtype=cfg.low_dtype)
    return f


def _next_pow2(n: int, floor: int) -> int:
    """Smallest power of two >= max(n, floor, 32). The floor itself is
    rounded up to a power of two — a non-pow2 ``cfg.min_capacity`` must
    not break the capacity invariant (doubling preserves any stray
    factor, and the bitmap packing needs 32 | cap)."""
    cap = 32
    while cap < max(int(floor), n):
        cap *= 2
    return cap


# --------------------------------------------------------------------------
# snapshot integrity envelope (shared by MutableIndex and the sharded
# snapshot)
# --------------------------------------------------------------------------

# bump on any change to the snapshot array schema; loads of a different
# version raise SnapshotCorruptError instead of mis-deserializing. Equal
# to the reference's: both packages read and write one schema.
SNAPSHOT_VERSION = 1


def snapshot_checksum(arrays: Dict[str, np.ndarray]) -> int:
    """Order-independent crc32 over every array's name, dtype, shape,
    and bytes (the ``checksum`` entry itself excluded)."""
    crc = 0
    for k in sorted(arrays):
        if k == "checksum":
            continue
        v = np.asarray(arrays[k])
        meta = f"{k}|{v.dtype.str}|{v.shape}".encode()
        crc = zlib.crc32(v.tobytes(), zlib.crc32(meta, crc))
    return crc & 0xFFFFFFFF


def write_snapshot(path, arrays: Dict[str, np.ndarray]) -> None:
    """One compressed npz with the integrity envelope
    (``format_version`` + content ``checksum``) stamped in. Honors an
    installed ``FaultPlan``'s truncate-snapshot event (after the write),
    so corruption detection runs on the real file path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = dict(arrays)
    arrays["format_version"] = np.int64(SNAPSHOT_VERSION)
    arrays["checksum"] = np.uint32(snapshot_checksum(arrays))
    np.savez_compressed(path, **arrays)
    plan = _faults.active()
    if plan is not None:
        plan.snapshot_hook(path)


def read_snapshot(path) -> Dict[str, np.ndarray]:
    """Load + verify an npz written by ``write_snapshot``. Raises
    ``SnapshotCorruptError`` on an unreadable/truncated file, a missing
    envelope, a format-version mismatch, or a content checksum
    mismatch — never garbage-deserializes."""
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: np.asarray(z[k]) for k in z.files}
    except OSError as e:
        raise SnapshotCorruptError(
            f"snapshot {path} is unreadable/truncated: {e}") from None
    except Exception as e:   # zlib/zip errors on partial members, etc.
        raise SnapshotCorruptError(
            f"snapshot {path} is unreadable/truncated "
            f"(failed to deserialize): {e}") from None
    if "format_version" not in arrays or "checksum" not in arrays:
        raise SnapshotCorruptError(
            f"snapshot {path} has no integrity envelope (pre-versioned "
            f"or foreign npz)")
    ver = int(arrays.pop("format_version"))
    if ver != SNAPSHOT_VERSION:
        raise SnapshotCorruptError(
            f"snapshot {path}: format version {ver} != supported "
            f"{SNAPSHOT_VERSION}")
    want = int(arrays.pop("checksum"))
    got = snapshot_checksum(
        {**arrays, "format_version": np.int64(ver)})
    if got != want:
        raise SnapshotCorruptError(
            f"snapshot {path}: checksum mismatch "
            f"(stored {want:#010x}, computed {got:#010x})")
    return arrays


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A COPY of host array ``a`` on ``device``: a published tensor must
    never alias the host mirrors the next mutation writes."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


class MutableIndex:
    """Mutable pHNSW index over capacity-padded device buffers.

    Host numpy mirrors hold the authoritative graph; ``device`` holds
    the packed layout-(3) snapshot published as ``self.db`` (a
    ``PackedDB``) under a monotonically increasing ``self.epoch``.
    """

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def __init__(self, cfg: PHNSWConfig, pca, x: np.ndarray,
                 x_low: np.ndarray, levels: np.ndarray,
                 adj: Sequence[np.ndarray], entry: int,
                 deleted: Optional[np.ndarray] = None, *, seed: int = 0,
                 epoch: int = 0, device="cuda"):
        """Build from UNPADDED arrays ([n] rows); pads to capacity and
        publishes on ``device``. ``pca`` may be a bare ``PCA`` or any
        ``FilterSpec``; ``x_low`` is that filter's payload rows. Prefer
        the ``from_graph`` / ``build`` / ``load`` classmethods."""
        n = len(x)
        cap = _next_pow2(n, cfg.min_capacity)
        self.cfg = cfg
        self.device = torch.device(device)
        self.filt = _as_filter(pca, cfg)
        # PCA handle (drift checks): the PCAFilter's projection, or the
        # cascade's mid-stage projection; None for the other kinds
        self.pca = getattr(self.filt, "pca", None)
        self.n, self.cap = n, cap
        self.entry = int(entry)
        self.epoch = epoch
        self.rng = np.random.default_rng(seed)
        D, dl = x.shape[1], x_low.shape[1]
        self.x = np.zeros((cap, D), np.float32)
        self.x[:n] = x
        # host mirror of the filter payload (dtype is the filter's: f32
        # low-dim rows for PCA, uint8 codes for PQ, width 0 for
        # identity), f32 whatever the device stores
        self.x_low = np.zeros((cap, dl), self.filt.payload_dtype)
        self.x_low[:n] = x_low
        # the cascade's mid-stage side-car (PCA rows scored by the
        # promote pass), recomputed from x; None for single-stage filters
        self.x_mid: Optional[np.ndarray] = None
        if hasattr(self.filt, "encode_mid"):
            xm = self.filt.encode_mid(x)
            self.x_mid = np.zeros((cap, xm.shape[1]), np.float32)
            self.x_mid[:n] = xm
        self.levels = np.full(cap, -1, np.int64)
        self.levels[:n] = levels
        # tombstones: real deletions in [:n]; pad slots are born deleted
        self.deleted = np.ones(cap, bool)
        self.deleted[:n] = deleted[:n] if deleted is not None else False
        self.n_deleted = int(self.deleted[:n].sum())
        self.adj: List[np.ndarray] = []
        for l in range(cfg.n_layers):
            a = np.full((cap, cfg.degree(l)), -1, np.int32)
            if l < len(adj):
                a[:n] = adj[l][:n]
            self.adj.append(a)
        self.top = max(int(self.levels[:n].max()), 0)
        # old-id -> new-id map of the most recent compaction (None until
        # one happens); compaction renumbers the public id space
        self.last_remap: Optional[np.ndarray] = None
        # (layer, cap) -> empty device layer, for device_layers()
        self._empty_layers: Dict = {}
        self._publish_full()

    @classmethod
    def from_graph(cls, g: HNSWGraph, pca, *, seed: int = 0,
                   device="cuda") -> "MutableIndex":
        """Adopt a one-shot ``build_hnsw`` graph as the mutable seed.
        ``pca``: a fitted ``PCA`` or any ``FilterSpec``."""
        filt = _as_filter(pca, g.cfg)
        x_low = filt.encode(g.x)
        return cls(g.cfg, filt, g.x, x_low, g.levels, g.layers, g.entry,
                   seed=seed, device=device)

    @classmethod
    def build(cls, x: np.ndarray, cfg: PHNSWConfig, *, seed: int = 0,
              device="cuda") -> "MutableIndex":
        """Fit the configured filter + build the seed graph (its probe
        on ``device``) + adopt it."""
        filt = make_filter(cfg, x, seed=seed)
        g = build_hnsw(x, cfg, seed=seed, device=device)
        return cls.from_graph(g, filt, seed=seed + 1, device=device)

    # ------------------------------------------------------------------
    # device publication (epoch-versioned, out of place)
    # ------------------------------------------------------------------

    @property
    def _dev_payload_dtype(self) -> torch.dtype:
        """Device storage dtype of the filter payload: cfg.low_dtype for
        PCA (the bf16 layout-(3) option), the payload's own dtype (uint8
        codes / zero-width f32) otherwise."""
        if self.filt.kind == "pca":
            return _TORCH_DTYPE[self.cfg.low_dtype]
        return torch.from_numpy(self.x_low[:0]).dtype

    def _payload_to_device(self, rows: np.ndarray) -> torch.Tensor:
        """Payload rows on the device in their storage dtype (f32 rows
        rounded once to bfloat16 where ``cfg.low_dtype`` asks, as
        ``build_packed`` rounds them)."""
        return _to_device(rows, self.device).to(self._dev_payload_dtype)

    def _packed_rows(self, adj_rows: torch.Tensor) -> torch.Tensor:
        """Layout-(3) inline payload of adjacency rows [R, M]: each
        neighbour's payload row gathered from the published ``low``
        (zeros at -1 slots), [R, M, P]."""
        packed = self._dev_low[adj_rows.clamp(min=0).long()]
        packed[adj_rows < 0] = 0
        return packed

    def device_layers(self, n_pub: int):
        """The published device layers padded with cached EMPTY layers
        (all -1 adjacency, zero payload) up to ``n_pub`` >= top+1 —
        shard stacking (index/sharded.py) needs uniform layer counts
        across shards whose top layers differ. An empty layer is inert:
        the entry has no neighbours there, so its search latches done at
        the first check. Returns (adj list, packed list)."""
        adj, packed = list(self._dev_adj), list(self._dev_packed)
        for l in range(len(adj), n_pub):
            key = (l, self.cap)
            if key not in self._empty_layers:
                M = self.cfg.degree(l)
                pl = self._dev_low.shape[1]
                self._empty_layers[key] = (
                    torch.full((self.cap, M), -1, dtype=torch.int32,
                               device=self.device),
                    torch.zeros((self.cap, M, pl),
                                dtype=self._dev_payload_dtype,
                                device=self.device))
            a, p = self._empty_layers[key]
            adj.append(a)
            packed.append(p)
        return adj, packed

    def _publish_full(self) -> None:
        """Rebuild every device buffer (init / growth / compaction /
        top-layer change — anything that changes shapes or layer
        count)."""
        dev = self.device
        self._dev_low = self._payload_to_device(self.x_low)
        self._dev_adj = [_to_device(self.adj[l], dev)
                         for l in range(self.top + 1)]
        self._dev_packed = [self._packed_rows(a) for a in self._dev_adj]
        self._dev_high = _to_device(self.x, dev)
        self._dev_deleted = _to_device(pack_bitmap(self.deleted), dev)
        self._dev_low2 = None if self.x_mid is None \
            else _to_device(self.x_mid, dev)
        self._swap()

    def _publish_incremental(self, dirty: List[set], new_ids: np.ndarray,
                             deleted_ids: Optional[np.ndarray] = None
                             ) -> None:
        """Refresh only what changed: new vector rows, dirty adjacency
        rows (+ their inline packed payload), and exactly the tombstone
        words whose bits flipped (``new_ids`` clear their pad-slot bits;
        ``deleted_ids`` set theirs). Each refresh builds a new tensor
        (``index_copy``, out of place) over the exact row set."""
        dev = self.device
        new_ids = np.asarray(new_ids, np.int64)
        if len(new_ids):
            rows = _to_device(new_ids, dev)
            self._dev_high = self._dev_high.index_copy(
                0, rows, _to_device(self.x[new_ids], dev))
            self._dev_low = self._dev_low.index_copy(
                0, rows, self._payload_to_device(self.x_low[new_ids]))
            if self._dev_low2 is not None:
                self._dev_low2 = self._dev_low2.index_copy(
                    0, rows, _to_device(self.x_mid[new_ids], dev))
        for l in range(self.top + 1):
            if not dirty[l]:
                continue
            r = np.fromiter(sorted(dirty[l]), np.int64, len(dirty[l]))
            rows = _to_device(r, dev)
            a = _to_device(self.adj[l][r], dev)
            self._dev_adj[l] = self._dev_adj[l].index_copy(0, rows, a)
            self._dev_packed[l] = self._dev_packed[l].index_copy(
                0, rows, self._packed_rows(a))
        changed = np.concatenate(
            [new_ids, np.asarray(deleted_ids, np.int64)
             if deleted_ids is not None else np.empty(0, np.int64)])
        if len(changed):
            words = np.unique(changed // 32)
            self._dev_deleted = self._dev_deleted.index_copy(
                0, _to_device(words, dev),
                _to_device(pack_bitmap(self.deleted)[words], dev))
        self._swap()

    def _swap(self) -> None:
        """Publish a new epoch's PackedDB (plain attribute assignment;
        previous epochs stay valid frozen views)."""
        layers = [PackedLayer(adj=a, packed_low=p)
                  for a, p in zip(self._dev_adj, self._dev_packed)]
        self.epoch += 1
        self._db = PackedDB(layers=layers, low=self._dev_low,
                            high=self._dev_high, entry=self.entry,
                            cfg=self.cfg, deleted=self._dev_deleted,
                            low2=self._dev_low2,
                            filter_kind=self.filt.kind)

    @property
    def db(self) -> PackedDB:
        """The current epoch's device snapshot."""
        return self._db

    @property
    def n_live(self) -> int:
        return self.n - self.n_deleted

    @property
    def tombstone_frac(self) -> float:
        return self.n_deleted / max(self.n, 1)

    def live_ids(self) -> np.ndarray:
        """Ids of live (allocated, non-tombstoned) nodes, ascending —
        the id space results are drawn from."""
        return np.nonzero(~self.deleted[:self.n])[0]

    def live_ground_truth(self, q: np.ndarray, at: int) -> np.ndarray:
        """Exact top-``at`` neighbours of each query over the LIVE set,
        as mutable-index ids ([len(q), at])."""
        live = self.live_ids()
        return live[brute_force_topk(self.x[live], q, at)]

    # ------------------------------------------------------------------
    # upsert
    # ------------------------------------------------------------------

    def upsert(self, xs: np.ndarray,
               ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Insert vectors; with ``ids`` given, tombstone those ids first
        (replace semantics). Returns the new internal ids."""
        if ids is not None:
            self.delete(ids, auto_compact=False)
        xs = np.asarray(xs, np.float32)
        out = []
        bb = self.cfg.insert_batch
        for i in range(0, len(xs), bb):
            out.append(self._insert_batch(xs[i:i + bb]))
        return np.concatenate(out) if out else np.empty(0, np.int64)

    def reserve(self, capacity: int) -> None:
        """Pre-grow buffers to ``capacity`` (rounded up to a power of
        two) before traffic, instead of mid-upsert."""
        if capacity > self.cap:
            self._grow(capacity)
            self._publish_full()

    def _grow(self, need: int) -> None:
        new_cap = _next_pow2(need, self.cap * 2)
        pad = new_cap - self.cap
        self.x = np.concatenate(
            [self.x, np.zeros((pad, self.x.shape[1]), np.float32)])
        self.x_low = np.concatenate(
            [self.x_low, np.zeros((pad, self.x_low.shape[1]),
                                  self.x_low.dtype)])
        if self.x_mid is not None:
            self.x_mid = np.concatenate(
                [self.x_mid, np.zeros((pad, self.x_mid.shape[1]),
                                      np.float32)])
        self.levels = np.concatenate(
            [self.levels, np.full(pad, -1, np.int64)])
        self.deleted = np.concatenate([self.deleted, np.ones(pad, bool)])
        self.adj = [np.concatenate(
            [a, np.full((pad, a.shape[1]), -1, np.int32)])
            for a in self.adj]
        self.cap = new_cap

    def _insert_batch(self, xb: np.ndarray) -> np.ndarray:
        b = len(xb)
        grew = False
        if self.n + b > self.cap:
            self._grow(self.n + b)
            grew = True
        ids = np.arange(self.n, self.n + b)
        lvls = sample_levels(b, self.cfg, self.rng)
        xl = self.filt.encode(xb)

        # --- neighbourhood probe on the device against the pre-batch
        # snapshot, padded to the fixed probe width with the entry ---
        bb = self.cfg.insert_batch
        qx = xb
        if b < bb:
            qx = np.concatenate(
                [qx, np.broadcast_to(self.x[self.entry], (bb - b,
                                                          qx.shape[1]))])
        qprep = self.filt.prepare(qx)
        fd, fi = probe_neighborhoods(self._db, qx, qprep,
                                     self.cfg.ef_construction,
                                     self.cfg.ef_construction_k,
                                     device=self.device)
        # [Lpub, bb, efc] -> drop the pad lanes of an underfull batch
        fd = fd[:, :b].cpu().numpy()
        fi = fi[:, :b].cpu().numpy()

        # --- host state for the batch (before linking, so intra-batch
        # peers are visible as candidates) ---
        self.x[ids] = xb
        self.x_low[ids] = xl
        if self.x_mid is not None:
            self.x_mid[ids] = self.filt.encode_mid(xb)
        self.levels[ids] = lvls
        self.deleted[ids] = False
        self.n += b

        # --- vectorized wave linking on the host (core/build.py); the
        # intra-batch distance block supplies the peers the pre-batch
        # probe snapshot cannot see ---
        block = pairwise_sq(xb, xb)
        np.fill_diagonal(block, INF)
        changed = link_wave(self.x, self.adj, ids, self.levels,
                            fd, fi, block, self.cfg)
        dirty: List[set] = [set(map(int, d)) for d in changed]
        wmax = int(lvls.max())
        top_changed = wmax > self.top
        if top_changed:
            self.top = wmax
            self.entry = int(ids[int(np.argmax(lvls == wmax))])

        if grew or top_changed:
            self._publish_full()
        else:
            self._publish_incremental(dirty, ids)
        return ids

    # ------------------------------------------------------------------
    # delete / compaction
    # ------------------------------------------------------------------

    def delete(self, ids: np.ndarray, *, auto_compact: bool = True) -> int:
        """Tombstone ids (idempotent; out-of-range ids — e.g. stale
        after a compaction shrank the id space — are ignored). The nodes
        keep routing traffic but never appear in results. Returns the
        number newly deleted; triggers compaction past
        ``cfg.compact_tombstone_frac``."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        ids = ids[(ids >= 0) & (ids < self.n)]
        ids = np.unique(ids[~self.deleted[ids]])
        if len(ids) == 0:
            return 0
        self.deleted[ids] = True
        self.n_deleted += len(ids)
        self._publish_incremental([set() for _ in self.adj],
                                  np.empty(0, np.int64),
                                  deleted_ids=ids)
        if auto_compact and \
                self.tombstone_frac >= self.cfg.compact_tombstone_frac:
            self.compact()
        return len(ids)

    def compact(self) -> dict:
        """Physically drop tombstoned nodes: splice live 2-hop candidates
        over dead neighbours (diversity heuristic), remap ids dense,
        reallocate at the shrunk power-of-two capacity, and re-publish.

        COMPACTION RENUMBERS THE ID SPACE: ids handed out before it are
        stale afterward. The report's ``"remap"`` array (old id -> new
        id, -1 for dropped) — also kept as ``self.last_remap`` — lets
        callers re-resolve any ids they hold; ``delete()`` ignores stale
        out-of-range ids.

        Returns a report including the remap and the PCA-drift check."""
        n_before, frac_before = self.n, self.tombstone_frac
        live = ~self.deleted[:self.n]
        n_live = int(live.sum())
        if n_live == 0:
            raise ValueError("compact() on a fully-deleted index")
        drift = self.pca_drift()

        # --- graph repair: replace dead neighbours with live 2-hop ---
        for l in range(self.top + 1):
            A = self.adj[l]
            deg = A.shape[1]
            has_dead = np.zeros(self.n, bool)
            valid = A[:self.n] >= 0
            safe = np.where(valid, A[:self.n], 0)
            has_dead[live] = (valid & self.deleted[safe])[live].any(axis=1)
            for i in np.nonzero(has_dead)[0]:
                nb = A[i][A[i] >= 0]
                keep = [int(e) for e in nb if not self.deleted[e]]
                cand = set(keep)
                for e in nb:
                    if self.deleted[e]:
                        for f in A[e][A[e] >= 0]:
                            f = int(f)
                            if f != i and not self.deleted[f]:
                                cand.add(f)
                if not cand:
                    A[i, :] = -1
                    continue
                cl = np.fromiter(cand, np.int64, len(cand))
                ds = np.sum((self.x[cl] - self.x[i]) ** 2, axis=1)
                ordered = sorted(zip(ds.tolist(), cl.tolist()))
                sel = _select_heuristic(self.x, ordered, deg)
                A[i, :] = -1
                A[i, :len(sel)] = sel

        # --- dense remap + reallocation ---
        remap = np.full(self.n, -1, np.int64)
        remap[live] = np.arange(n_live)
        x = self.x[:self.n][live]
        x_low = self.x_low[:self.n][live]
        levels = self.levels[:self.n][live]
        adj = []
        for l in range(self.cfg.n_layers):
            A = self.adj[l][:self.n][live]
            A = np.where(A >= 0, remap[np.where(A >= 0, A, 0)], -1)
            adj.append(A.astype(np.int32))
        lv_top = int(levels.max())
        entry_cands = np.nonzero(levels == lv_top)[0]
        self.__init__(self.cfg, self.filt, x, x_low, levels, adj,
                      int(entry_cands[0]), seed=int(
                          self.rng.integers(0, 2**31 - 1)),
                      epoch=self.epoch, device=self.device)
        self.last_remap = remap
        return {"n_before": n_before, "n_after": self.n,
                "tombstone_frac_before": frac_before,
                "capacity": self.cap, "remap": remap,
                "pca_drift": drift}

    def pca_drift(self) -> dict:
        """How much variance of the LIVE distribution the frozen
        projection still captures, vs. what it captured at fit time.
        A large drop means inserts moved the data manifold and the
        low-dim filter is losing selectivity — refit offline. Only the
        PCA-bearing filters report a drift."""
        if self.pca is None:
            return {"captured_live": None, "captured_fit": None,
                    "drift": 0.0, "refit_recommended": False,
                    "note": f"drift check n/a for filter "
                            f"{self.filt.kind!r}"}
        live = ~self.deleted[:self.n]
        xc = self.x[:self.n][live] - self.pca.mean
        tot = float((xc * xc).sum())
        proj = xc @ self.pca.components
        captured = float((proj * proj).sum()) / max(tot, 1e-12)
        fit = float(self.pca.explained.sum())
        return {"captured_live": captured, "captured_fit": fit,
                "drift": fit - captured,
                "refit_recommended": bool(
                    fit - captured > self.cfg.pca_drift_tol)}

    # ------------------------------------------------------------------
    # search / snapshot
    # ------------------------------------------------------------------

    def search(self, queries: np.ndarray, **kw):
        """Batched search over the current epoch, on the index's
        device: (dists [B, ef0], ids [B, ef0]) tensors."""
        return search_batched(self._db, queries, filt=self.filt,
                              device=self.device, **kw)

    def _snapshot_arrays(self) -> Dict[str, np.ndarray]:
        """The unpadded array schema of one index snapshot (shared by
        ``save`` and the sharded snapshot, which stores one of these per
        shard under a prefix)."""
        fk = self.filt.kind
        filt_arrays = {}
        if fk == "pca":
            filt_arrays = dict(pca_mean=self.pca.mean,
                               pca_components=self.pca.components,
                               pca_explained=self.pca.explained)
        elif fk == "pq":
            filt_arrays = dict(pq_centroids=self.filt.cb.centroids)
        elif fk == "cascade":
            # both stages' parameters: the PQ traversal codebook AND
            # the PCA promote projection (x_mid is recomputed on load)
            filt_arrays = dict(pq_centroids=self.filt.cb.centroids,
                               pca_mean=self.pca.mean,
                               pca_components=self.pca.components,
                               pca_explained=self.pca.explained)
        return dict(
            n=np.int64(self.n), entry=np.int64(self.entry),
            epoch=np.int64(self.epoch),
            n_layers=np.int64(self.cfg.n_layers), filter_kind=fk,
            x=self.x[:self.n], x_low=self.x_low[:self.n],
            levels=self.levels[:self.n], deleted=self.deleted[:self.n],
            **filt_arrays,
            **{f"adj{l}": self.adj[l][:self.n]
               for l in range(self.cfg.n_layers)})

    def save(self, path) -> None:
        """Snapshot the whole index (graph + vectors + tombstones +
        filter payload + filter parameters) to one npz, under the
        integrity envelope (format version + content checksum) that
        ``load`` verifies."""
        write_snapshot(path, self._snapshot_arrays())

    @classmethod
    def _from_arrays(cls, z: Dict[str, np.ndarray], cfg: PHNSWConfig,
                     *, seed: int = 0, device="cuda") -> "MutableIndex":
        fk = str(z["filter_kind"]) if "filter_kind" in z else "pca"
        if fk == "pca":
            filt = PCAFilter(
                PCA(mean=z["pca_mean"], components=z["pca_components"],
                    explained=z["pca_explained"]),
                low_dtype=cfg.low_dtype)
        elif fk == "pq":
            filt = PQFilter(PQCodebook(centroids=z["pq_centroids"]))
        elif fk == "cascade":
            filt = CascadeFilter(
                PQCodebook(centroids=z["pq_centroids"]),
                PCA(mean=z["pca_mean"], components=z["pca_components"],
                    explained=z["pca_explained"]))
        else:
            filt = IdentityFilter(dim=z["x"].shape[1])
        n_layers = int(z["n_layers"])
        return cls(cfg, filt, z["x"], z["x_low"], z["levels"],
                   [z[f"adj{l}"] for l in range(n_layers)],
                   int(z["entry"]), deleted=z["deleted"], seed=seed,
                   epoch=int(z["epoch"]), device=device)

    @classmethod
    def load(cls, path, cfg: PHNSWConfig, *, seed: int = 0,
             device="cuda") -> "MutableIndex":
        """Restore from ``save``'s npz (the reference's too) onto
        ``device``. Raises ``SnapshotCorruptError`` on a truncated,
        bit-flipped, envelope-less, or version-mismatched file."""
        return cls._from_arrays(read_snapshot(path), cfg, seed=seed,
                                device=device)
