"""Batched pHNSW vector-search service (port of
``repro/serve/vector_service.py``).

Requests accumulate into fixed-size batches; underfull batches are
padded with the entry point and results trimmed. QPS and latency
percentiles ride on the observability plane (``repro_torch.obs``):
latency lands in a log-bucketed histogram — O(1) per record, constant
memory forever — and percentiles are bucket quantiles.

Backed by any of four snapshots behind one API:

  * a frozen ``PackedDB`` (read-only single-shard serving) or a
    ``MutableIndex`` (live single-shard serving);
  * a frozen ``ShardedDB`` (read-only SHARDED serving) or a
    ``ShardedMutableIndex`` (live sharded serving) — results carry
    GLOBAL ids, served by the shard loop ``shard_search_host``, or with
    ``mesh=`` by the collective path over a device mesh
    (``distributed_search``, bit-equal).

``upsert`` / ``delete`` (mutable backends) mutate the index and swap
the published epoch's device snapshot under the running service. The
swap is a plain attribute assignment of a snapshot whose tensors are
never written again, so in-flight batches finish on the epoch they
started on and the next batch sees the new one.

**Fault tolerance**: pass a ``FaultPolicy`` to serve a sharded backend
resiliently — each shard is probed individually
(``core.distributed.probe_shard``), failures get bounded
exponential-backoff retries inside a per-request deadline budget,
per-shard wall times feed a median+MAD straggler monitor, repeated
failures mark a shard dead (skipped until ``recover_shard``), and the
request completes DEGRADED from whichever shards answered — results
then carry exact ``coverage`` accounting via ``query(...,
return_stats=True)``. Deadlines, backoff and the straggler monitor run
on the host's ``time.monotonic``; ``probe_shard`` synchronises the
device before it reads the clock.

**Tracing**: pass ``tracer=Tracer()`` and every request builds a span
tree — ``serve.query`` -> per-shard ``shard.probe`` children
(fault-injection hits, retry/backoff, straggler and dead-shard marks as
ordered events) -> ``merge`` (with coverage/degraded attrs) — and
mutations trace ``serve.upsert`` / ``serve.delete`` -> ``epoch.swap``.
Off by default: the disabled path allocates no span objects.

**Streaming**: ``run_stream`` serves through the continuous-batching
scheduler (``serve.scheduler.StreamScheduler``: queries retire one by
one as they converge, no convoy and no pad lanes) wherever it is
supported, else the synchronous batch path ``run_stream_sync``;
``scheduler(**kw)`` gives the front-end itself (``submit`` / ``tick`` /
``drain``, mixed k, deadlines and shedding).
"""
from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.distributed import (ShardedDB, _normalize,
                                          check_shard_result,
                                          distributed_search,
                                          merge_surviving, probe_shard,
                                          shard_live_counts,
                                          shard_search_host)
from repro_torch.core.filters import FilterSpec, IdentityFilter, PCAFilter
from repro_torch.core.pca import PCA
from repro_torch.core.search_torch import (PackedDB, _check_device,
                                           search_batched)
from repro_torch.distributed import faults as faults_mod
from repro_torch.distributed.faults import (AllShardsDeadError,
                                            FaultPolicy, ShardCorruptError,
                                            ShardFaultError, ShardHealth)
from repro_torch.index import MutableIndex, ShardedMutableIndex
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Tracer

class ServiceStats:
    """Rolling serving statistics on the obs metrics plane.

    Latency lives in a log-bucketed ``Histogram``: recording is O(1)
    and ``percentile()`` is an O(buckets) cumulative walk over mergeable
    buckets. Each ``ServiceStats`` owns a private ``Registry`` by
    default (two services never share counts); pass one in to scrape
    several services from a single exporter endpoint.
    """

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        self.latency_ms = r.histogram(
            "phnsw_request_latency_ms",
            "per-query serving latency (ms)")
        self._queries = r.counter("phnsw_queries_total", "queries served")
        self._upserts = r.counter("phnsw_upserts_total",
                                  "vectors upserted")
        self._deletes = r.counter("phnsw_deletes_total", "ids tombstoned")
        self._degraded = r.counter("phnsw_degraded_requests_total",
                                   "requests completed degraded")
        self._coverage = r.gauge("phnsw_request_coverage",
                                 "live-vector coverage of the last "
                                 "request")
        self._coverage.set(1.0)
        self.started = time.monotonic()

    # -- recording (the service's write surface) ---------------------------

    def record_request(self, n: int, latency_ms: float) -> None:
        """One served batch of ``n`` real queries: each counts toward
        QPS and each experienced the batch's latency."""
        self._queries.inc(n)
        for _ in range(n):
            self.latency_ms.observe(latency_ms)

    def record_degraded(self, coverage: float) -> None:
        self._degraded.inc()
        self._coverage.set(coverage)

    def record_upserts(self, n: int) -> None:
        self._upserts.inc(n)

    def record_deletes(self, n: int) -> None:
        self._deletes.inc(n)

    def reset(self) -> None:
        """Zero every metric in place (scraper references stay valid)
        and restart the QPS clock — the warmup-exclusion hook."""
        self.registry.reset()
        self._coverage.set(1.0)
        self.started = time.monotonic()

    # -- reading -----------------------------------------------------------

    @property
    def queries(self) -> int:
        return int(self._queries.value)

    @property
    def upserts(self) -> int:
        return int(self._upserts.value)

    @property
    def deletes(self) -> int:
        return int(self._deletes.value)

    @property
    def degraded_queries(self) -> int:
        return int(self._degraded.value)

    @property
    def qps(self) -> float:
        return self.queries / max(time.monotonic() - self.started, 1e-9)

    def percentile(self, p: float) -> float:
        if self.latency_ms.count == 0:
            return 0.0
        return self.latency_ms.percentile(p)


class VectorSearchService:
    def __init__(self, db: Union[PackedDB, MutableIndex, ShardedDB,
                                 ShardedMutableIndex],
                 pca: Optional[PCA] = None, *, batch_size: int = 64,
                 ef0: Optional[int] = None,
                 filt: Optional[FilterSpec] = None, mesh=None,
                 nan_policy: str = "raise",
                 fault_policy: Optional[FaultPolicy] = None,
                 tracer: Optional[Tracer] = None,
                 registry: Optional[Registry] = None,
                 device="cuda"):
        """``filt`` (any ``core.filters.FilterSpec``) generalizes the
        ``pca`` argument; mutable indexes bring their own filter. A
        frozen identity-filter db needs neither. Sharded backends
        (``ShardedDB`` / ``ShardedMutableIndex``) serve GLOBAL ids.
        ``device`` is where the backend lives; a backend elsewhere is
        refused. ``mesh`` (a ``core.distributed.Mesh``) serves a sharded
        backend through the collective path (the shard loop otherwise;
        bit-equal); the results come back from the mesh's first device.

        ``nan_policy``: what to do with NaN/Inf entries in queries and
        upserts — ``"raise"`` (default, a clear ValueError at the API
        boundary) or ``"sanitize"`` (zero them).

        ``fault_policy`` (sharded backends) turns on the resilient
        per-shard query loop: retry/deadline/straggler handling plus
        degraded-mode completion — see the module docstring.

        ``tracer``: a ``repro_torch.obs.Tracer`` to build per-request
        span trees (default: disabled). ``registry``: the metrics
        registry ``ServiceStats`` records into (default: a private one
        per service)."""
        self.index: Optional[MutableIndex] = None
        self.sindex: Optional[ShardedMutableIndex] = None
        self.sdb: Optional[ShardedDB] = None
        self.db: Optional[PackedDB] = None
        self.device = torch.device(device)
        self.mesh = mesh
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if nan_policy not in ("raise", "sanitize"):
            raise ValueError(f"nan_policy must be 'raise' or 'sanitize', "
                             f"got {nan_policy!r}")
        self.nan_policy = nan_policy
        if isinstance(db, ShardedMutableIndex):
            self.sindex = db
            self.sdb = db.sdb
            filt = filt or db.filt
        elif isinstance(db, ShardedDB):
            self.sdb = db
        elif isinstance(db, MutableIndex):
            self.index = db
            self.db = db.db
            filt = filt or db.filt
        else:
            self.db = db
        snap = self.sdb if self.sdb is not None else self.db
        _check_device(snap, self.device)
        if filt is None:
            if pca is not None:
                filt = PCAFilter(pca, low_dtype=snap.cfg.low_dtype)
            elif snap.filter_kind == "none":
                filt = IdentityFilter(dim=snap.high.shape[-1])
            else:
                raise ValueError("filt (or pca) is required when "
                                 "serving a frozen db with the "
                                 f"{snap.filter_kind!r} filter")
        self.filt = filt
        self.pca = filt.pca if isinstance(filt, PCAFilter) else pca
        self.batch = batch_size
        self.ef0 = ef0 or snap.cfg.ef0
        self._dim = int(snap.high.shape[-1])
        mut = self.index or self.sindex
        self.epoch = mut.epoch if mut else 0
        self.fault_policy = fault_policy
        self.health: Optional[ShardHealth] = None
        if fault_policy is not None:
            if self.sdb is None:
                raise ValueError("fault_policy needs a sharded backend "
                                 "(ShardedDB / ShardedMutableIndex) — "
                                 "single-shard redundancy is the "
                                 "ReplicaSet's job")
            if mesh is not None:
                raise ValueError("fault_policy drives the per-shard "
                                 "host path; it cannot be combined "
                                 "with mesh=")
            self.health = ShardHealth(self.sdb.n_shards, fault_policy)
        self.last_stats = {"coverage": 1.0, "degraded": False}
        self._refresh_pad_row()
        self._refresh_live_counts()
        # warm the path (on the card: load the kernel library and fill
        # the allocator's cache), then reset stats IN PLACE so the
        # warmup batch never pollutes QPS/latency percentiles; the
        # in-place reset keeps scrapers' references to the histogram
        # valid
        self.stats = ServiceStats(registry)
        dummy = np.zeros((batch_size, self._dim), np.float32)
        self._run(dummy)
        self.stats.reset()

    def _refresh_pad_row(self):
        # pad row for underfull batches: the entry point's vector — its
        # search terminates in O(1) steps, so pad lanes never drag the
        # batch; sharded: shard 0's entry
        if self.sdb is not None:
            row = self.sdb.high[0, int(self.sdb.entries[0])]
        else:
            row = self.db.high[int(self.db.entry)]
        self._pad_row = row.cpu().numpy()[None].astype(np.float32)

    def _refresh_live_counts(self):
        """Host cache of per-shard live populations (the ``coverage``
        denominators) + ownership spans — refreshed on every epoch
        swap, read per degraded request."""
        if self.sdb is not None:
            self._live_counts = shard_live_counts(self.sdb)
            self._offsets_np = np.asarray(self.sdb.offsets, np.int64)
            self._counts_np = np.asarray(self.sdb.counts, np.int64)

    # ------------------------------------------------------------------
    # input validation (the API boundary: clear errors here instead of
    # shape/dtype failures deep inside the search, or NaN mis-serving)
    # ------------------------------------------------------------------

    def _validate_vectors(self, a, what: str, *, dim: Optional[int] = None
                          ) -> np.ndarray:
        a = np.asarray(a)
        if a.dtype == object or not (np.issubdtype(a.dtype, np.floating)
                                     or np.issubdtype(a.dtype, np.integer)):
            raise ValueError(f"{what} must be numeric, got dtype "
                             f"{a.dtype}")
        dim = self._dim if dim is None else dim
        if a.ndim != 2 or a.shape[1] != dim:
            raise ValueError(f"{what} must be [n, {dim}], got shape "
                             f"{a.shape}")
        if len(a) == 0:
            raise ValueError(f"empty {what} batch")
        a = a.astype(np.float32, copy=False)
        finite = np.isfinite(a)
        if not finite.all():
            if self.nan_policy == "sanitize":
                a = np.where(finite, a, np.float32(0.0))
            else:
                raise ValueError(
                    f"{what} contain {int((~finite).sum())} non-finite "
                    f"(NaN/Inf) values; construct the service with "
                    f"nan_policy='sanitize' to zero them instead")
        return a

    def _validate_queries(self, q) -> np.ndarray:
        q = self._validate_vectors(q, "queries")
        if len(q) > self.batch:
            raise ValueError(
                f"{len(q)} queries exceed batch_size={self.batch}; "
                f"use run_stream() to serve in batches")
        return q

    # ------------------------------------------------------------------
    # mutation (mutable-index-backed services only)
    # ------------------------------------------------------------------

    def _swap(self, span=NULL_SPAN):
        """Publish the index's current epoch to the serving path
        (attribute assignment of a snapshot never written again)."""
        with span.child("epoch.swap", from_epoch=self.epoch) as sw:
            if self.sindex is not None:
                self.sdb = self.sindex.sdb
                self.epoch = self.sindex.epoch
            else:
                self.db = self.index.db
                self.epoch = self.index.epoch
            self._refresh_pad_row()
            self._refresh_live_counts()
            sw.set(to_epoch=self.epoch)

    @property
    def _mut(self):
        return self.index if self.index is not None else self.sindex

    def upsert(self, vectors: np.ndarray,
               ids: Optional[np.ndarray] = None,
               *, span=None) -> np.ndarray:
        """Insert (or, with ``ids``, replace) vectors; swaps the serving
        snapshot to the new epoch. Returns the new internal ids (GLOBAL
        ids on a sharded backend)."""
        if self._mut is None:
            raise RuntimeError("upsert() needs a mutable-index-backed "
                               "service (got a frozen snapshot)")
        vectors = self._validate_vectors(vectors, "upsert vectors")
        if ids is not None:
            ids = np.atleast_1d(np.asarray(ids))
            if not np.issubdtype(ids.dtype, np.integer):
                raise ValueError(f"ids must be integers, got dtype "
                                 f"{ids.dtype}")
            if len(ids) != len(vectors):
                raise ValueError(f"{len(ids)} ids for {len(vectors)} "
                                 f"vectors")
        root = (span.child("serve.upsert") if span is not None and
                span.enabled else self.tracer.span("serve.upsert"))
        root.set(n=len(vectors))
        with root:
            if self.sindex is not None:
                new_ids = self.sindex.upsert(vectors, ids=ids, span=root)
            else:
                new_ids = self.index.upsert(vectors, ids=ids)
            self.stats.record_upserts(len(new_ids))
            self._swap(span=root)
        return new_ids

    def delete(self, ids: np.ndarray, *, span=None) -> int:
        """Tombstone ids; deleted ids never appear in results from the
        swapped epoch onward. Returns the number newly deleted."""
        if self._mut is None:
            raise RuntimeError("delete() needs a mutable-index-backed "
                               "service (got a frozen snapshot)")
        root = (span.child("serve.delete") if span is not None and
                span.enabled else self.tracer.span("serve.delete"))
        with root:
            if self.sindex is not None:
                n = self.sindex.delete(ids, span=root)
            else:
                n = self.index.delete(ids)
            root.set(n=n)
            self.stats.record_deletes(n)
            self._swap(span=root)
        return n

    # ------------------------------------------------------------------
    # query path
    # ------------------------------------------------------------------

    def _run(self, q: np.ndarray, span=NULL_SPAN):
        if self.health is not None:
            return self._run_resilient(q, span=span)
        qprep = self.filt.prepare(q)
        if self.sdb is not None and self.mesh is not None:
            with span.child("search", path="mesh"):
                fd, fi = distributed_search(self.mesh, self.sdb, q, qprep,
                                            ef0=self.ef0)
        elif self.sdb is not None:
            with span.child("search", path="host-sharded"):
                fd, fi = shard_search_host(self.sdb, q, qprep,
                                           ef0=self.ef0,
                                           device=self.device)
        else:
            with span.child("search", path="single"):
                fd, fi = search_batched(self.db, q, qprep, ef0=self.ef0,
                                        device=self.device)
        return fd.cpu().numpy(), fi.cpu().numpy()

    def _coverage(self, answered: np.ndarray) -> float:
        lc = self._live_counts
        return int(lc[answered].sum()) / max(int(lc.sum()), 1)

    def _run_resilient(self, q: np.ndarray, span=NULL_SPAN):
        """The fault-tolerant sharded query loop: probe every non-dead
        shard individually (bounded retry + exponential backoff inside
        the per-request deadline budget), validate each answer at the
        merge boundary, feed wall times to the per-shard straggler
        monitor, then complete the request from whichever shards
        answered (degraded when any didn't).

        Every decision the loop takes lands in the trace: a
        ``shard.probe`` child per probed shard carries fault /
        quarantine / backoff / straggler / dead_mark events in the
        order they happened; skipped-dead shards and the final merge
        (with exact coverage) are recorded on the request span."""
        pol = self.fault_policy
        sdb = self.sdb
        Pn = sdb.n_shards
        plan = faults_mod.active()
        if plan is not None:
            plan.tick()
        qd = torch.as_tensor(q, device=sdb.device)
        qp = torch.as_tensor(self.filt.prepare(q), device=sdb.device)
        ef0, _, deferred, rm, pm = _normalize(sdb, self.ef0, None, None,
                                              None)
        # per-shard list width: the cascade's promote pool when active
        # (pm normalizes to 1 for every other config)
        E = ef0 * max(rm, pm) if deferred else ef0
        fd_all = np.zeros((Pn, len(q), E), np.float32)
        gi_all = np.full((Pn, len(q), E), -1, np.int32)
        answered = np.zeros(Pn, bool)
        deadline = time.monotonic() + pol.deadline_ms / 1e3
        for s in range(Pn):
            if self.health.dead[s]:
                span.event("skip_dead_shard", shard=s)
                continue
            ps = span.child("shard.probe", shard=s)
            with ps:
                for attempt in range(pol.max_retries + 1):
                    if attempt and time.monotonic() >= deadline:
                        # retry budget spent: serve degraded
                        ps.event("deadline_exhausted", attempt=attempt)
                        break
                    try:
                        fd, gi, wall = probe_shard(sdb, s, qd, qp,
                                                   ef0=self.ef0,
                                                   span=ps)
                        if not check_shard_result(
                                fd, gi, int(self._offsets_np[s]),
                                int(self._counts_np[s])):
                            raise ShardCorruptError(
                                f"shard {s} failed the merge-boundary "
                                f"integrity check")
                        ev = self.health.heartbeat(s, wall)
                        if ev.kind == "straggler":
                            ps.event("straggler", shard=s,
                                     detail=ev.detail)
                        fd_all[s], gi_all[s] = fd, gi
                        answered[s] = True
                        ps.set(answered=True, attempts=attempt + 1,
                               wall_ms=wall * 1e3)
                        break
                    except ShardFaultError as e:
                        kind = ("quarantine"
                                if isinstance(e, ShardCorruptError)
                                else "fault")
                        ps.event(kind, shard=s, attempt=attempt,
                                 error=repr(e))
                        if self.health.failure(s, e):
                            ps.event("dead_mark", shard=s,
                                     failures=int(
                                         self.health.failures[s]))
                            break   # marked dead: stop retrying it
                        pause = min(pol.backoff_ms * (2 ** attempt) / 1e3,
                                    max(deadline - time.monotonic(), 0.0))
                        if pause > 0:
                            ps.event("backoff", ms=pause * 1e3,
                                     attempt=attempt)
                            time.sleep(pause)
                if not answered[s]:
                    ps.set(answered=False)
        if not answered.any():
            span.event("all_shards_dead")
            raise AllShardsDeadError(
                f"no shard of {Pn} answered within the "
                f"{pol.deadline_ms:.0f}ms budget")
        with span.child("merge", live_shards=int(answered.sum()),
                        n_shards=Pn) as ms:
            fd, fi = merge_surviving(sdb, fd_all, gi_all, answered, qd,
                                     qprep=qp, ef0=self.ef0)
            degraded = bool(~answered.all())
            cov = self._coverage(answered)
            ms.set(coverage=cov, degraded=degraded, deferred=deferred)
        self.last_stats = {
            "coverage": cov,
            "degraded": degraded,
            "live_shards": int(answered.sum()),
            "n_shards": Pn,
            "answered": answered,
        }
        if degraded:
            self.stats.record_degraded(cov)
        return fd.cpu().numpy(), fi.cpu().numpy()

    def recover_shard(self, s: int) -> None:
        """Clear a shard's dead mark after the underlying fault healed
        (operator action / fault-plan heal): the next request probes it
        again."""
        if self.health is None:
            raise RuntimeError("recover_shard() needs a fault_policy-"
                               "enabled service")
        self.health.recover(s)

    def query(self, q: np.ndarray, *, return_stats: bool = False,
              span=None) -> Tuple[np.ndarray, ...]:
        """q: [n, D] with n <= batch_size; underfull batches are padded
        with the entry point. Returns (dists, indices) numpy arrays for
        the n real queries; only those count toward stats. With
        ``return_stats`` a third element reports this request's serving
        health: ``coverage`` (fraction of live vectors reachable —
        exact), ``degraded``, and ``latency_ms``. ``span`` (optional)
        parents this request's trace under a caller span instead of
        opening a new root."""
        q = self._validate_queries(q)
        n = len(q)
        t0 = time.monotonic()
        root = (span.child("serve.query") if span is not None and
                span.enabled else self.tracer.span("serve.query"))
        root.set(n=n, batch=self.batch, epoch=self.epoch)
        with root:
            if n < self.batch:
                pad = np.broadcast_to(self._pad_row,
                                      (self.batch - n, q.shape[1]))
                q = np.concatenate([q, pad], axis=0)
            fd, fi = self._run(q, span=root)
            dt = (time.monotonic() - t0) * 1000.0
            self.stats.record_request(n, dt)
            root.set(latency_ms=dt,
                     coverage=self.last_stats.get("coverage", 1.0),
                     degraded=self.last_stats.get("degraded", False))
        if return_stats:
            return fd[:n], fi[:n], {**self.last_stats,
                                    "latency_ms": dt}
        return fd[:n], fi[:n]

    @property
    def scheduler_supported(self) -> bool:
        """Whether the continuous-batching scheduler can serve this
        configuration: single-shard and sharded, single-shard deferred
        re-ranking included (the promote and re-rank passes run batched
        at retirement); neither the mesh's collective path nor the
        sharded deferred merge-then-rerank is slotted."""
        snap = self.sdb if self.sdb is not None else self.db
        deferred = snap.cfg.deferred_rerank and snap.filter_kind != "none"
        return self.mesh is None and not (deferred
                                          and self.sdb is not None)

    def scheduler(self, **kw):
        """The service's continuous-batching front-end
        (``serve.scheduler.StreamScheduler``). With no arguments the one
        default instance is cached and reused (its slot state and step
        telemetry persist across ``run_stream`` calls); keyword
        arguments build a fresh scheduler (e.g. ``ef=128`` for mixed-k
        traffic, ``slo_ms=`` for deadline shedding)."""
        from repro_torch.serve.scheduler import StreamScheduler
        if kw:
            return StreamScheduler(self, **kw)
        if getattr(self, "_sched", None) is None:
            self._sched = StreamScheduler(self)
        return self._sched

    def _stream_stats(self, extra: Optional[dict] = None) -> dict:
        st = {
            "qps": self.stats.qps,
            "p50_ms": self.stats.percentile(50),
            "p99_ms": self.stats.percentile(99),
            "p999_ms": self.stats.percentile(99.9),
        }
        if extra:
            st.update(extra)
        return st

    def run_stream_sync(self, queries: np.ndarray
                        ) -> Tuple[np.ndarray, dict]:
        """The synchronous batch-at-a-time stream path: serve in service
        batches, every query waiting for its batch's slowest
        traverser."""
        outs = []
        for i in range(0, len(queries), self.batch):
            _, fi = self.query(queries[i:i + self.batch])
            outs.append(fi)
        return np.concatenate(outs, axis=0), \
            self._stream_stats({"path": "sync"})

    def run_stream(self, queries: np.ndarray, *,
                   scheduler: Optional[bool] = None
                   ) -> Tuple[np.ndarray, dict]:
        """Serve a stream of queries; returns (all indices [n, ef0],
        stats). By default the continuous-batching scheduler serves any
        supported configuration and the synchronous batch path serves
        the rest; force either with ``scheduler=``. Results come back in
        SUBMISSION order whatever the retirement order, exactly once per
        query."""
        if scheduler is None:
            scheduler = self.scheduler_supported
        if not scheduler:
            return self.run_stream_sync(queries)
        q = self._validate_vectors(queries, "queries")
        sched = self.scheduler()
        k = min(self.ef0, sched.EF)
        n = len(q)
        out = np.full((n, k), -1, np.int64)
        i = got = 0
        while got < n:
            while i < n and sched.has_capacity():
                sched.submit(q[i], k=k, rid=i)
                i += 1
            for c in sched.tick():
                out[c.rid] = c.ids
                got += 1
        return out, self._stream_stats({"path": "scheduler"})
