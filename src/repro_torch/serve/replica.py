"""Replica groups with failover and snapshot-shipping recovery (port of
``repro/serve/replica.py``).

A ``ReplicaSet`` holds N ``VectorSearchService`` replicas of the SAME
logical index behind one query/upsert/delete API:

* **Health-checked routing.** Queries go to the preferred (primary)
  replica; a replica that raises a serving-plane ``FaultError`` (or is
  killed by the installed ``FaultPlan``) is marked dead and the SAME
  request fails over to the next healthy replica — callers never see a
  replica die, only (at worst) degraded coverage.
* **Replicated mutation with an op log.** Every upsert/delete gets a
  monotonically increasing sequence number, is appended to a bounded
  op log, and applied to every healthy replica. Ids converge because
  inserts are deterministic (round-robin shard assignment + arange
  local slots) and every replica sees the same op order.
* **Snapshot shipping + idempotent re-publish.** Recovery re-seeds a
  dead replica from a healthy donor's checksummed npz snapshot
  (``MutableIndex.save`` / ``ShardedMutableIndex.save`` — a corrupt
  ship raises the typed ``SnapshotCorruptError`` instead of serving
  garbage), then replays the op-log tail the snapshot predates. Replay
  is idempotent: each replica tracks ``applied_seq`` and skips any op
  it already absorbed, so re-delivering the whole log is always safe
  (the re-publish protocol needs no careful cut point).

The replicas' graphs may differ microscopically after a recovery (each
replica's insert rng walks its own path once histories diverge — HNSW
is stochastic by construction); what converges is the STATE that
defines correct serving: the live id -> vector map, tombstones, and
``applied_seq``. ``assert_converged`` checks exactly that, on the
indexes' host mirrors (numpy), never on a device tensor.

Each replica owns its own device copy of the index, on the device of
the service it was modelled on: an N-replica set holds N copies. The
snapshot npz is the reference's envelope, so a checkpoint written by
either package's ``ReplicaSet`` re-seeds a replica in the other.
"""
from __future__ import annotations

import tempfile
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Deque, List, Optional, Tuple

import numpy as np

from repro_torch.distributed import faults as faults_mod
from repro_torch.distributed.faults import AllReplicasDeadError, FaultError
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serve.vector_service import VectorSearchService


@dataclass
class ReplicaState:
    svc: VectorSearchService
    alive: bool = True
    applied_seq: int = 0
    reseeds: int = 0


@dataclass
class _Op:
    kind: str                 # "upsert" | "delete"
    seq: int
    vectors: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None


class ReplicaSet:
    """N replicas of one logical vector-search service: failover
    queries, replicated mutations, snapshot-shipped recovery."""

    def __init__(self, services: List[VectorSearchService], *,
                 snapshot_dir=None, oplog_capacity: int = 4096,
                 tracer: Optional[Tracer] = None):
        assert len(services) >= 1
        self.replicas = [ReplicaState(svc=s) for s in services]
        self.seq = 0
        self.oplog: Deque[_Op] = deque(maxlen=oplog_capacity)
        self.snapshot_dir = Path(snapshot_dir) if snapshot_dir \
            else Path(tempfile.mkdtemp(prefix="phnsw_replicas_"))
        self._primary = 0
        # (event, replica, detail) — failover/recovery observability
        self.events: List[Tuple[str, int, str]] = []
        # per-request span trees (failover decisions, snapshot shipping,
        # oplog replay) — disabled by default, zero hot-path cost
        self.tracer = tracer if tracer is not None else NULL_TRACER

    @classmethod
    def replicate(cls, svc: VectorSearchService, n: int, *,
                  snapshot_dir=None, seed: int = 0,
                  oplog_capacity: int = 4096) -> "ReplicaSet":
        """Clone one mutable-backed service into an N-replica set via
        the snapshot path — each replica gets its OWN index value (no
        shared mutable state), loaded with the same rng seed so
        replicas that live through the same op history stay
        convergent."""
        if svc._mut is None:
            raise ValueError("replicate() needs a mutable-index-backed "
                             "service (frozen snapshots cannot absorb "
                             "replicated mutations)")
        rs = cls([svc], snapshot_dir=snapshot_dir,
                 oplog_capacity=oplog_capacity)
        path = rs.snapshot_dir / "seed.npz"
        svc._mut.save(path)
        for _ in range(n - 1):
            rs.replicas.append(ReplicaState(
                svc=rs._service_from_snapshot(path, like=svc, seed=seed)))
        return rs

    def _service_from_snapshot(self, path, *, like: VectorSearchService,
                               seed: int = 0) -> VectorSearchService:
        """Load a snapshot onto ``like``'s device and wrap it in a service
        with the SAME serving knobs as ``like`` (the same batch shape,
        so a re-seed serves exactly the donor's batches). The new
        service runs its one warm-up batch."""
        from repro_torch.index import MutableIndex, ShardedMutableIndex
        cfg = like._mut.cfg
        idx_cls = ShardedMutableIndex if like.sindex is not None \
            else MutableIndex
        idx = idx_cls.load(path, cfg, seed=seed, device=like.device)
        return VectorSearchService(
            idx, batch_size=like.batch, ef0=like.ef0,
            nan_policy=like.nan_policy,
            fault_policy=like.fault_policy, device=like.device)

    # ------------------------------------------------------------------
    # health / routing
    # ------------------------------------------------------------------

    @property
    def n_alive(self) -> int:
        return sum(r.alive for r in self.replicas)

    def _mark_dead(self, i: int, reason: str) -> None:
        if self.replicas[i].alive:
            self.replicas[i].alive = False
            self.events.append(("dead", i, reason))

    def _healthy_order(self):
        """Replica indices starting at the primary, wrapping — the
        failover probe order."""
        n = len(self.replicas)
        for d in range(n):
            i = (self._primary + d) % n
            if self.replicas[i].alive:
                yield i

    def _check_injected_death(self, i: int) -> bool:
        plan = faults_mod.active()
        if plan is not None and plan.replica_dead(i):
            self._mark_dead(i, f"killed by fault plan at t={plan.t}")
            return True
        return False

    # ------------------------------------------------------------------
    # query (failover)
    # ------------------------------------------------------------------

    def query(self, q: np.ndarray, *, return_stats: bool = False):
        """Serve from the primary, failing over through the healthy
        replicas on any serving-plane ``FaultError`` — the caller's
        request survives every failure short of total loss
        (``AllReplicasDeadError``). With a tracer, the request's span
        tree records each failover hop and parents the serving
        replica's ``serve.query`` span."""
        root = self.tracer.span("replica.query",
                                primary=self._primary)
        with root:
            last: Optional[Exception] = None
            for i in self._healthy_order():
                if self._check_injected_death(i):
                    root.event("replica_dead", replica=i,
                               detail="killed by fault plan")
                    continue
                r = self.replicas[i]
                try:
                    out = r.svc.query(
                        q, return_stats=return_stats,
                        span=root if root.enabled else None)
                except FaultError as e:
                    self._mark_dead(i, repr(e))
                    root.event("replica_dead", replica=i,
                               detail=repr(e))
                    last = e
                    continue
                if i != self._primary:
                    self.events.append(("failover", i,
                                        f"primary -> {i}"))
                    root.event("failover", from_replica=self._primary,
                               to_replica=i)
                    self._primary = i
                root.set(served_by=i)
                return out
            raise AllReplicasDeadError(
                f"all {len(self.replicas)} replicas dead"
                + (f" (last: {last!r})" if last else ""))

    # ------------------------------------------------------------------
    # replicated mutation (op log, seq-numbered, idempotent delivery)
    # ------------------------------------------------------------------

    _SKIPPED = object()        # _apply sentinel: op already absorbed

    def _apply(self, r: ReplicaState, op: _Op):
        """Deliver one op to one replica; skips ops the replica already
        absorbed (``seq <= applied_seq`` — THE idempotence that makes
        blanket re-publish safe). Returns the op's result, or
        ``_SKIPPED``."""
        if op.seq <= r.applied_seq:
            return self._SKIPPED
        if op.kind == "upsert":
            out = r.svc.upsert(op.vectors, ids=op.ids)
        else:
            out = r.svc.delete(op.ids)
        r.applied_seq = op.seq
        return out

    def _mutate(self, op: _Op):
        """Append to the op log and deliver to every healthy replica;
        a replica that cannot absorb the op is marked dead (it would
        fall behind silently otherwise) until a snapshot re-seed
        brings it back. Returns the first healthy replica's result
        (identical everywhere — deterministic op application)."""
        self.oplog.append(op)
        result, got = None, False
        for i, r in enumerate(self.replicas):
            if not r.alive or self._check_injected_death(i):
                continue
            try:
                out = self._apply(r, op)
                if not got and out is not self._SKIPPED:
                    result, got = out, True
            except FaultError as e:
                self._mark_dead(i, f"mutation failed: {e!r}")
        if not got:
            # total failure: NO replica absorbed the op, and the caller
            # sees an exception — the op never happened. Un-log it so a
            # later recovery cannot replay a mutation the client was
            # told failed (which would diverge the recovered replica
            # from the survivors).
            self.oplog.pop()
            self.seq = op.seq - 1
            raise AllReplicasDeadError(
                f"no healthy replica to apply {op.kind} seq={op.seq}")
        return result

    def upsert(self, vectors: np.ndarray,
               ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Replicated upsert. Returns the new ids — identical on every
        healthy replica (round-robin shard assignment + arange local
        slots are deterministic in op order)."""
        self.seq += 1
        return self._mutate(_Op(
            "upsert", self.seq, vectors=np.asarray(vectors, np.float32),
            ids=None if ids is None else np.asarray(ids)))

    def delete(self, ids: np.ndarray) -> int:
        """Replicated delete. Returns the newly-deleted count."""
        self.seq += 1
        return self._mutate(_Op("delete", self.seq,
                                ids=np.asarray(ids)))

    # ------------------------------------------------------------------
    # snapshot shipping + recovery
    # ------------------------------------------------------------------

    def checkpoint(self, *, span=None) -> Tuple[Path, int]:
        """Ship a snapshot from the healthiest donor: returns
        (path, applied_seq at save time). Recovery from a STALE
        checkpoint is exactly as correct as from a fresh one — the
        op-log replay covers the gap (idempotently)."""
        cs = (span.child("replica.checkpoint") if span is not None and
              span.enabled else self.tracer.span("replica.checkpoint"))
        with cs:
            for i in self._healthy_order():
                donor = self.replicas[i]
                path = self.snapshot_dir / \
                    f"ckpt_seq{donor.applied_seq}_r{i}.npz"
                donor.svc._mut.save(path)
                self.events.append(("checkpoint", i,
                                    f"seq={donor.applied_seq}"))
                cs.set(donor=i, seq=donor.applied_seq)
                return path, donor.applied_seq
            raise AllReplicasDeadError(
                "no healthy donor to checkpoint from")

    def recover(self, i: int, *, snapshot: Optional[Path] = None,
                snapshot_seq: Optional[int] = None) -> int:
        """Re-seed replica ``i``: load a donor snapshot (fresh one
        shipped now unless a ``snapshot``/``snapshot_seq`` checkpoint
        is given), then re-publish the op log — ops the snapshot
        already contains are skipped by seq (idempotent), ops after it
        replay. Returns the number of ops replayed. The replica serves
        again immediately after. With a tracer the recovery's span
        tree times the snapshot ship and the oplog replay separately."""
        root = self.tracer.span("replica.recover", replica=i)
        with root:
            if snapshot is None:
                snapshot, snapshot_seq = self.checkpoint(span=root)
            assert snapshot_seq is not None
            r = self.replicas[i]
            donor_like = None
            for j in self._healthy_order():
                donor_like = self.replicas[j].svc
                break
            if donor_like is None:
                raise AllReplicasDeadError(
                    "no healthy replica to model the recovered "
                    "service on")
            with root.child("snapshot.ship",
                            seq=int(snapshot_seq)) as ship:
                r.svc = self._service_from_snapshot(snapshot,
                                                    like=donor_like)
                ship.set(path=str(snapshot))
            r.applied_seq = snapshot_seq
            r.alive = True
            r.reseeds += 1
            with root.child("oplog.replay") as rep:
                replayed = self.republish(i)
                rep.set(n_replayed=replayed,
                        log_len=len(self.oplog))
            self.events.append(("recovered", i,
                                f"seq={snapshot_seq}+{replayed} replayed"))
            root.set(replayed=replayed)
        return replayed

    def republish(self, i: int) -> int:
        """Deliver the WHOLE op log to replica ``i``; already-applied
        ops are skipped by seq. Safe to call any number of times —
        this idempotence is what lets a recovering replica converge
        without coordinating a precise log cut."""
        r = self.replicas[i]
        n = 0
        for op in list(self.oplog):
            if self._apply(r, op) is not self._SKIPPED:
                n += 1
        return n

    # ------------------------------------------------------------------
    # convergence accounting
    # ------------------------------------------------------------------

    def assert_converged(self) -> dict:
        """Verify every healthy replica agrees on the serving STATE:
        applied_seq, live id set, and the id -> vector map. Returns a
        small report; raises AssertionError on divergence."""
        healthy = [r for r in self.replicas if r.alive]
        assert healthy, "no healthy replicas to compare"
        ref = healthy[0]
        ref_ids = ref.svc._mut.live_ids()
        for r in healthy[1:]:
            assert r.applied_seq == ref.applied_seq, \
                (r.applied_seq, ref.applied_seq)
            ids = r.svc._mut.live_ids()
            np.testing.assert_array_equal(ids, ref_ids)
            np.testing.assert_array_equal(_live_vectors(r.svc),
                                          _live_vectors(ref.svc))
        return {"n_healthy": len(healthy),
                "applied_seq": ref.applied_seq,
                "n_live": int(len(ref_ids))}


def _live_vectors(svc: VectorSearchService) -> np.ndarray:
    """The live id -> vector map of a service's mutable index, in live
    id order (the convergence invariant replicas must agree on)."""
    mut = svc._mut
    if svc.sindex is not None:
        stride = mut.stride
        gids = mut.live_global_ids()
        return np.stack([mut.shards[g // stride].x[g % stride]
                         for g in gids])
    return mut.x[mut.live_ids()]
