"""Continuous-batching serving front-end (port of
``repro/serve/scheduler.py``).

The synchronous ``VectorSearchService.query`` convoy: every query of a
batch waits for the slowest traverser of that batch, and an underfull
request pads dead lanes on top. This scheduler serves instead from a
fixed bank of slots over the resumable slotted search state
(``core.search_torch.SlotState``):

  * a bounded request QUEUE admits single queries (ragged, mixed-k
    traffic: each request carries its own k and deadline);
  * each ``tick`` (1) writes admitted queries into free slots as data
    (``_slot_admit_step``: the routing-layer descent and a fixed-width
    scatter), (2) advances every live slot by up to ``quantum`` trips of
    the layer-0 body the synchronous search runs (slots are allocated
    low-first and the tick steps the smallest WIDTH-LADDER prefix that
    covers the highest live slot), and (3) RETIRES the slots whose
    ``done`` latched, answering queries out of order as each converges;
  * per-query ADAPTIVE STEP BUDGETS: a fresh query starts at the p50 of
    the observed per-query steps (the ``phnsw_sched_slot_steps``
    histogram) and an unconverged one escalates (its budget doubles,
    counted on the obs plane) up to the static bound — bit-equal to the
    fixed-budget program, since a budget-frozen slot keeps its frontier
    and resumes where it froze;
  * per-slot EFFECTIVE ef (``ef_eff = clamp(max(k, ef_policy)) <= EF``)
    serves mixed k from one bank;
  * SLO-aware ADMISSION CONTROL: the queue is bounded (overflow sheds at
    submit) and requests past their deadline shed at admission — shed
    counters by reason, queue-depth and occupancy gauges and escalation
    counters land on the service's registry, each tick in a
    ``sched.tick`` span.

Sharded backends step every shard's slots in one pass over the stacked
view of the ``ShardedDB`` (``core.distributed.stacked_db_view``, the
reference's operand: ``_slot_step_sharded`` runs the stacked [P, S]
bank as P * S rows, one launch of each per-trip kernel for all
shards); retirement needs the done latch on every LIVE shard and
merges the disjoint per-shard lists on the host (a stable sort: lower
shard, then lower slot). Dead shards (``ShardHealth``
when the service carries a fault policy, else ``set_live``) are left
out of the done gate and the merge, and completions carry exact
coverage.

Admission, retirement, escalation, epoch swaps and kill/recover cycles
are all data: ``cache_sizes()`` (= ``search_torch.slot_cache_sizes``)
stays fixed in steady state.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import search_torch as st
from repro_torch.core.distributed import stacked_db_view


class SchedulerUnsupported(RuntimeError):
    """The service's configuration has no slotted program (mesh
    collectives, sharded deferred re-ranking): callers serve via
    ``run_stream_sync``."""


@dataclass
class _Pending:
    rid: int
    k: int
    ef_eff: int
    t_submit: float
    t_sched: float                 # scheduled arrival (open-loop start)
    deadline: Optional[float]      # monotonic seconds, None = none
    q: Optional[np.ndarray]        # [D]; dropped once admitted


@dataclass
class Completion:
    """One retired query. ``ids``/``dists`` are the top-``k`` answer
    (GLOBAL ids on sharded backends). ``forced`` marks a query retired at
    the static step bound without latching ``done`` (exactly what the
    synchronous program would have returned for it)."""
    rid: int
    ids: np.ndarray
    dists: np.ndarray
    latency_ms: float
    steps: int
    forced: bool = False
    degraded: bool = False
    coverage: float = 1.0


class StreamScheduler:
    """The continuous-batching front-end over one
    ``VectorSearchService``. Construct via ``svc.scheduler()``.

    ``ef`` is the compiled result width (default the service's ef0): the
    largest k / effective ef any request may ask for. ``ef_policy`` is
    the per-request effective-ef floor (default ``min(svc.ef0, ef)``): a
    request gets ``ef_eff = max(k, ef_policy)``. ``quantum`` is trips
    per tick; ``slo_ms`` (optional) stamps a default deadline on every
    request; ``adaptive_budget=False`` pins every query to the static
    step bound (the fixed-budget arm)."""

    def __init__(self, svc, *, n_slots: Optional[int] = None,
                 quantum: int = 32, max_queue: int = 512,
                 slo_ms: Optional[float] = None,
                 ef: Optional[int] = None,
                 ef_policy: Optional[int] = None,
                 adaptive_budget: bool = True):
        if svc.mesh is not None:
            raise SchedulerUnsupported(
                "the mesh collective path has no slotted program; "
                "serve via the host path or run_stream_sync")
        snap = svc.sdb if svc.sdb is not None else svc.db
        self.sharded = svc.sdb is not None
        # DEFERRED re-ranking (single shard): slots traverse in filter
        # space at the WIDE pool width and the promote (cascade) and
        # Dist.H passes run batched over each tick's retiring slots —
        # the final blocks of the synchronous deferred program, so
        # run_stream stays bit-equal to run_stream_sync
        self.deferred = bool(snap.cfg.deferred_rerank
                             and snap.filter_kind != "none")
        if self.deferred and self.sharded:
            raise SchedulerUnsupported(
                "sharded deferred re-ranking merges per-shard lists "
                "before the global re-rank; serve via run_stream_sync")
        self.cascade = self.deferred and snap.filter_kind == "cascade"
        self.rm = int(snap.cfg.rerank_mult) if self.deferred else 1
        # wide = the slot list's pool multiplier: the cascade's promote
        # pool, else the re-rank pool (1 when not deferred)
        self.wide = max(int(snap.cfg.promote_mult), self.rm) \
            if self.cascade else self.rm
        self.svc = svc
        self.cfg = snap.cfg
        self.EF = int(ef or svc.ef0)
        self.EFW = self.EF * self.wide   # the slot list's width
        self.ef_policy = int(min(ef_policy or svc.ef0, self.EF))
        self.S = int(n_slots or svc.batch)
        self.quantum = int(quantum)
        self.W = self.cfg.expand_width
        self.max_queue = int(max_queue)
        self.slo_ms = slo_ms
        self.adaptive = bool(adaptive_budget)
        self.tracer = svc.tracer
        self.device = snap.device
        r = svc.stats.registry
        self._g_depth = r.gauge("phnsw_sched_queue_depth",
                                "admission queue depth")
        self._g_occ = r.gauge("phnsw_sched_slot_occupancy",
                              "fraction of slots in flight")
        self._c_shed = r.counter("phnsw_sched_shed_total",
                                 "requests shed by admission control",
                                 labels=("reason",))
        self._c_esc = r.counter("phnsw_sched_escalations_total",
                                "per-query step-budget escalations")
        self._c_adm = r.counter("phnsw_sched_admitted_total",
                                "queries admitted into slots")
        self._c_ret = r.counter("phnsw_sched_retired_total",
                                "queries retired from slots")
        self.steps_hist = r.histogram(
            "phnsw_sched_slot_steps",
            "expansion steps per retired query (drives the p50 "
            "initial budget)")
        # host mirrors of the per-slot bookkeeping (the device state
        # carries only what the programs read)
        self._rid_of = np.full(self.S, -1, np.int64)
        self._budget = np.zeros(self.S, np.int32)
        self._cap = np.zeros(self.S, np.int32)
        # per-slot promote-keep width (cascade: ef_eff * rerank_mult)
        self._keep = np.zeros(self.S, np.int32)
        self._meta: Dict[int, _Pending] = {}
        self._queue: Deque[_Pending] = deque()
        self._next_rid = 0
        self._escalated = False
        self._live_mask: Optional[np.ndarray] = None   # test override
        D = int(snap.high.shape[-1])
        self._D = D
        qp_ex = svc.filt.prepare(np.zeros((1, D), np.float32))
        self.state = st.make_slot_state(
            snap, self.S, qp_ex, ef=self.EFW,
            n_shards=snap.n_shards if self.sharded else None,
            deferred=self.deferred)
        if self.sharded:
            self._offsets = np.asarray(svc.sdb.offsets, np.int64)
        # WIDTH LADDER: slots are allocated low-first and each tick steps
        # the smallest prefix covering the highest live slot — a fixed
        # set of widths
        self.rungs = sorted({self.S} | set(range(16, self.S, 16)))
        # warm every program with a no-op admission (every pad row's
        # slot id is out of range) and an empty step (all budgets 0);
        # nothing is recorded, so the service's stats stay clean
        dbv = self._db()
        for wd in self.rungs:
            self.state = self._admit_step_call(
                dbv, np.zeros((wd, D), np.float32),
                np.full(wd, self.S, np.int32),
                np.full(wd, self.EFW, np.int32),
                np.zeros(wd, np.int32), wd)
            self.state = self._step_call(dbv, wd)
        if self.deferred:
            # warm the retirement passes too (all-pad rows)
            pad_fi = torch.full((self.S, self.EFW), -1, dtype=torch.int32,
                                device=self.device)
            if self.cascade:
                st._retire_promote(
                    self.svc.db, self.state.qprep, pad_fi,
                    torch.zeros((self.S,), dtype=torch.int32,
                                device=self.device))
            st._retire_rerank(self.svc.db, self.state.q_high, pad_fi)

    # -- plumbing ----------------------------------------------------------

    def _db(self):
        return stacked_db_view(self.svc.sdb) if self.sharded \
            else self.svc.db

    def _live(self) -> np.ndarray:
        """[P] live-shard mask: the service's fault-plane health when it
        has one, a test override otherwise, else all-live."""
        if not self.sharded:
            return np.ones(1, bool)
        if self.svc.health is not None:
            return ~np.asarray(self.svc.health.dead, bool)
        if self._live_mask is not None:
            return self._live_mask
        return np.ones(self.svc.sdb.n_shards, bool)

    def set_live(self, mask) -> None:
        """Degraded-mode override for tests and benches without a fault
        policy: serve from the ``mask``-live shards only."""
        self._live_mask = np.asarray(mask, bool)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _admit_step_call(self, dbv, q_new, slot_ids, ef_eff, budget,
                         width):
        qp = self.svc.filt.prepare(q_new)
        args = (self._tensor(q_new),
                self._tensor(np.asarray(qp, np.float32)),
                self._tensor(slot_ids), self._tensor(ef_eff),
                self._tensor(budget))
        fn = st._slot_admit_step_sharded if self.sharded \
            else st._slot_admit_step
        return fn(dbv, self.state, *args, width, self.quantum, self.W,
                  self.deferred)

    def _step_call(self, dbv, width):
        if width >= self.S:
            fn = st._slot_step_sharded if self.sharded else st._slot_step
            return fn(dbv, self.state, self.quantum, self.W, self.deferred)
        fn = st._slot_step_prefix_sharded if self.sharded \
            else st._slot_step_prefix
        return fn(dbv, self.state, width, self.quantum, self.W,
                  self.deferred)

    def _push_budget(self) -> None:
        b = self._tensor(self._budget)
        if self.sharded:
            b = b.expand(self.state.budget.shape).contiguous()
        self.state = dataclasses.replace(self.state, budget=b)

    def _static_cap(self, ef_eff: int) -> int:
        """The per-request step bound — the bound the synchronous program
        runs with for this effective ef."""
        if self.cfg.step_budget is not None:
            cap = self.cfg.max_steps_for_layer(0)
        else:
            cap = 4 * ef_eff + 16
        return -(-cap // self.W) * self.W

    def _initial_budget(self, ef_eff: int) -> int:
        """Start at the observed p50 step budget once telemetry exists
        (>= 64 retired queries), else the static bound."""
        cap = self._static_cap(ef_eff)
        if not self.adaptive or self.steps_hist.count < 64:
            return cap
        b = int(np.ceil(self.steps_hist.percentile(50))) + 1
        b = -(-b // self.W) * self.W
        return int(min(max(b, self.W), cap))

    # -- admission ---------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        return int((self._rid_of >= 0).sum())

    def has_capacity(self) -> bool:
        return len(self._queue) < self.max_queue

    def submit(self, q, *, k: int = 10, rid: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               t_sched: Optional[float] = None) -> Optional[int]:
        """Enqueue one query. ``k`` results come back (k <= EF).
        ``deadline_ms`` (or the scheduler's ``slo_ms``) arms deadline
        shedding; ``t_sched`` is the open-loop scheduled arrival the
        latency clock starts from (default now). Returns the request
        id, or None when admission control SHEDS the request (queue
        full / deadline passed)."""
        if k > self.EF:
            raise ValueError(f"k={k} exceeds the compiled result "
                             f"width EF={self.EF}; construct the "
                             f"scheduler with ef>={k}")
        now = time.monotonic()
        t_sched = now if t_sched is None else t_sched
        dl_ms = deadline_ms if deadline_ms is not None else self.slo_ms
        deadline = None if dl_ms is None else t_sched + dl_ms / 1e3
        if deadline is not None and now > deadline:
            self._c_shed.labels(reason="deadline").inc()
            return None
        if len(self._queue) >= self.max_queue:
            self._c_shed.labels(reason="queue_full").inc()
            return None
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        ef_eff = int(min(max(k, self.ef_policy), self.EF))
        self._queue.append(_Pending(
            rid=rid, k=int(k), ef_eff=ef_eff, t_submit=now,
            t_sched=t_sched, deadline=deadline,
            q=np.asarray(q, np.float32).reshape(-1)))
        self._g_depth.set(len(self._queue))
        return rid

    # -- the execution loop ------------------------------------------------

    def _admit_step(self, dbv, span) -> int:
        """Admit whatever the queue holds into the lowest free slots and
        advance the bank — one admit-and-step call when there are
        arrivals, a prefix step otherwise, both at the smallest ladder
        width covering the highest live slot."""
        free = np.nonzero(self._rid_of < 0)[0]
        take: List[_Pending] = []
        if len(free) and self._queue:
            now = time.monotonic()
            while self._queue and len(take) < len(free):
                p = self._queue.popleft()
                if p.deadline is not None and now > p.deadline:
                    self._c_shed.labels(reason="deadline").inc()
                    span.event("shed", rid=p.rid)
                    continue
                take.append(p)
        for row, p in enumerate(take):
            s = int(free[row])
            self._rid_of[s] = p.rid
            self._budget[s] = self._initial_budget(p.ef_eff)
            self._cap[s] = self._static_cap(p.ef_eff)
            self._keep[s] = p.ef_eff * self.rm
            self._meta[p.rid] = p
        occ = np.nonzero(self._rid_of >= 0)[0]
        if not len(occ):
            self._g_depth.set(len(self._queue))
            return 0
        wd = next(w for w in self.rungs if w >= int(occ[-1]) + 1)
        if take:
            q_new = np.zeros((wd, self._D), np.float32)
            slot_ids = np.full(wd, self.S, np.int32)
            ef_eff = np.full(wd, self.EFW, np.int32)
            budget = np.zeros(wd, np.int32)
            for row, p in enumerate(take):
                s = int(free[row])
                q_new[row] = p.q
                slot_ids[row] = s
                # deferred slots hold the WIDE filter-space pool, so the
                # effective ef scales with it
                ef_eff[row] = p.ef_eff * self.wide
                budget[row] = self._budget[s]
                p.q = None
            self.state = self._admit_step_call(dbv, q_new, slot_ids,
                                               ef_eff, budget, wd)
            self._c_adm.inc(len(take))
            span.set(admitted=len(take))
        else:
            self.state = self._step_call(dbv, wd)
        self._g_depth.set(len(self._queue))
        return len(take)

    def _retire(self, span) -> List[Completion]:
        self._escalated = False
        occupied = self._rid_of >= 0
        if not occupied.any():
            return []
        done = self.state.done.cpu().numpy()
        ns = self.state.nsteps.cpu().numpy()
        live = self._live()
        if self.sharded:
            if live.any():
                done_eff = done[live].all(axis=0)
                ns_eff = ns[live].max(axis=0)
            else:
                done_eff = np.ones(self.S, bool)
                ns_eff = ns.max(axis=0)
        else:
            done_eff, ns_eff = done, ns
        finished = occupied & done_eff
        # budget escalation: an unconverged slot that spent its budget
        # doubles it (up to the static bound); at the bound it is
        # force-retired with what the static program would have returned
        stalled = occupied & ~done_eff & (ns_eff >= self._budget)
        forced = np.zeros(self.S, bool)
        if stalled.any():
            dirty = False
            for s in np.nonzero(stalled)[0]:
                if self._budget[s] < self._cap[s]:
                    self._budget[s] = min(2 * int(self._budget[s]),
                                          int(self._cap[s]))
                    self._c_esc.inc()
                    dirty = True
                else:
                    forced[s] = True
            if dirty:
                self._push_budget()
                self._escalated = True
        finished = finished | forced
        if not finished.any():
            return []
        if self.deferred:
            # the promote (cascade) and Dist.H passes over THIS tick's
            # retiring slots at the full bank width (non-retiring rows
            # ride as fi = -1 pads): the final blocks of the synchronous
            # deferred program, so results are bit-equal
            db = self.svc.db
            fin = self._tensor(finished)
            fi_b = torch.where(fin[:, None], self.state.F_i, -1)
            if self.cascade:
                keep = np.where(finished, self._keep, 0).astype(np.int32)
                _, fi_b = st._retire_promote(db, self.state.qprep, fi_b,
                                             self._tensor(keep))
            rd, ri, _ = st._retire_rerank(db, self.state.q_high, fi_b)
            fd, fi = rd.cpu().numpy(), ri.cpu().numpy()
        else:
            fd = self.state.F_d.cpu().numpy()
            fi = self.state.F_i.cpu().numpy()
        degraded = self.sharded and bool(~live.all())
        cov = self.svc._coverage(live) if degraded else 1.0
        now = time.monotonic()
        out: List[Completion] = []
        for s in np.nonzero(finished)[0]:
            p = self._meta.pop(int(self._rid_of[s]))
            kq = p.k
            if self.sharded:
                ds = np.concatenate([fd[pp, s] for pp in
                                     np.nonzero(live)[0]])
                gs = np.concatenate(
                    [np.where(fi[pp, s] >= 0,
                              fi[pp, s] + self._offsets[pp], -1)
                     for pp in np.nonzero(live)[0]])
                order = np.argsort(ds, kind="stable")[:kq]
                ids, dists = gs[order], ds[order]
            else:
                ids, dists = fi[s, :kq].copy(), fd[s, :kq].copy()
            lat = (now - p.t_sched) * 1e3
            out.append(Completion(
                rid=p.rid, ids=ids, dists=dists, latency_ms=lat,
                steps=int(ns_eff[s]), forced=bool(forced[s]),
                degraded=degraded, coverage=cov))
            self.steps_hist.observe(float(ns_eff[s]))
            self.svc.stats.record_request(1, lat)
            if degraded:
                self.svc.stats.record_degraded(cov)
            self._rid_of[s] = -1
            self._budget[s] = 0
        self._c_ret.inc(len(out))
        if out:
            span.set(retired=len(out))
        return out

    def tick(self) -> List[Completion]:
        """One scheduler round: admit -> step -> escalate/retire.
        Returns the queries that completed this round (out of order by
        design — exactly once per rid)."""
        span = self.tracer.span("sched.tick")
        with span:
            dbv = self._db()
            self._admit_step(dbv, span)
            out = self._retire(span)
            # escalation pass: a budget-frozen slot whose budget just
            # doubled resumes NOW instead of waiting out a whole round
            # (done slots stay masked)
            passes = 0
            while self._escalated and passes < 2:
                occ = np.nonzero(self._rid_of >= 0)[0]
                if not len(occ):
                    break
                wd = next(w for w in self.rungs
                          if w >= int(occ[-1]) + 1)
                self.state = self._step_call(dbv, wd)
                out.extend(self._retire(span))
                passes += 1
            self._g_occ.set(self.in_flight / self.S)
        return out

    def drain(self) -> List[Completion]:
        """Tick until the queue and every slot are empty; returns all
        completions in retirement order."""
        out: List[Completion] = []
        while self._queue or (self._rid_of >= 0).any():
            out.extend(self.tick())
        return out

    @staticmethod
    def cache_sizes():
        """The slotted programs' key counts (``slot_cache_sizes``) — the
        no-new-programs assertions."""
        return st.slot_cache_sizes()
