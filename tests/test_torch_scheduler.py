"""repro_torch's slotted search and continuous-batching scheduler against
``repro.core.search_jax`` and ``repro.serve.scheduler``.

Both packages serve the very same state: the reference ``PackedDB`` (or
shard graphs, or mutable indexes adopted from one graph) carried into
the port, on the exact-arithmetic fixture of tests/test_torch_search.py
(small-integer vectors, a coordinate-selecting 'PCA', integer PQ
centroids), so every f32 sum is exact and the two are held bit for bit:

* the slotted programs (``make_slot_state``, admission, step, prefix
  step, admit-and-step) give the reference's ``SlotState`` field for
  field in the pca, pq, pca-deferred and cascade-deferred modes, with
  and without tombstones, including a bank that mixes live, done and
  budget-frozen slots with a quantum below the trips they need, and
  slots frozen exactly where they converge (the loop-exit trap: the
  reference runs a trip only while some slot can progress);
* the same submit/tick script on both schedulers gives the same
  completions tick by tick (rid, ids, dists, steps, forced) and the same
  escalation and shed counters: mixed k, queue overflow, past and
  expiring deadlines, adaptive against fixed budgets;
* ``run_stream()`` serves through the scheduler, bit-equal to
  ``run_stream_sync()`` and to the reference's ``run_stream``, single
  shard (deferred modes too), at P = 3, with a dead shard (degraded,
  exact coverage, none of its ids), and on a mutable index between
  upserts and deletes; ``slot_cache_sizes()`` does not grow under churn;
* ``ref.trip_fold_ref`` gated per row (``ef_eff``, ``pop``) is bit-equal
  to the reference body's lines.
"""
import dataclasses
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core import distributed as rdist
from repro.core import search_jax as sj
from repro.core.graph import HNSWGraph as RefGraph
from repro.index import MutableIndex as RefIndex
from repro.kernels import ref as jref
from repro.serve.vector_service import VectorSearchService as RefService
from repro_torch.configs.base import PHNSWConfig
from repro_torch.constants import INF
from repro_torch.core import distributed as tdist
from repro_torch.core import search_torch as st
from repro_torch.core.graph import build_hnsw
from repro_torch.index import MutableIndex
from repro_torch.kernels import ops, ref
from repro_torch.serve.scheduler import SchedulerUnsupported
from repro_torch.serve.vector_service import VectorSearchService
from test_torch_fold import fold_inputs
from test_torch_search import _int_filters, _ref_db, ref_db_arrays

N, NQ, S = 600, 96, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several workers on the host's cores: one torch
    thread each keeps the plain CPU kernels from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture():
    """600 integer vectors in [0, 8)^16, a graph over them, 96 integer
    queries and 10% of the points marked for tombstones."""
    rng = np.random.default_rng(2024)
    x = rng.integers(0, 8, (N, 16)).astype(np.float32)
    q = rng.integers(0, 8, (NQ, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int600", n_points=N, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=128)
    g = build_hnsw(x, cfg, seed=1, device="cpu")
    dead = np.zeros(N, bool)
    dead[rng.choice(N, N // 10, replace=False)] = True
    return cfg, g, x, q, dead


# (filter kind, deferred) of the modes; rerank_mult 2 keeps the deferred
# pools narrow
MODES = {"pca": ("pca", False), "pq": ("pq", False),
         "pca-deferred": ("pca", True), "cascade-deferred": ("cascade", True)}


def _dbs(fixture, mode, tombs):
    """(reference db, port db, reference filter, port filter, cfg)."""
    cfg, g, _, _, dead = fixture
    kind, deferred = MODES[mode]
    cfg = dataclasses.replace(cfg, deferred_rerank=deferred, rerank_mult=2,
                              promote_mult=3)
    g = dataclasses.replace(g, cfg=cfg)
    rfilt, tfilt = _int_filters(kind)
    jdb = _ref_db(cfg, g, kind, rfilt)
    arrays = ref_db_arrays(jdb)
    if tombs:
        jdb = dataclasses.replace(
            jdb, deleted=jnp.asarray(sj.pack_bitmap(dead)))
        arrays["deleted"] = np.asarray(jdb.deleted)
    return jdb, st.from_reference(arrays, cfg, device="cpu"), rfilt, \
        tfilt, cfg


def _assert_state_equal(js, ts, what):
    for f in st._SLOT_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {f}")


class _Twin:
    """The same slotted calls on both packages, each state held to the
    other after every call."""

    def __init__(self, jdb, tdb, W, deferred):
        self.jdb, self.tdb, self.W, self.deferred = jdb, tdb, W, deferred

    def bank(self, qp, ef):
        self.js = sj.make_slot_state(self.jdb, S, qp, ef=ef,
                                     deferred=self.deferred)
        self.ts = st.make_slot_state(self.tdb, S, qp, ef=ef,
                                     deferred=self.deferred)
        _assert_state_equal(self.js, self.ts, "empty bank")

    def admit(self, q, qp, ids, efe, bud, width=None, quantum=0):
        a = [np.asarray(v) for v in (q, qp, ids, efe, bud)]
        if width is None:
            self.js = sj._slot_admit_jit(self.jdb, self.js,
                                         *map(jnp.asarray, a),
                                         deferred=self.deferred)
            self.ts = st._slot_admit(self.tdb, self.ts,
                                     *map(torch.from_numpy, a),
                                     deferred=self.deferred)
        else:
            self.js = sj._slot_admit_step_jit(
                self.jdb, self.js, *map(jnp.asarray, a), width, quantum,
                self.W, self.deferred)
            self.ts = st._slot_admit_step(
                self.tdb, self.ts, *map(torch.from_numpy, a), width,
                quantum, self.W, self.deferred)
        _assert_state_equal(self.js, self.ts, f"admit width={width}")

    def step(self, quantum, width=None):
        # the port's programs never write a state they were handed
        held, before = self.ts, [t.clone() for t in self.ts.fields()]
        if width is None:
            self.js = sj._slot_step_jit(self.jdb, self.js, quantum, self.W,
                                        self.deferred)
            self.ts = st._slot_step(self.tdb, self.ts, quantum, self.W,
                                    self.deferred)
        else:
            self.js = sj._slot_step_prefix_jit(self.jdb, self.js, width,
                                               quantum, self.W,
                                               self.deferred)
            self.ts = st._slot_step_prefix(self.tdb, self.ts, width,
                                           quantum, self.W, self.deferred)
        _assert_state_equal(self.js, self.ts, f"step {quantum} {width}")
        assert all(torch.equal(a, b) for a, b in zip(held.fields(), before))

    def set_budget(self, bud):
        self.js = dataclasses.replace(self.js, budget=jnp.asarray(bud))
        self.ts = dataclasses.replace(self.ts, budget=torch.from_numpy(bud))


# (mode, tombstones): every mode, each tombstone setting twice
SLOT_CASES = [("pca", False), ("pca", True), ("pq", True),
              ("pca-deferred", False), ("cascade-deferred", True)]


@pytest.mark.parametrize("mode,tombs", SLOT_CASES)
def test_slot_programs_bit_equal(fixture, mode, tombs):
    q = fixture[3]
    jdb, tdb, rfilt, _, cfg = _dbs(fixture, mode, tombs)
    deferred = MODES[mode][1]
    EF = 10 * {"pca-deferred": 2, "cascade-deferred": 3}.get(mode, 1)
    qp = np.asarray(rfilt.prepare(q), np.float32)
    tw = _Twin(jdb, tdb, cfg.expand_width, deferred)
    full = lambda v: np.full(S, v, np.int32)
    # every admission is S rows wide (one program), pads carrying slot
    # ids past S; mixed effective ef and budgets from 1 step to unbounded
    tw.bank(qp, EF)
    ids = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, S, S + 5, 9] + [S] * 4,
                   np.int32)
    efe = np.array([EF, EF // 2, EF, 3, EF, EF, 4, EF, EF, EF, EF, EF]
                   + [EF] * 4, np.int32)
    bud = np.array([4, 1000, 2, 1000, 8, 1, 1000, 16, 1000, 0, 0, 6]
                   + [0] * 4, np.int32)
    tw.admit(q[:S], qp[:S], ids, efe, bud)
    # a quantum below the trips the bank needs: live, done and frozen
    # slots side by side, then the rest to the end
    tw.step(3)
    tw.step(64)
    frozen = (~tw.ts.done) & (tw.ts.nsteps >= tw.ts.budget)
    assert bool(frozen[:10].any()), "the bank should hold frozen slots"
    # escalate the frozen slots and step a prefix, then refill slots
    # 10..15 through the admit-and-step program
    tw.set_budget(np.where(frozen.numpy(), 1000, tw.ts.budget.numpy())
                  .astype(np.int32))
    tw.step(3, width=8)
    tw.admit(q[S:2 * S], qp[S:2 * S],
             np.array([10, 11, 12, 13, 14, 15] + [S] * 10, np.int32),
             full(EF), full(12), width=S, quantum=3)
    tw.step(64)
    # the loop-exit trap: each slot's budget exactly the steps it takes
    # to converge, so the slot that needs the most freezes, converged,
    # in the very trip after which the reference's loop stops; one more
    # trip would latch its done
    tw.bank(qp, EF)
    tw.admit(q[:S], qp[:S], np.arange(S, dtype=np.int32), full(EF),
             full(1000))
    tw.step(64)
    natural = tw.ts.nsteps.numpy()
    assert bool(tw.ts.done.all())
    pick = np.nonzero(natural % st.DONE_CHECK_EVERY != 0)[0]
    tw.bank(qp, EF)
    tw.admit(q[:S], qp[:S], np.where(np.isin(np.arange(S), pick),
                                     np.arange(S), S).astype(np.int32),
             full(EF), natural)
    tw.step(64)
    stuck = (~tw.ts.done) & (tw.ts.nsteps >= tw.ts.budget)
    assert bool(stuck.any()), "no slot froze at its convergence"


# ------------------------------- scheduler ---------------------------------

def _services(fixture, mode="pca", tombs=False, batch=S):
    jdb, tdb, rfilt, tfilt, _ = _dbs(fixture, mode, tombs)
    rs = RefService(jdb, filt=rfilt, batch_size=batch)
    ts = VectorSearchService(tdb, filt=tfilt, batch_size=batch,
                             device="cpu")
    return rs, ts


def _ticks(sched, script):
    """Run ``script`` (a list of ("submit", kwargs) / ("tick",) /
    ("sleep", s)) on a scheduler; returns each tick's completions as
    (rid, ids, dists, steps, forced) and each submit's returned rid."""
    out = []
    for step in script:
        if step[0] == "submit":
            out.append(("rid", step[1].get("rid"),
                        sched.submit(**step[1])))
        elif step[0] == "sleep":
            time.sleep(step[1])
        else:
            out.append(_tick(sched))
    while sched.in_flight or sched.queue_depth:
        out.append(_tick(sched))
    return out


def _tick(sched):
    """One tick's completions in retirement order."""
    return [(c.rid, np.asarray(c.ids, np.int64).tolist(),
             np.asarray(c.dists).tolist(), c.steps, c.forced)
            for c in sched.tick()]


def _counters(svc):
    reg = svc.stats.registry
    shed = reg.get("phnsw_sched_shed_total")
    return {"escalations": reg.get("phnsw_sched_escalations_total").value,
            "admitted": reg.get("phnsw_sched_admitted_total").value,
            "retired": reg.get("phnsw_sched_retired_total").value,
            "shed_full": shed.labels(reason="queue_full").value,
            "shed_deadline": shed.labels(reason="deadline").value}


def test_scheduler_mixed_k_ticks_equal(fixture):
    """Mixed k (4 or 24 at ef=24; 8 trips a tick) with arrivals between
    ticks: equal completions tick by tick, out of submission order, each
    answer the synchronous program's at that request's effective ef."""
    q = fixture[3]
    rs, ts = _services(fixture)
    script = []
    for i in range(48):
        script.append(("submit", dict(q=q[i], k=4 if i % 2 else 24,
                                      rid=i)))
        if i % 12 == 11:
            script.append(("tick",))
    got = {}
    for svc in (rs, ts):
        got[svc is ts] = _ticks(svc.scheduler(ef=24, n_slots=S, quantum=8),
                               script)
    assert got[True] == got[False]
    order = [c[0] for tick in got[True] if isinstance(tick, list)
             for c in tick]
    assert sorted(order) == list(range(48)) and order != sorted(order)
    assert _counters(ts) == _counters(rs)
    # each answer is the synchronous program's at ef_eff = max(k, 10)
    done = {c[0]: c for tick in got[True] if isinstance(tick, list)
            for c in tick}
    for ef_eff, ks in ((24, 24), (10, 4)):
        _, fi = st.search_batched(ts.db, q[:48], ts.filt.prepare(q[:48]),
                                  ef0=ef_eff, device="cpu")
        for i in range(48):
            if (4 if i % 2 else 24) == ks:
                assert done[i][1] == fi[i, :ks].tolist()


def test_scheduler_shed_ticks_equal(fixture):
    """Queue overflow sheds at submit, a deadline already past sheds at
    submit, one that expires in the queue sheds at admission: the same
    counters and completions in both packages; shed + delivered ==
    submitted."""
    q = fixture[3]
    rs, ts = _services(fixture)
    script = [("submit", dict(q=q[i], k=10)) for i in range(6)]
    script.append(("submit", dict(q=q[6], k=10, deadline_ms=1.0,
                                  t_sched=time.monotonic() - 10.0)))
    script.append(("tick",))
    script.append(("submit", dict(q=q[7], k=10, deadline_ms=1.0)))
    script.append(("sleep", 0.02))
    script.append(("tick",))
    got, counts = {}, {}
    for svc in (rs, ts):
        # both late requests carry an absolute scheduled arrival in the
        # past, fixed before the run
        sched = svc.scheduler(n_slots=S, max_queue=4)
        got[svc is ts] = _ticks(sched, script)
        counts[svc is ts] = _counters(svc)
    assert got[True] == got[False]
    assert counts[True] == counts[False]
    c = counts[True]
    assert c["shed_full"] == 2 and c["shed_deadline"] == 2
    delivered = [r for tick in got[True] if isinstance(tick, list)
                 for r in tick]
    assert len(delivered) == 4 == c["retired"]


def test_scheduler_adaptive_against_fixed(fixture):
    """Adaptive budgets (p50 start after 64 retirements, escalation up
    to the static bound) give the fixed-budget answers; escalation
    counts and every tick equal to the reference's."""
    q = fixture[3]
    rs, ts = _services(fixture)
    script = [("submit", dict(q=q[i], k=10, rid=i)) for i in range(NQ)]
    runs = {}
    for svc in (rs, ts):
        fixed = _ticks(svc.scheduler(n_slots=S, adaptive_budget=False),
                       script)
        adaptive = svc.scheduler(n_slots=S)
        first = _ticks(adaptive, script)
        esc0 = _counters(svc)["escalations"]
        second = _ticks(adaptive, script)
        runs[svc is ts] = (fixed, first, second,
                           _counters(svc)["escalations"] - esc0)
    assert runs[True] == runs[False]
    fixed, _, second, esc = runs[True]
    assert esc > 0, "p50 budgets should force escalations"
    ans = lambda ticks: sorted(c[:3] for t in ticks if isinstance(t, list)
                               for c in t)
    assert ans(second) == ans(fixed)


@pytest.mark.parametrize("mode,tombs", [("pca", False), ("pq", True),
                                        ("pca-deferred", True),
                                        ("cascade-deferred", False)])
def test_run_stream_bit_equal_to_sync(fixture, mode, tombs):
    """``run_stream()`` defaults to the scheduler, bit-equal to the
    synchronous path and to the reference's ``run_stream``."""
    q = fixture[3][:40]
    rs, ts = _services(fixture, mode, tombs)
    assert ts.scheduler_supported and rs.scheduler_supported
    ids, stats = ts.run_stream(q)
    assert stats["path"] == "scheduler"
    sync, sstats = ts.run_stream_sync(q)
    assert sstats["path"] == "sync"
    np.testing.assert_array_equal(ids, sync.astype(np.int64))
    rids, _ = rs.run_stream(q)
    np.testing.assert_array_equal(ids, rids)
    again, _ = ts.run_stream(q[::-1])
    np.testing.assert_array_equal(again, ids[::-1])


def _sharded_services(fixture, P=3, deferred=False, fault_policy=None):
    cfg, _, x, _, _ = fixture
    cfg = dataclasses.replace(cfg, deferred_rerank=deferred)
    graphs = [build_hnsw(x[a:b], cfg, seed=1 + s, device="cpu")
              for s, (a, b) in enumerate(tdist.shard_bounds(N, P))]
    rcfg = RefConfig(**dataclasses.asdict(cfg))
    rgraphs = [RefGraph(cfg=rcfg, x=g.x, levels=g.levels, layers=g.layers,
                        entry=g.entry) for g in graphs]
    rfilt, tfilt = _int_filters("pca")
    rsdb = rdist.build_sharded(x, rcfg, rfilt, P, graphs=rgraphs)
    tsdb = tdist.build_sharded(x, cfg, tfilt, P, graphs=graphs,
                               device="cpu")
    rs = RefService(rsdb, filt=rfilt, batch_size=S)
    ts = VectorSearchService(tsdb, filt=tfilt, batch_size=S, device="cpu",
                             fault_policy=fault_policy)
    return rs, ts, tsdb


def test_sharded_scheduler_bit_equal_and_degraded(fixture):
    """P = 3: ``run_stream`` equal to the synchronous shard loop and to
    the reference; with shard 1 dead through ``set_live`` every
    completion is degraded with the exact coverage, holds none of its
    ids and equals the reference's tick by tick."""
    q = fixture[3]
    rs, ts, tsdb = _sharded_services(fixture)
    ids, stats = ts.run_stream(q[:40])
    assert stats["path"] == "scheduler"
    np.testing.assert_array_equal(ids, ts.run_stream_sync(q[:40])[0])
    np.testing.assert_array_equal(ids, rs.run_stream(q[:40])[0])
    script = [("submit", dict(q=q[i], k=10, rid=i)) for i in range(40)]
    got, cov = {}, {}
    for svc in (rs, ts):
        sched = svc.scheduler()
        sched.set_live([True, False, True])
        comps = []
        for step in script:
            sched.submit(**step[1])
        while sched.in_flight or sched.queue_depth:
            comps.extend(sched.tick())
        got[svc is ts] = sorted((c.rid, np.asarray(c.ids).tolist(),
                                 np.asarray(c.dists).tolist(), c.steps)
                                for c in comps)
        cov[svc is ts] = {(c.degraded, c.coverage) for c in comps}
    assert got[True] == got[False]
    assert cov[True] == cov[False]
    assert len(got[True]) == 40
    lo = int(tsdb.offsets[1])
    hi = lo + int(tsdb.counts[1])
    (deg, c), = cov[True]
    live = ts._live_counts
    assert deg and c == (live[0] + live[2]) / live.sum()
    for _, gids, _, _ in got[True]:
        g = np.asarray(gids)
        assert not ((g >= lo) & (g < hi)).any()


def test_scheduler_supported_and_sharded_deferred_raises(fixture):
    """``scheduler_supported`` as the reference decides it: single shard,
    sharded and single-shard deferred are served; sharded deferred is
    not (``run_stream`` then serves the synchronous path) and its
    ``scheduler()`` raises ``SchedulerUnsupported``."""
    rs, ts, _ = _sharded_services(fixture, P=2, deferred=True)
    assert not ts.scheduler_supported and not rs.scheduler_supported
    with pytest.raises(SchedulerUnsupported):
        ts.scheduler()
    q = fixture[3][:20]
    ids, stats = ts.run_stream(q)
    assert stats["path"] == "sync"
    np.testing.assert_array_equal(ids, rs.run_stream(q)[0])


def test_mutable_service_between_drains(fixture):
    """A ``MutableIndex``-backed service: drains between upserts and
    deletes serve the new epoch, bit-equal to the reference's scheduler
    and to the port's synchronous path, no deleted id returned."""
    cfg, g, x, q, _ = fixture
    cfg = dataclasses.replace(cfg, ef_construction=16, ef_construction_k=8,
                              insert_batch=32)
    g = dataclasses.replace(g, cfg=cfg)
    rfilt, tfilt = _int_filters("pca")
    rcfg = RefConfig(**dataclasses.asdict(cfg))
    ridx = RefIndex.from_graph(RefGraph(cfg=rcfg, x=g.x, levels=g.levels,
                                        layers=g.layers, entry=g.entry),
                               rfilt, seed=3)
    tidx = MutableIndex.from_graph(g, tfilt, seed=3, device="cpu")
    for idx in (ridx, tidx):
        idx.reserve(1024)
    rs = RefService(ridx, batch_size=S)
    ts = VectorSearchService(tidx, batch_size=S, device="cpu")
    rng = np.random.default_rng(9)
    for rnd in range(3):
        ids, stats = ts.run_stream(q[:32])
        assert stats["path"] == "scheduler"
        np.testing.assert_array_equal(ids, rs.run_stream(q[:32])[0])
        np.testing.assert_array_equal(ids, ts.run_stream_sync(q[:32])[0])
        assert not np.isin(ids, np.nonzero(tidx.deleted)[0]).any()
        new = rng.integers(0, 8, (40, 16)).astype(np.float32)
        np.testing.assert_array_equal(ts.upsert(new), rs.upsert(new))
        doomed = rng.choice(tidx.n, 30, replace=False)
        assert ts.delete(doomed) == rs.delete(doomed)
    assert ts.scheduler().cache_sizes() == st.slot_cache_sizes()


def test_no_new_keys_under_churn(fixture):
    """Steady state — admission churn, mixed k, escalation, repeated
    waves, another run_stream — calls the slotted programs with no new
    (static arguments, shapes) key."""
    q = fixture[3]
    _, ts = _services(fixture)
    sched = ts.scheduler()
    ts.run_stream(q[:32])
    warm = st.slot_cache_sizes()
    assert warm[0] > 0 and warm[1 + 5] > 0
    for wave in range(3):
        for i in range(30):
            sched.submit(q[(wave * 30 + i) % NQ], k=(i % 10) + 1)
        sched.drain()
    ts.run_stream(q[32:64])
    assert st.slot_cache_sizes() == warm


# ------------------------------ gated fold ---------------------------------

def jax_fold_gated(F_d, F_i, C_d, C_i, W, Cp, dh, cand, kv, deleted,
                   ef_eff, pop):
    """The slotted body's lines of search_jax._layer_body from the bound
    to the three merges: the bound at ef_eff, the pop where ``pop``."""
    B, kk = dh.shape
    ef = F_d.shape[1]
    bnd = jnp.take_along_axis(F_d, jnp.maximum(ef_eff, 1)[:, None] - 1,
                              axis=1)
    sh_d = jnp.concatenate([C_d[:, W:], jnp.full((B, W), INF)], 1)
    sh_i = jnp.concatenate([C_i[:, W:], jnp.full((B, W), -1, jnp.int32)], 1)
    C_d = jnp.where(pop[:, None], sh_d, C_d)
    C_i = jnp.where(pop[:, None], sh_i, C_i)
    accept = dh < bnd
    rows_d = [jnp.where(accept, dh, INF)]
    rows_i = [jnp.where(accept, cand, -1)]
    if deleted is not None:
        okF = accept & ~sj._tombstone_bit(deleted, cand)
        rows_d.insert(0, jnp.where(okF, dh, INF))
        rows_i.insert(0, jnp.where(okF, cand, -1))
    if kv is not None:
        rows_d.append(jnp.where(accept, kv, INF))
        rows_i.append(jnp.zeros((B, kk), jnp.int32))
    s_d, s_i = sj._rank_sort_with_payload(jnp.concatenate(rows_d, 0),
                                          jnp.concatenate(rows_i, 0))
    r = B if deleted is not None else 0
    sd, si = s_d[r:r + B], s_i[r:r + B]
    fd_n, fi_n = (s_d[:B], s_i[:B]) if deleted is not None else (sd, si)
    F_d, F_i = jref.merge_topk_sorted_ref(F_d, F_i, fd_n, fi_n, ef)
    C_d, C_i = jref.merge_topk_sorted_ref(C_d, C_i, sd, si, C_d.shape[1])
    if Cp is not None:
        k = Cp.shape[1]
        pv = s_d[r + B:] if kv is not None else sd
        Cp, _ = jref.merge_topk_sorted_ref(
            Cp, jnp.zeros((B, k), jnp.int32), pv,
            jnp.zeros((B, pv.shape[1]), jnp.int32), k)
    return F_d, F_i, C_d, C_i, Cp


@pytest.mark.parametrize("mode", ["per_step", "deferred_tombstones",
                                  "bypass"])
@pytest.mark.parametrize("ef,k,W,kk", [(10, 16, 1, 16), (30, 16, 2, 32)])
def test_trip_fold_gated_bit_equal_to_the_jax_lines(ef, k, W, kk, mode):
    heap, kv_row, tombs = {"per_step": (True, True, False),
                           "deferred_tombstones": (True, False, True),
                           "bypass": (False, False, False)}[mode]
    cap = max(ef + kk, 8)
    rng = np.random.default_rng(ef + kk + len(mode))
    a = fold_inputs(rng, 16, ef, cap, k, kk)
    ef_eff = rng.integers(1, ef + 1, 16).astype(np.int32)
    ef_eff[:2] = (1, ef)
    pop = rng.random(16) < 0.6
    args = [a["F_d"], a["F_i"], a["C_d"], a["C_i"], W,
            a["Cp"] if heap else None, a["dh"], a["cand"],
            a["kv"] if kv_row else None, a["deleted"] if tombs else None]
    t = lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    j = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v
    got = ops.trip_fold(*map(t, args), ef_eff=t(ef_eff), pop=t(pop))
    plain = ref.trip_fold_ref(*map(t, args), ef_eff=t(ef_eff), pop=t(pop))
    want = jax.jit(jax_fold_gated, static_argnums=4)(
        *map(j, args), j(ef_eff), j(pop))
    for g, p, w in zip(got, plain, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == p.dtype and torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # every row popped at the compiled bound is the ungated fold
    full = ops.trip_fold(*map(t, args),
                         ef_eff=torch.full((16,), ef, dtype=torch.int32),
                         pop=torch.ones(16, dtype=torch.bool))
    for g, p in zip(full, ops.trip_fold(*map(t, args))):
        assert (g is None and p is None) or torch.equal(g, p)


def test_load_bench_rows_on_cpu(fixture):
    """``repro_torch.bench.load.run_load`` end to end at a tiny size:
    every row, exact-sample percentiles in order, no request shed, no new
    slotted-program key, recall 1.0 against the synchronous path's
    answers, and an entry that serialises to JSON."""
    import json
    from repro_torch.bench.load import run_load
    q = fixture[3]
    _, ts = _services(fixture)
    gt = ts.run_stream_sync(q)[0][:, :10]
    res = run_load(ts, q, gt, req_size=8, offered_fracs=(0.3, 0.6),
                   n_requests=4, calib_reps=1)
    names = [r[0] for r in res["rows"]]
    for name in ("load/capacity", "load/capacity_tight", "obs/overhead",
                 "load/sync_tight", "load/speedup_p99", "load/mixed_k",
                 "load/new_keys", "obs/cost_model"):
        assert name in names
    e = res["entry"]
    assert e["new_keys"] == [0] * 10
    for pt in e["points"] + e["sched_points"] + [e["mixed_k"]]:
        assert 0 <= pt["p50_ms"] <= pt["p99_ms"] <= pt["p999_ms"]
    for pt in e["sched_points"]:
        assert pt["shed"] == 0 and pt["recall"] == 1.0
    json.dumps(e, default=float)
