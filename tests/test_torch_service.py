"""repro_torch's ``VectorSearchService`` against
``repro.serve.vector_service``.

Both packages serve the very same state: mutable indexes adopted from
one set of shard graphs over the exact-arithmetic fixture (small-integer
vectors, a coordinate-selecting 'PCA'). For the same queries the port's
service gives the reference's ids, dists, ``answered``, ``coverage`` and
``degraded``, and trace span trees with the same span names and the
same event kinds in the same order: healthy, and under a ``FaultPlan``
that kills, corrupts or stalls a shard or kills them all. Mutations
through the service (upserts, deletes, the epoch swap) give the
reference's ids and traces. The remaining cases are the reference's
service cases (tests/test_index.py, tests/test_faults.py,
tests/test_obs.py) on the port: degraded results bit-equal to the
live-mask search, the dead mark and recovery, the retry budget (counted,
with its backoff sleeps recorded, never timed on the wall clock), input
validation, ``nan_policy``, the constructor guards, bounded stats, the
warm-up excluded from the stats, and the disabled tracer allocating no
span. A service over a device mesh (``mesh=``) answers as the
host-sharded one, on span path "mesh", and refuses the scheduler and a
fault policy as the reference's does. The scheduler's cases are in
tests/test_torch_scheduler.py."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core.graph import HNSWGraph as RefGraph
from repro.distributed import faults as rfaults
from repro.index import MutableIndex as RefIndex
from repro.index import ShardedMutableIndex as RefSharded
from repro.obs.trace import Tracer as RefTracer
from repro.serve.vector_service import VectorSearchService as RefService
from repro_torch.configs.base import PHNSWConfig
from repro_torch.core.distributed import make_mesh, shard_bounds
from repro_torch.core.graph import build_hnsw
from repro_torch.core.search_torch import build_packed
from repro_torch.distributed import faults
from repro_torch.distributed.faults import (FaultPlan, FaultPolicy,
                                            ShardKilledError,
                                            SnapshotCorruptError)
from repro_torch.index import MutableIndex, ShardedMutableIndex
from repro_torch.obs import NULL_TRACER, Span, Tracer
from repro_torch.serve import vector_service
from repro_torch.serve.scheduler import SchedulerUnsupported
from repro_torch.serve.vector_service import (ServiceStats,
                                              VectorSearchService)
from test_torch_search import _int_filters

N, P, B = 400, 4, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several workers on the host's cores: one torch
    thread each keeps the plain CPU kernels from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return PHNSWConfig(name="svc400", n_points=N, dim=16, d_low=4, M=8,
                       M0=16, ef_construction=16, wave_size=128,
                       ef_construction_k=8, insert_batch=32,
                       min_capacity=32)


def _cpu_mesh(R, Pn):
    return make_mesh((R, Pn), ("data", "model"), devices=["cpu"] * (R * Pn))


def _ref_graph(g):
    return RefGraph(cfg=RefConfig(**dataclasses.asdict(g.cfg)), x=g.x,
                    levels=g.levels, layers=g.layers, entry=g.entry)


def _int_rows(rng, n):
    return rng.integers(0, 8, (n, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def shard_graphs():
    rng = np.random.default_rng(31)
    x = _int_rows(rng, N)
    q = _int_rows(rng, B)
    cfg = _cfg()
    graphs = [build_hnsw(x[a:b], cfg, seed=1 + s, device="cpu")
              for s, (a, b) in enumerate(shard_bounds(N, P))]
    return cfg, x, q, graphs


def _indexes(shard_graphs):
    """The reference's and the port's sharded index over the same
    graphs."""
    cfg, _, _, graphs = shard_graphs
    rfilt, tfilt = _int_filters("pca")
    ref = RefSharded([RefIndex.from_graph(_ref_graph(g), rfilt,
                                          seed=10 + s)
                      for s, g in enumerate(graphs)], rfilt,
                     RefConfig(**dataclasses.asdict(cfg)))
    port = ShardedMutableIndex(
        [MutableIndex.from_graph(g, tfilt, seed=10 + s, device="cpu")
         for s, g in enumerate(graphs)], tfilt, cfg)
    return ref, port


# a deadline that a loaded host's CPU probes never reach: the fault
# cases below must not depend on the wall clock
POLICY = dict(deadline_ms=5000.0, max_retries=2, backoff_ms=1.0,
              dead_after_failures=2, straggler_factor=4.0, mad_factor=6.0)


@pytest.fixture(scope="module")
def twin_services(shard_graphs):
    """A traced, fault-tolerant service per package over equal state."""
    from repro.distributed.faults import FaultPolicy as RefPolicy
    ref_idx, port_idx = _indexes(shard_graphs)
    rs = RefService(ref_idx, batch_size=B,
                    fault_policy=RefPolicy(**POLICY), tracer=RefTracer())
    ts = VectorSearchService(port_idx, batch_size=B,
                             fault_policy=FaultPolicy(**POLICY),
                             tracer=Tracer(), device="cpu")
    return rs, ts, shard_graphs[2]


@pytest.fixture(autouse=True)
def _clean_faults(request):
    """No test leaks an installed plan or dead marks into the next."""
    yield
    faults.clear()
    rfaults.clear()
    if "twin_services" in request.fixturenames:
        for svc in request.getfixturevalue("twin_services")[:2]:
            for s in range(P):
                svc.recover_shard(s)
            svc.health.failures[:] = 0


@pytest.fixture()
def virtual_clock(monkeypatch):
    """Probe walls on a virtual clock in both packages: ``monotonic``
    reads only the stalls injected so far, so a healthy probe's wall is
    0 and a stalled one's exactly its stall; the straggler monitors'
    verdicts then depend on the fault plan, never on the host's load."""
    import repro.core.distributed as rdist
    import repro_torch.core.distributed as tdist
    slept = []
    clock = types.SimpleNamespace(monotonic=lambda: sum(slept),
                                  sleep=slept.append)
    for mod in (rdist, rfaults, tdist, faults):
        monkeypatch.setattr(mod, "time", clock)
    return slept


def _tree(span):
    """A span tree's names and event kinds, depth first."""
    return [(s.name, s.event_kinds()) for s in span.iter_spans()]


# fault plans (kind, target, param): one event each, or none
PLANS = {"healthy": None, "kill": ("kill_shard", 1, 0.0),
         "corrupt": ("corrupt_shard", 2, 0.0),
         "all_dead": ("kill_shard", -1, 0.0)}


@pytest.mark.parametrize("plan", list(PLANS))
def test_service_matches_reference_under_fault_plans(twin_services, plan,
                                                     virtual_clock):
    rs, ts, q = twin_services
    got = {}
    for name, svc, mod in (("ref", rs, rfaults), ("port", ts, faults)):
        fp = mod.FaultPlan()
        if PLANS[plan] is not None:
            kind, target, param = PLANS[plan]
            fp.add(kind, target, param=param)
        with mod.inject(fp):
            try:
                out = svc.query(q, return_stats=True)
            except Exception as e:               # all shards dead
                out = type(e).__name__
        root = svc.tracer.last("serve.query")
        got[name] = (out, _tree(root), list(fp.log))
    (r_out, r_tree, r_log), (t_out, t_tree, t_log) = got["ref"], got["port"]
    assert t_tree == r_tree
    assert t_log == r_log
    if plan == "all_dead":
        assert r_out == t_out == "AllShardsDeadError"
        return
    (rd, ri, rst), (td, ti, tst) = r_out, t_out
    np.testing.assert_array_equal(ti, np.asarray(ri))
    np.testing.assert_array_equal(td, np.asarray(rd))
    for k in ("coverage", "degraded", "live_shards", "n_shards"):
        assert tst[k] == rst[k], k
    np.testing.assert_array_equal(tst["answered"], rst["answered"])
    assert ts.health.dead.tolist() == rs.health.dead.tolist()


def test_service_straggler_matches_reference(twin_services, virtual_clock):
    """A stalled (slow but correct) shard is flagged by the per-shard
    median+MAD monitor in both packages — and only flagged: coverage
    stays full, and the span trees agree event for event."""
    rs, ts, q = twin_services
    trees = {}
    for name, svc, mod in (("ref", rs, rfaults), ("port", ts, faults)):
        for _ in range(8):                       # build the wall window
            svc.query(q)
        n_ev = len(svc.health.events)
        with mod.inject(mod.FaultPlan()) as fp:
            fp.add("stall_shard", 3, param=0.5)
            _, _, st = svc.query(q, return_stats=True)
        assert st["coverage"] == 1.0 and not st["degraded"]
        assert ("straggler", 3) in [(k, s) for k, s, _ in
                                    svc.health.events[n_ev:]]
        trees[name] = _tree(svc.tracer.last("serve.query"))
    assert trees["port"] == trees["ref"]


def test_service_mutations_match_reference(twin_services):
    """Upserts and deletes through the two services hand out the same
    global ids, trace the same spans and serve the same results."""
    rs, ts, q = twin_services
    xs = _int_rows(np.random.default_rng(5), 10)
    g_r, g_t = rs.upsert(xs), ts.upsert(xs)
    np.testing.assert_array_equal(g_t, g_r)
    assert _tree(ts.tracer.last("serve.upsert")) == \
        _tree(rs.tracer.last("serve.upsert"))
    up = ts.tracer.last("serve.upsert")
    assert [s.name for s in up.iter_spans()] == \
        ["serve.upsert", "publish", "epoch.swap"]
    sw = up.find("epoch.swap")
    assert sw.attrs["to_epoch"] == sw.attrs["from_epoch"] + 1 == ts.epoch
    assert rs.delete(g_r[:3]) == ts.delete(g_t[:3]) == 3
    assert _tree(ts.tracer.last("serve.delete")) == \
        _tree(rs.tracer.last("serve.delete"))
    assert ts.epoch == rs.epoch
    rd, ri = rs.query(xs)
    td, ti = ts.query(xs)
    np.testing.assert_array_equal(ti, np.asarray(ri))
    np.testing.assert_array_equal(td, np.asarray(rd))
    assert not np.isin(ti, g_t[:3]).any()
    assert (ti[3:, 0] == g_t[3:]).all()          # new vectors servable


def test_single_shard_service_matches_reference(shard_graphs):
    """test_index.py's service case on both packages: one MutableIndex,
    upsert -> servable at once, delete -> gone from the next batch; a
    frozen PackedDB service refuses mutation."""
    cfg, x, q, graphs = shard_graphs
    rfilt, tfilt = _int_filters("pca")
    g = graphs[0]
    rsvc = RefService(RefIndex.from_graph(_ref_graph(g), rfilt, seed=1),
                      batch_size=B)
    tsvc = VectorSearchService(MutableIndex.from_graph(g, tfilt, seed=1,
                                                       device="cpu"),
                               batch_size=B, device="cpu")
    e0 = tsvc.epoch
    _, fi_before = tsvc.query(q)
    x_new = _int_rows(np.random.default_rng(12), 40)
    ids = tsvc.upsert(x_new)
    np.testing.assert_array_equal(ids, rsvc.upsert(x_new))
    assert tsvc.epoch > e0
    _, fi_new = tsvc.query(x_new[:B])
    assert (fi_new[:, 0] == ids[:B]).mean() > 0.9
    victim = fi_before[:, 0]
    assert tsvc.delete(victim) == rsvc.delete(victim)
    td, ti = tsvc.query(q)
    rd, ri = rsvc.query(q)
    np.testing.assert_array_equal(ti, np.asarray(ri))
    np.testing.assert_array_equal(td, np.asarray(rd))
    assert not np.isin(ti, victim).any()
    assert tsvc.stats.upserts == 40 and \
        tsvc.stats.deletes == len(np.unique(victim))
    db = build_packed(g, filt=tfilt, device="cpu")
    frozen = VectorSearchService(db, filt=tfilt, batch_size=B,
                                 device="cpu")
    with pytest.raises(RuntimeError):
        frozen.upsert(x_new)
    with pytest.raises(RuntimeError):
        frozen.delete([0])


def test_frozen_sharded_service_serves_global_ids(twin_services):
    """A frozen ShardedDB behind the service serves what the mutable
    index it came from serves."""
    _, ts, q = twin_services
    frozen = VectorSearchService(ts.sindex.sdb, filt=ts.filt, batch_size=B,
                                 device="cpu")
    fd, fi = frozen.query(q)
    td, ti = ts.sindex.search(q)
    np.testing.assert_array_equal(fi, ti.numpy())
    np.testing.assert_array_equal(fd, td.numpy())


# --------------------------------------------------------------------------
# the reference's service cases on the port
# --------------------------------------------------------------------------

def test_service_kill_degrade_recover(twin_services):
    """Kill one of four shards -> requests complete DEGRADED with exact
    coverage and results bit-equal to the live-mask search -> the shard
    is dead-marked after the failure streak (later requests never probe
    it) -> heal + recover -> full coverage and the healthy results."""
    _, svc, q = twin_services
    idx = svc.sindex
    fd_h, fi_h, st = svc.query(q, return_stats=True)
    assert st["coverage"] == 1.0 and not st["degraded"]
    with faults.inject(FaultPlan()) as plan:
        plan.add("kill_shard", 1)
        fd_d, fi_d, st = svc.query(q, return_stats=True)
        assert st["degraded"] and st["live_shards"] == P - 1
        lc = svc._live_counts
        mask = np.ones(P, bool)
        mask[1] = False
        assert st["coverage"] == pytest.approx(lc[mask].sum() / lc.sum())
        fd_o, fi_o = idx.search(q, live=mask)
        np.testing.assert_array_equal(fi_d, fi_o.numpy())
        np.testing.assert_array_equal(fd_d, fd_o.numpy())
        assert svc.health.dead[1]
        hits = len(plan.log)
        svc.query(q)
        assert len(plan.log) == hits, "dead shard still being probed"
        assert svc.stats.degraded_queries >= 2
        root = svc.tracer.last("serve.query")
        assert "skip_dead_shard" in root.event_kinds()
    svc.recover_shard(1)
    fd_r, fi_r, st = svc.query(q, return_stats=True)
    assert st["coverage"] == 1.0 and not st["degraded"]
    np.testing.assert_array_equal(fi_r, fi_h)
    np.testing.assert_array_equal(fd_r, fd_h)


def test_service_retry_backoff_respects_deadline(twin_services,
                                                 monkeypatch):
    """With the dead mark disabled, a killed shard burns its full retry
    budget: max_retries + 1 attempts, each failure followed by an
    exponential backoff capped by what is left of the request's
    deadline, so the pauses sum to at most the deadline. The service
    module's clock is virtual: ``time.sleep`` records the pause and
    advances ``time.monotonic`` by it, so no wall-clock bound enters the
    test."""
    _, svc, q = twin_services
    slept = []
    monkeypatch.setattr(vector_service, "time", types.SimpleNamespace(
        monotonic=lambda: sum(slept), sleep=slept.append))
    pol = FaultPolicy(deadline_ms=80.0, max_retries=4, backoff_ms=5.0,
                      dead_after_failures=10 ** 6)
    old = svc.fault_policy
    svc.fault_policy = svc.health.policy = pol
    try:
        with faults.inject(FaultPlan()) as plan:
            plan.add("kill_shard", 0)
            _, _, st = svc.query(q, return_stats=True)
            assert st["degraded"] and not st["answered"][0]
            assert not svc.health.dead[0]
            kills = [e for e in plan.log if e[1] == "kill_shard"]
            assert len(kills) == pol.max_retries + 1
    finally:
        svc.fault_policy = svc.health.policy = old
    # 5 + 10 + 20 + 40 ms, then the 5 ms left of the 80 ms budget (the
    # subtraction of the clock from the deadline rounds in the last bit)
    assert len(slept) == pol.max_retries + 1
    assert all(s > 0 for s in slept)
    assert sum(slept) == pytest.approx(pol.deadline_ms / 1e3, rel=1e-12)
    assert sum(slept[:-1]) < pol.deadline_ms / 1e3
    probe = svc.tracer.last("serve.query").find_all("shard.probe")[0]
    assert probe.event_kinds() == ["fault", "backoff"] * 5


def test_sharded_mutation_fault_injection(twin_services):
    """Mutations routed to a killed shard raise the typed error; after
    heal the same mutation lands and is immediately servable."""
    _, svc, q = twin_services
    idx = svc.sindex
    xs = np.random.default_rng(5).integers(0, 8, (P, 16)) \
        .astype(np.float32)
    with faults.inject(FaultPlan()) as plan:
        plan.add("kill_shard", 2)
        with pytest.raises(ShardKilledError):
            svc.upsert(xs)
    gids = svc.upsert(xs)
    assert len(gids) == P
    with faults.inject(FaultPlan()) as plan:
        plan.add("kill_shard", int(gids[0] // idx.stride))
        with pytest.raises(ShardKilledError):
            svc.delete(gids[:1])
    assert svc.delete(gids[:1]) == 1


def test_truncate_snapshot_fault_caught_at_load(tmp_path, twin_services):
    """The fault plan chops the sharded npz as it is written; the
    envelope catches it at load."""
    _, svc, _ = twin_services
    p = tmp_path / "ship.npz"
    with faults.inject(FaultPlan()) as plan:
        plan.add("truncate_snapshot", param=0.6)
        svc.sindex.save(p)
        assert any(k == "truncate_snapshot" for _, k, _ in plan.log)
    with pytest.raises(SnapshotCorruptError):
        ShardedMutableIndex.load(p, svc.sindex.cfg, device="cpu")


def test_service_input_validation(twin_services):
    _, svc, q = twin_services
    D = q.shape[1]
    with pytest.raises(ValueError, match=r"\[n, \d+\]"):
        svc.query(q[:, :-1])
    with pytest.raises(ValueError, match=r"\[n, \d+\]"):
        svc.query(q[0])
    with pytest.raises(ValueError, match="empty"):
        svc.query(q[:0])
    with pytest.raises(ValueError, match="run_stream"):
        svc.query(np.zeros((B + 1, D), np.float32))
    with pytest.raises(ValueError, match="numeric"):
        svc.query(np.array([["a"] * D], dtype=object))
    bad = q.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        svc.query(bad)
    with pytest.raises(ValueError, match="non-finite"):
        svc.upsert(np.full((1, D), np.inf, np.float32))
    with pytest.raises(ValueError, match="ids must be integers"):
        svc.upsert(q[:1], ids=np.array([1.5]))
    with pytest.raises(ValueError, match="2 ids for 1"):
        svc.upsert(q[:1], ids=np.array([1, 2]))


def test_service_nan_policy_sanitize(twin_services):
    _, svc, q = twin_services
    svc2 = VectorSearchService(svc.sindex, batch_size=B,
                               nan_policy="sanitize",
                               fault_policy=svc.fault_policy, device="cpu")
    bad = q.copy()
    bad[0, :] = np.nan
    zeroed = q.copy()
    zeroed[0, :] = 0.0
    np.testing.assert_array_equal(svc2.query(bad)[1], svc2.query(zeroed)[1])
    with pytest.raises(ValueError, match="nan_policy"):
        VectorSearchService(svc.sindex, batch_size=B, nan_policy="drop",
                            device="cpu")


def test_service_ctor_guards(shard_graphs, twin_services):
    _, svc, _ = twin_services
    _, tfilt = _int_filters("pca")
    db = build_packed(shard_graphs[3][0], filt=tfilt, device="cpu")
    with pytest.raises(ValueError, match="sharded backend"):
        VectorSearchService(db, filt=tfilt, batch_size=8,
                            fault_policy=FaultPolicy(), device="cpu")
    with pytest.raises(ValueError, match="cannot be combined with mesh"):
        VectorSearchService(svc.sindex, batch_size=B,
                            fault_policy=FaultPolicy(),
                            mesh=_cpu_mesh(1, P), device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        VectorSearchService(db, filt=tfilt, batch_size=8, device="cuda")
    with pytest.raises(ValueError, match="filt"):
        VectorSearchService(db, batch_size=8, device="cpu")


def test_scheduler_supported_and_mesh_raises(shard_graphs, twin_services):
    """``scheduler_supported`` as the reference decides it (the sharded
    fault-tolerant service: yes; a sharded deferred one: no; a mesh one:
    no, and its ``scheduler()`` raises ``SchedulerUnsupported``). The
    mesh service answers bit-equal to the host-sharded service on span
    path "mesh", serves the epoch a mutation through it swaps in, and
    its ``run_stream()`` takes the synchronous path;
    ``run_stream(scheduler=False)`` serves in service batches."""
    rsvc, svc, q = twin_services
    assert svc.scheduler_supported and rsvc.scheduler_supported
    cfg, _, _, graphs = shard_graphs
    _, tfilt = _int_filters("pca")
    port = ShardedMutableIndex(
        [MutableIndex.from_graph(g, tfilt, seed=10 + s, device="cpu")
         for s, g in enumerate(graphs)], tfilt, cfg)
    host = VectorSearchService(port, batch_size=B, device="cpu")
    msvc = VectorSearchService(port, batch_size=B, mesh=_cpu_mesh(2, P),
                               tracer=Tracer(), device="cpu")
    assert not msvc.scheduler_supported
    with pytest.raises(SchedulerUnsupported, match="mesh"):
        msvc.scheduler()
    for a, b in zip(msvc.query(q), host.query(q)):
        np.testing.assert_array_equal(a, b)
    root = msvc.tracer.last("serve.query")
    assert [c.attrs["path"] for c in root.find_all("search")] == ["mesh"]
    gids = msvc.upsert(q[:3] + 0.5)
    assert msvc.sdb is port.sdb and msvc.epoch == port.epoch
    fd, fi = msvc.query(q)
    hd, hi = port.search(q)
    np.testing.assert_array_equal(fi, hi.numpy())
    np.testing.assert_array_equal(fd, hd.numpy())
    np.testing.assert_array_equal(fi[:3, 0], gids)
    ids, st = msvc.run_stream(q)
    assert st["path"] == "sync"
    np.testing.assert_array_equal(ids, fi)
    sdb = svc.sdb
    deferred = dataclasses.replace(
        sdb, cfg=dataclasses.replace(sdb.cfg, deferred_rerank=True))
    assert not VectorSearchService(deferred, filt=tfilt, batch_size=8,
                                   device="cpu").scheduler_supported
    qs = np.concatenate([q, q[:5]])
    ids, st = svc.run_stream(qs, scheduler=False)
    assert st["path"] == "sync" and ids.shape == (len(qs), svc.ef0)
    np.testing.assert_array_equal(ids[:B], svc.query(q)[1])


def test_service_stats_bounded_memory():
    st = ServiceStats()
    n_buckets = len(st.latency_ms.counts)
    for i in range(5_000):
        st.record_request(1, float(i + 1))
    assert len(st.latency_ms.counts) == n_buckets
    assert st.latency_ms.count == 5_000
    assert st.percentile(0) == 1.0
    assert st.percentile(100) == 5_000.0
    g = st.latency_ms.growth
    assert abs(st.percentile(50) - 2_500) / 2_500 < g - 1
    assert st.queries == 5_000


def test_warmup_batches_excluded_from_histograms(shard_graphs):
    """The constructor's warm-up batch never appears in the latency
    histogram or the query counter (stats are reset IN PLACE after it,
    so scraper references stay valid)."""
    _, port = _indexes(shard_graphs)
    q = shard_graphs[2]
    svc = VectorSearchService(port, batch_size=B, device="cpu")
    hist = svc.stats.latency_ms
    assert svc.stats.queries == 0 and hist.count == 0
    svc.query(q)
    assert svc.stats.queries == len(q) and hist.count == len(q)


def test_untraced_service_query_allocates_no_spans(twin_services):
    _, svc, q = twin_services
    svc.query(q)
    tracer = svc.tracer
    svc.tracer = NULL_TRACER
    try:
        before = Span.n_created
        svc.query(q)
        assert Span.n_created == before
    finally:
        svc.tracer = tracer
