"""repro_torch's collective search over a device mesh against
``repro.core.distributed``.

Both packages stack the very same shard graphs over one shared filter,
on the exact-arithmetic fixture of tests/test_torch_distributed.py
(small-integer vectors, a coordinate-selecting 'PCA' and integer PQ
centroids). The port's ``distributed_search`` on meshes (1, P) and
(2, P) of "cpu" devices is bit-equal to the reference's
``shard_search_host`` (the reference's own stand-in for its mesh path,
held bit-equal to it by tests/test_distributed.py) in ids, dists and
the coverage stats: every filter and re-rank mode, P in {2, 4}, with
and without tombstones, with every shard live and with one dead (the
pca and identity modes here, pq and pca-deferred in
tests/test_torch_mesh_modes.py, cascade-deferred in
tests/test_torch_mesh_cascade.py, which also holds it at P = 1 to the
reference's ``distributed_search`` on a real one-device mesh). Beside
those: ``make_mesh``'s and the search's
refusals, the shards' searches issuing their first trips before any
host read of ``done`` (the lockstep), and the program keys
(``search_cache_sizes``, ``resilient_cache_sizes``) fixed over a kill ->
degraded -> recover cycle."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import distributed as rdist
from repro_torch.configs.base import PHNSWConfig
from repro_torch.core import distributed as tdist
from repro_torch.core import search_torch
from repro_torch.core.graph import build_hnsw
from repro_torch.distributed import faults
from repro_torch.distributed.faults import FaultPlan, FaultPolicy
from repro_torch.index import MutableIndex, ShardedMutableIndex
from repro_torch.kernels import ops
from repro_torch.serve.vector_service import VectorSearchService
from test_torch_distributed import (MODES, _assert_stats_equal, _filters,
                                    _ref_graphs)

N_INT, B = 301, 16              # 301 % 2 == 301 % 4 == 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several workers on the host's cores: one torch
    thread each keeps the plain CPU kernels from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def int_mesh():
    """301 integer vectors in [0, 8)^16, 16 integer queries, 1% of the
    points tombstoned plus every query's exact nearest neighbour, and
    the port's shard graphs (seed 1 + s) for P in {1, 2, 4}. Three
    layers keep the reference's programs quick to compile."""
    rng = np.random.default_rng(2025)
    x = rng.integers(0, 8, (N_INT, 16)).astype(np.float32)
    q = rng.integers(0, 8, (B, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int301", n_points=N_INT, dim=16, d_low=4, M=8,
                      M0=16, n_layers=3, ef_construction=16, wave_size=128,
                      ef_construction_k=8, insert_batch=32, min_capacity=32)
    deleted = np.zeros(N_INT, bool)
    deleted[rng.choice(N_INT, N_INT // 100, replace=False)] = True
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    deleted[np.argmin(d2, 1)] = True
    graphs = {P: [build_hnsw(x[a:b], cfg, seed=1 + s, device="cpu")
                  for s, (a, b) in enumerate(tdist.shard_bounds(N_INT, P))]
              for P in (1, 2, 4)}
    return cfg, x, q, deleted, graphs


def _sharded(int_mesh, P, kind, tombs, ref=False):
    """(port ShardedDB, port filter) and, with ``ref``, the reference's
    ShardedDB and filter over the same graphs."""
    cfg, x, _, deleted, graphs = int_mesh
    rfilt, tfilt = _filters(kind)
    d = deleted if tombs else None
    tsdb = tdist.build_sharded(x, cfg, tfilt, P, graphs=graphs[P],
                               deleted=d, device="cpu")
    if not ref:
        return tsdb, tfilt
    rcfg, rgraphs = _ref_graphs(cfg, graphs[P])
    rsdb = rdist.build_sharded(x, rcfg, rfilt, P, graphs=rgraphs, deleted=d)
    return tsdb, tfilt, rsdb, rfilt


def _cpu_mesh(R, P):
    return tdist.make_mesh((R, P), ("data", "model"),
                           devices=["cpu"] * (R * P))


def _one_dead(P):
    live = np.ones(P, bool)
    live[1] = False
    return live


# one reference program per case (its compile is most of the time):
# the other modes are in tests/test_torch_mesh_modes.py and
# tests/test_torch_mesh_cascade.py, so that each file stays quick
REF_CASES = [("pca", 2, True), ("none", 2, False)]


@pytest.mark.parametrize("mode,P,tombs", REF_CASES)
def test_mesh_bit_equal_to_reference_host(int_mesh, mode, P, tombs):
    check_mesh_against_reference_host(int_mesh, mode, P, tombs)


def check_mesh_against_reference_host(int_mesh, mode, P, tombs):
    """(1, P) and (2, P) meshes, every shard live and shard 1 dead: ids,
    dists and coverage stats bit-equal to the reference's
    ``shard_search_host``; no id of the dead shard, no tombstone."""
    kind, deferred, rm = MODES[mode]
    _, _, q, deleted, _ = int_mesh
    tsdb, tfilt, rsdb, rfilt = _sharded(int_mesh, P, kind, tombs, ref=True)
    for live in (None, _one_dead(P)):
        jd, ji, js = rdist.shard_search_host(
            rsdb, jnp.asarray(q), filt=rfilt, deferred=deferred,
            rerank_mult=rm, live=live, return_stats=True)
        for R in (1, 2):
            td, ti, ts = tdist.distributed_search(
                _cpu_mesh(R, P), tsdb, q, filt=tfilt, deferred=deferred,
                rerank_mult=rm, live=live, return_stats=True)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            _assert_stats_equal(ts, js)
        got = ti.numpy()
        if tombs:
            assert not deleted[got[got >= 0]].any()
        if live is not None:
            a, n = int(tsdb.offsets[1]), int(tsdb.counts[1])
            assert not ((got >= a) & (got < a + n)).any()


def test_mesh_placement_views_and_copies(int_mesh):
    """A mesh device that is the db's own gets views into the stacks
    (no copy); the placement is cached per db object, and each (shard,
    device) is placed once whatever the rows. A device that is not the
    db's own ("cpu:0" is not "cpu") takes the moving branch (a move
    that stays on the host) and gives the same answers."""
    tsdb, tfilt = _sharded(int_mesh, 2, "pca", True)
    _, _, q, _, _ = int_mesh
    moved = tdist.make_mesh((1, 2), ("data", "model"),
                            devices=["cpu:0"] * 2)
    db = moved.placement(tsdb)[0][1]
    assert all(torch.equal(a, b) for a, b in zip(
        (db.high, db.low, db.deleted, db.layers[0].adj),
        (tsdb.high[1], tsdb.low[1], tsdb.deleted[1], tsdb.adj[0][1])))
    got = tdist.distributed_search(moved, tsdb, q, filt=tfilt)
    want = tdist.shard_search_host(tsdb, q, filt=tfilt, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    mesh = _cpu_mesh(2, 2)
    placed = mesh.placement(tsdb)
    assert placed is mesh.placement(tsdb)
    assert placed[0][1] is placed[1][1]
    for s in range(2):
        db = placed[0][s]
        assert db.high.data_ptr() == tsdb.high[s].data_ptr()
        assert db.deleted.data_ptr() == tsdb.deleted[s].data_ptr()
    # a db that is collected leaves the cache
    other, _ = _sharded(int_mesh, 2, "pca", False)
    mesh.placement(other)
    assert len(mesh._placed) == 2
    del other
    assert len(mesh._placed) == 1


def test_make_mesh_and_search_refusals(int_mesh, monkeypatch):
    tsdb, tfilt = _sharded(int_mesh, 2, "pca", False)
    _, _, q, _, _ = int_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 4 cards, 0 found"):
        tdist.make_mesh((1, 4), ("data", "model"))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="including 'model'"):
        tdist.make_mesh((2,), ("data",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="including 'model'"):
        tdist.make_mesh((1, 2), ("data", "shard"), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="do not pair up"):
        tdist.make_mesh((1, 2), ("model",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="3 devices"):
        tdist.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="'model' axis has 3 devices, the "
                                         "db 2 shards"):
        tdist.distributed_search(_cpu_mesh(1, 3), tsdb, q, filt=tfilt)
    with pytest.raises(ValueError, match="16 queries do not split into the "
                                         "mesh's 3"):
        tdist.distributed_search(_cpu_mesh(3, 2), tsdb, q, filt=tfilt)
    pod = tdist.make_mesh((2, 1, 2), ("pod", "model", "data"),
                          devices=["cpu"] * 4)
    assert pod.shape == {"pod": 2, "model": 1, "data": 2}
    assert pod.grid().shape == (4, 1)


def _trip_log(monkeypatch, sdb):
    """Record, in order, each pca expand as ("trip", shard) (the shard
    found by its adjacency's address) and each host read of ``done`` as
    ("read", None)."""
    shard_of = {a[s].data_ptr(): s for a in sdb.adj
                for s in range(sdb.n_shards)}
    log = []
    expand, all_done = ops.fused_expand_rows, search_torch._all_done

    def traced_expand(adj, *args, **kw):
        log.append(("trip", shard_of[adj.data_ptr()]))
        return expand(adj, *args, **kw)

    def traced_read(done):
        log.append(("read", None))
        return all_done(done)

    monkeypatch.setattr(ops, "fused_expand_rows", traced_expand)
    monkeypatch.setattr(search_torch, "_all_done", traced_read)
    return log


def test_mesh_shards_issue_trips_before_the_first_read(int_mesh,
                                                       monkeypatch):
    """On the mesh every shard's search issues its first trips before any
    host read of ``done`` (the host path runs shard 0 to its first read
    alone), the mesh makes the same trips and reads as the host path,
    and the answers are equal."""
    tsdb, tfilt = _sharded(int_mesh, 4, "pca", True)
    _, _, q, _, _ = int_mesh
    log = _trip_log(monkeypatch, tsdb)
    hd, hi = tdist.shard_search_host(tsdb, q, filt=tfilt, device="cpu")
    host = list(log)
    log.clear()
    md, mi = tdist.distributed_search(_cpu_mesh(1, 4), tsdb, q, filt=tfilt)
    assert torch.equal(mi, hi) and torch.equal(md, hd)
    first = log.index(("read", None))
    assert {s for _, s in log[:first]} == {0, 1, 2, 3}
    host_first = host.index(("read", None))
    assert {s for _, s in host[:host_first]} == {0}
    assert sorted(log, key=str) == sorted(host, key=str)


def test_cache_sizes_fixed_over_kill_degraded_recover(int_mesh):
    """After warm-up a kill -> degraded -> recover cycle (the resilient
    service's probes and merges, the mesh and host searches with a dead
    shard, the index's mesh search after an upsert into a reserved
    index) adds no program key."""
    cfg, x, q, _, graphs = int_mesh
    _, tfilt = _filters("pca")
    idx = ShardedMutableIndex(
        [MutableIndex.from_graph(g, tfilt, seed=10 + s, device="cpu")
         for s, g in enumerate(graphs[2])], tfilt, cfg)
    idx.reserve(256)
    svc = VectorSearchService(idx, batch_size=B,
                              fault_policy=FaultPolicy(deadline_ms=5000.0),
                              device="cpu")
    mesh = _cpu_mesh(2, 2)
    fd_h, fi_h, st = svc.query(q, return_stats=True)
    idx.search(q)
    idx.search(q, mesh=mesh)
    counters = (tdist.search_cache_sizes(), tdist.resilient_cache_sizes())
    with faults.inject(FaultPlan()) as plan:
        plan.add("kill_shard", 1)
        _, fi_d, st = svc.query(q, return_stats=True)
        assert st["degraded"] and svc.health.dead[1]
    live = _one_dead(2)
    md, mi = idx.search(q, mesh=mesh, live=live)
    np.testing.assert_array_equal(mi.numpy(), fi_d)
    hd, hi = idx.search(q, live=live)
    assert torch.equal(mi, hi) and torch.equal(md, hd)
    svc.recover_shard(1)
    fd_r, fi_r, st = svc.query(q, return_stats=True)
    assert st["coverage"] == 1.0
    np.testing.assert_array_equal(fi_r, fi_h)
    svc.upsert(x[:4] + 1.0)
    idx.search(q, mesh=mesh)
    assert (tdist.search_cache_sizes(),
            tdist.resilient_cache_sizes()) == counters
