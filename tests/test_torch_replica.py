"""repro_torch's ``ReplicaSet`` against ``repro.serve.replica``.

One scenario — the reference's replica cases (tests/test_faults.py's
replicate / failover / stale-checkpoint recovery / all-dead, and
tests/test_obs.py's traced failover and recovery) — runs once in each
package over equal state: indexes adopted from one set of graphs over
the exact-arithmetic fixture (small-integer vectors, a
coordinate-selecting 'PCA'), with the same integer upserts, deletes,
kills and recoveries, behind a P=2 ``ShardedMutableIndex`` and behind a
``MutableIndex``. Each replica's ids and dists, the ``events``, the
``applied_seq``, the replay counts, the live ids and live vectors, and
the span trees' names are equal across the packages. Then a checkpoint
written by each package re-seeds a replica in the other, and the
recovered replicas serve equal answers and converge with their
survivors."""
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
from repro.serve.replica import ReplicaSet as RefReplicaSet
from repro.serve.replica import _live_vectors as ref_live_vectors
from repro.serve.vector_service import VectorSearchService as RefService
from repro_torch.configs.base import PHNSWConfig
from repro_torch.core.distributed import shard_bounds
from repro_torch.core.graph import build_hnsw
from repro_torch.distributed import faults
from repro_torch.index import MutableIndex, ShardedMutableIndex
from repro_torch.obs.trace import Tracer
from repro_torch.serve import ReplicaSet
from repro_torch.serve.replica import _live_vectors
from repro_torch.serve.vector_service import VectorSearchService
from test_torch_search import _int_filters

N, P, B = 480, 2, 8

REF = types.SimpleNamespace(ReplicaSet=RefReplicaSet, faults=rfaults,
                            Tracer=RefTracer, live_vectors=ref_live_vectors)
PORT = types.SimpleNamespace(ReplicaSet=ReplicaSet, faults=faults,
                             Tracer=Tracer, live_vectors=_live_vectors)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several workers on the host's cores: one torch
    thread each keeps the plain CPU kernels from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.clear()
    rfaults.clear()


def _cfg():
    return PHNSWConfig(name="rep480", n_points=N, dim=16, d_low=4, M=8,
                       M0=16, ef_construction=16, wave_size=128,
                       ef_construction_k=8, insert_batch=32,
                       min_capacity=32)


def _ref_graph(g):
    return RefGraph(cfg=RefConfig(**dataclasses.asdict(g.cfg)), x=g.x,
                    levels=g.levels, layers=g.layers, entry=g.entry)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(77)
    x = rng.integers(0, 8, (N, 16)).astype(np.float32)
    q = rng.integers(0, 8, (B, 16)).astype(np.float32)
    new = rng.integers(0, 8, (12, 16)).astype(np.float32)
    cfg = _cfg()
    graphs = [build_hnsw(x[a:b], cfg, seed=5 + s, device="cpu")
              for s, (a, b) in enumerate(shard_bounds(N, P))]
    single = build_hnsw(x, cfg, seed=4, device="cpu")
    return cfg, x, q, new, graphs, single


def _services(data, backend):
    """The reference's and the port's service over equal state."""
    cfg, _, _, _, graphs, single = data
    rfilt, tfilt = _int_filters("pca")
    if backend == "single":
        ref = RefIndex.from_graph(_ref_graph(single), rfilt, seed=9)
        port = MutableIndex.from_graph(single, tfilt, seed=9, device="cpu")
    else:
        ref = RefSharded([RefIndex.from_graph(_ref_graph(g), rfilt,
                                              seed=10 + s)
                          for s, g in enumerate(graphs)], rfilt,
                         RefConfig(**dataclasses.asdict(cfg)))
        port = ShardedMutableIndex(
            [MutableIndex.from_graph(g, tfilt, seed=10 + s, device="cpu")
             for s, g in enumerate(graphs)], tfilt, cfg)
    return (RefService(ref, batch_size=B),
            VectorSearchService(port, batch_size=B, device="cpu"))


def _answers(rs, q):
    return [tuple(np.asarray(a) for a in r.svc.query(q))
            for r in rs.replicas]


def _state(pkg, rs):
    return {"applied": [r.applied_seq for r in rs.replicas],
            "alive": [r.alive for r in rs.replicas],
            "reseeds": [r.reseeds for r in rs.replicas],
            "live": [np.asarray(r.svc._mut.live_ids()) for r in rs.replicas],
            "vecs": [pkg.live_vectors(r.svc) for r in rs.replicas],
            "seq": rs.seq, "oplog": len(rs.oplog)}


def _scenario(pkg, svc, q, new, snap_dir):
    """The reference's replica cases in one run; returns what each step
    observed and the set itself."""
    plan_cls = pkg.faults.FaultPlan
    dead = pkg.faults.AllReplicasDeadError
    obs = {}
    rs = pkg.ReplicaSet.replicate(svc, 3, snapshot_dir=snap_dir)
    tracer = pkg.Tracer()
    rs.tracer = tracer
    obs["q0"] = _answers(rs, q) + [tuple(rs.query(q))]
    obs["q0_span"] = [s.name for s in
                      tracer.last("replica.query").iter_spans()]
    obs["q0_served"] = tracer.last("replica.query").attrs["served_by"]
    gids = rs.upsert(new[:3])
    obs["up1"] = (np.asarray(gids), rs.assert_converged())
    obs["del1"] = (rs.delete(gids[:1]), rs.assert_converged())
    ckpt, ckpt_seq = rs.checkpoint()
    obs["ckpt_seq"] = ckpt_seq
    with pkg.faults.inject(plan_cls()) as plan:
        plan.add("kill_replica", 0)
        obs["q_failover"] = tuple(rs.query(q))
        obs["alive0"] = rs.replicas[0].alive
        obs["up2"] = np.asarray(rs.upsert(new[3:6]))
        obs["conv2"] = rs.assert_converged()
    obs["failover_span"] = tracer.last("replica.query").attrs["served_by"]
    obs["behind"] = rs.seq - ckpt_seq
    obs["replayed"] = rs.recover(0, snapshot=ckpt, snapshot_seq=ckpt_seq)
    obs["republish"] = rs.republish(0)
    obs["conv3"] = rs.assert_converged()
    rc = tracer.last("replica.recover")
    obs["recover_span"] = [s.name for s in rc.iter_spans()]
    obs["recover_attrs"] = (rc.attrs["replica"], rc.attrs["replayed"],
                            rc.find("oplog.replay").attrs["n_replayed"])
    obs["q_recovered"] = _answers(rs, q)
    with pkg.faults.inject(plan_cls()) as plan:
        plan.add("kill_replica", -1)
        raised = []
        for call in (lambda: rs.query(q), lambda: rs.upsert(new[6:7]),
                     lambda: rs.checkpoint()):
            try:
                call()
                raised.append(False)
            except dead:
                raised.append(True)
        obs["all_dead_raised"] = raised
        obs["seq_after_failed_upsert"] = rs.seq
    rs.replicas[1].alive = True                 # operator override
    obs["heal"] = (rs.recover(0), rs.recover(2))
    obs["heal_span"] = [s.name for s in
                        tracer.last("replica.recover").iter_spans()]
    obs["conv4"] = rs.assert_converged()
    obs["q_final"] = _answers(rs, q)
    obs["state"] = _state(pkg, rs)
    obs["events"] = list(rs.events)
    return obs, rs


@pytest.fixture(scope="module", params=["sharded", "single"])
def twins(request, data, tmp_path_factory):
    _, _, q, new, _, _ = data
    rsvc, tsvc = _services(data, request.param)
    ref_obs, ref_rs = _scenario(REF, rsvc, q, new,
                                tmp_path_factory.mktemp("ref"))
    port_obs, port_rs = _scenario(PORT, tsvc, q, new,
                                  tmp_path_factory.mktemp("port"))
    return ref_obs, port_obs, ref_rs, port_rs, q, new


def _same_answers(a, b):
    assert len(a) == len(b)
    for (ad, ai), (bd, bi) in zip(a, b):
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(ad, bd)


def test_replicas_answer_equal_across_packages(twins):
    ref, port = twins[:2]
    for key in ("q0", "q_recovered", "q_final"):
        _same_answers(port[key], ref[key])
    _same_answers([port["q_failover"]], [ref["q_failover"]])
    # within a package the three fresh replicas agree bit for bit
    for a in port["q0"][1:]:
        _same_answers([a], [port["q0"][0]])


def test_replica_events_seq_and_replays_equal(twins):
    ref, port = twins[:2]
    for key in ("events", "ckpt_seq", "behind", "replayed", "republish",
                "heal", "all_dead_raised", "seq_after_failed_upsert",
                "alive0", "conv2", "conv3", "conv4"):
        assert port[key] == ref[key], key
    np.testing.assert_array_equal(port["up1"][0], ref["up1"][0])
    assert port["up1"][1] == ref["up1"][1]
    assert port["del1"] == ref["del1"]
    np.testing.assert_array_equal(port["up2"], ref["up2"])
    # the reference's own checks, on the port
    assert ("failover", 1, "primary -> 1") in port["events"]
    assert port["alive0"] is False
    assert port["replayed"] == port["behind"] >= 1
    assert port["republish"] == 0
    assert port["conv3"]["n_healthy"] == 3
    assert port["conv2"]["n_healthy"] == 2
    assert port["all_dead_raised"] == [True, True, True]
    assert port["conv4"]["n_healthy"] == 3


def test_replica_live_state_equal(twins):
    ref, port = twins[:2]
    a, b = port["state"], ref["state"]
    for key in ("applied", "alive", "reseeds", "seq", "oplog"):
        assert a[key] == b[key], key
    for u, v in zip(a["live"], b["live"]):
        np.testing.assert_array_equal(u, v)
    for u, v in zip(a["vecs"], b["vecs"]):
        np.testing.assert_array_equal(u, v)
    # every id the recovered replica 0 serves is live everywhere
    ids = port["q_recovered"][0][1]
    assert np.isin(ids, a["live"][1]).all()


def test_replica_span_trees_equal(twins):
    ref, port = twins[:2]
    assert port["q0_span"][:2] == ["replica.query", "serve.query"]
    assert port["q0_span"] == ref["q0_span"]
    # a recovery from a given checkpoint ships it; one without ships a
    # fresh checkpoint first
    assert port["recover_span"] == ref["recover_span"] == [
        "replica.recover", "snapshot.ship", "oplog.replay"]
    assert port["heal_span"] == ref["heal_span"] == [
        "replica.recover", "replica.checkpoint", "snapshot.ship",
        "oplog.replay"]
    assert port["recover_attrs"] == ref["recover_attrs"]
    assert (port["q0_served"], port["failover_span"]) == \
        (ref["q0_served"], ref["failover_span"]) == (0, 1)


def test_checkpoints_cross_packages(twins):
    """A reference checkpoint re-seeds a port replica and a port
    checkpoint re-seeds a reference replica; each replays the gap,
    converges with its survivors, and the two recovered replicas serve
    the same answers."""
    _, _, ref_rs, port_rs, q, new = twins
    rpath, rseq = ref_rs.checkpoint()
    ppath, pseq = port_rs.checkpoint()
    assert rseq == pseq
    np.testing.assert_array_equal(np.asarray(ref_rs.upsert(new[8:10])),
                                  port_rs.upsert(new[8:10]))
    n_port = port_rs.recover(2, snapshot=rpath, snapshot_seq=rseq)
    n_ref = ref_rs.recover(2, snapshot=ppath, snapshot_seq=pseq)
    assert n_port == n_ref == 1
    assert port_rs.assert_converged() == ref_rs.assert_converged()
    _same_answers(_answers(port_rs, q), _answers(ref_rs, q))
