"""repro_torch's observability plane (``repro_torch.obs``) and the
detection side of its fault plane (``StepMonitor``, ``FaultPolicy``,
``ShardHealth``): the cases of tests/test_obs.py and
tests/test_faults.py that need no index, run on the port's own copies.
This file imports no jax (the card's machine has none): log-bucketed
histograms with exact-to-bucket percentiles and lossless merge,
thread-safe counters, labeled families, in-place registry reset, trace
spans and the zero-allocation disabled path, the Prometheus and JSON
exporters, the unified event stream, the device-telemetry cost bridge
(``repro_torch.obs.bridge``) and the traced ``ReplicaSet`` failover and
recovery. The traced service cases are in tests/test_torch_service.py;
the bridge and ``ReplicaSet`` are held against the reference in
tests/test_torch_oracle.py and tests/test_torch_replica.py."""
import json
import threading

import numpy as np
import pytest

from repro_torch.distributed.fault import StepMonitor
from repro_torch.distributed.faults import FaultPolicy, ShardHealth
from repro_torch.obs import (NULL_SPAN, NULL_TRACER, Registry, Span, Tracer,
                             parse_prometheus, prometheus_families,
                             record_search_stats, snapshot_json,
                             to_prometheus)
from repro_torch.obs.metrics import DEFAULT, Histogram


# --------------------------------------------------------------------------
# metrics core
# --------------------------------------------------------------------------

def test_histogram_percentiles_within_one_bucket_of_numpy():
    """Bucket quantiles track np.percentile within one log-bucket
    relative width (growth - 1), with EXACT extremes (min/max ride
    along), on a heavy-tailed latency-like distribution."""
    rng = np.random.default_rng(0)
    samples = np.exp(rng.normal(1.0, 1.2, 20_000))  # lognormal, ~ms
    h = Histogram()
    h.observe_many(samples)
    assert h.count == len(samples)
    assert h.percentile(0) == samples.min()
    assert h.percentile(100) == samples.max()
    for p in (1, 10, 25, 50, 75, 90, 99, 99.9):
        exact = float(np.percentile(samples, p))
        est = h.percentile(p)
        assert abs(est - exact) / exact <= h.growth - 1, (p, est, exact)
    assert h.mean == pytest.approx(float(samples.mean()))


def test_histogram_observe_many_matches_loop_and_merge_is_lossless():
    rng = np.random.default_rng(1)
    a, b = rng.exponential(5.0, 3_000), rng.exponential(0.5, 2_000)
    h_loop, h_vec, h_a, h_b = (Histogram() for _ in range(4))
    for v in a:
        h_loop.observe(v)
    h_vec.observe_many(a)
    np.testing.assert_array_equal(h_loop.counts, h_vec.counts)
    assert h_loop.count == h_vec.count
    h_a.observe_many(a)
    h_b.observe_many(b)
    h_a.merge(h_b)
    h_all = Histogram()
    h_all.observe_many(np.concatenate([a, b]))
    np.testing.assert_array_equal(h_a.counts, h_all.counts)
    assert h_a.min == h_all.min and h_a.max == h_all.max
    with pytest.raises(ValueError, match="bucket configs differ"):
        h_a.merge(Histogram(lo=1.0))


def test_histogram_out_of_range_and_empty():
    h = Histogram(lo=1.0, hi=100.0, growth=2.0)
    assert h.percentile(50) == 0.0                  # empty
    h.observe(0.001)                                # underflow -> bucket 0
    h.observe(1e9)                                  # overflow -> last
    assert h.counts[0] == 1 and h.counts[-1] == 1
    assert h.percentile(0) == 0.001                 # exact extremes kept
    assert h.percentile(100) == 1e9


def test_counter_gauge_histogram_thread_safety():
    reg = Registry()
    c = reg.counter("c_total")
    g = reg.gauge("g")
    h = reg.histogram("h")
    n_threads, per = 8, 5_000

    def work(k):
        for i in range(per):
            c.inc()
            g.inc()
            h.observe(float(i % 100 + 1))

    ts = [threading.Thread(target=work, args=(k,))
          for k in range(n_threads)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert c.value == n_threads * per               # no lost updates
    assert g.value == n_threads * per
    assert h.count == n_threads * per
    assert int(h.counts.sum()) == h.count
    with pytest.raises(ValueError, match="only go up"):
        c.inc(-1)


def test_family_labels_and_redeclare_conflict():
    reg = Registry()
    fam = reg.counter("reqs_total", "by status", labels=("status",))
    fam.labels(status="ok").inc(3)
    fam.labels(status="err").inc()
    assert fam.labels(status="ok").value == 3
    assert reg.counter("reqs_total", labels=("status",)) is fam
    with pytest.raises(ValueError, match="re-declared"):
        reg.gauge("reqs_total")
    with pytest.raises(ValueError, match="labels"):
        fam.labels(shard=1)
    unl = reg.counter("plain_total")
    unl.inc(2)
    assert unl.value == 2                           # proxy to solo child
    with pytest.raises(AttributeError):
        unl.no_such_attr


def test_registry_reset_keeps_references_valid():
    reg = Registry()
    h = reg.histogram("lat")
    c = reg.counter("n_total")
    h.observe(5.0)
    c.inc()
    reg.emit("x", source="t")
    reg.reset()
    assert h.count == 0 and c.value == 0 and not reg.events
    h.observe(1.0)                                  # same objects still live
    assert reg.histogram("lat").count == 1


# --------------------------------------------------------------------------
# trace spans
# --------------------------------------------------------------------------

def test_span_nesting_and_event_ordering():
    tr = Tracer()
    with tr.span("root", a=1) as root:
        root.event("start")
        with root.child("left") as left:
            left.event("fault", attempt=0)
            left.event("backoff", ms=5)
            left.event("fault", attempt=1)
        with root.child("right") as right:
            right.set(ok=True)
    assert tr.last("root") is root
    assert [s.name for s in root.iter_spans()] == ["root", "left",
                                                   "right"]
    assert root.find("left").event_kinds() == ["fault", "backoff",
                                               "fault"]
    ts = [t for t, _, _ in root.find("left").events]
    assert ts == sorted(ts)                         # monotone offsets
    assert root.children[0] is left and root.children[1] is right
    d = root.to_dict()
    assert d["attrs"] == {"a": 1}
    assert [c["name"] for c in d["children"]] == ["left", "right"]
    json.dumps(d)                                   # JSON-serializable


def test_span_exit_records_error_and_propagates():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("boom") as s:
            raise RuntimeError("x")
    assert s.attrs["ok"] is False
    assert s.event_kinds() == ["error"]
    assert s.t1 is not None and tr.last("boom") is s


def test_disabled_tracer_allocates_no_spans():
    """THE zero-overhead contract: a disabled tracer returns the
    NULL_SPAN singleton, whose children are itself — a fully
    instrumented code path creates zero Span objects."""
    before = Span.n_created
    sp = NULL_TRACER.span("serve.query", n=64)
    assert sp is NULL_SPAN and not sp.enabled
    with sp.child("shard.probe", shard=0) as ps:
        ps.event("fault", error="nope")
        assert ps is NULL_SPAN
    assert sp.find("shard.probe") is None
    assert Span.n_created == before


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------

def test_prometheus_roundtrip_and_snapshot_stability():
    reg = Registry()
    reg.counter("reqs_total", "requests", labels=("status",)) \
        .labels(status="ok").inc(7)
    reg.gauge("cov").set(0.75)
    h = reg.histogram("lat_ms", "latency")
    h.observe_many([0.5, 2.0, 2.1, 40.0])
    text = to_prometheus(reg)
    assert set(prometheus_families(text)) == {"reqs_total", "cov",
                                              "lat_ms"}
    parsed = parse_prometheus(text)
    assert parsed["reqs_total"] == [({"status": "ok"}, 7.0)]
    assert parsed["cov"] == [({}, 0.75)]
    assert parsed["lat_ms_count"][0][1] == 4.0
    assert parsed["lat_ms_sum"][0][1] == pytest.approx(44.6)
    # cumulative bucket series ends at the total, +Inf included
    buckets = parsed["lat_ms_bucket"]
    assert buckets[-1][0]["le"] == "+Inf" and buckets[-1][1] == 4.0
    cums = [v for _, v in buckets]
    assert cums == sorted(cums)
    with pytest.raises(ValueError):
        parse_prometheus("lat_ms{bad 1.0")
    # snapshot: byte-stable under re-serialization, carries quantiles
    s1, s2 = snapshot_json(reg), snapshot_json(reg)
    assert s1 == s2
    snap = json.loads(s1)
    lat = next(f for f in snap["families"] if f["name"] == "lat_ms")
    assert lat["children"][0]["count"] == 4
    assert lat["children"][0]["p50"] > 0


# --------------------------------------------------------------------------
# the device-telemetry cost bridge
# --------------------------------------------------------------------------

def test_bridge_folds_telemetry_and_prices_queries():
    from repro_torch.configs.base import PHNSWConfig
    from repro_torch.obs.bridge import predicted_query_ns
    cfg = PHNSWConfig()
    reg = Registry()
    stats = {"steps_total": np.full(32, 20.0),
             "dist_h_evals": np.full(32, 60.0), "coverage": 1.0}
    out = record_search_stats(stats, wall_s=0.004, registry=reg,
                              cfg=cfg)
    assert reg.histogram("phnsw_search_steps").count == 32
    assert reg.histogram("phnsw_search_dist_h_evals").count == 32
    assert reg.gauge("phnsw_search_coverage").value == 1.0
    assert out["steps_mean"] == 20.0 and out["dist_h_mean"] == 60.0
    assert out["measured_us"] == pytest.approx(125.0)
    assert out["predicted_us"] > 0
    assert out["cost_ratio"] == pytest.approx(
        out["measured_us"] / out["predicted_us"])
    assert reg.histogram("phnsw_cost_ratio").count == 1
    # the prediction is monotone in the telemetry it prices
    lo = predicted_query_ns(cfg, steps_mean=10, dist_h_mean=30)
    hi = predicted_query_ns(cfg, steps_mean=40, dist_h_mean=120)
    assert hi > lo > 0


def test_obs_import_pulls_in_no_torch(tmp_path):
    """``repro_torch.obs`` (the bridge included) stays numpy-only: its
    cost-model imports wait inside ``predicted_query_ns``."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    probe = ("import sys, repro_torch.obs; "
             "print(sorted(m for m in sys.modules if m == 'torch' or "
             "m.startswith(('torch.', 'repro_torch.core'))))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=str(src)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# --------------------------------------------------------------------------
# ReplicaSet: failover and recovery, traced
# --------------------------------------------------------------------------

def test_replica_failover_and_recovery_trace(tmp_path):
    from repro_torch.configs.base import PHNSWConfig
    from repro_torch.core.graph import build_hnsw
    from repro_torch.core.pca import fit_pca
    from repro_torch.data.vectors import make_queries, make_sift_like
    from repro_torch.index import MutableIndex
    from repro_torch.serve.replica import ReplicaSet
    from repro_torch.serve.vector_service import VectorSearchService
    cfg = PHNSWConfig(name="obs-rep", n_points=600, ef_construction=32)
    x = make_sift_like(600, seed=61)
    q = make_queries(x, 8, seed=62)
    pca = fit_pca(x, cfg.d_low)
    idx = MutableIndex.from_graph(build_hnsw(x, cfg, seed=0, device="cpu"),
                                  pca, seed=1, device="cpu")
    svc = VectorSearchService(idx, batch_size=8, device="cpu")
    tracer = Tracer()
    rs = ReplicaSet.replicate(svc, 2, snapshot_dir=tmp_path)
    rs.tracer = tracer
    rs.query(q)
    rq = tracer.last("replica.query")
    # the serving replica's request span is PARENTED under the
    # failover loop's span (explicit context passing end to end)
    assert [s.name for s in rq.iter_spans()][:2] == ["replica.query",
                                                     "serve.query"]
    assert rq.attrs["served_by"] == 0
    rs.upsert(make_sift_like(4, seed=63))
    rs._mark_dead(0, "test kill")
    rs.query(q)
    rq2 = tracer.last("replica.query")
    assert rq2.attrs["served_by"] == 1
    rs.recover(0)
    rc = tracer.last("replica.recover")
    names = [s.name for s in rc.iter_spans()]
    assert names == ["replica.recover", "replica.checkpoint",
                     "snapshot.ship", "oplog.replay"]
    assert rc.attrs["replica"] == 0
    assert rc.find("oplog.replay").attrs["n_replayed"] >= 0
    rs.assert_converged()
    # each replica owns its own copy of the index, on the donor's device
    assert rs.replicas[0].svc._mut is not rs.replicas[1].svc._mut
    assert rs.replicas[0].svc.device == svc.device


# --------------------------------------------------------------------------
# unified event stream and shard health
# --------------------------------------------------------------------------

def test_step_monitor_and_shard_health_share_event_stream():
    DEFAULT.reset()
    mon = StepMonitor(straggler_factor=2.0, source="train")
    for i in range(8):
        mon.heartbeat(i, 0.10)
    mon.heartbeat(8, 10.0)                          # obvious straggler
    health = ShardHealth(2, FaultPolicy(dead_after_failures=2))
    health.failure(0, RuntimeError("boom"))
    health.failure(0, RuntimeError("boom"))         # -> dead
    health.recover(0)
    kinds = [(e.kind, e.source) for e in DEFAULT.events]
    assert ("straggler", "train") in kinds
    assert ("failure", "serve.shard0") in kinds
    assert ("dead", "serve.shard0") in kinds
    assert ("recovered", "serve.shard0") in kinds
    # one record type, queryable by kind and source prefix
    assert all(type(e).__name__ == "ObsEvent" for e in DEFAULT.events)
    assert len(DEFAULT.events_of(source_prefix="serve.shard")) == 4
    assert DEFAULT.events_of("straggler")[0].target == 8
    assert DEFAULT.counter(
        "phnsw_heartbeats_total",
        labels=("source",)).labels(source="train").value == 9
    # an unnamed monitor stays OFF the obs plane (train loops that
    # predate the obs plane emit nothing)
    DEFAULT.reset()
    StepMonitor().heartbeat(0, 0.1)
    assert not DEFAULT.events


def test_step_monitor_mad_factor():
    """The additive MAD term keeps sub-ms workloads from flagging jitter
    that is a large RATIO but a tiny absolute delay; a genuine stall
    still fires. mad_factor=None preserves the ratio-only seed rule."""
    walls = [0.0010, 0.0011, 0.0009, 0.0010, 0.0012, 0.0010, 0.0009,
             0.0011]
    ratio_only = StepMonitor(straggler_factor=2.0)
    robust = StepMonitor(straggler_factor=2.0, mad_factor=20.0)
    for i, w in enumerate(walls):
        assert ratio_only.heartbeat(i, w).kind == "ok"
        assert robust.heartbeat(i, w).kind == "ok"
    # 2.5x the median but only +1.5ms absolute: scheduler noise
    assert ratio_only.heartbeat(8, 0.0025).kind == "straggler"
    assert robust.heartbeat(8, 0.0025).kind == "ok"
    # a real stall clears both terms of the max()
    assert robust.heartbeat(9, 0.050).kind == "straggler"


def test_shard_health_dead_mark_and_recover():
    h = ShardHealth(3, FaultPolicy(dead_after_failures=2))
    assert not h.failure(1, RuntimeError("x"))      # streak 1: not dead
    assert h.failure(1, RuntimeError("x"))          # streak 2: dead
    assert h.dead[1] and h.n_live == 2
    np.testing.assert_array_equal(h.live_mask(), [True, False, True])
    h.heartbeat(0, 0.001)                           # success resets streak
    assert h.failures[0] == 0
    h.recover(1)
    assert not h.dead[1] and h.failures[1] == 0
    kinds = [k for k, _, _ in h.events]
    assert kinds == ["failure", "failure", "dead", "recovered"]
