"""repro_torch's host oracle, cost model, k-select and cost bridge, and
the public API that closed the port's gaps with the reference (C2),
against the JAX package.

Both packages run on the very same graph (built once per fixture by the
port and carried to the reference as numpy arrays) and the very same
filter parameters. ``search_ref`` is numpy in both, so the oracles'
ids and every ``SearchStats`` counter are equal on the exact-arithmetic
fixture (small-integer vectors, a coordinate-selecting 'PCA', integer
PQ centroids) and on float SIFT-like data alike: no tolerance is
needed. The cost model, k-select sweeps and the bridge are float64
arithmetic over those counters, so they are equal exactly too. The
paper's orderings (Table III, Fig 5) and the filter pricing are checked
again on the port's own stats."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core import cost_model as rcm
from repro.core import filters as rfilters
from repro.core import kselect as rks
from repro.core import pq as rpq
from repro.core import search_ref as rsr
from repro.core.graph import HNSWGraph as RefGraph
from repro.core.pca import PCA as RefPCA
from repro.core.pq import PQCodebook as RefCodebook
from repro.kernels import ref as rref
from repro.obs import Registry as RefRegistry
from repro.obs import bridge as rbridge
from repro_torch.configs.base import PHNSWConfig
from repro_torch.core import cost_model, filters, kselect, pq, search_ref
from repro_torch.core.distributed import shard_bounds
from repro_torch.core.graph import build_hnsw
from repro_torch.core.pca import fit_pca
from repro_torch.core.pq import train_pq
from repro_torch.data.vectors import (brute_force_topk, make_queries,
                                      make_sift_like)
from repro_torch.kernels import ref as tref
from repro_torch.obs import Registry, bridge
from test_torch_search import _int_filters

N, NQ, P = 600, 12, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several workers on the host's cores: one torch
    thread each keeps the plain CPU kernels from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_graph(g):
    return RefGraph(cfg=RefConfig(**dataclasses.asdict(g.cfg)), x=g.x,
                    levels=g.levels, layers=g.layers, entry=g.entry)


def _ref_filter(kind, arrays):
    pca = RefPCA(arrays["mean"], arrays["components"], arrays["explained"])
    if kind == "none":
        return rfilters.IdentityFilter(dim=arrays["dim"])
    cb = RefCodebook(arrays["centroids"])
    return {"pca": rfilters.PCAFilter(pca), "pq": rfilters.PQFilter(cb),
            "cascade": rfilters.CascadeFilter(cb, pca)}[kind]


class Fixture:
    """One dataset: the port's graphs and filters beside the reference's
    (same arrays), the queries, the ground truth and tombstones."""

    def __init__(self, x, q, cfg, arrays, seed):
        self.x, self.q, self.cfg = x, q, cfg
        self.gt = brute_force_topk(x, q, 10)
        self.g = build_hnsw(x, cfg, seed=seed, device="cpu")
        self.rg = _ref_graph(self.g)
        self.bounds = shard_bounds(len(x), P)
        self.graphs = [build_hnsw(x[a:b], cfg, seed=seed + 1 + s,
                                  device="cpu")
                       for s, (a, b) in enumerate(self.bounds)]
        self.rgraphs = [_ref_graph(g) for g in self.graphs]
        self.filt = {k: filters.from_reference(k, arrays)
                     for k in ("pca", "pq", "cascade", "none")}
        self.rfilt = {k: _ref_filter(k, arrays)
                      for k in ("pca", "pq", "cascade", "none")}
        self.pca = self.filt["pca"].pca
        self.rpca = self.rfilt["pca"].pca
        rng = np.random.default_rng(seed + 7)
        self.deleted = rng.random(len(x)) < 0.15

    def payload(self, kind, x=None):
        x = self.x if x is None else x
        return self.filt[kind].encode(x)

    def mid(self, kind, x=None):
        x = self.x if x is None else x
        return self.filt[kind].encode_mid(x) if kind == "cascade" else None


@pytest.fixture(scope="module")
def int_fix():
    """600 integer vectors in [0, 8)^16: every f32 sum is exact."""
    rng = np.random.default_rng(2024)
    x = rng.integers(0, 8, (N, 16)).astype(np.float32)
    q = rng.integers(0, 8, (NQ, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int600", n_points=N, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=128,
                      pq_n_sub=4)
    ref, _ = _int_filters("cascade")
    arrays = {"mean": ref.pca.mean, "components": ref.pca.components,
              "explained": ref.pca.explained,
              "centroids": ref.cb.centroids, "dim": 16}
    return Fixture(x, q, cfg, arrays, seed=1)


@pytest.fixture(scope="module")
def float_fix():
    """600 SIFT-like float vectors at the paper's widths (128 -> 15,
    M0 = 32), a fitted PCA and a 16 x 256 PQ codebook."""
    x = make_sift_like(N, seed=71)
    q = make_queries(x, NQ, seed=72)
    cfg = PHNSWConfig(name="oracle600", n_points=N, ef_construction=32,
                      wave_size=256)
    pca = fit_pca(x, cfg.d_low)
    cb = train_pq(x, cfg.pq_n_sub, iters=4, seed=0)
    arrays = {"mean": pca.mean, "components": pca.components,
              "explained": pca.explained, "centroids": cb.centroids,
              "dim": 128}
    return Fixture(x, q, cfg, arrays, seed=3)


FIXTURES = ["int_fix", "float_fix"]


def _same(a, b):
    """ids equal and every SearchStats field equal."""
    (ia, sa), (ib, sb) = a, b
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
    assert dataclasses.asdict(sa) == dataclasses.asdict(sb)


# --------------------------------------------------------------------------
# C2: the public API the port lacked
# --------------------------------------------------------------------------

def test_graph_degree_and_stats_match_reference(int_fix, float_fix):
    for fx in (int_fix, float_fix):
        for g, rg in zip([fx.g] + fx.graphs, [fx.rg] + fx.rgraphs):
            assert g.stats() == rg.stats()
            for l in range(len(g.layers)):
                assert g.degree(l) == rg.degree(l)


def test_pca_inverse_matches_reference(float_fix):
    z = float_fix.pca.transform(float_fix.q)
    back = float_fix.pca.inverse(z)
    np.testing.assert_allclose(back, float_fix.rpca.inverse(z), rtol=0,
                               atol=1e-6)
    assert back.shape == float_fix.q.shape


@pytest.mark.parametrize("k", [1, 7, 24, 27])
def test_ksort_l_ref_valid_matches_reference(k):
    """Invalid entries become inf and sort last, ties to the lower
    index, inf already in the data included; k > M keeps the (0.0, 0)
    quirk."""
    rng = np.random.default_rng(k)
    d = rng.integers(0, 6, (9, 24)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = np.inf
    valid = rng.random(d.shape) < 0.7
    valid[0] = False
    valid[1] = True
    for v in (valid, None):
        rv, ri = rref.ksort_l_ref(jnp.asarray(d), k,
                                  None if v is None else jnp.asarray(v))
        tv, ti = tref.ksort_l_ref(torch.from_numpy(d), k,
                                  None if v is None else
                                  torch.from_numpy(v))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                      np.asarray(rv).view(np.int32))


def test_adc_tables_from_centroids_matches_reference():
    rng = np.random.default_rng(9)
    cents = rng.integers(0, 8, (4, 256, 4)).astype(np.float32)
    q = rng.integers(0, 8, (5, 16)).astype(np.float32)
    want = rpq.adc_tables_from_centroids(cents, q, np)
    want_j = np.asarray(rpq.adc_tables_from_centroids(
        jnp.asarray(cents), jnp.asarray(q), jnp))
    np.testing.assert_array_equal(want, want_j)
    got_np = pq.adc_tables_from_centroids(cents, q, np)
    got_t = pq.adc_tables_from_centroids(
        torch.from_numpy(cents), torch.from_numpy(q.astype(np.float64)),
        torch)
    assert got_np.dtype == np.float32 and got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    # both of the port's spellings route through it
    cb = pq.PQCodebook(cents)
    np.testing.assert_array_equal(pq.adc_table_batch(cb, q), want)
    np.testing.assert_array_equal(
        pq.adc_tables_torch(torch.from_numpy(cents),
                            torch.from_numpy(q)).numpy(), want)


# --------------------------------------------------------------------------
# search_ref: the host oracles
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fix", FIXTURES)
@pytest.mark.parametrize("hw_mode", [False, True])
@pytest.mark.parametrize("tomb", [False, True])
def test_search_hnsw_matches_reference(fix, hw_mode, tomb, request):
    fx = request.getfixturevalue(fix)
    dele = fx.deleted if tomb else None
    for qi in fx.q:
        _same(search_ref.search_hnsw(fx.g, qi, hw_mode=hw_mode,
                                     deleted=dele),
              rsr.search_hnsw(fx.rg, qi, hw_mode=hw_mode, deleted=dele))


@pytest.mark.parametrize("fix", FIXTURES)
@pytest.mark.parametrize("layout", ["packed", "separate"])
@pytest.mark.parametrize("deferred", [False, True])
def test_search_phnsw_matches_reference(fix, layout, deferred, request):
    fx = request.getfixturevalue(fix)
    xl = fx.payload("pca")
    for i, qi in enumerate(fx.q):
        dele = fx.deleted if i % 2 else None
        _same(search_ref.search_phnsw(fx.g, xl, fx.pca, qi, layout=layout,
                                      deleted=dele, deferred=deferred,
                                      rerank_mult=2),
              rsr.search_phnsw(fx.rg, xl, fx.rpca, qi, layout=layout,
                               deleted=dele, deferred=deferred,
                               rerank_mult=2))


# (kind, deferred, rerank_mult, promote_mult, layout)
FILTERED = {
    "pca": ("pca", False, 1, 1, "packed"),
    "pca-separate": ("pca", False, 1, 1, "separate"),
    "pca-deferred": ("pca", True, 3, 1, "packed"),
    "pq": ("pq", False, 1, 1, "packed"),
    "pq-separate": ("pq", False, 1, 1, "separate"),
    "pq-deferred": ("pq", True, 3, 1, "packed"),
    "cascade": ("cascade", False, 1, 1, "packed"),
    "cascade-deferred": ("cascade", True, 2, 4, "packed"),
    "cascade-deferred-separate": ("cascade", True, 2, 4, "separate"),
    "none": ("none", False, 1, 1, "packed"),
}


@pytest.mark.parametrize("fix", FIXTURES)
@pytest.mark.parametrize("mode", list(FILTERED))
def test_search_filtered_matches_reference(fix, mode, request):
    fx = request.getfixturevalue(fix)
    kind, deferred, rm, pm, layout = FILTERED[mode]
    pay, mid = fx.payload(kind), fx.mid(kind)
    for i, qi in enumerate(fx.q):
        kw = dict(layout=layout, deferred=deferred, rerank_mult=rm,
                  promote_mult=pm, payload_mid=mid,
                  deleted=fx.deleted if i % 2 else None,
                  final_rerank=bool(i % 3))
        _same(search_ref.search_filtered(fx.g, fx.filt[kind], pay, qi,
                                         **kw),
              rsr.search_filtered(fx.rg, fx.rfilt[kind], pay, qi, **kw))


@pytest.mark.parametrize("fix", FIXTURES)
@pytest.mark.parametrize("mode", ["pca", "pca-deferred", "pq",
                                  "cascade-deferred", "none"])
@pytest.mark.parametrize("tomb", [False, True])
def test_search_sharded_matches_reference(fix, mode, tomb, request):
    fx = request.getfixturevalue(fix)
    kind, deferred, rm, pm, _ = FILTERED[mode]
    xs = [fx.x[a:b] for a, b in fx.bounds]
    pays = [fx.payload(kind, xi) for xi in xs]
    mids = [fx.mid(kind, xi) for xi in xs] if kind == "cascade" else None
    dele = [fx.deleted[a:b] for a, b in fx.bounds] if tomb else None
    for qi in fx.q:
        kw = dict(deleted=dele, deferred=deferred, rerank_mult=rm,
                  promote_mult=pm, payload_mids=mids)
        _same(search_ref.search_sharded(fx.graphs, fx.filt[kind], pays, qi,
                                        **kw),
              rsr.search_sharded(fx.rgraphs, fx.rfilt[kind], pays, qi,
                                 **kw))


def test_search_sharded_all_deleted_is_empty(int_fix):
    fx = int_fix
    pays = [fx.payload("pca", fx.x[a:b]) for a, b in fx.bounds]
    dele = [np.ones(b - a, bool) for a, b in fx.bounds]
    ids, st = search_ref.search_sharded(fx.graphs, fx.filt["pca"], pays,
                                        fx.q[0], deleted=dele)
    rids, rst = rsr.search_sharded(fx.rgraphs, fx.rfilt["pca"], pays,
                                   fx.q[0], deleted=dele)
    assert len(ids) == 0 and len(rids) == 0
    assert dataclasses.asdict(st) == dataclasses.asdict(rst)


@pytest.mark.parametrize("fix", FIXTURES)
@pytest.mark.parametrize("algo", ["hnsw", "hnsw-hw", "phnsw",
                                  "phnsw-separate", "filtered-cascade"])
def test_run_queries_matches_reference(fix, algo, request):
    fx = request.getfixturevalue(fix)
    kw = {"hnsw": dict(algo="hnsw"),
          "hnsw-hw": dict(algo="hnsw", hw_mode=True, deleted=fx.deleted),
          "phnsw": dict(algo="phnsw", x_low=fx.payload("pca")),
          "phnsw-separate": dict(algo="phnsw", x_low=fx.payload("pca"),
                                 layout="separate", deferred=True),
          "filtered-cascade": dict(algo="filtered",
                                   payload=fx.payload("cascade"),
                                   payload_mid=fx.mid("cascade"),
                                   deferred=True, rerank_mult=2,
                                   promote_mult=4)}[algo]
    port_kw = dict(kw, pca=fx.pca, filt=fx.filt["cascade"])
    ref_kw = dict(kw, pca=fx.rpca, filt=fx.rfilt["cascade"])
    r, st = search_ref.run_queries(fx.g, fx.q, fx.gt, **port_kw)
    rr, rst = rsr.run_queries(fx.rg, fx.q, fx.gt, **ref_kw)
    assert r == rr
    assert dataclasses.asdict(st) == dataclasses.asdict(rst)
    assert 0.0 <= r <= 1.0


def test_recall_at_matches_reference():
    rng = np.random.default_rng(4)
    for _ in range(20):
        found = rng.integers(0, 30, 12)
        truth = rng.permutation(30)[:10]
        for at in (1, 5, 10):
            assert search_ref.recall_at(found, truth, at) == \
                rsr.recall_at(found, truth, at)


def test_search_stats_add_and_fields():
    assert [f.name for f in dataclasses.fields(search_ref.SearchStats)] \
        == [f.name for f in dataclasses.fields(rsr.SearchStats)]
    a = search_ref.SearchStats(expansions=2, dist_high=5)
    a.add(search_ref.SearchStats(expansions=1, rand_bytes=7))
    assert a.as_dict() == dict(rsr.SearchStats(expansions=3, dist_high=5,
                                               rand_bytes=7).as_dict())


# --------------------------------------------------------------------------
# the cost model (the paper's 65 nm processor, not the card)
# --------------------------------------------------------------------------

def _traces(fx, port=True):
    mod = search_ref if port else rsr
    g = fx.g if port else fx.rg
    pca = fx.pca if port else fx.rpca
    xl = fx.payload("pca")
    _, st_h = mod.run_queries(g, fx.q, fx.gt, algo="hnsw", hw_mode=True)
    _, st_p = mod.run_queries(g, fx.q, fx.gt, algo="phnsw", x_low=xl,
                              pca=pca)
    _, st_s = mod.run_queries(g, fx.q, fx.gt, algo="phnsw", x_low=xl,
                              pca=pca, layout="separate")
    return st_h, st_p, st_s


def _cost_dict(c):
    return {**dataclasses.asdict(c), "total_ns": c.total_ns,
            "total_pj": c.total_pj, "qps": c.qps, "energy_uj": c.energy_uj,
            "dram_energy_share": c.dram_energy_share}


@pytest.fixture(scope="module")
def t3_pair(float_fix):
    fx = float_fix
    port = cost_model.table3(
        cost_model.hw_variant_stats(*_traces(fx)), n_queries=NQ, dim=128,
        d_low=15)
    ref = rcm.table3(rcm.hw_variant_stats(*_traces(fx, port=False)),
                     n_queries=NQ, dim=128, d_low=15)
    return port, ref


def test_table3_matches_reference(t3_pair):
    port, ref = t3_pair
    assert list(port) == list(ref) == ["HNSW-Std", "pHNSW-Sep", "pHNSW"]
    for v in port:
        assert list(port[v]) == ["DDR4", "HBM"]
        for d in port[v]:
            assert _cost_dict(port[v][d]) == _cost_dict(ref[v][d])


def test_cost_model_constants_match_reference():
    for a, b in ((cost_model.DDR4, rcm.DDR4), (cost_model.HBM, rcm.HBM),
                 (cost_model.PROCESSOR, rcm.PROCESSOR)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("fix", FIXTURES)
@pytest.mark.parametrize("kind", ["pca", "pq", "cascade", "none"])
def test_query_cost_matches_reference_per_filter(fix, kind, request):
    fx = request.getfixturevalue(fix)
    deferred = kind == "cascade"
    kw = dict(deferred=deferred, rerank_mult=2, promote_mult=4,
              payload_mid=fx.mid(kind))
    st = search_ref.SearchStats()
    for qi in fx.q[:4]:
        st.add(search_ref.search_filtered(fx.g, fx.filt[kind],
                                          fx.payload(kind), qi, **kw)[1])
    rst = rsr.SearchStats(**st.as_dict())
    for dram, rdram in ((cost_model.DDR4, rcm.DDR4),
                        (cost_model.HBM, rcm.HBM)):
        c = cost_model.query_cost(st, n_queries=4, dim=fx.x.shape[1],
                                  filt=fx.filt[kind], dram=dram)
        rc = rcm.query_cost(rst, n_queries=4, dim=fx.x.shape[1],
                            filt=fx.rfilt[kind], dram=rdram)
        assert _cost_dict(c) == _cost_dict(rc)
        c2 = cost_model.query_cost(st, n_queries=4, dim=fx.x.shape[1],
                                   d_low=7, dram=dram)
        rc2 = rcm.query_cost(rst, n_queries=4, dim=fx.x.shape[1], d_low=7,
                             dram=rdram)
        assert _cost_dict(c2) == _cost_dict(rc2)
    with pytest.raises(ValueError):
        cost_model.query_cost(st, n_queries=1, dim=16,
                              dram=cost_model.DDR4)


def test_table3_orderings_on_port_stats(t3_pair):
    """tests/test_core.py's Table III and Fig 5 orderings, on the port's
    own traces."""
    t3, _ = t3_pair
    for d in ("DDR4", "HBM"):
        assert t3["pHNSW"][d].qps > t3["pHNSW-Sep"][d].qps
        assert t3["pHNSW"][d].qps > t3["HNSW-Std"][d].qps
        assert t3["pHNSW"][d].energy_uj < t3["HNSW-Std"][d].energy_uj
        assert t3["pHNSW"][d].energy_uj < t3["pHNSW-Sep"][d].energy_uj
    for v in t3:
        assert t3[v]["HBM"].qps >= t3[v]["DDR4"].qps
    assert t3["pHNSW"]["DDR4"].dram_energy_share > 0.6
    assert t3["pHNSW"]["HBM"].dram_energy_share < \
        t3["pHNSW"]["DDR4"].dram_energy_share


def test_cost_model_prices_filters_on_port_stats(float_fix):
    """tests/test_filters.py's filter pricing on the port's traces: PQ
    priced at its own depth, fewer inline bytes than PCA, and the
    cascade's promote stage priced as its own ``dist_m`` entry at
    ``mid_cost_dims`` depth."""
    fx = float_fix
    st = {k: search_ref.search_filtered(fx.g, fx.filt[k], fx.payload(k),
                                        fx.q[0])[1]
          for k in ("pca", "pq")}
    c_pca = cost_model.query_cost(st["pca"], n_queries=1, dim=128,
                                  filt=fx.filt["pca"], dram=cost_model.DDR4)
    c_pq = cost_model.query_cost(st["pq"], n_queries=1, dim=128,
                                 filt=fx.filt["pq"], dram=cost_model.DDR4)
    mis = cost_model.query_cost(st["pq"], n_queries=1, dim=128,
                                d_low=fx.filt["pca"].cost_dims,
                                dram=cost_model.DDR4)
    assert c_pq.breakdown["dist_l"] != mis.breakdown["dist_l"]
    assert st["pq"].seq_bytes < st["pca"].seq_bytes
    assert c_pq.total_ns > 0 and c_pca.total_ns > 0
    filt = fx.filt["cascade"]
    _, stc = search_ref.search_filtered(fx.g, filt, fx.payload("cascade"),
                                        fx.q[0], deferred=True,
                                        rerank_mult=2, promote_mult=4,
                                        payload_mid=fx.mid("cascade"))
    assert stc.dist_mid > 0
    c = cost_model.query_cost(stc, n_queries=1, dim=128, filt=filt,
                              dram=cost_model.DDR4)
    cycles = c.breakdown["dist_m"] * cost_model.PROCESSOR.freq_ghz
    assert cycles == math.ceil(stc.dist_mid
                               / cost_model.PROCESSOR.dist_lanes) \
        * filt.mid_cost_dims
    assert st["pca"].dist_mid == 0
    assert "dist_m" not in c_pca.breakdown


# --------------------------------------------------------------------------
# kselect
# --------------------------------------------------------------------------

def test_kselect_matches_reference(float_fix):
    fx = float_fix
    xl = fx.payload("pca")
    q, gt = fx.q[:6], fx.gt[:6]
    a = kselect.sweep_k1(fx.g, xl, fx.pca, q, gt, k0=12, k1_values=(2, 8))
    b = rks.sweep_k1(fx.rg, xl, fx.rpca, q, gt, k0=12, k1_values=(2, 8))
    assert [dataclasses.asdict(p) for p in a] == \
        [dataclasses.asdict(p) for p in b]
    a = kselect.sweep_k0(fx.g, xl, fx.pca, q, gt, k1=4, k0_values=(8, 20))
    b = rks.sweep_k0(fx.rg, xl, fx.rpca, q, gt, k1=4, k0_values=(8, 20))
    assert [dataclasses.asdict(p) for p in a] == \
        [dataclasses.asdict(p) for p in b]
    sched, sw = kselect.select_schedule(fx.g, xl, fx.pca, q[:3], gt[:3])
    rsched, rsw = rks.select_schedule(fx.rg, xl, fx.rpca, q[:3], gt[:3])
    assert sched == rsched and sched[2:] == (3, 3, 3, 3)
    for key in ("sweep_k1", "sweep_k0"):
        assert [dataclasses.asdict(p) for p in sw[key]] == \
            [dataclasses.asdict(p) for p in rsw[key]]


# --------------------------------------------------------------------------
# the cost bridge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["pca", "pq", "cascade", "none", None])
def test_bridge_matches_reference(float_fix, kind):
    fx = float_fix
    cfg = dataclasses.replace(fx.cfg, expand_width=2)
    rcfg = RefConfig(**dataclasses.asdict(cfg))
    filt = None if kind is None else fx.filt[kind]
    rfilt = None if kind is None else fx.rfilt[kind]
    rng = np.random.default_rng(5)
    stats = {"steps_total": rng.integers(5, 60, 32).astype(np.int32),
             "dist_h_evals": rng.integers(10, 200, 32).astype(np.int32),
             "coverage": 0.75}
    for dram, rdram in ((None, None), (cost_model.DDR4, rcm.DDR4)):
        assert bridge.predicted_query_ns(
            cfg, steps_mean=17.5, dist_h_mean=48.9, filt=filt, dram=dram) \
            == rbridge.predicted_query_ns(rcfg, steps_mean=17.5,
                                          dist_h_mean=48.9, filt=rfilt,
                                          dram=rdram)
        reg, rreg = Registry(), RefRegistry()
        out = bridge.record_search_stats(
            {**stats, "steps_total": torch.from_numpy(stats["steps_total"]),
             "dist_h_evals": torch.from_numpy(stats["dist_h_evals"])},
            wall_s=0.0123, n_queries=30, registry=reg, cfg=cfg, filt=filt,
            dram=dram)
        rout = rbridge.record_search_stats(stats, wall_s=0.0123,
                                           n_queries=30, registry=rreg,
                                           cfg=rcfg, filt=rfilt, dram=rdram)
        assert out == rout
        for name in (bridge.STEPS, bridge.DIST_H, bridge.MEASURED_US,
                     bridge.PREDICTED_US, bridge.COST_RATIO):
            h, rh = reg.histogram(name), rreg.histogram(name)
            assert (h.count, h.sum, list(h.counts)) == \
                (rh.count, rh.sum, list(rh.counts))
        assert reg.gauge(bridge.COVERAGE).value == \
            rreg.gauge(rbridge.COVERAGE).value == 0.75
        assert reg.counter(bridge.BATCHES).value == 1
    assert (bridge.STEPS, bridge.DIST_H, bridge.COVERAGE,
            bridge.MEASURED_US, bridge.PREDICTED_US, bridge.COST_RATIO,
            bridge.BATCHES) == (rbridge.STEPS, rbridge.DIST_H,
                                rbridge.COVERAGE, rbridge.MEASURED_US,
                                rbridge.PREDICTED_US, rbridge.COST_RATIO,
                                rbridge.BATCHES)


def test_bridge_on_a_port_batch(float_fix):
    """The bridge folds the port's own ``return_stats`` tensors."""
    from repro_torch.core.search_torch import build_packed, search_batched
    fx = float_fix
    db = build_packed(fx.g, filt=fx.filt["pca"], device="cpu")
    _, _, st = search_batched(db, fx.q, filt=fx.filt["pca"],
                              return_stats=True, device="cpu")
    reg = Registry()
    out = bridge.record_search_stats(st, wall_s=0.01, registry=reg,
                                     cfg=fx.cfg, filt=fx.filt["pca"])
    assert reg.histogram(bridge.STEPS).count == NQ
    assert out["steps_mean"] == float(st["steps_total"].double().mean())
    assert out["cost_ratio"] == pytest.approx(out["measured_us"]
                                              / out["predicted_us"])


def test_table3_bench_rows_on_cpu(float_fix, tmp_path):
    """The Table III / Fig 5 benches' rows on the CPU at the fixture's
    size: the oracle's, the model's (equal to the reference's table3),
    the batched pca and none rows on a padded batch, and the JSON."""
    import json
    from repro_torch.bench import table3_qps
    from repro_torch.bench.common import emit
    from repro_torch.bench.fig5_energy import energy_rows
    fx = float_fix
    xl = fx.payload("pca")
    rows, traces, host = table3_qps.host_rows(fx.g, xl, fx.pca, fx.q, fx.gt)
    assert [r[0] for r in rows] == ["table3/HNSW-CPU", "table3/pHNSW-CPU"]
    assert host["phnsw_recall"] == search_ref.run_queries(
        fx.g, fx.q, fx.gt, algo="phnsw", x_low=xl, pca=fx.pca)[0]
    crows, t3 = table3_qps.cost_rows(traces, NQ, 128, 15)
    assert len(crows) == 6 and list(t3) == list(traces)
    brows, ms = table3_qps.batched_rows(fx.cfg, fx.x, fx.g, fx.pca, fx.q,
                                        fx.gt, batch=16, reps=1,
                                        device="cpu")
    assert [m["name"] for m in ms] == ["pca", "none"]
    assert all(m["queries"] == NQ and m["batch"] == 16 for m in ms)
    assert abs(ms[0]["recall"] - host["phnsw_recall"]) <= 0.02
    assert ms[0]["stats"]["steps_total"].shape == (NQ,)
    erows = energy_rows(t3)
    assert erows[-1][0] == "fig5/savings_ddr4"
    out = tmp_path / "t3.json"
    emit(rows + crows + brows + erows, out, bench="table3_qps")
    doc = json.loads(out.read_text())
    assert doc["bench"] == "table3_qps" and len(doc["rows"]) == 2 + 6 + 2 + 7
