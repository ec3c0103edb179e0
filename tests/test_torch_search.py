"""repro_torch's batched search against ``repro.core.search_jax``.

Both engines search the very same index state: the reference
``PackedDB``'s arrays are carried into the port with
``search_torch.from_reference``, and the PCA through its
``mean``/``components``. On an exact-arithmetic fixture (small-integer
vectors and payloads, so every f32 sum is exact in any order and ties
are plentiful) ids, dists, ``steps_per_layer`` and ``dist_h_evals`` are
bit-equal; on the 4k float fixture recall@10 stays within 0.02 of the
host reference ``search_ref``."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core import search_jax
from repro.core.filters import IdentityFilter
from repro.core.graph import HNSWGraph as RefGraph
from repro_torch.configs.base import PHNSWConfig
from repro_torch.core import search_torch
from repro_torch.core.graph import HNSWGraph, build_hnsw
from repro_torch.core.pca import PCA


def port_cfg(cfg) -> PHNSWConfig:
    """The port's config from a reference one (the fields it reads)."""
    return PHNSWConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(PHNSWConfig)})


def ref_db_arrays(db) -> dict:
    return {"adj": [np.asarray(l.adj) for l in db.layers],
            "packed_low": [np.asarray(l.packed_low) for l in db.layers],
            "low": np.asarray(db.low), "high": np.asarray(db.high),
            "entry": int(db.entry), "filter_kind": db.filter_kind}


@pytest.fixture(scope="module")
def int_fixture():
    """600 integer vectors in [0, 8)^16, a graph over them, and integer
    queries; the 'PCA' payload is the first 4 coordinates (a projection,
    so a lower bound on the distance, as PCA is)."""
    rng = np.random.default_rng(2024)
    x = rng.integers(0, 8, (600, 16)).astype(np.float32)
    q = rng.integers(0, 8, (48, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int600", n_points=600, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=128)
    g = build_hnsw(x, cfg, seed=1, device="cpu")
    return cfg, g, x, q


def _ref_db(cfg, g, kind):
    rg = RefGraph(cfg=RefConfig(**dataclasses.asdict(cfg)), x=g.x,
                  levels=g.levels, layers=g.layers, entry=g.entry)
    if kind == "pca":
        return search_jax.build_packed(rg, g.x[:, :4].copy())
    return search_jax.build_packed(rg, filt=IdentityFilter(dim=g.x.shape[1]))


@pytest.mark.parametrize("kind", ["pca", "none"])
@pytest.mark.parametrize("W", [1, 2])
def test_search_bit_equal_on_integer_fixture(int_fixture, kind, W):
    cfg, g, x, q = int_fixture
    cfg = dataclasses.replace(cfg, expand_width=W)
    g = dataclasses.replace(g, cfg=cfg)
    jdb = _ref_db(cfg, g, kind)
    jqp = jnp.asarray(q[:, :4]) if kind == "pca" else None
    jd, ji, js = search_jax.search_batched(jdb, jnp.asarray(q), jqp,
                                           return_stats=True)
    tdb = search_torch.from_reference(ref_db_arrays(jdb), cfg, device="cpu")
    tqp = q[:, :4] if kind == "pca" else None
    td, ti, ts = search_torch.search_batched(tdb, q, tqp, return_stats=True,
                                             device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts["steps_per_layer"].numpy(),
                                  np.asarray(js["steps_per_layer"]))
    np.testing.assert_array_equal(ts["dist_h_evals"].numpy(),
                                  np.asarray(js["dist_h_evals"]))
    assert ts["dist_h_evals"].dtype == torch.int32
    assert ti.dtype == torch.int32
    assert tdb.bytes_layout3 == jdb.bytes_layout3
    assert tdb.bytes_layout4 == jdb.bytes_layout4
    if kind == "pca":
        # the port's own packing gives the reference's arrays
        own = search_torch.build_packed(g, g.x[:, :4], device="cpu")
        assert len(own.layers) == len(tdb.layers)
        for a, b in zip(own.layers, tdb.layers):
            assert torch.equal(a.adj, b.adj)
            assert torch.equal(a.packed_low, b.packed_low)
        assert torch.equal(own.low, tdb.low)
        assert torch.equal(own.high, tdb.high)


@pytest.mark.parametrize("ef,ef_upper", [(8, 4), (24, 8)])
def test_probe_bit_equal_on_integer_fixture(int_fixture, ef, ef_upper):
    cfg, g, x, q = int_fixture
    jdb = _ref_db(cfg, g, "none")
    jd, ji = search_jax.probe_neighborhoods(
        jdb, jnp.asarray(q), jnp.zeros((len(q), 0), jnp.float32), ef, 16,
        filter_deleted=False, ef_upper=ef_upper)
    tdb = search_torch.from_reference(ref_db_arrays(jdb), cfg, device="cpu")
    td, ti = search_torch.probe_neighborhoods(
        tdb, q, np.zeros((len(q), 0), np.float32), ef, 16,
        ef_upper=ef_upper, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_recall_parity_with_search_ref(small_dataset, small_graph,
                                       small_pca, small_xlow):
    """recall@10 within 0.02 of the host reference on the 4k fixture
    (the bar of tests/test_core.py's batched-engine parity test)."""
    from repro.core.search_ref import recall_at, run_queries
    x, q, gt = small_dataset
    r_ref, _ = run_queries(small_graph, q, gt, algo="phnsw",
                           x_low=small_xlow, pca=small_pca)
    cfg = port_cfg(small_graph.cfg)
    g = HNSWGraph(cfg=cfg, x=small_graph.x, levels=small_graph.levels,
                  layers=small_graph.layers, entry=small_graph.entry)
    pca = PCA(small_pca.mean, small_pca.components, small_pca.explained)
    np.testing.assert_array_equal(pca.transform(x[:5]),
                                  small_pca.transform(x[:5]))
    db = search_torch.build_packed(g, small_xlow, device="cpu")
    _, fi = search_torch.search_batched(db, q, pca=pca, device="cpu")
    fi = fi.numpy()
    r_port = float(np.mean([recall_at(fi[i], gt[i], 10)
                            for i in range(len(q))]))
    assert abs(r_port - r_ref) <= 0.02, (r_port, r_ref)


@pytest.mark.parametrize("case", ["deferred", "rerank_mult", "bf16",
                                  "tombstones", "pq", "device"])
def test_outside_the_slice_raises(int_fixture, case):
    cfg, g, x, q = int_fixture
    if case == "bf16":
        with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
            search_torch.build_packed(g, x[:, :4], low_dtype="bfloat16",
                                      device="cpu")
        return
    if case == "pq":
        arrays = ref_db_arrays(_ref_db(cfg, g, "pca"))
        arrays["filter_kind"] = "pq"
        with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
            search_torch.from_reference(arrays, cfg, device="cpu")
        return
    db = search_torch.build_packed(g, x[:, :4], device="cpu")
    if case in ("deferred", "rerank_mult"):
        kw = {"deferred": True} if case == "deferred" else {"rerank_mult": 3}
        with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
            search_torch.search_batched(db, q, q[:, :4], device="cpu", **kw)
    elif case == "tombstones":
        with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
            search_torch.probe_neighborhoods(db, q, q[:, :4], 8, 4,
                                             filter_deleted=True,
                                             device="cpu")
    else:
        with pytest.raises(ValueError, match="lives on cpu"):
            search_torch.search_batched(db, q, q[:, :4])
