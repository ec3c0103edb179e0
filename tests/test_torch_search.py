"""repro_torch's batched search against ``repro.core.search_jax``.

Both engines search the very same index state: the reference
``PackedDB``'s arrays are carried into the port with
``search_torch.from_reference``, the PCA through its
``mean``/``components`` and a filter's parameters with
``filters.from_reference``. On an exact-arithmetic fixture (small-integer
vectors, payloads and PQ centroids, so every f32 sum is exact in any
order and ties are plentiful) ids, dists, ``steps_per_layer`` and
``dist_h_evals`` are bit-equal in every filter and re-ranking mode; on
the 4k float fixture recall@10 stays within 0.02 of the host reference
``search_ref``."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core import search_jax
from repro.core import filters as rfilters
from repro.core.filters import IdentityFilter
from repro.core.graph import HNSWGraph as RefGraph
from repro.core.pca import PCA as RefPCA
from repro.core.pq import PQCodebook as RefCodebook
from repro_torch.configs.base import PHNSWConfig
from repro_torch.core import filters, search_torch
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
            "low2": None if db.low2 is None else np.asarray(db.low2),
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


def _ref_db(cfg, g, kind, filt=None):
    rg = RefGraph(cfg=RefConfig(**dataclasses.asdict(cfg)), x=g.x,
                  levels=g.levels, layers=g.layers, entry=g.entry)
    if filt is not None:
        return search_jax.build_packed(rg, filt=filt)
    if kind == "pca":
        return search_jax.build_packed(rg, g.x[:, :4].copy())
    return search_jax.build_packed(rg, filt=IdentityFilter(dim=g.x.shape[1]))


def _int_filters(kind):
    """(reference filter, port filter) with exact arithmetic on the
    integer fixture: small-integer centroids (4 subspaces of 4 dims) and
    a 'PCA' that selects the first 4 coordinates."""
    arrays = {"centroids": np.random.default_rng(5).integers(
                  0, 8, (4, 256, 4)).astype(np.float32),
              "mean": np.zeros(16, np.float32),
              "components": np.eye(16, 4, dtype=np.float32),
              "explained": np.full(4, 0.25, np.float32)}
    pca = RefPCA(arrays["mean"], arrays["components"], arrays["explained"])
    cb = RefCodebook(arrays["centroids"])
    ref = {"pca": rfilters.PCAFilter(pca), "pq": rfilters.PQFilter(cb),
           "cascade": rfilters.CascadeFilter(cb, pca)}[kind]
    return ref, filters.from_reference(kind, arrays)


# (filter kind, deferred, rerank_mult) of the filter/re-rank modes, at
# the tracked bench's multipliers (promote_mult is the config's 6)
MODES = {"pq": ("pq", False, None), "pq-deferred": ("pq", True, 3),
         "pca-deferred": ("pca", True, 3),
         "cascade-deferred": ("cascade", True, 2)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("W", [1, 2])
def test_filter_modes_bit_equal_on_integer_fixture(int_fixture, mode, W):
    kind, deferred, rm = MODES[mode]
    cfg, g, x, q = int_fixture
    cfg = dataclasses.replace(cfg, expand_width=W)
    g = dataclasses.replace(g, cfg=cfg)
    rfilt, tfilt = _int_filters(kind)
    jdb = _ref_db(cfg, g, kind, rfilt)
    jd, ji, js = search_jax.search_batched(
        jdb, jnp.asarray(q), filt=rfilt, deferred=deferred, rerank_mult=rm,
        return_stats=True)
    tdb = search_torch.build_packed(g, filt=tfilt, device="cpu")
    td, ti, ts = search_torch.search_batched(
        tdb, q, filt=tfilt, deferred=deferred, rerank_mult=rm,
        return_stats=True, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts["steps_per_layer"].numpy(),
                                  np.asarray(js["steps_per_layer"]))
    np.testing.assert_array_equal(ts["dist_h_evals"].numpy(),
                                  np.asarray(js["dist_h_evals"]))
    assert tdb.bytes_layout3 == jdb.bytes_layout3
    assert tdb.bytes_sidecar == jdb.bytes_sidecar
    assert tdb.bytes_layout4 == jdb.bytes_layout4
    # the port's own packing gives the reference's arrays, uint8 codes
    # included, and from_reference carries them (and the side-car) back
    back = search_torch.from_reference(ref_db_arrays(jdb), cfg,
                                       device="cpu")
    for own in (tdb, back):
        assert len(own.layers) == len(jdb.layers)
        for a, b in zip(own.layers, jdb.layers):
            np.testing.assert_array_equal(a.adj.numpy(), np.asarray(b.adj))
            np.testing.assert_array_equal(a.packed_low.numpy(),
                                          np.asarray(b.packed_low))
        np.testing.assert_array_equal(own.low.numpy(), np.asarray(jdb.low))
        assert (own.low2 is None) == (jdb.low2 is None)
        if own.low2 is not None:
            np.testing.assert_array_equal(own.low2.numpy(),
                                          np.asarray(jdb.low2))
    if kind != "pca":
        assert tdb.low.dtype == torch.uint8
        assert tdb.layers[0].packed_low.dtype == torch.uint8
    if deferred:
        # deferred re-ranking spends exactly one Dist.H pass per query
        assert int(ts["dist_h_evals"].max()) <= 10 * rm


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
        filter_deleted=False, ef_upper=ef_upper, device="cpu")
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


@pytest.mark.parametrize("mode", ["pq", "cascade-deferred"])
def test_search_keywords_bit_equal_on_integer_fixture(int_fixture, mode):
    """``ef0``, ``k_schedule``, ``entry`` and ``promote_mult`` override
    the config as in the reference."""
    kind, deferred, rm = MODES[mode]
    cfg, g, x, q = int_fixture
    rfilt, tfilt = _int_filters(kind)
    kw = dict(deferred=deferred, rerank_mult=rm, ef0=6,
              k_schedule=(12, 4, 2), entry=int(np.argmax(g.levels)),
              promote_mult=4)
    jd, ji, js = search_jax.search_batched(
        _ref_db(cfg, g, kind, rfilt), jnp.asarray(q), filt=rfilt,
        return_stats=True, **kw)
    td, ti, ts = search_torch.search_batched(
        search_torch.build_packed(g, filt=tfilt, device="cpu"), q,
        filt=tfilt, return_stats=True, device="cpu", **kw)
    assert ti.shape == (len(q), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts["steps_per_layer"].numpy(),
                                  np.asarray(js["steps_per_layer"]))
    np.testing.assert_array_equal(ts["dist_h_evals"].numpy(),
                                  np.asarray(js["dist_h_evals"]))


@pytest.mark.parametrize("mode", ["pca-deferred", "cascade-deferred"])
def test_deferred_recall_parity_with_search_ref(small_dataset, small_graph,
                                                small_pca, mode):
    """recall@10 of the deferred modes within 0.02 of the host
    reference ``search_filtered`` on the 4k fixture. The cascade's
    codebook is trained by the port (density-aware, the config's 8
    Lloyd iterations) and handed to the reference as numpy."""
    from repro.core.search_ref import recall_at, search_filtered
    kind, _, rm = MODES[mode]
    x, q, gt = small_dataset
    cfg = port_cfg(small_graph.cfg)
    g = HNSWGraph(cfg=cfg, x=small_graph.x, levels=small_graph.levels,
                  layers=small_graph.layers, entry=small_graph.entry)
    arrays = {"mean": small_pca.mean, "components": small_pca.components,
              "explained": small_pca.explained}
    if kind == "cascade":
        tfilt = filters.make_filter(
            dataclasses.replace(cfg, filter_kind="cascade"), x, seed=0,
            pca=filters.from_reference("pca", arrays).pca,
            levels=g.levels)
        rfilt = rfilters.CascadeFilter(RefCodebook(tfilt.cb.centroids),
                                       small_pca)
    else:
        tfilt = filters.from_reference("pca", arrays)
        rfilt = rfilters.PCAFilter(small_pca)
    db = search_torch.build_packed(g, filt=tfilt, device="cpu")
    _, fi = search_torch.search_batched(db, q, filt=tfilt, deferred=True,
                                        rerank_mult=rm, device="cpu")
    fi = fi.numpy()
    pay = rfilt.encode(x)
    mid = rfilt.encode_mid(x) if kind == "cascade" else None
    pm = max(cfg.promote_mult, rm)
    r_ref, r_port = [], []
    for i in range(len(q)):
        ids, _ = search_filtered(small_graph, rfilt, pay, q[i],
                                 deferred=True, rerank_mult=rm,
                                 promote_mult=pm, payload_mid=mid)
        r_ref.append(recall_at(ids, gt[i], 10))
        r_port.append(recall_at(fi[i], gt[i], 10))
    assert abs(np.mean(r_port) - np.mean(r_ref)) <= 0.02, \
        (mode, np.mean(r_port), np.mean(r_ref))
    assert np.mean(r_port) >= 0.9


def test_identity_filter_ignores_deferred(int_fixture):
    """Deferred re-ranking is a no-op for the identity filter, and
    ``rerank_mult`` outside deferred mode changes nothing (the
    reference's normalisation)."""
    cfg, g, x, q = int_fixture
    db = search_torch.from_reference(ref_db_arrays(_ref_db(cfg, g, "none")),
                                     cfg, device="cpu")
    base = search_torch.search_batched(db, q, device="cpu")
    for kw in ({"deferred": True, "rerank_mult": 3}, {"rerank_mult": 5}):
        got = search_torch.search_batched(db, q, device="cpu", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, base))
    pdb = search_torch.build_packed(g, x[:, :4], device="cpu")
    a = search_torch.search_batched(pdb, q, q[:, :4], device="cpu")
    b = search_torch.search_batched(pdb, q, q[:, :4], rerank_mult=7,
                                    promote_mult=9, device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_filter_mismatch_and_bad_payload_raise(int_fixture):
    cfg, g, x, q = int_fixture
    _, tpq = _int_filters("pq")
    db = search_torch.build_packed(g, x[:, :4], device="cpu")
    with pytest.raises(ValueError, match="filter mismatch"):
        search_torch.search_batched(db, q, filt=tpq, device="cpu")
    arrays = ref_db_arrays(_ref_db(cfg, g, "pca"))
    arrays["filter_kind"] = "pq"           # float rows are no PQ codes
    with pytest.raises(ValueError, match="uint8"):
        search_torch.from_reference(arrays, cfg, device="cpu")


@pytest.mark.parametrize("case", ["float16", "tombstones", "device"])
def test_outside_the_slice_raises(int_fixture, case):
    """A pca payload is stored in float32 or bfloat16 only; tombstone
    filtering needs a bitmap (the reference asserts the same); a db
    lives on one device."""
    cfg, g, x, q = int_fixture
    if case == "float16":
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            search_torch.build_packed(g, x[:, :4], low_dtype="float16",
                                      device="cpu")
        arrays = ref_db_arrays(_ref_db(cfg, g, "pca"))
        arrays["low"] = arrays["low"].astype(np.float16)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            search_torch.from_reference(arrays, cfg, device="cpu")
        return
    db = search_torch.build_packed(g, x[:, :4], device="cpu")
    if case == "tombstones":
        with pytest.raises(ValueError, match="needs db.deleted"):
            search_torch.probe_neighborhoods(db, q, q[:, :4], 8, 4,
                                             filter_deleted=True,
                                             device="cpu")
        with pytest.raises(ValueError, match="needs db.deleted"):
            search_torch.probe_neighborhoods(db, q, q[:, :4], 8, 4,
                                             device="cpu")
    else:
        with pytest.raises(ValueError, match="lives on cpu"):
            search_torch.search_batched(db, q, q[:, :4])


# --------------------------- bf16 layout-(3) rows ---------------------------

def _bf16_pair(cfg, g, low):
    """The reference's and the port's pca db over the same graph with
    ``low`` stored in bfloat16 (the reference rounds by ``jnp.asarray``,
    the port by ``Tensor.to``), and the port's db carried over from the
    reference's arrays."""
    bcfg = dataclasses.replace(cfg, low_dtype="bfloat16")
    rg = RefGraph(cfg=RefConfig(**dataclasses.asdict(bcfg)), x=g.x,
                  levels=g.levels, layers=g.layers, entry=g.entry)
    jdb = search_jax.build_packed(rg, low.copy())
    own = search_torch.build_packed(dataclasses.replace(g, cfg=bcfg), low,
                                    device="cpu")
    back = search_torch.from_reference(ref_db_arrays(jdb), bcfg,
                                       device="cpu")
    return bcfg, jdb, own, back


def _bits16(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("source", ["build_packed", "from_reference"])
@pytest.mark.parametrize("mode", ["pca", "pca-deferred"])
@pytest.mark.parametrize("W", [1, 2])
def test_bf16_search_bit_equal_on_integer_fixture(int_fixture, mode, source,
                                                  W):
    """low_dtype="bfloat16": the port's pca and pca-deferred search, on a
    db it packed itself or carried over from the reference's arrays, is
    bit-equal to ``search_jax`` in ids, dists, ``steps_per_layer`` and
    ``dist_h_evals``; the stored rows are bf16 with the reference's bits
    and the layout-(3) bytes count two bytes an element."""
    cfg, g, x, q = int_fixture
    cfg = dataclasses.replace(cfg, expand_width=W)
    g = dataclasses.replace(g, cfg=cfg)
    deferred = mode == "pca-deferred"
    bcfg, jdb, own, back = _bf16_pair(cfg, g, g.x[:, :4])
    tdb = own if source == "build_packed" else back
    assert tdb.low.dtype == torch.bfloat16
    assert str(np.asarray(jdb.low).dtype) == "bfloat16"
    for a, b in zip(tdb.layers, jdb.layers):
        assert a.packed_low.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _bits16(a.packed_low),
            np.asarray(b.packed_low).view(np.int16))
    jd, ji, js = search_jax.search_batched(
        jdb, jnp.asarray(q), jnp.asarray(q[:, :4]), deferred=deferred,
        rerank_mult=3, return_stats=True)
    td, ti, ts = search_torch.search_batched(
        tdb, q, q[:, :4], deferred=deferred, rerank_mult=3,
        return_stats=True, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts["steps_per_layer"].numpy(),
                                  np.asarray(js["steps_per_layer"]))
    np.testing.assert_array_equal(ts["dist_h_evals"].numpy(),
                                  np.asarray(js["dist_h_evals"]))
    assert tdb.bytes_layout3 == jdb.bytes_layout3
    assert tdb.bytes_layout4 == jdb.bytes_layout4


def test_bf16_rows_round_as_the_reference_on_float_data(int_fixture):
    """On float rows the one f32 -> bf16 rounding of ``build_packed``
    gives the reference's bits in ``low`` and every ``packed_low`` (the
    -1 slots' zeros included), and ``from_reference`` carries them bit
    for bit."""
    cfg, g, x, q = int_fixture
    low = np.random.default_rng(11).standard_normal(
        (len(g.x), 4)).astype(np.float32) * 37.0
    low[:5] = [[1e-40, -0.0, 3.4e38, -1.00390625]] * 5
    _, jdb, own, back = _bf16_pair(cfg, g, low)
    for tdb in (own, back):
        np.testing.assert_array_equal(_bits16(tdb.low),
                                      np.asarray(jdb.low).view(np.int16))
        for a, b in zip(tdb.layers, jdb.layers):
            np.testing.assert_array_equal(
                _bits16(a.packed_low),
                np.asarray(b.packed_low).view(np.int16))


def test_bf16_bytes_layout3_below_three_quarters_of_f32(int_fixture):
    """The bf16 store's layout-(3) bytes are below 0.75x the f32 store's
    (as ``tests/test_system.py`` holds the reference's), its bytes
    beside the reference's."""
    cfg, g, x, q = int_fixture
    _, jdb, own, _ = _bf16_pair(cfg, g, g.x[:, :4])
    f32 = search_torch.build_packed(g, g.x[:, :4], device="cpu")
    assert own.bytes_layout3 == jdb.bytes_layout3
    assert own.bytes_layout3 < 0.75 * f32.bytes_layout3
    dl = own.low.shape[1]
    extra = lambda db, isz: sum(int((l.adj >= 0).sum()) * (4 + dl * isz)
                                for l in db.layers)
    assert own.bytes_layout3 - extra(own, 2) \
        == f32.bytes_layout3 - extra(f32, 4) == own.high.numel() * 4


# ------------------------------- tombstones --------------------------------

def _doomed(x, q, frac=0.05, seed=9):
    """Tombstone flags: ``frac`` of the points at random plus every
    query's exact nearest neighbor (so the filter must bite)."""
    rng = np.random.default_rng(seed)
    flags = np.zeros(len(x), bool)
    flags[rng.choice(len(x), int(frac * len(x)), replace=False)] = True
    flags[np.argmin(((q[:, None] - x[None]) ** 2).sum(-1), 1)] = True
    return flags


def _tombstoned_pair(cfg, g, kind, flags):
    """(reference db, port db) over the same state, tombstones set."""
    rfilt, tfilt = (None, None) if kind in ("pca", "none") \
        else _int_filters(kind)
    jdb = _ref_db(cfg, g, kind, rfilt)
    words = search_torch.pack_bitmap(flags)
    np.testing.assert_array_equal(words, search_jax.pack_bitmap(flags))
    jdb = dataclasses.replace(jdb, deleted=jnp.asarray(words))
    tdb = search_torch.from_reference(ref_db_arrays(jdb) | {
        "deleted": words}, cfg, device="cpu")
    return jdb, tdb, rfilt, tfilt


@pytest.mark.parametrize("mode", ["pca", "pq", "pca-deferred",
                                  "cascade-deferred"])
@pytest.mark.parametrize("W", [1, 2])
def test_tombstoned_search_bit_equal_on_integer_fixture(int_fixture, mode,
                                                        W):
    """Deleted nodes are traversed but never returned: ids, dists,
    ``steps_per_layer`` and ``dist_h_evals`` bit-equal to the reference
    with the bitmap set, per step and deferred."""
    kind, deferred, rm = MODES.get(mode, ("pca", False, None))
    cfg, g, x, q = int_fixture
    cfg = dataclasses.replace(cfg, expand_width=W)
    g = dataclasses.replace(g, cfg=cfg)
    flags = _doomed(x, q)
    jdb, tdb, rfilt, tfilt = _tombstoned_pair(cfg, g, kind, flags)
    kw = dict(deferred=deferred, rerank_mult=rm, return_stats=True)
    if kind == "pca":
        jd, ji, js = search_jax.search_batched(
            jdb, jnp.asarray(q), jnp.asarray(q[:, :4]), **kw)
        td, ti, ts = search_torch.search_batched(tdb, q, q[:, :4],
                                                 device="cpu", **kw)
    else:
        jd, ji, js = search_jax.search_batched(jdb, jnp.asarray(q),
                                               filt=rfilt, **kw)
        td, ti, ts = search_torch.search_batched(tdb, q, filt=tfilt,
                                                 device="cpu", **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts["steps_per_layer"].numpy(),
                                  np.asarray(js["steps_per_layer"]))
    np.testing.assert_array_equal(ts["dist_h_evals"].numpy(),
                                  np.asarray(js["dist_h_evals"]))
    got = ti.numpy()
    assert not flags[got[got >= 0]].any()
    assert (got >= 0).all()


@pytest.mark.parametrize("ef,ef_upper", [(8, 4), (24, None)])
def test_tombstoned_probe_bit_equal_on_integer_fixture(int_fixture, ef,
                                                       ef_upper):
    """``probe_neighborhoods`` filters tombstones at every layer by
    default, as the reference's does."""
    cfg, g, x, q = int_fixture
    flags = _doomed(x, q, frac=0.1)
    jdb, tdb, _, _ = _tombstoned_pair(cfg, g, "none", flags)
    qp = np.zeros((len(q), 0), np.float32)
    jd, ji = search_jax.probe_neighborhoods(jdb, jnp.asarray(q),
                                            jnp.asarray(qp), ef, 16,
                                            ef_upper=ef_upper)
    td, ti = search_torch.probe_neighborhoods(tdb, q, qp, ef, 16,
                                              ef_upper=ef_upper,
                                              device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    got = ti.numpy()
    assert not flags[got[got >= 0]].any()


@pytest.mark.parametrize("mode", ["pca-deferred", "cascade-deferred"])
def test_deferred_without_final_rerank_is_the_wide_list(int_fixture, mode):
    """``final_rerank=False`` skips the promote stage and the re-rank:
    the layer-0 filter-space list of ``promote_mult * ef0`` (cascade) or
    ``rerank_mult * ef0`` entries, bit-equal to the reference's."""
    import functools
    import jax
    kind, _, rm = MODES[mode]
    cfg, g, x, q = int_fixture
    flags = _doomed(x, q)
    jdb, tdb, rfilt, tfilt = _tombstoned_pair(cfg, g, kind, flags)
    if kind == "pca":
        jqp, tqp = jnp.asarray(q[:, :4]), torch.from_numpy(q[:, :4].copy())
    else:
        jqp, tqp = rfilt.prepare_jnp(jnp.asarray(q)), \
            tfilt.prepare_torch(torch.from_numpy(q))
    ks = cfg.k_schedule_for(kind, True)
    kw = dict(ef0=10, k_schedule=ks, deferred=True, rerank_mult=rm,
              promote_mult=6, final_rerank=False)
    jd, ji, js, _ = jax.jit(functools.partial(
        search_jax._search_batched_impl, **kw))(jdb, jnp.asarray(q), jqp)
    td, ti, ts, _ = search_torch._search_batched_impl(
        tdb, torch.from_numpy(q), tqp, **kw)
    assert ti.shape == (len(q), 10 * (6 if kind == "cascade" else rm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
