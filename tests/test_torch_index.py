"""repro_torch's mutable indexes against ``repro.index``.

On the exact-arithmetic fixture (small-integer vectors and a
coordinate-selecting 'PCA', as in tests/test_torch_search.py) both
packages adopt the very same graph and run the same mutation sequence —
upserts with underfull probe batches, deletes (the entry point
included), a replace-upsert, a growth in the middle of an upsert,
``reserve``, ``compact`` and more upserts — and after every step the
port's ``MutableIndex`` is bit-equal to the reference's: host adjacency,
levels, entry, ``n``, ``cap``, epoch, tombstones, ``last_remap``, the
published device snapshot and the search's ids and dists.
``ShardedMutableIndex`` gives the reference's global ids for P in {1, 3},
through a growth that renumbers them, and its search over a device mesh
(``mesh=``) the reference's answers. Snapshots written by either
package load in the other with equal checksums; a damaged file raises
``SnapshotCorruptError``. On a 2,000-point float fixture the port
passes the reference's behavioural cases (tests/test_index.py) at their
bars, and an earlier epoch's tensors never change under later
mutations."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core.graph import HNSWGraph as RefGraph
from repro.index import MutableIndex as RefIndex
from repro.index import ShardedMutableIndex as RefSharded
from repro.index import mutable as rmutable
from repro_torch.configs.base import PHNSWConfig
from repro_torch.core.distributed import make_mesh, shard_bounds
from repro_torch.core.graph import build_hnsw
from repro_torch.core.pca import fit_pca
from repro_torch.data.vectors import make_queries, make_sift_like
from repro_torch.distributed import faults
from repro_torch.distributed.faults import FaultPlan, SnapshotCorruptError
from repro_torch.index import MutableIndex, ShardedMutableIndex
from repro_torch.index import mutable as tmutable
from test_torch_search import _int_filters

N_INT = 600


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several workers on the host's cores: one torch
    thread each keeps the plain CPU kernels from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int_cfg(n=N_INT, **kw):
    """The integer fixture's config: the probe's top-k fits the upper
    layers' degree (k <= M), and narrow insert batches keep the CPU's
    plain merges cheap."""
    return PHNSWConfig(name="int600", n_points=n, dim=16, d_low=4, M=8,
                       M0=16, ef_construction=16, wave_size=128,
                       ef_construction_k=8, insert_batch=32, **kw)


def _ref_graph(g):
    rcfg = RefConfig(**dataclasses.asdict(g.cfg))
    return RefGraph(cfg=rcfg, x=g.x, levels=g.levels, layers=g.layers,
                    entry=g.entry)


def _int_rows(rng, n):
    return rng.integers(0, 8, (n, 16)).astype(np.float32)


def _state(idx) -> dict:
    """Everything the two packages must agree on, as numpy."""
    fd, fi = idx.search(QUERIES)
    db = idx.db
    # copies: the reference's CPU arrays may alias its host mirrors
    npy = lambda t: np.array(t.cpu() if isinstance(t, torch.Tensor)
                             else t)
    out = {"n": idx.n, "cap": idx.cap, "entry": idx.entry,
           "epoch": idx.epoch, "top": idx.top, "n_deleted": idx.n_deleted,
           "levels": npy(idx.levels), "deleted": npy(idx.deleted),
           "x": npy(idx.x), "x_low": npy(idx.x_low),
           "last_remap": None if idx.last_remap is None
           else idx.last_remap.copy(),
           "fd": npy(fd), "fi": npy(fi), "db_entry": int(db.entry),
           "db_low": npy(db.low), "db_high": npy(db.high),
           "db_deleted": npy(db.deleted)}
    for l, a in enumerate(idx.adj):
        out[f"adj{l}"] = a.copy()
    for l, lay in enumerate(db.layers):
        out[f"db_adj{l}"] = npy(lay.adj)
        out[f"db_packed{l}"] = npy(lay.packed_low)
    return out


QUERIES = np.random.default_rng(7).integers(0, 8, (24, 16)) \
    .astype(np.float32)

# the mutation sequence both packages run, step by step
STEPS = ("adopt", "upsert_300", "delete_60_and_entry", "replace_20",
         "upsert_growth", "reserve", "compact", "upsert_after_compact")


def _apply(idx, step, rng):
    if step == "upsert_300":
        idx.upsert(_int_rows(rng, 300))        # 9 x 32 + 12 (padded)
    elif step == "delete_60_and_entry":
        ids = np.append(rng.choice(idx.n, 60, replace=False), idx.entry)
        idx.delete(ids, auto_compact=False)
    elif step == "replace_20":
        live = idx.live_ids()
        idx.upsert(_int_rows(rng, 20), ids=live[:20])
    elif step == "upsert_growth":
        idx.upsert(_int_rows(rng, 120))        # 920 + 120 > cap 1024
    elif step == "reserve":
        idx.reserve(3000)
    elif step == "compact":
        idx.compact()
    elif step == "upsert_after_compact":
        idx.upsert(_int_rows(rng, 50))


@pytest.fixture(scope="module")
def int_sequence():
    """Both packages through STEPS from one graph, with one rng stream
    each (seeded alike); the state after every step."""
    rng = np.random.default_rng(2024)
    x = _int_rows(rng, N_INT)
    g = build_hnsw(x, _int_cfg(), seed=1, device="cpu")
    rfilt, tfilt = _int_filters("pca")
    ridx = RefIndex.from_graph(_ref_graph(g), rfilt, seed=3)
    tidx = MutableIndex.from_graph(g, tfilt, seed=3, device="cpu")
    rr, rt = np.random.default_rng(5), np.random.default_rng(5)
    out = {}
    for step in STEPS:
        _apply(ridx, step, rr)
        _apply(tidx, step, rt)
        out[step] = (_state(ridx), _state(tidx))
    return out, ridx, tidx


@pytest.mark.parametrize("step", STEPS)
def test_mutation_sequence_bit_equal_on_integer_fixture(int_sequence, step):
    states, _, _ = int_sequence
    ref, port = states[step]
    assert set(ref) == set(port)
    for k in ref:
        if ref[k] is None or port[k] is None:
            assert ref[k] is None and port[k] is None, k
            continue
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)


def test_mutation_sequence_exercises_every_path(int_sequence):
    """The sequence really grows, renumbers and compacts."""
    states, ridx, tidx = int_sequence
    assert states["upsert_300"][1]["cap"] == 1024
    assert states["upsert_growth"][1]["cap"] == 2048
    assert states["reserve"][1]["cap"] == 4096
    remap = states["compact"][1]["last_remap"]
    assert remap is not None
    assert (remap == -1).sum() == states["reserve"][1]["n_deleted"] > 60
    assert states["compact"][1]["n_deleted"] == 0
    assert states["compact"][1]["cap"] == 1024
    assert tidx.pca_drift()["drift"] == pytest.approx(
        ridx.pca_drift()["drift"], rel=1e-5)


def test_snapshot_checksum_and_cross_load(int_sequence, tmp_path):
    """Snapshots carry the same names, dtypes, shapes and bytes in both
    packages (equal checksums), and each package loads the other's:
    the restored indexes search alike, bit for bit."""
    _, ridx, tidx = int_sequence
    ra, ta = ridx._snapshot_arrays(), tidx._snapshot_arrays()
    assert sorted(ra) == sorted(ta)
    for k in ra:
        a, b = np.asarray(ra[k]), np.asarray(ta[k])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
    assert tmutable.snapshot_checksum(ta) == rmutable.snapshot_checksum(ra)
    tidx.save(tmp_path / "port.npz")
    ridx.save(tmp_path / "ref.npz")
    r_from_t = RefIndex.load(tmp_path / "port.npz", ridx.cfg, seed=9)
    t_from_r = MutableIndex.load(tmp_path / "ref.npz", tidx.cfg, seed=9,
                                 device="cpu")
    z_t = np.load(tmp_path / "port.npz")
    z_r = np.load(tmp_path / "ref.npz")
    assert int(z_t["checksum"]) == int(z_r["checksum"])
    rd, ri = r_from_t.search(jnp.asarray(QUERIES))
    td, ti = t_from_r.search(QUERIES)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    # a restored index publishes once more: epoch + 1 in both packages
    assert (t_from_r.n, t_from_r.entry, t_from_r.epoch) == \
        (r_from_t.n, r_from_t.entry, r_from_t.epoch) == \
        (ridx.n, ridx.entry, ridx.epoch + 1)


# --------------------------------------------------------------------------
# the sharded index, P in {1, 3}
# --------------------------------------------------------------------------

# upserts that cross one shard's capacity at min_capacity 32: P=1 holds
# 300 points in 512 slots, P=3 100 in 128 per shard
N_SHARDED = 300
GROWTH = {1: 220, 3: 90}


@pytest.mark.parametrize("P", [1, 3])
def test_sharded_global_ids_bit_equal(P, tmp_path):
    rng = np.random.default_rng(99)
    x = _int_rows(rng, N_SHARDED)
    cfg = _int_cfg(N_SHARDED, min_capacity=32)
    graphs = [build_hnsw(x[a:b], cfg, seed=1 + s, device="cpu")
              for s, (a, b) in enumerate(shard_bounds(N_SHARDED, P))]
    rfilt, tfilt = _int_filters("pca")
    ref = RefSharded([RefIndex.from_graph(_ref_graph(g), rfilt,
                                          seed=10 + s)
                      for s, g in enumerate(graphs)], rfilt,
                     RefConfig(**dataclasses.asdict(cfg)))
    port = ShardedMutableIndex(
        [MutableIndex.from_graph(g, tfilt, seed=10 + s, device="cpu")
         for s, g in enumerate(graphs)], tfilt, cfg)
    stride0 = port.stride
    xs = _int_rows(rng, 40)
    g_r, g_t = ref.upsert(xs), port.upsert(xs)
    np.testing.assert_array_equal(g_t, g_r)
    assert ref.delete(g_r[:7]) == port.delete(g_t[:7]) == 7
    big = _int_rows(rng, GROWTH[P])
    g_r, g_t = ref.upsert(big), port.upsert(big)
    np.testing.assert_array_equal(g_t, g_r)
    assert port.stride == ref.stride == 2 * stride0   # renumbered
    assert port.epoch == ref.epoch
    np.testing.assert_array_equal(port.live_global_ids(),
                                  ref.live_global_ids())
    rd, ri = ref.search(jnp.asarray(QUERIES))
    td, ti = port.search(QUERIES)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    sdb_r, sdb_t = ref.sdb, port.sdb
    for a, b in zip(sdb_t.adj + sdb_t.packed_low,
                    sdb_r.adj + sdb_r.packed_low):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for k in ("entries", "offsets", "counts"):
        np.testing.assert_array_equal(getattr(sdb_t, k),
                                      np.asarray(getattr(sdb_r, k)))
    np.testing.assert_array_equal(sdb_t.deleted.numpy(),
                                  np.asarray(sdb_r.deleted))
    # the one-npz sharded snapshot crosses both ways
    port.save(tmp_path / "p.npz")
    ref.save(tmp_path / "r.npz")
    assert int(np.load(tmp_path / "p.npz")["checksum"]) == \
        int(np.load(tmp_path / "r.npz")["checksum"])
    back = ShardedMutableIndex.load(tmp_path / "r.npz", cfg, seed=10,
                                    device="cpu")
    assert (back.stride, back._rr, back.epoch) == \
        (ref.stride, ref._rr, ref.epoch)
    np.testing.assert_array_equal(back.search(QUERIES)[1].numpy(),
                                  np.asarray(ri))
    rback = RefSharded.load(tmp_path / "p.npz", ref.cfg, seed=10)
    np.testing.assert_array_equal(
        np.asarray(rback.search(jnp.asarray(QUERIES))[1]), ti.numpy())


def test_sharded_snapshot_drops_a_reservation(tmp_path):
    """The sharded snapshot keeps no capacity (the reference's format):
    an index ``reserve``d past the next power of two of its points
    restores at that power, so its global ids renumber (the stride is
    the per-shard capacity), the same in both packages; each answer is
    the same (shard, local) point at the same distance."""
    rng = np.random.default_rng(98)
    x = _int_rows(rng, N_SHARDED)
    cfg = _int_cfg(N_SHARDED, min_capacity=32)
    graphs = [build_hnsw(x[a:b], cfg, seed=1 + s, device="cpu")
              for s, (a, b) in enumerate(shard_bounds(N_SHARDED, 3))]
    rfilt, tfilt = _int_filters("pca")
    ref = RefSharded([RefIndex.from_graph(_ref_graph(g), rfilt,
                                          seed=10 + s)
                      for s, g in enumerate(graphs)], rfilt,
                     RefConfig(**dataclasses.asdict(cfg)))
    port = ShardedMutableIndex(
        [MutableIndex.from_graph(g, tfilt, seed=10 + s, device="cpu")
         for s, g in enumerate(graphs)], tfilt, cfg)
    big = 4 * port.stride
    ref.reserve(big)
    port.reserve(big)
    assert port.stride == ref.stride == big
    port.save(tmp_path / "p.npz")
    ref.save(tmp_path / "r.npz")
    back = ShardedMutableIndex.load(tmp_path / "p.npz", cfg, seed=10,
                                    device="cpu")
    rback = RefSharded.load(tmp_path / "r.npz", ref.cfg, seed=10)
    assert back.stride == rback.stride == big // 4
    td, ti = port.search(QUERIES)
    bd, bi = back.search(QUERIES)
    np.testing.assert_array_equal(np.asarray(rback.search(
        jnp.asarray(QUERIES))[1]), bi.numpy())
    np.testing.assert_array_equal(bd.numpy(), td.numpy())
    ti, bi = ti.numpy(), bi.numpy()
    assert not np.array_equal(bi, ti)
    for a, stride in ((ti, big), (bi, big // 4)):
        a[a >= 0] = (a[a >= 0] // stride) * N_SHARDED + a[a >= 0] % stride
    np.testing.assert_array_equal(bi, ti)


def test_sharded_mesh_not_ported():
    """``ShardedMutableIndex.search(mesh=)`` (once refused, now the
    collective path) after upserts, a replace-upsert and deletes: on
    meshes (1, 2) and (2, 2) of "cpu" devices, bit-equal to the
    reference index's search, deferred too."""
    rng = np.random.default_rng(3)
    x = _int_rows(rng, 200)
    # three layers keep the reference's programs quick to compile
    cfg = _int_cfg(200, min_capacity=32, n_layers=3)
    graphs = [build_hnsw(x[a:b], cfg, seed=1 + s, device="cpu")
              for s, (a, b) in enumerate(shard_bounds(200, 2))]
    rfilt, tfilt = _int_filters("pca")
    ref = RefSharded([RefIndex.from_graph(_ref_graph(g), rfilt,
                                          seed=10 + s)
                      for s, g in enumerate(graphs)], rfilt,
                     RefConfig(**dataclasses.asdict(cfg)))
    port = ShardedMutableIndex(
        [MutableIndex.from_graph(g, tfilt, seed=10 + s, device="cpu")
         for s, g in enumerate(graphs)], tfilt, cfg)
    xs = _int_rows(rng, 24)
    g_r, g_t = ref.upsert(xs), port.upsert(xs)
    np.testing.assert_array_equal(g_t, g_r)
    r_r, r_t = ref.upsert(xs[:3], ids=g_r[:3]), port.upsert(xs[:3],
                                                           ids=g_t[:3])
    np.testing.assert_array_equal(r_t, r_r)
    assert ref.delete(g_r[3:9]) == port.delete(g_t[3:9]) == 6
    for kw in ({}, {"deferred": True, "rerank_mult": 3}):
        rd, ri = ref.search(jnp.asarray(QUERIES), **kw)
        for R in (1, 2):
            mesh = make_mesh((R, 2), ("data", "model"),
                             devices=["cpu"] * (2 * R))
            td, ti = port.search(QUERIES, mesh=mesh, **kw)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
            np.testing.assert_array_equal(td.numpy(), np.asarray(rd))


# --------------------------------------------------------------------------
# the reference's behavioural cases (tests/test_index.py) on floats
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def float_fixture():
    x = make_sift_like(2000, seed=3)
    q = make_queries(x, 32, seed=4)
    cfg = PHNSWConfig(name="f2k", n_points=2000, ef_construction=32)
    g = build_hnsw(x, cfg, seed=0, device="cpu")
    return x, q, g, fit_pca(x, 15)


@pytest.fixture()
def mut_index(float_fixture):
    _, _, g, pca = float_fixture
    return MutableIndex.from_graph(g, pca, seed=1, device="cpu")


def _recall(ids, gt, at=10):
    return float(np.mean([len(set(a[:at].tolist()) & set(b[:at].tolist()))
                          / at for a, b in zip(ids, gt)]))


def _live_recall(idx, q, at=10):
    gt = idx.live_ground_truth(q, at)
    _, fi = idx.search(q)
    fi = fi.numpy()
    return _recall(fi, gt, at), fi


def test_capacity_padding_invariants(mut_index):
    idx = mut_index
    assert idx.cap >= idx.n and idx.cap & (idx.cap - 1) == 0
    assert idx.deleted[idx.n:].all()
    assert (idx.levels[idx.n:] == -1).all()
    for a in idx.adj:
        assert (a[idx.n:] == -1).all()
    assert idx.db.high.shape[0] == idx.cap
    assert idx.db.deleted.shape[0] == idx.cap // 32


def test_insert_finds_new_vectors(mut_index, float_fixture):
    idx = mut_index
    x, _, _, _ = float_fixture
    x_new = make_sift_like(300, seed=77)
    n0, epoch0 = idx.n, idx.epoch
    ids = idx.upsert(x_new)
    assert idx.n == n0 + 300 and len(ids) == 300
    assert idx.epoch > epoch0
    _, fi = idx.search(x_new[:32])
    assert (fi.numpy()[:, 0] == ids[:32]).mean() > 0.9
    q = make_queries(np.concatenate([x, x_new]), 32, seed=10)
    rec, _ = _live_recall(idx, q)
    assert rec > 0.85


def test_delete_tombstone_semantics(mut_index, float_fixture):
    idx = mut_index
    x, q, _, _ = float_fixture
    gt = idx.live_ground_truth(q, 10)
    dels = np.unique(gt[:, :3].ravel())
    idx.delete(dels, auto_compact=False)
    rec, fi = _live_recall(idx, q)
    assert not np.isin(fi, dels).any()
    assert (fi < idx.n).all()
    assert rec > 0.85


def test_delete_entry_point_still_routes(mut_index, float_fixture):
    idx = mut_index
    _, q, _, _ = float_fixture
    entry = idx.entry
    idx.delete([entry], auto_compact=False)
    rec, fi = _live_recall(idx, q)
    assert not (fi == entry).any()
    assert rec > 0.85


def test_growth_is_power_of_two_and_reserve(mut_index):
    idx = mut_index
    cap0 = idx.cap
    idx.upsert(make_sift_like(cap0 - idx.n + 1, seed=5))
    assert idx.cap == 2 * cap0
    idx.reserve(idx.cap * 4 + 1)
    assert idx.cap == cap0 * 16
    assert idx.deleted[idx.n:].all()


def test_compact_trigger_and_remap(float_fixture):
    _, q, g, pca = float_fixture
    cfg = dataclasses.replace(g.cfg, compact_tombstone_frac=0.2)
    idx = MutableIndex.from_graph(dataclasses.replace(g, cfg=cfg), pca,
                                  seed=1, device="cpu")
    n0 = idx.n
    doomed = np.random.default_rng(0).choice(n0, size=int(0.25 * n0),
                                             replace=False)
    idx.delete(doomed)                       # crosses 0.2 -> auto-compact
    assert idx.n_deleted == 0 and idx.n == n0 - len(doomed)
    assert idx.cap & (idx.cap - 1) == 0
    rec, fi = _live_recall(idx, q)
    assert (fi[fi >= 0] < idx.n).all()
    assert rec > 0.8
    remap = idx.last_remap
    assert remap is not None and len(remap) == n0
    assert (remap[doomed] == -1).all()
    assert (np.sort(remap[remap >= 0]) == np.arange(idx.n)).all()
    assert idx.delete(np.asarray([n0 - 1, n0, 10 ** 6])) == 0


def test_pca_drift_flags_distribution_shift(mut_index):
    idx = mut_index
    rep0 = idx.pca_drift()
    assert not rep0["refit_recommended"]
    # inserts far off the fitted manifold (full-rank uniform noise), a
    # quarter of the points as in the reference's case
    rng = np.random.default_rng(3)
    x_off = rng.uniform(0, 220, size=(500, idx.x.shape[1])) \
        .astype(np.float32)
    idx.upsert(x_off)
    rep1 = idx.pca_drift()
    assert rep1["captured_live"] < rep0["captured_live"]
    assert rep1["refit_recommended"]


def test_snapshot_restore_roundtrip(mut_index, float_fixture, tmp_path):
    idx = mut_index
    _, q, _, _ = float_fixture
    idx.upsert(make_sift_like(100, seed=8))
    idx.delete(np.arange(50), auto_compact=False)
    idx.save(tmp_path / "snap.npz")
    idx2 = MutableIndex.load(tmp_path / "snap.npz", idx.cfg, seed=2,
                             device="cpu")
    assert idx2.n == idx.n and idx2.entry == idx.entry
    assert idx2.n_deleted == idx.n_deleted
    np.testing.assert_array_equal(idx.search(q)[1].numpy(),
                                  idx2.search(q)[1].numpy())
    assert len(idx2.upsert(make_sift_like(20, seed=9))) == 20


def test_earlier_epoch_stays_frozen(mut_index, float_fixture):
    """A PackedDB held from before an upsert and a delete keeps every
    tensor unchanged: the port publishes out of place."""
    idx = mut_index
    x, q, _, _ = float_fixture
    db0 = idx.db
    tensors = lambda db: [db.low, db.high, db.deleted] + \
        [t for lay in db.layers for t in (lay.adj, lay.packed_low)]
    before = [t.clone() for t in tensors(db0)]
    fd0, fi0 = idx.search(q)
    idx.upsert(make_sift_like(100, seed=21))
    idx.delete(fi0.numpy()[:, 0], auto_compact=False)
    assert idx.db is not db0
    assert all(torch.equal(a, b) for a, b in zip(before, tensors(db0)))
    from repro_torch.core.search_torch import search_batched
    fd1, fi1 = search_batched(db0, q, filt=idx.filt, device="cpu")
    assert torch.equal(fi1, fi0) and torch.equal(fd1, fd0)


def test_snapshot_roundtrip_and_corruption(tmp_path, mut_index,
                                          float_fixture):
    _, q, _, _ = float_fixture
    idx, cfg = mut_index, mut_index.cfg
    p = tmp_path / "a.npz"
    idx.save(p)
    idx2 = MutableIndex.load(p, cfg, device="cpu")
    np.testing.assert_array_equal(idx.search(q[:8])[1].numpy(),
                                  idx2.search(q[:8])[1].numpy())
    t = tmp_path / "trunc.npz"
    t.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    with pytest.raises(SnapshotCorruptError, match="unreadable|truncated"):
        tmutable.read_snapshot(t)
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    f = tmp_path / "flip.npz"
    f.write_bytes(bytes(raw))
    with pytest.raises(SnapshotCorruptError):
        tmutable.read_snapshot(f)
    e = tmp_path / "naked.npz"
    np.savez(e, x=np.zeros(3))
    with pytest.raises(SnapshotCorruptError, match="version"):
        tmutable.read_snapshot(e)
    tmutable.write_snapshot(tmp_path / "c.npz",
                            {"a": np.arange(5, dtype=np.int64)})
    z = dict(np.load(tmp_path / "c.npz"))
    z["a"][0] = 99
    np.savez(tmp_path / "c2.npz", **z)
    with pytest.raises(SnapshotCorruptError, match="checksum"):
        tmutable.read_snapshot(tmp_path / "c2.npz")
    # the fault plan truncates a snapshot as it is written
    s = tmp_path / "ship.npz"
    with faults.inject(FaultPlan()) as plan:
        plan.add("truncate_snapshot", param=0.6)
        idx.save(s)
        assert any(k == "truncate_snapshot" for _, k, _ in plan.log)
    with pytest.raises(SnapshotCorruptError):
        MutableIndex.load(s, cfg, device="cpu")


def test_cached_graph_shared_with_reference(tmp_path):
    """``cached_graph`` names its file as the reference does (the same
    config fingerprint) and writes the same npz keys: a cache written by
    either package loads in the other, with no rebuild."""
    from repro.core import graph as rgraph
    from repro_torch.core import graph as tgraph
    x = _int_rows(np.random.default_rng(4), 200)
    cfg = _int_cfg(200)
    for c in (cfg, dataclasses.replace(cfg, low_dtype="bfloat16"),
              dataclasses.replace(cfg, wave_size=64)):
        rc = RefConfig(**dataclasses.asdict(c))
        assert tgraph._cfg_fingerprint(c) == rgraph._cfg_fingerprint(rc)
    assert tgraph.GRAPH_BUILD_VERSION == rgraph.GRAPH_BUILD_VERSION
    g = tgraph.cached_graph(x, cfg, tmp_path / "a", seed=2, builder="ref",
                            device="cpu")
    files = list((tmp_path / "a").iterdir())
    assert len(files) == 1
    rg = rgraph.cached_graph(x, RefConfig(**dataclasses.asdict(cfg)),
                             tmp_path / "a", seed=2, builder="ref")
    assert list((tmp_path / "a").iterdir()) == files   # loaded, not built
    rg2 = rgraph.cached_graph(x, RefConfig(**dataclasses.asdict(cfg)),
                              tmp_path / "b", seed=2, builder="ref")
    g2 = tgraph.cached_graph(x, cfg, tmp_path / "b", seed=2, builder="ref",
                             device="cpu")
    assert [p.name for p in (tmp_path / "b").iterdir()] == \
        [p.name for p in files]
    for h in (rg, rg2, g2):
        assert h.entry == g.entry
        np.testing.assert_array_equal(h.levels, g.levels)
        for a, b in zip(h.layers, g.layers):
            np.testing.assert_array_equal(a, b)
