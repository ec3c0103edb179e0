"""repro_torch's sharded search against ``repro.core.distributed``.

Both packages stack the very same shard graphs (built once by the port,
handed to the reference as its ``HNSWGraph``) over one shared filter.
On the exact-arithmetic fixture (small-integer vectors, a
coordinate-selecting 'PCA' and integer PQ centroids, so every f32 sum is
exact in any order and ties are plentiful) ``shard_search_host`` is
bit-equal to the reference in ids, dists and the coverage stats, in
every filter and re-rank mode, for P in {1, 3, 4} (splits with
``n % P != 0``), with and without tombstones and with dead shards. The
merge and the promote stage are held against the reference's functions
on seeded tie-rich draws; the resilient path (``probe_shard`` +
``merge_surviving``) against ``shard_search_host``, and the port's
``FaultPlan`` against the reference's. On the 4k float fixture recall@10
stays within 0.02 of the reference's sharded search."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core import distributed as rdist
from repro.core.filters import IdentityFilter as RefIdentity
from repro.core.graph import HNSWGraph as RefGraph
from repro.distributed import faults as rfaults
from repro_torch.configs.base import PHNSWConfig
from repro_torch.constants import INF
from repro_torch.core import distributed as tdist
from repro_torch.core import filters
from repro_torch.core.graph import build_hnsw
from repro_torch.core.search_torch import search_batched
from repro_torch.distributed import faults as tfaults
from test_torch_search import _int_filters, port_cfg

N_INT = 601                    # 601 % 3 == 601 % 4 == 1


@pytest.fixture(scope="module")
def int_shards():
    """601 integer vectors in [0, 8)^16, integer queries, 1% of the
    points tombstoned plus every query's exact nearest neighbor, and
    the port's shard graphs (seed 1 + s) for P in {1, 3, 4}."""
    rng = np.random.default_rng(2024)
    x = rng.integers(0, 8, (N_INT, 16)).astype(np.float32)
    q = rng.integers(0, 8, (48, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int601", n_points=N_INT, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=128)
    deleted = np.zeros(N_INT, bool)
    deleted[rng.choice(N_INT, N_INT // 100, replace=False)] = True
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    deleted[np.argmin(d2, 1)] = True
    graphs = {P: [build_hnsw(x[a:b], cfg, seed=1 + s, device="cpu")
                  for s, (a, b) in enumerate(tdist.shard_bounds(N_INT, P))]
              for P in (1, 3, 4)}
    return cfg, x, q, deleted, graphs


def _ref_graphs(cfg, graphs):
    rcfg = RefConfig(**dataclasses.asdict(cfg))
    return rcfg, [RefGraph(cfg=rcfg, x=g.x, levels=g.levels,
                           layers=g.layers, entry=g.entry) for g in graphs]


def _filters(kind):
    if kind == "none":
        return RefIdentity(dim=16), filters.IdentityFilter(dim=16)
    return _int_filters(kind)


def _both_sharded(int_shards, P, kind, tombs):
    cfg, x, q, deleted, graphs = int_shards
    rfilt, tfilt = _filters(kind)
    rcfg, rgraphs = _ref_graphs(cfg, graphs[P])
    d = deleted if tombs else None
    rsdb = rdist.build_sharded(x, rcfg, rfilt, P, graphs=rgraphs, deleted=d)
    tsdb = tdist.build_sharded(x, cfg, tfilt, P, graphs=graphs[P],
                               deleted=d, device="cpu")
    return rsdb, tsdb, rfilt, tfilt


def _ref_arrays(sdb) -> dict:
    opt = lambda a: None if a is None else np.asarray(a)
    return {"adj": [np.asarray(a) for a in sdb.adj],
            "packed_low": [np.asarray(p) for p in sdb.packed_low],
            "low": np.asarray(sdb.low), "high": np.asarray(sdb.high),
            "entries": np.asarray(sdb.entries),
            "offsets": np.asarray(sdb.offsets),
            "counts": np.asarray(sdb.counts),
            "deleted": opt(sdb.deleted), "low2": opt(sdb.low2),
            "filter_kind": sdb.filter_kind}


def _assert_stats_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        if key == "live_mask":
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        else:
            assert got[key] == want[key], key
            assert type(got[key]) is type(want[key]), key


# (filter kind, deferred, rerank_mult) per mode; promote_mult is the
# config's 6
MODES = {"pca": ("pca", False, None), "pq": ("pq", False, None),
         "pca-deferred": ("pca", True, 3), "pq-deferred": ("pq", True, 3),
         "cascade-deferred": ("cascade", True, 2),
         "none": ("none", False, None)}
# every mode with tombstones at P=3 and without at P=4 (both splits
# leave a remainder), and two modes at P=1
CASES = ([(3, m, True) for m in MODES] + [(4, m, False) for m in MODES]
         + [(1, "pca", True), (1, "cascade-deferred", False)])


@pytest.mark.parametrize("P,mode,tombs", CASES)
def test_shard_search_host_bit_equal(int_shards, P, mode, tombs):
    """ids, dists and coverage stats bit-equal to the reference with
    every shard live, one shard dead and all but one dead; the stacked
    arrays equal the reference's, and ``from_reference`` carries them."""
    kind, deferred, rm = MODES[mode]
    cfg, x, q, deleted, _ = int_shards
    rsdb, tsdb, rfilt, tfilt = _both_sharded(int_shards, P, kind, tombs)
    want = _ref_arrays(rsdb)
    back = tdist.from_reference(want, cfg, device="cpu")
    for own in (tsdb, back):
        for key in ("entries", "offsets", "counts"):
            np.testing.assert_array_equal(getattr(own, key), want[key])
        for a, b in zip(own.adj + own.packed_low + [own.low, own.high],
                        want["adj"] + want["packed_low"]
                        + [want["low"], want["high"]]):
            np.testing.assert_array_equal(a.numpy(), b)
        for key in ("deleted", "low2"):
            t = getattr(own, key)
            assert (t is None) == (want[key] is None)
            if t is not None:
                np.testing.assert_array_equal(t.numpy(), want[key])
        assert own.filter_kind == rsdb.filter_kind
    masks = [None]
    if P > 1:
        one_dead = np.ones(P, bool)
        one_dead[1] = False
        masks += [one_dead, np.arange(P) == P - 1]
    for live in masks:
        jd, ji, js = rdist.shard_search_host(
            rsdb, jnp.asarray(q), filt=rfilt, deferred=deferred,
            rerank_mult=rm, live=live, return_stats=True)
        td, ti, ts = tdist.shard_search_host(
            tsdb, q, filt=tfilt, deferred=deferred, rerank_mult=rm,
            live=live, return_stats=True, device="cpu")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        _assert_stats_equal(ts, js)
        if tombs:
            got = ti.numpy()
            assert not deleted[got[got >= 0]].any()
        if live is not None:
            for s in np.nonzero(~live)[0]:
                a, n = int(tsdb.offsets[s]), int(tsdb.counts[s])
                got = ti.numpy()
                assert not ((got >= a) & (got < a + n)).any()
            # degraded == searching the survivors only
            sd, si = tdist.shard_search_host(
                tsdb.select(np.nonzero(live)[0]), q, filt=tfilt,
                deferred=deferred, rerank_mult=rm, device="cpu")
            assert torch.equal(si, ti) and torch.equal(sd, td)


@pytest.mark.parametrize("mode", ["pca", "pca-deferred"])
def test_bf16_shard_search_host_bit_equal(int_shards, mode):
    """low_dtype="bfloat16" at P = 4: the stacked bf16 payloads carry the
    reference's bits (built by the port and carried over by
    ``from_reference``), and ``shard_search_host`` is bit-equal to
    ``repro.core.distributed``'s in ids, dists and the coverage stats,
    with every shard live and with one shard dead."""
    kind, deferred, rm = MODES[mode]
    cfg, x, q, deleted, graphs = int_shards
    cfg = dataclasses.replace(cfg, low_dtype="bfloat16")
    gs = [dataclasses.replace(g, cfg=cfg) for g in graphs[4]]
    rfilt, tfilt = _filters(kind)
    rcfg, rgraphs = _ref_graphs(cfg, gs)
    rsdb = rdist.build_sharded(x, rcfg, rfilt, 4, graphs=rgraphs,
                               deleted=deleted)
    tsdb = tdist.build_sharded(x, cfg, tfilt, 4, graphs=gs, deleted=deleted,
                               device="cpu")
    want = _ref_arrays(rsdb)
    back = tdist.from_reference(want, cfg, device="cpu")
    for own in (tsdb, back):
        for a, b in zip(own.packed_low + [own.low], want["packed_low"]
                        + [want["low"]]):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16))
    one_dead = np.ones(4, bool)
    one_dead[2] = False
    for live in (None, one_dead):
        jd, ji, js = rdist.shard_search_host(
            rsdb, jnp.asarray(q), filt=rfilt, deferred=deferred,
            rerank_mult=rm, live=live, return_stats=True)
        for sdb in (tsdb, back):
            td, ti, ts = tdist.shard_search_host(
                sdb, q, filt=tfilt, deferred=deferred, rerank_mult=rm,
                live=live, return_stats=True, device="cpu")
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            _assert_stats_equal(ts, js)


@pytest.mark.parametrize("mode", list(MODES))
def test_one_shard_equals_search_batched(int_shards, mode):
    """P=1: the merge is the identity and the global promote / re-rank
    are the single-shard ones, so the sharded search returns
    ``search_batched``'s bits (tombstones included)."""
    kind, deferred, rm = MODES[mode]
    cfg, x, q, deleted, graphs = int_shards
    _, tfilt = _filters(kind)
    sdb = tdist.build_sharded(x, cfg, tfilt, 1, graphs=graphs[1],
                              deleted=deleted, device="cpu")
    db = sdb.shard_db(0)
    fd, fi, st = search_batched(db, q, filt=tfilt, deferred=deferred,
                                rerank_mult=rm, return_stats=True,
                                device="cpu")
    sd, si, ss = tdist.shard_search_host(sdb, q, filt=tfilt,
                                         deferred=deferred, rerank_mult=rm,
                                         return_stats=True, device="cpu")
    assert torch.equal(si, fi) and torch.equal(sd, fd)
    assert ss["coverage"] == 1.0 and not ss["degraded"]
    assert ss["total_live"] == N_INT - int(deleted.sum())
    # the shard's views alias the stacks (no copy)
    assert db.high.data_ptr() == sdb.high.data_ptr()


def test_shard_bounds_and_live_counts():
    for n, P in [(601, 3), (601, 4), (10, 4), (8, 1), (5, 5)]:
        want = rdist.shard_bounds(n, P)
        assert tdist.shard_bounds(n, P) == want
        assert want[-1][1] == n


# ------------------- merge and promote on tie-rich draws -------------------

def _tie_lists(rng, P, B, E):
    """Per-shard ascending lists from a tie-rich pool (INF included),
    ids in each shard's range of 100 (-1 where INF)."""
    pool = np.asarray([0.0, -0.0, 1.0, 1.0, 2.0, 2.5, INF], np.float32)
    fd = np.sort(rng.choice(pool, (P, B, E)), axis=2).astype(np.float32)
    ids = np.arange(E, dtype=np.int32)[None, None, :] \
        + 100 * np.arange(P, dtype=np.int32)[:, None, None]
    fi = np.where(fd < INF, ids, -1).astype(np.int32)
    if B > 1:
        fd[:, 1], fi[:, 1] = INF, -1              # an all-INF row
    return fd, fi


@pytest.mark.parametrize("P,E,k", [(1, 4, 4), (2, 5, 3), (3, 10, 10),
                                   (4, 10, 10), (4, 30, 30), (4, 60, 60),
                                   (5, 7, 1), (3, 12, 36)])
def test_merge_lists_matches_reference(P, E, k):
    rng = np.random.default_rng(P * 100 + E * 10 + k)
    fd, fi = _tie_lists(rng, P, 6, E)
    md, mi = tdist._merge_lists(torch.from_numpy(fd), torch.from_numpy(fi),
                                k)
    jd, ji = rdist._merge_lists(jnp.asarray(fd), jnp.asarray(fi), k)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(md.numpy(), np.asarray(jd))
    assert (np.diff(md.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("E,n_keep", [(2, 1), (6, 6), (12, 4), (60, 20),
                                      (36, 30)])
def test_global_promote_and_rerank_match_reference(E, n_keep):
    rng = np.random.default_rng(E * 10 + n_keep)
    pool = np.asarray([0.0, 1.0, 1.0, 2.0, 3.5], np.float32)
    dm = rng.choice(pool, (5, E)).astype(np.float32)
    mask = rng.random((5, E)) < 0.7
    mask[0] = False                                # an all-pad row
    ids = np.where(mask, np.arange(E, dtype=np.int32) + 100, -1) \
        .astype(np.int32)
    for fn, args in ((tdist._global_promote, (ids, dm, n_keep)),
                     (tdist._global_rerank, (dm, ids, dm, n_keep))):
        got = fn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                   for a in args])
        want = getattr(rdist, fn.__name__)(
            *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------- resilient path ------------------------------

@pytest.mark.parametrize("mode", ["pca", "pca-deferred",
                                  "cascade-deferred"])
def test_probe_and_merge_equal_shard_search(int_shards, mode):
    """Per-shard ``probe_shard`` + answered-mask ``merge_surviving``
    reassemble the bits of ``shard_search_host`` for the full mask and a
    degraded one, and the reference's ``merge_surviving`` agrees on the
    same probed lists."""
    kind, deferred, rm = MODES[mode]
    cfg, x, q, deleted, _ = int_shards
    rsdb, tsdb, rfilt, tfilt = _both_sharded(int_shards, 3, kind, True)
    qp = tfilt.prepare_torch(torch.from_numpy(q))
    outs = [tdist.probe_shard(tsdb, s, q, qp, deferred=deferred,
                              rerank_mult=rm) for s in range(3)]
    assert all(w > 0 for _, _, w in outs)
    assert all(tdist.check_shard_result(fd, gi, int(tsdb.offsets[s]),
                                        int(tsdb.counts[s]))
               for s, (fd, gi, _) in enumerate(outs))
    fd_all = np.stack([o[0] for o in outs])
    gi_all = np.stack([o[1] for o in outs])
    for mask in (np.ones(3, bool), np.array([True, False, True])):
        md, mi = tdist.merge_surviving(tsdb, fd_all, gi_all, mask, q,
                                       qprep=qp, deferred=deferred,
                                       rerank_mult=rm)
        sd, si = tdist.shard_search_host(tsdb, q, filt=tfilt,
                                         deferred=deferred, rerank_mult=rm,
                                         live=mask, device="cpu")
        assert torch.equal(mi, si) and torch.equal(md, sd)
        jd, ji = rdist.merge_surviving(
            rsdb, fd_all, gi_all, mask, jnp.asarray(q),
            qprep=jnp.asarray(qp.numpy()), deferred=deferred,
            rerank_mult=rm)
        np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(md.numpy(), np.asarray(jd))


def test_fault_plan_kill_stall_corrupt_match_reference(int_shards):
    """Under each package's ``FaultPlan`` (kill shard 2, stall shard 0,
    corrupt shard 1) the port's ``probe_shard`` raises the same errors
    and leaves the same ``plan.log`` as the reference's; the corrupt
    answer fails ``check_shard_result`` on both sides, and the merge
    over the survivors equals the live-masked search."""
    cfg, x, q, deleted, _ = int_shards
    rsdb, tsdb, rfilt, tfilt = _both_sharded(int_shards, 3, "pca", False)
    qp = q[:, :4].copy()
    logs, verdicts = {}, {}
    for name, mod, sdb, qq, qpp in (
            ("ref", rfaults, rsdb, jnp.asarray(q), jnp.asarray(qp)),
            ("port", tfaults, tsdb, q, qp)):
        probe = rdist.probe_shard if name == "ref" else tdist.probe_shard
        check = rdist.check_shard_result if name == "ref" \
            else tdist.check_shard_result
        plan = mod.FaultPlan(seed=3)
        plan.add("kill_shard", 2)
        plan.add("stall_shard", 0, param=0.001)
        plan.add("corrupt_shard", 1)
        with mod.inject(plan):
            assert mod.active() is plan
            got = {}
            for s in range(3):
                try:
                    got[s] = probe(sdb, s, qq, qpp)
                except mod.ShardKilledError as e:
                    got[s] = e
                plan.tick()
        assert mod.active() is None
        assert isinstance(got[2], mod.ShardFaultError)
        verdicts[name] = [check(got[s][0], got[s][1], int(sdb.offsets[s]),
                                int(sdb.counts[s])) for s in (0, 1)]
        logs[name] = list(plan.log)
        if name == "port":
            live = np.array([True, False, False])
            fd_all = np.stack([got[0][0], got[0][0], got[0][0]])
            gi_all = np.stack([got[0][1], got[0][1], got[0][1]])
            md, mi = tdist.merge_surviving(sdb, fd_all, gi_all, live, q)
            sd, si = tdist.shard_search_host(sdb, q, qp, live=live,
                                             device="cpu")
            assert torch.equal(mi, si) and torch.equal(md, sd)
    assert logs["port"] == logs["ref"] == [
        (0, "stall_shard", 0), (1, "corrupt_shard", 1), (2, "kill_shard", 2)]
    assert verdicts["port"] == verdicts["ref"] == [True, False]


def test_fault_plan_windows_and_chaos_match_reference():
    """Event windows, heal and the seeded ``chaos`` script are the
    reference's, event for event."""
    for mod in (rfaults, tfaults):
        plan = mod.FaultPlan(seed=7)
        plan.add("kill_shard", 1, at=3, until=5)
        assert not plan.is_active("kill_shard", 1)
        plan.tick(3)
        assert plan.is_active("kill_shard", 1)
        assert not plan.is_active("kill_shard", 0)
        plan.tick(2)
        assert not plan.is_active("kill_shard", 1)
        assert plan.heal("kill_shard") == 1
        with pytest.raises(AssertionError):
            plan.add("melt_shard", 0)
    ev = lambda p: [(e.kind, e.target, e.param, e.at, e.until)
                    for e in p.events]
    for seed in (0, 3, 11):
        assert ev(tfaults.FaultPlan.chaos(4, seed=seed, n_events=6)) == \
            ev(rfaults.FaultPlan.chaos(4, seed=seed, n_events=6))


def test_check_shard_result_rejects_garbage():
    good_d = np.array([[0.0, 1.0, INF, INF]], np.float32)
    good_i = np.array([[100, 105, -1, -1]], np.int32)
    bad_nan = good_d.copy()
    bad_nan[0, 0] = np.nan
    bad_neg = good_d.copy()
    bad_neg[0, 0] = -1.0
    bad_ord = np.array([[1.0, 0.5, INF, INF]], np.float32)
    alien_lo, alien_hi = good_i.copy(), good_i.copy()
    alien_lo[0, 0], alien_hi[0, 0] = 99, 110
    for d, i in [(good_d, good_i), (bad_nan, good_i), (bad_neg, good_i),
                 (bad_ord, good_i), (good_d, alien_lo),
                 (good_d, alien_hi)]:
        assert tdist.check_shard_result(d, i, 100, 10) == \
            rdist.check_shard_result(d, i, 100, 10)
    assert tdist.check_shard_result(good_d, good_i, 100, 10)


def test_bad_arguments_raise(int_shards):
    cfg, x, q, deleted, graphs = int_shards
    _, tpca = _filters("pca")
    _, tpq = _filters("pq")
    sdb = tdist.build_sharded(x, cfg, tpca, 3, graphs=graphs[3],
                              device="cpu")
    with pytest.raises(ValueError, match="filter mismatch"):
        tdist.shard_search_host(sdb, q, filt=tpq, device="cpu")
    with pytest.raises(ValueError, match="live mask"):
        tdist.shard_search_host(sdb, q, filt=tpca, live=[True, False],
                                device="cpu")
    with pytest.raises(ValueError, match="lives on cpu"):
        tdist.shard_search_host(sdb, q, filt=tpca)
    _, tcas = _filters("cascade")
    csdb = tdist.build_sharded(x, cfg, tcas, 3, graphs=graphs[3],
                               device="cpu")
    with pytest.raises(ValueError, match="needs qprep"):
        tdist.merge_surviving(csdb, np.zeros((3, 2, 60), np.float32),
                              np.zeros((3, 2, 60), np.int32),
                              np.ones(3, bool), q[:2], deferred=True)


# ------------------------------ float fixture ------------------------------

def test_recall_parity_with_reference_sharded(small_dataset, small_graph,
                                              small_pca):
    """The 4k float fixture over 3 shards: recall@10 of the port's
    sharded search within 0.02 of the reference's on the same shard
    graphs (the bar of tests/test_core.py's parity test)."""
    from repro.core.search_ref import recall_at
    x, q, gt = small_dataset
    cfg = port_cfg(small_graph.cfg)
    graphs = [build_hnsw(x[a:b], cfg, seed=s, device="cpu")
              for s, (a, b) in enumerate(tdist.shard_bounds(len(x), 3))]
    _, rgraphs = _ref_graphs(cfg, graphs)
    rsdb = rdist.build_sharded(x, small_graph.cfg, small_pca, 3,
                               graphs=rgraphs)
    qp = small_pca.transform(q).astype(np.float32)
    _, ji = rdist.shard_search_host(rsdb, jnp.asarray(q), jnp.asarray(qp))
    pca = filters.from_reference("pca", {
        "mean": small_pca.mean, "components": small_pca.components,
        "explained": small_pca.explained})
    tsdb = tdist.build_sharded(x, cfg, pca, 3, graphs=graphs, device="cpu")
    _, ti = tdist.shard_search_host(tsdb, q, filt=pca, device="cpu")
    ji, ti = np.asarray(ji), ti.numpy()
    r_ref = np.mean([recall_at(ji[i], gt[i], 10) for i in range(len(q))])
    r_port = np.mean([recall_at(ti[i], gt[i], 10) for i in range(len(q))])
    assert abs(r_port - r_ref) <= 0.02, (r_port, r_ref)
    assert r_port >= 0.9
