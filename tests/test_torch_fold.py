"""The search path's fused ops against the JAX package, and the tier plans
of every search kernel, without a card.

* ``ref.trip_fold_ref`` (the plain version of ``ops.trip_fold``: a
  trip's pop, accept test, feeds and three merges) is bit-equal to the
  JAX composition ``repro.core.search_jax._layer_body`` runs
  (``_rank_sort_with_payload`` and ``repro.kernels.ref.
  merge_topk_sorted_ref``) in every mode: with and without tombstones,
  with and without the heap's own kv row, and the filter bypass, on rows
  with planted ties, -0.0 beside 0.0, INF pads and -1 ids. The JAX
  merge sums one-hot products, which turns -0.0 into +0.0, so the
  comparison is by value (``assert_array_equal``: -0.0 == 0.0); the
  card tests hold the kernel to the plain version bit for bit.
* ``ref.pq_expand_rows_ref`` (the PQ expand with its row gathers) is
  bit-equal to the JAX expand path (``jnp.take`` of the popped rows, the
  Pallas ``pq_adc_expand`` in interpret mode or its jnp oracle, the id
  gather) on integer tables, W in {1, 2, 4, 8}, pq and cascade tables;
  ``ops.fused_expand_rows`` (the pca expand with its row gathers) is
  bit-equal to the same lines around ``fused_expand`` on integer rows.
* ``search_batched`` and the build's probe stay bit-equal to
  ``search_jax`` at W in {4, 8} on the integer fixture (W in {1, 2}:
  ``tests/test_torch_search.py``).
* The host plans (``expand_plan``, the filter and PQ expands' tiers,
  ``filter_plan`` with the pca expand's staging, ``merge_plan``,
  ``ksort_plan``, ``fold_plan``) serve every shape: a tier for each, in
  the shared memory a block may have on an H100.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core import filters as rfilters
from repro.core import search_jax
from repro.core.filters import IdentityFilter
from repro.core.graph import HNSWGraph as RefGraph
from repro.core.pca import PCA as RefPCA
from repro.core.pq import PQCodebook as RefCodebook
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.base import PHNSWConfig
from repro_torch.constants import INF
from repro_torch.core import filters, search_torch
from repro_torch.core.graph import build_hnsw
from repro_torch.kernels import _launch, ops, ref
from repro_torch.kernels import fused_filter as ff
from repro_torch.kernels import ksort_l as ks
from repro_torch.kernels import merge_sorted as ms
from repro_torch.kernels import trip_fold as tf


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several workers on the host's cores: one torch
    thread each keeps the plain CPU kernels from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["ref", "interpret"])
def jax_impl(request, monkeypatch):
    """Route the JAX ops to the jnp oracles or to the Pallas kernels in
    interpret mode (``tests/test_kernels.py``'s switch); compiled
    programs are dropped around it."""
    if request.param == "ref":
        monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
        monkeypatch.delenv("REPRO_FORCE_PALLAS_INTERPRET", raising=False)
    else:
        monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


# ------------------------------- trip fold ---------------------------------

def fold_inputs(rng, B, ef, cap, k, kk, n_ids=300):
    """A trip's state and feed, ascending frontiers, drawn from a small
    pool with -0.0 beside 0.0 (ties everywhere), INF pads with -1 ids on
    the frontiers' tails and in the feed, and edge rows: F empty (all
    INF: every finite dh is accepted), C exhausted, a feed of one value,
    a feed with nothing accepted."""
    pool = np.asarray([-0.0, 0.0, 1.0, 2.0, 2.0, 3.0, 5.0, 8.0], np.float32)

    def frontier(n):
        d = np.sort(rng.choice(pool, (B, n)), 1).astype(np.float32)
        pads = rng.integers(0, n + 1, B)
        d[np.arange(n)[None, :] >= n - pads[:, None]] = INF
        i = rng.integers(0, n_ids, (B, n)).astype(np.int32)
        i[d == INF] = -1
        return d, i

    F_d, F_i = frontier(ef)
    C_d, C_i = frontier(cap)
    Cp, _ = frontier(k)
    dh = rng.choice(np.append(pool, INF), (B, kk)).astype(np.float32)
    cand = rng.integers(0, n_ids, (B, kk)).astype(np.int32)
    cand[dh == INF] = -1
    kv = rng.choice(np.append(pool, INF), (B, kk)).astype(np.float32)
    F_d[0], F_i[0] = INF, -1
    C_d[1], C_i[1] = INF, -1
    dh[2] = 2.0
    F_d[3] = -0.0
    dh[3] = 0.0                       # ties F's bound: nothing accepted
    deleted = search_torch.pack_bitmap(rng.random(n_ids) < 0.3)
    return dict(F_d=F_d, F_i=F_i, C_d=C_d, C_i=C_i, Cp=Cp, dh=dh,
                cand=cand, kv=kv, deleted=deleted)


def jax_fold(F_d, F_i, C_d, C_i, W, Cp, dh, cand, kv, deleted):
    """The reference's lines: search_jax._layer_body from the pop to the
    three merges, with repro.kernels.ref's merge."""
    B, kk = dh.shape
    ef = F_d.shape[1]
    bnd = F_d[:, -1:]
    C_d = jnp.concatenate([C_d[:, W:], jnp.full((B, W), INF)], 1)
    C_i = jnp.concatenate([C_i[:, W:], jnp.full((B, W), -1, jnp.int32)], 1)
    accept = dh < bnd
    rows_d = [jnp.where(accept, dh, INF)]
    rows_i = [jnp.where(accept, cand, -1)]
    if deleted is not None:
        okF = accept & ~search_jax._tombstone_bit(deleted, cand)
        rows_d.insert(0, jnp.where(okF, dh, INF))
        rows_i.insert(0, jnp.where(okF, cand, -1))
    if kv is not None:
        rows_d.append(jnp.where(accept, kv, INF))
        rows_i.append(jnp.zeros((B, kk), jnp.int32))
    s_d, s_i = search_jax._rank_sort_with_payload(
        jnp.concatenate(rows_d, 0), jnp.concatenate(rows_i, 0))
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


# (ef, k, W, kk): the pca search's layer 0 (ef0 = 10, k = 16), the
# build's probe at layer 0 (ef_construction = 100, the bypass's kk = W *
# M0 = 32; k is the heap's width where a mode keeps one), and the pca
# layer 0 at W = 4
FOLD_SHAPES = {"pca": (10, 16, 1, 16), "probe": (100, 16, 1, 32),
               "pca_w4": (10, 16, 4, 64)}
# (heap, kv row, tombstones): per-step, deferred, each with tombstones,
# and the bypass (no heap) with and without
FOLD_MODES = {"per_step": (True, True, False),
              "deferred": (True, False, False),
              "per_step_tombstones": (True, True, True),
              "deferred_tombstones": (True, False, True),
              "bypass": (False, False, False),
              "bypass_tombstones": (False, False, True)}


@pytest.mark.parametrize("mode", list(FOLD_MODES))
@pytest.mark.parametrize("shape", list(FOLD_SHAPES))
def test_trip_fold_ref_bit_equal_to_the_jax_composition(shape, mode):
    ef, k, W, kk = FOLD_SHAPES[shape]
    heap, kv_row, tombs = FOLD_MODES[mode]
    cap = max(ef + kk, 8)
    rng = np.random.default_rng(ef + kk + 7 * len(mode))
    a = fold_inputs(rng, 16, ef, cap, k, kk)
    args = [a["F_d"], a["F_i"], a["C_d"], a["C_i"], W,
            a["Cp"] if heap else None, a["dh"], a["cand"],
            a["kv"] if kv_row else None, a["deleted"] if tombs else None]
    t = lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    j = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v
    got = ops.trip_fold(*map(t, args))
    plain = ref.trip_fold_ref(*map(t, args))
    want = jax_fold(*map(j, args))
    assert (got[4] is None) == (not heap) == (want[4] is None)
    for g, p, w in zip(got, plain, want):
        if w is None:
            continue
        assert g.dtype == p.dtype and torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the new frontiers stay ascending; the inputs are untouched
    for d in (got[0], got[2]) + ((got[4],) if heap else ()):
        assert bool((d[:, 1:] >= d[:, :-1]).all())
    assert np.array_equal(args[0], a["F_d"])


# ------------------------------ fused PQ expand ----------------------------

def pq_rows_inputs(rng, B, W, N=300, M0=32, S=16, cascade=False):
    """A layer (adj [N, M0] with -1 tails, codes [N, M0, S]), popped ids
    (some -1) and gates, integer tables (exact sums in any order): the
    pq filter's [B, S, 256] or the cascade's flat [B, S*256 + 4] row."""
    adj = rng.integers(0, N, (N, M0)).astype(np.int32)
    tails = rng.integers(0, M0 // 2, N)
    adj[np.arange(M0)[None, :] >= M0 - tails[:, None]] = -1
    codes = rng.integers(0, 256, (N, M0, S)).astype(np.uint8)
    c_w = rng.integers(-1, N, (B, W)).astype(np.int32)
    exp = rng.random((B, W)) < 0.8
    exp[0] = False                     # every slot gated off
    width = S * 256 + (4 if cascade else 0)
    prep = rng.integers(0, 1 << 12, (B, width)).astype(np.float32)
    th = np.where(rng.random(B) < 0.5, float(S << 11), INF) \
        .astype(np.float32)
    th[1] = 0.0
    return adj, codes, c_w, exp, prep, th


@pytest.mark.parametrize("cascade", [False, True], ids=["pq", "cascade"])
@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_pq_expand_rows_bit_equal_to_the_jax_expand(W, cascade, jax_impl):
    rng = np.random.default_rng(10 * W + cascade)
    B, M0, S, k = 8, 32, 16, 16
    adj, codes, c_w, exp, prep, th = pq_rows_inputs(rng, B, W, M0=M0, S=S,
                                                    cascade=cascade)
    kk = W * k
    # the reference's lines (search_jax._layer_body's pq branch)
    jc_safe = jnp.where(jnp.asarray(exp), jnp.maximum(jnp.asarray(c_w), 0),
                        0)
    nb_i = jnp.take(jnp.asarray(adj), jc_safe.reshape(-1), axis=0) \
        .reshape(B, -1)
    nb_mask = (nb_i >= 0) & jnp.repeat(jnp.asarray(exp), M0, axis=1)
    nb_pay = jnp.take(jnp.asarray(codes), jc_safe.reshape(-1),
                      axis=0).reshape(B, W * M0, -1)
    jlut = search_jax._cascade_lut(jnp.asarray(prep), S) if cascade \
        else jnp.asarray(prep).reshape(B, S, 256)
    jkv, jki = jops.pq_adc_expand(nb_pay, jlut, nb_mask, jnp.asarray(th),
                                  kk)
    jcand = jnp.take_along_axis(nb_i, jki, axis=1)
    tprep = torch.from_numpy(prep)
    tlut = search_torch._cascade_lut(tprep, S) if cascade \
        else tprep.reshape(B, S, 256)
    # th as the search passes it: a column view of a [B, k] heap
    heap = torch.zeros((B, 3), dtype=torch.float32)
    heap[:, -1] = torch.from_numpy(th)
    kv, cand = ops.pq_expand_rows(torch.from_numpy(adj),
                                  torch.from_numpy(codes),
                                  torch.from_numpy(c_w),
                                  torch.from_numpy(exp), tlut, heap[:, -1],
                                  kk)
    np.testing.assert_array_equal(kv.numpy(), np.asarray(jkv))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    assert cand.dtype == torch.int32
    assert bool((kv[0] == INF).all()) and bool((kv[1] == INF).all())


def test_pq_expand_rows_k_above_w_m0_raises():
    rng = np.random.default_rng(0)
    adj, codes, c_w, exp, prep, th = pq_rows_inputs(rng, 4, 2)
    t = [torch.from_numpy(a) for a in (adj, codes, c_w, exp)]
    lut = torch.from_numpy(prep).reshape(4, 16, 256)
    with pytest.raises(ValueError, match="exceeds W"):
        ops.pq_expand_rows(*t, lut, torch.from_numpy(th), 65)


# ------------------------------ fused pca expand ---------------------------

def pca_rows_inputs(rng, B, W, N=300, M0=32, dl=15):
    """A layer (adj [N, M0] with -1 tails, integer layout-(3) rows [N,
    M0, dl]: exact sums in any order), a frontier whose first W ids are
    popped (some -1), gates, integer queries and a heap whose last column
    is the threshold. Edge rows: 0 has every gate clear, 1 a threshold of
    0, 2 a -1 pop with its gate set (the reference scores node 0's
    neighbours there)."""
    adj = rng.integers(0, N, (N, M0)).astype(np.int32)
    tails = rng.integers(0, M0 // 2, N)
    adj[np.arange(M0)[None, :] >= M0 - tails[:, None]] = -1
    low = rng.integers(0, 8, (N, M0, dl)).astype(np.float32)
    C_i = rng.integers(-1, N, (B, W + 5)).astype(np.int32)
    exp = rng.random((B, W)) < 0.8
    exp[0] = False
    C_i[2, 0], exp[2, 0] = -1, True
    q = rng.integers(0, 8, (B, dl)).astype(np.float32)
    heap = np.zeros((B, 3), np.float32)
    heap[:, -1] = np.where(rng.random(B) < 0.5, 16.0 * dl, INF)
    heap[1, -1] = 0.0
    return adj, low, C_i, exp, q, heap


@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_fused_expand_rows_bit_equal_to_the_jax_expand(W, jax_impl):
    rng = np.random.default_rng(20 + W)
    B, M0, dl, k = 8, 32, 15, 16
    adj, low, C_i, exp, q, heap = pca_rows_inputs(rng, B, W, M0=M0, dl=dl)
    c_w, th, kk = C_i[:, :W], heap[:, -1], W * k
    # the reference's lines (search_jax._layer_body's pca branch)
    jc_safe = jnp.where(jnp.asarray(exp), jnp.maximum(jnp.asarray(c_w), 0),
                        0)
    nb_i = jnp.take(jnp.asarray(adj), jc_safe.reshape(-1), axis=0) \
        .reshape(B, -1)
    nb_mask = (nb_i >= 0) & jnp.repeat(jnp.asarray(exp), M0, axis=1)
    nb_pay = jnp.take(jnp.asarray(low), jc_safe.reshape(-1),
                      axis=0).reshape(B, W * M0, -1)
    jkv, jki = jops.fused_expand(nb_pay, jnp.asarray(q), nb_mask,
                                 jnp.asarray(th), kk)
    jcand = jnp.take_along_axis(nb_i, jki, axis=1)
    # c_w as a view of the wider frontier, th as the heap's column
    tC, theap = torch.from_numpy(C_i), torch.from_numpy(heap)
    kv, cand = ops.fused_expand_rows(torch.from_numpy(adj),
                                     torch.from_numpy(low), tC[:, :W],
                                     torch.from_numpy(exp),
                                     torch.from_numpy(q), theap[:, -1], kk)
    np.testing.assert_array_equal(kv.numpy(), np.asarray(jkv))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    assert cand.dtype == torch.int32
    assert bool((kv[0] == INF).all()) and bool((kv[1] == INF).all())
    # the -1 pop with its gate set scored node 0's neighbours
    live = kv[2] < INF
    assert bool(live.any())
    row0 = set(adj[0].tolist()) | set(adj[C_i[2, 1:W]].ravel().tolist())
    assert set(cand[2][live].tolist()) <= row0


def test_fused_expand_rows_k_above_w_m0_raises():
    rng = np.random.default_rng(0)
    adj, low, C_i, exp, q, heap = pca_rows_inputs(rng, 4, 2)
    t = [torch.from_numpy(a) for a in (adj, low, C_i[:, :2], exp, q)]
    with pytest.raises(ValueError, match="exceeds W"):
        ops.fused_expand_rows(*t, torch.from_numpy(heap[:, -1]), 65)


# ------------------- search and probe at W in {4, 8} -----------------------

@pytest.fixture(scope="module")
def int_fixture():
    """600 integer vectors in [0, 8)^16, their graph, integer queries
    (``tests/test_torch_search.py``'s fixture)."""
    rng = np.random.default_rng(2024)
    x = rng.integers(0, 8, (600, 16)).astype(np.float32)
    q = rng.integers(0, 8, (48, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int600", n_points=600, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=128)
    g = build_hnsw(x, cfg, seed=1, device="cpu")
    return cfg, g, x, q


def _int_filters(kind):
    arrays = {"centroids": np.random.default_rng(5).integers(
                  0, 8, (4, 256, 4)).astype(np.float32),
              "mean": np.zeros(16, np.float32),
              "components": np.eye(16, 4, dtype=np.float32),
              "explained": np.full(4, 0.25, np.float32)}
    pca = RefPCA(arrays["mean"], arrays["components"], arrays["explained"])
    cb = RefCodebook(arrays["centroids"])
    rf = {"pca": rfilters.PCAFilter(pca), "pq": rfilters.PQFilter(cb),
          "cascade": rfilters.CascadeFilter(cb, pca),
          "none": IdentityFilter(dim=16)}[kind]
    tfilt = filters.IdentityFilter(dim=16) if kind == "none" \
        else filters.from_reference(kind, arrays)
    return rf, tfilt


# (filter kind, deferred, rerank_mult, tombstones)
WIDE_MODES = {"pca": ("pca", False, None, False),
              "none": ("none", False, None, False),
              "pq": ("pq", False, None, False),
              "pca-deferred": ("pca", True, 3, False),
              "cascade-deferred": ("cascade", True, 2, False),
              "pca-tombstones": ("pca", False, None, True),
              "pq-deferred-tombstones": ("pq", True, 3, True)}


def _doomed(x, q, frac=0.05, seed=9):
    rng = np.random.default_rng(seed)
    flags = np.zeros(len(x), bool)
    flags[rng.choice(len(x), int(frac * len(x)), replace=False)] = True
    flags[np.argmin(((q[:, None] - x[None]) ** 2).sum(-1), 1)] = True
    return flags


@pytest.mark.parametrize("mode", list(WIDE_MODES))
@pytest.mark.parametrize("W", [4, 8])
def test_search_bit_equal_at_wide_expand_widths(int_fixture, W, mode):
    """W * M0 = 64 and 128 expand slots a row, W * k fold feeds: ids,
    dists, ``steps_per_layer`` and ``dist_h_evals`` bit-equal to the
    reference, with and without tombstones."""
    kind, deferred, rm, tombs = WIDE_MODES[mode]
    cfg, g, x, q = int_fixture
    cfg = dataclasses.replace(cfg, expand_width=W)
    g = dataclasses.replace(g, cfg=cfg)
    rfilt, tfilt = _int_filters(kind)
    rg = RefGraph(cfg=RefConfig(**dataclasses.asdict(cfg)), x=g.x,
                  levels=g.levels, layers=g.layers, entry=g.entry)
    jdb = search_jax.build_packed(rg, filt=rfilt)
    tdb = search_torch.build_packed(g, filt=tfilt, device="cpu")
    if tombs:
        words = search_torch.pack_bitmap(_doomed(x, q))
        jdb = dataclasses.replace(jdb, deleted=jnp.asarray(words))
        tdb = dataclasses.replace(tdb, deleted=torch.from_numpy(words))
    kw = dict(deferred=deferred, rerank_mult=rm, return_stats=True)
    jd, ji, js = search_jax.search_batched(jdb, jnp.asarray(q), filt=rfilt,
                                           **kw)
    td, ti, ts = search_torch.search_batched(tdb, q, filt=tfilt,
                                             device="cpu", **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts["steps_per_layer"].numpy(),
                                  np.asarray(js["steps_per_layer"]))
    np.testing.assert_array_equal(ts["dist_h_evals"].numpy(),
                                  np.asarray(js["dist_h_evals"]))


@pytest.mark.parametrize("W", [4, 8])
def test_probe_bit_equal_at_wide_expand_widths(int_fixture, W):
    """The build's probe (the bypass, tombstones filtered at every layer)
    at W = 4 and 8: kk = W * M0 fold feeds."""
    cfg, g, x, q = int_fixture
    cfg = dataclasses.replace(cfg, expand_width=W)
    g = dataclasses.replace(g, cfg=cfg)
    rfilt, tfilt = _int_filters("none")
    rg = RefGraph(cfg=RefConfig(**dataclasses.asdict(cfg)), x=g.x,
                  levels=g.levels, layers=g.layers, entry=g.entry)
    words = search_torch.pack_bitmap(_doomed(x, q, frac=0.1))
    jdb = dataclasses.replace(search_jax.build_packed(rg, filt=rfilt),
                              deleted=jnp.asarray(words))
    tdb = dataclasses.replace(
        search_torch.build_packed(g, filt=tfilt, device="cpu"),
        deleted=torch.from_numpy(words))
    qp = np.zeros((len(q), 0), np.float32)
    jd, ji = search_jax.probe_neighborhoods(jdb, jnp.asarray(q),
                                            jnp.asarray(qp), 24, 16,
                                            ef_upper=8)
    td, ti = search_torch.probe_neighborhoods(tdb, q, qp, 24, 16,
                                              ef_upper=8, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# ------------------------------- tier plans --------------------------------

# an H100's opt-in maximum (cudaDevAttrMaxSharedMemoryPerBlockOptin);
# on the card the plans are given the card's own figure
OPTIN = 232_448


@pytest.mark.parametrize("M", [32 * w for w in (1, 2, 4, 8)] + [160, 100,
                                                                 14_000,
                                                                 70_000])
def test_expand_plans_serve_every_width(M):
    """W in {1, 2, 4, 8} at M0 = 32, M0 = 160 at W = 1, odd widths and
    rows past shared memory: a warp tier up to 128 slots, a block tier
    above with the row in (opted-in) shared memory, global past it. The
    filter and PQ expands share these tiers."""
    plan = ff.expand_plan(M, OPTIN)
    assert plan["tier"] in ("warp", "block", "global")
    if plan["tier"] == "warp":
        assert M <= 32 * plan["per_lane"] and plan["per_lane"] in (1, 2, 4)
        assert M <= 128
    else:
        assert M > 128 and plan["per_lane"] == 0
        assert 32 <= plan["threads"] <= 1024
        assert plan["threads"] % 32 == 0
        if plan["tier"] == "block":
            assert plan["smem"] == 4 * M <= OPTIN
        else:
            assert 4 * M > OPTIN and plan["scratch"] == M


@pytest.mark.parametrize("dl", [15, 16])
@pytest.mark.parametrize("W", [1, 4, 8])
def test_filter_plan_staging_and_tiers(W, dl):
    """The pca expand at M0 = 32: a warp a row up to W = 4 (128 slots),
    a block past it; each stages its popped rows by 16-byte cp.async
    where every node's [M0, dl] block is 16-byte aligned and dl is odd
    (dl = 15 on an aligned table), else by 4-byte copies at the odd row
    stride dl | 1 (dl = 16, or a misaligned base); the staging area fits
    the default 48 KB at W <= 4 (30 KB at W = 4, dl = 15), and rows whose
    area cannot fit the card's limit are read in place."""
    M0 = 32
    for aligned in (True, False):
        plan = ff.filter_plan(W, M0, dl, aligned, OPTIN)
        assert plan["tier"] == ("warp" if W <= 4 else "block")
        assert plan["per_lane"] == (W if W <= 4 else 0)
        assert plan["staged"]
        assert plan["copy"] == (16 if aligned and dl == 15 else 4)
        assert plan["rw"] == (15 if dl == 15 else 17)
        words = ff.stage_words(W, M0, dl, plan["rw"])
        assert words % 4 == 0 and words >= dl + W * M0 * dl
        if plan["tier"] == "warp":
            assert plan["smem"] == ff.WARPS_PER_BLOCK * 4 * words
            assert plan["smem"] <= _launch.SMEM_DEFAULT
        else:
            assert plan["smem"] == 4 * (W * M0 + words) <= OPTIN
    assert ff.filter_plan(4, M0, 15, True, OPTIN)["smem"] == 30_976
    # a staging area past the card's limit is not staged: the rows are
    # read in place, the block tier keeping its distance row
    tight = ff.filter_plan(W, M0, dl, True, 4 * W * M0 + 64)
    assert not tight["staged"] and tight["copy"] == tight["rw"] == 0
    assert tight["smem"] == (0 if W <= 4 else 4 * W * M0)
    # so are four warps' areas of 128 slots of dl = 128 on an H100
    wide_dl = ff.filter_plan(4, M0, 128, True, OPTIN)
    assert wide_dl["tier"] == "warp" and not wide_dl["staged"]


@pytest.mark.parametrize("n,tier", [(42, "shared"), (12288, "shared"),
                                    (12289, "shared_optin"),
                                    (OPTIN // 4, "shared_optin"),
                                    (OPTIN // 4 + 1, "global"),
                                    (200_000, "global")])
def test_merge_and_ksort_plans_past_12288(n, tier):
    """Rows up to 12288 f32 stage in the default 48 KB, longer ones opt
    into the card's maximum, longer still run in global memory. kSort.L
    sorts rows of up to 512 values by a warp each instead (its own tier,
    ``tests/test_torch_kernel_plans.py``) and keeps these tiers past."""
    plans = [ms.merge_plan(n // 2, n - n // 2, OPTIN)]
    if n > ks.WARP_MAX:
        plans.append(ks.ksort_plan(n, OPTIN))
    else:
        assert ks.ksort_plan(n, OPTIN)["tier"] == "warp"
    for plan in plans:
        assert plan["tier"] == tier
        assert plan["staged"] == (tier != "global")
        assert plan["smem"] == (4 * n if tier != "global" else 0)
        assert plan["smem"] <= OPTIN
        assert plan["threads"] == min(1024, -(-n // 32) * 32)


def _fold_shapes():
    """(ef, cap, k, kk) over ef up to 500, W in {1, 2, 4, 8}, the pca
    and cascade heaps (k = 16, 32), the bypass (no heap, kk = W * M0)
    and a frontier past shared memory."""
    out = []
    for ef in (1, 10, 30, 60, 100, 500):
        for W in (1, 2, 4, 8):
            for k, kk in ((16, W * 16), (32, W * 32), (0, W * 32)):
                out.append((ef, max(ef + kk, 8), k, kk))
    return out + [(30_000, 30_032, 16, 32)]


def test_fold_plan_serves_every_shape():
    tiers = set()
    for ef, cap, k, kk in _fold_shapes():
        plan = tf.fold_plan(ef, cap, k, kk, OPTIN)
        n = tf.slice_words(ef, cap, k, kk)
        tiers.add(plan["tier"])
        if plan["tier"] == "warp":
            assert kk <= tf.WARP_MAX_FEED
            assert plan["smem"] == tf.WARPS_PER_BLOCK * 4 * n
            assert plan["smem"] <= _launch.SMEM_DEFAULT
        elif plan["tier"] == "block":
            assert plan["smem"] == 4 * n <= OPTIN
            assert 32 <= plan["threads"] <= 512
        else:
            assert 4 * n > OPTIN and plan["scratch"] == n
    assert tiers == {"warp", "block", "global"}
    # the main path's shapes take the warp tier: pca layer 0, the
    # deferred arms' layer 0, the probe's two layers
    for shape in ((10, 26, 16, 16), (30, 46, 16, 16), (60, 92, 32, 32),
                  (100, 132, 0, 32), (16, 32, 0, 16)):
        assert tf.fold_plan(*shape, OPTIN)["tier"] == "warp"
