"""repro_torch's stacked sharded slotted programs against the reference's.

``core.distributed.stacked_db_view`` is the reference's leaf for leaf
(views of the ``ShardedDB``'s stacks, no copy). The four sharded slot
programs run every shard's slots in ONE pass over the stacked view, as
the reference's ``jax.vmap`` over the shards does, and are held on the
exact-arithmetic fixture of tests/test_torch_scheduler.py:

* field for field to the reference's ``_slot_*_sharded_jit`` over
  ``repro.core.distributed.stacked_db_view``, in the pca, pq and none
  modes, with and without tombstones, at P = 2 and 3, including a bank
  where every slot of one shard is frozen at its budget, converged,
  while another shard's slots still progress (the reference's loop test
  sits inside the ``vmap``, so that shard runs no trip and latches
  nothing);
* field for field to the single-shard programs run shard by shard;
* the stacked plain kernels (``fused_expand_rows``, ``pq_expand_rows``,
  ``trip_fold``) bit for bit to per-shard calls, each refusing a batch
  that does not split into the P shards;
* a stacked view is not searchable: ``search_batched`` refuses it.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core import distributed as rdist
from repro.core import search_jax as sj
from repro.core.filters import IdentityFilter as RefIdentity
from repro.core.graph import HNSWGraph as RefGraph
from repro_torch.constants import INF
from repro_torch.core import distributed as tdist
from repro_torch.core import filters
from repro_torch.core import search_torch as st
from repro_torch.core.graph import build_hnsw
from repro_torch.kernels import ops, ref
from test_torch_scheduler import (N, S, _assert_state_equal,  # noqa: F401
                                  _one_torch_thread, fixture)
from test_torch_search import _int_filters


@pytest.fixture(scope="module")
def shard_graphs(fixture):
    """The port's shard graphs over the fixture's points (seed 1 + s),
    for P in {2, 3}."""
    cfg, _, x, _, _ = fixture
    return {P: [build_hnsw(x[a:b], cfg, seed=1 + s, device="cpu")
                for s, (a, b) in enumerate(tdist.shard_bounds(N, P))]
            for P in (2, 3)}


def _filters(kind):
    if kind == "none":
        return RefIdentity(dim=16), filters.IdentityFilter(dim=16)
    return _int_filters(kind)


def _sharded(fixture, shard_graphs, kind, tombs, P):
    """(reference ShardedDB, port ShardedDB, reference filter): the same
    shard graphs stacked by both packages over one filter."""
    cfg, _, x, _, dead = fixture
    rcfg = RefConfig(**dataclasses.asdict(cfg))
    graphs = shard_graphs[P]
    rgraphs = [RefGraph(cfg=rcfg, x=g.x, levels=g.levels, layers=g.layers,
                        entry=g.entry) for g in graphs]
    rfilt, tfilt = _filters(kind)
    d = dead if tombs else None
    rsdb = rdist.build_sharded(x, rcfg, rfilt, P, graphs=rgraphs, deleted=d)
    tsdb = tdist.build_sharded(x, cfg, tfilt, P, graphs=graphs, deleted=d,
                               device="cpu")
    return rsdb, tsdb, rfilt


@pytest.mark.parametrize("kind,tombs", [("pca", True), ("pq", False),
                                        ("none", True), ("cascade", False)])
def test_stacked_db_view_is_the_reference_leaf_for_leaf(
        fixture, shard_graphs, kind, tombs):
    rsdb, tsdb, _ = _sharded(fixture, shard_graphs, kind, tombs, 3)
    jv, tv = rdist.stacked_db_view(rsdb), tdist.stacked_db_view(tsdb)
    assert tv.filter_kind == jv.filter_kind == kind
    assert len(tv.layers) == len(jv.layers)
    pairs = [(t.adj, j.adj) for t, j in zip(tv.layers, jv.layers)] \
        + [(t.packed_low, j.packed_low)
           for t, j in zip(tv.layers, jv.layers)] \
        + [(tv.low, jv.low), (tv.high, jv.high)]
    for opt in ("deleted", "low2"):
        t, j = getattr(tv, opt), getattr(jv, opt)
        assert (t is None) == (j is None), opt
        if t is not None:
            pairs.append((t, j))
    for t, j in pairs:
        assert t.dim() == np.asarray(j).ndim and t.shape[0] == 3
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(np.asarray(tv.entry),
                                  np.asarray(jv.entry))
    # views of the stacks, no copy
    leaves = [*tsdb.adj, *tsdb.packed_low, tsdb.low, tsdb.high,
              tsdb.deleted, tsdb.low2]
    got = [*(l.adj for l in tv.layers), *(l.packed_low for l in tv.layers),
           tv.low, tv.high, tv.deleted, tv.low2]
    for a, b in zip(leaves, got):
        assert a is b


def _stack(states):
    return st._slot_zip(lambda *ts: torch.stack(ts), *states)


class _ShardedTwin:
    """The same sharded slotted calls on both packages over their stacked
    views, and the port's single-shard programs shard by shard; the three
    states held to each other after every call."""

    def __init__(self, rsdb, tsdb, W):
        self.jv = rdist.stacked_db_view(rsdb)
        self.tv = tdist.stacked_db_view(tsdb)
        self.tsdb, self.P, self.W = tsdb, tsdb.n_shards, W

    def bank(self, qp, ef):
        self.js = sj.make_slot_state(self.jv, S, qp, ef=ef,
                                     n_shards=self.P)
        self.ts = st.make_slot_state(self.tv, S, qp, ef=ef,
                                     n_shards=self.P)
        _assert_state_equal(self.js, self.ts, "empty bank")

    def _shard_by_shard(self, fn):
        return _stack([fn(self.tsdb.shard_db(p),
                          self.ts.map(lambda t: t[p]))
                       for p in range(self.P)])

    def _check(self, js, ts, per, what):
        _assert_state_equal(js, ts, what)
        for a, b in zip(ts.fields(), per.fields()):
            assert torch.equal(a, b), f"{what}: differs from shard by shard"
        self.js, self.ts = js, ts

    def admit(self, q, qp, ids, efe, bud, width=None, quantum=0):
        a = [np.asarray(v) for v in (q, qp, ids, efe, bud)]
        ta = [torch.from_numpy(v) for v in a]
        if width is None:
            js = sj._slot_admit_sharded_jit(self.jv, self.js,
                                            *map(jnp.asarray, a))
            ts = st._slot_admit_sharded(self.tv, self.ts, *ta)
            per = self._shard_by_shard(
                lambda d, s: st._slot_admit_impl(d, s, *ta))
        else:
            js = sj._slot_admit_step_sharded_jit(
                self.jv, self.js, *map(jnp.asarray, a), width, quantum,
                self.W)
            ts = st._slot_admit_step_sharded(self.tv, self.ts, *ta, width,
                                             quantum, self.W)
            per = self._shard_by_shard(
                lambda d, s: st._slot_admit_step_impl(
                    d, s, *ta, width=width, quantum=quantum,
                    expand_width=self.W))
        self._check(js, ts, per, f"admit width={width}")

    def step(self, quantum, width=None):
        held, before = self.ts, [t.clone() for t in self.ts.fields()]
        if width is None:
            js = sj._slot_step_sharded_jit(self.jv, self.js, quantum, self.W)
            ts = st._slot_step_sharded(self.tv, self.ts, quantum, self.W)
            per = self._shard_by_shard(lambda d, s: st._slot_step_impl(
                d, s, quantum=quantum, expand_width=self.W))
        else:
            js = sj._slot_step_prefix_sharded_jit(self.jv, self.js, width,
                                                  quantum, self.W)
            ts = st._slot_step_prefix_sharded(self.tv, self.ts, width,
                                              quantum, self.W)
            per = self._shard_by_shard(lambda d, s: st._slot_step_prefix_impl(
                d, s, width=width, quantum=quantum, expand_width=self.W))
        self._check(js, ts, per, f"step {quantum} {width}")
        assert all(torch.equal(a, b) for a, b in zip(held.fields(), before))

    def set_budget(self, bud):
        self.js = dataclasses.replace(self.js, budget=jnp.asarray(bud))
        self.ts = dataclasses.replace(self.ts, budget=torch.from_numpy(bud))


# (kind, tombstones, P): each kind with and without tombstones, at P = 2
# and 3
SHARDED_CASES = [("pca", False, 2), ("pca", True, 3), ("pq", True, 2),
                 ("pq", False, 3), ("none", True, 3), ("none", False, 2)]


@pytest.mark.parametrize("kind,tombs,P", SHARDED_CASES)
def test_sharded_slot_programs_bit_equal(fixture, shard_graphs, kind, tombs,
                                         P):
    q = fixture[3]
    rsdb, tsdb, rfilt = _sharded(fixture, shard_graphs, kind, tombs, P)
    EF = 10
    qp = np.asarray(rfilt.prepare(q), np.float32)
    tw = _ShardedTwin(rsdb, tsdb, tsdb.cfg.expand_width)
    full = lambda v: np.full(S, v, np.int32)
    # an S-wide admission (pads carry slot ids past S), mixed effective
    # ef and budgets; a quantum below the trips the bank needs, the rest
    # to the end; a frozen slot escalated and a prefix stepped; slots
    # refilled through the admit-and-step program
    tw.bank(qp, EF)
    ids = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, S, S + 5, 9] + [S] * 4,
                   np.int32)
    efe = np.array([EF, EF // 2, EF, 3, EF, EF, 4, EF, EF, EF, EF, EF]
                   + [EF] * 4, np.int32)
    bud = np.array([4, 1000, 2, 1000, 8, 1, 1000, 16, 1000, 0, 0, 6]
                   + [0] * 4, np.int32)
    tw.admit(q[:S], qp[:S], ids, efe, bud)
    tw.step(3)
    tw.step(64)
    frozen = ((~tw.ts.done) & (tw.ts.nsteps >= tw.ts.budget)).numpy()
    assert frozen[:, :10].any(), "the bank should hold frozen slots"
    tw.set_budget(np.where(frozen, 1000, tw.ts.budget.numpy())
                  .astype(np.int32))
    tw.step(3, width=8)
    tw.admit(q[S:2 * S], qp[S:2 * S],
             np.array([10, 11, 12, 13, 14, 15] + [S] * 10, np.int32),
             full(EF), full(12), width=S, quantum=3)
    tw.step(64)
    # the per-shard loop test: every slot of shard f frozen at its
    # budget while shard g's slots still progress, the last to freeze in
    # shard f frozen exactly where it converges; the reference runs no
    # trip for shard f past its last one, so those slots stay converged
    # and un-latched (one more trip would latch their done)
    tw.bank(qp, EF)
    tw.admit(q[:S], qp[:S], np.arange(S, dtype=np.int32), full(EF),
             full(1000))
    tw.step(64)
    assert bool(tw.ts.done.all())
    natural = tw.ts.nsteps.numpy()
    g = int(np.argmax(natural.max(1)))
    f = (g + 1) % P
    below = natural[f][natural[f] < natural[g].max()]
    assert below.size, "shard f has no slot converging before shard g ends"
    tw.bank(qp, EF)
    tw.admit(q[:S], qp[:S], np.arange(S, dtype=np.int32), full(EF),
             full(1000))
    bud = np.full((P, S), 1000, np.int32)
    bud[f] = np.minimum(natural[f], below.max())
    tw.set_budget(bud)
    tw.step(64)
    stuck = ((~tw.ts.done) & (tw.ts.nsteps >= tw.ts.budget)).numpy()
    assert stuck[f][natural[f] == below.max()].all(), \
        "a converged slot of the frozen shard latched"
    assert tw.ts.done.numpy()[np.arange(P) != f].all()


def _stacked_layer(rng, P, N_, M0, width, dtype):
    adj = rng.integers(0, N_, (P, N_, M0)).astype(np.int32)
    tails = rng.integers(0, M0 // 2, (P, N_))
    adj[np.arange(M0)[None, None, :] >= M0 - tails[..., None]] = -1
    if dtype == np.uint8:
        pay = rng.integers(0, 256, (P, N_, M0, width)).astype(np.uint8)
    else:
        pay = rng.integers(0, 16, (P, N_, M0, width)).astype(np.float32)
    return torch.from_numpy(adj), torch.from_numpy(pay)


def _pops(rng, B, W, N_):
    """Popped ids (some -1, row 2 a -1 pop with its gate set) and gates
    (row 0 all clear)."""
    c_w = rng.integers(-1, N_, (B, W)).astype(np.int32)
    exp = rng.random((B, W)) < 0.8
    exp[0] = False
    c_w[2, 0], exp[2, 0] = -1, True
    return torch.from_numpy(c_w), torch.from_numpy(exp)


def _split(t, P):
    return t.reshape(P, -1, *t.shape[1:])


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("P", [2, 3])
def test_stacked_plain_kernels_equal_per_shard(P, W):
    """The plain versions of the three per-trip kernels on stacked
    leaves: bit for bit the per-shard calls (row block p with shard p's
    leaves), pca on f32 and bf16 rows, pq, and the fold gated and
    ungated with per-shard tombstone words; B % P != 0 raises."""
    rng = np.random.default_rng(10 * P + W)
    Sb, N_, M0, dl, Spq, k = 8, 200, 16, 4, 4, 8
    B, kk = P * Sb, W * k
    c_w, exp = _pops(rng, B, W, N_)
    q = torch.from_numpy(rng.integers(0, 16, (B, dl)).astype(np.float32))
    th = torch.from_numpy(np.where(rng.random(B) < 0.5, 64.0 * dl, INF)
                          .astype(np.float32))
    lut = torch.from_numpy(rng.integers(0, 1 << 10, (B, Spq, 256))
                           .astype(np.float32))
    adj, low = _stacked_layer(rng, P, N_, M0, dl, np.float32)
    _, codes = _stacked_layer(rng, P, N_, M0, Spq, np.uint8)
    each = lambda t: _split(t, P)
    for pay in (low, low.to(torch.bfloat16)):
        got = ops.fused_expand_rows(adj, pay, c_w, exp, q, th, kk)
        per = [ops.fused_expand_rows(adj[p], pay[p], each(c_w)[p],
                                     each(exp)[p], each(q)[p], each(th)[p],
                                     kk) for p in range(P)]
        for g, w in zip(got, map(torch.cat, zip(*per))):
            assert torch.equal(g, w)
    got = ops.pq_expand_rows(adj, codes, c_w, exp, lut, th, kk)
    per = [ops.pq_expand_rows(adj[p], codes[p], each(c_w)[p], each(exp)[p],
                              each(lut)[p], each(th)[p], kk)
           for p in range(P)]
    for g, w in zip(got, map(torch.cat, zip(*per))):
        assert torch.equal(g, w)
    # the fold: shard p's words mark other ids than shard q's
    ef, kf = 10, 16
    cap = max(ef + W * kf, 8)
    F_d = torch.from_numpy(np.sort(rng.integers(0, 8, (B, ef)), 1)
                           .astype(np.float32))
    F_i = torch.from_numpy(rng.integers(0, N_, (B, ef)).astype(np.int32))
    C_d = torch.from_numpy(np.sort(rng.integers(0, 8, (B, cap)), 1)
                           .astype(np.float32))
    C_i = torch.from_numpy(rng.integers(0, N_, (B, cap)).astype(np.int32))
    Cp = torch.from_numpy(np.sort(rng.integers(0, 8, (B, kf)), 1)
                          .astype(np.float32))
    dh = torch.from_numpy(rng.integers(0, 8, (B, W * kf)).astype(np.float32))
    cand = torch.from_numpy(rng.integers(-1, N_, (B, W * kf))
                            .astype(np.int32))
    kv = torch.from_numpy(rng.integers(0, 8, (B, W * kf)).astype(np.float32))
    words = torch.from_numpy(np.stack([st.pack_bitmap(rng.random(N_) < 0.3)
                                       for _ in range(P)]))
    ef_eff = torch.from_numpy(rng.integers(1, ef + 1, B).astype(np.int32))
    pop = torch.from_numpy(rng.random(B) < 0.6)
    for gates in ({}, {"ef_eff": ef_eff, "pop": pop}):
        got = ops.trip_fold(F_d, F_i, C_d, C_i, W, Cp, dh, cand, kv, words,
                            **gates)
        per = [ops.trip_fold(*(each(t)[p] for t in (F_d, F_i, C_d, C_i)),
                             W, each(Cp)[p], each(dh)[p], each(cand)[p],
                             each(kv)[p], words[p],
                             **{n: each(t)[p] for n, t in gates.items()})
               for p in range(P)]
        for g, w in zip(got, map(torch.cat, zip(*per))):
            assert torch.equal(g, w)
        # the stacked words are what each row reads: one shard's words
        # for every row gives another fold
        assert any(not torch.equal(g, w) for g, w in zip(
            got, ops.trip_fold(F_d, F_i, C_d, C_i, W, Cp, dh, cand, kv,
                               words[0], **gates)))
    # a batch that does not split into the P shards
    cut = slice(0, B - 1)
    with pytest.raises(ValueError, match="shards"):
        ops.fused_expand_rows(adj, low, c_w[cut], exp[cut], q[cut], th[cut],
                              kk)
    with pytest.raises(ValueError, match="shards"):
        ops.pq_expand_rows(adj, codes, c_w[cut], exp[cut], lut[cut], th[cut],
                           kk)
    with pytest.raises(ValueError, match="shards"):
        ops.trip_fold(F_d[cut], F_i[cut], C_d[cut], C_i[cut], W, Cp[cut],
                      dh[cut], cand[cut], kv[cut], words)
    with pytest.raises(ValueError, match="shards"):
        ref.tombstone_bit(words, cand[cut])


def test_stacked_view_is_not_searchable(fixture, shard_graphs):
    q = fixture[3][:8]
    _, tsdb, _ = _sharded(fixture, shard_graphs, "pca", True, 2)
    tv = tdist.stacked_db_view(tsdb)
    filt = _filters("pca")[1]
    with pytest.raises(ValueError, match="stacked"):
        st.search_batched(tv, q, filt=filt, device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        st.search_layer_batched(tv, 0, torch.from_numpy(q),
                                filt.prepare_torch(torch.from_numpy(q)),
                                None, None, ef=10, k=4)
    # and the sharded programs take nothing but a stacked view
    state = st.make_slot_state(tsdb, S, q, ef=10, n_shards=2)
    with pytest.raises(TypeError, match="stacked"):
        st._slot_step_sharded(tsdb, state, 4, 1)
    with pytest.raises(TypeError, match="stacked"):
        st._slot_step_sharded(tsdb.shard_db(0), state, 4, 1)
