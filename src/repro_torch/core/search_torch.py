"""Batched fixed-shape pHNSW search in PyTorch (port of
``repro/core/search_jax.py``, the query path).

B queries run Algorithm 1 together, as in the reference:

  * packed layout (3) as a device tensor ``packed_low[N, M, dl]`` — one
    row gather per expansion fetches indices and all neighbor low-dim
    vectors;
  * the fused expand kernel (``ops.fused_expand``): Dist.L, the
    adjacency/active mask, the C_pca threshold and kSort.L in one launch;
  * sorted frontiers: C (candidates), F (finals) and C_pca stay
    ascending, so the pop is slot 0 and every per-step fold is an
    O(ef+k) sorted merge (``ops.merge_topk_sorted``);
  * fixed-capacity buffers with masked updates and a per-query visited
    BITMAP (one bit per node in int32 words, bit 31 included);
  * per-query ``done`` flags latched in the loop state. A latched query
    expands nothing, so its F, ``nsteps`` and ``dhe`` stop changing: the
    loop runs at most ``ceil(steps / W)`` trips and tests ``done.all()``
    on the host only every ``DONE_CHECK_EVERY`` trips, with results
    bit-identical to an exit at the first all-done trip.

This slice covers the "pca" and "none" filter kinds at float32 low
storage with per-step re-ranking and no tombstones. Everything else
raises ``NotImplementedError`` naming its ROADMAP.md item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import PHNSWConfig
from repro_torch.constants import INF, VALID_MAX
from repro_torch.core.graph import HNSWGraph
from repro_torch.kernels import ops

# host check of done.all() every this many loop trips (a device->host
# sync); extra trips after every query latched are exact no-ops
DONE_CHECK_EVERY = 8


def _todo(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})")


@dataclass
class PackedLayer:
    adj: torch.Tensor          # [N, M] int32, -1 padded
    packed_low: torch.Tensor   # [N, M, dl] neighbor low-dim data, inline


@dataclass
class PackedDB:
    """Device-resident database in the paper's layout (3).

    ``filter_kind`` is "pca" (dense low-dim rows in ``low`` and inline in
    every ``packed_low``) or "none" (zero-width payload: every neighbor
    goes straight to Dist.H). The reference's tombstone bitmap
    (``deleted``) and cascade side-car (``low2``) are not ported yet."""
    layers: List[PackedLayer]
    low: torch.Tensor          # [N, P] filter payload rows (P may be 0)
    high: torch.Tensor         # [N, D]
    entry: int
    cfg: PHNSWConfig
    filter_kind: str = "pca"

    @property
    def device(self) -> torch.device:
        return self.high.device

    @property
    def bytes_layout3(self) -> int:
        """Stored bytes under the paper's layout (3): per RESIDENT node
        per layer, the neighbor list with inline low-dim vectors
        (non-padded entries), plus the high-dim table."""
        dl = self.low.shape[1]
        low_bytes = self.low.element_size()
        extra = 0
        for l in self.layers:
            nnz = int((l.adj >= 0).sum())
            extra += nnz * (4 + dl * low_bytes)
        return extra + self.high.numel() * 4

    @property
    def bytes_layout4(self) -> int:
        idx = sum(int((l.adj >= 0).sum()) * 4 for l in self.layers)
        return idx + self.low.numel() * self.low.element_size() \
            + self.high.numel() * 4


def _check_slice(filter_kind: str, low_dtype: str) -> None:
    if filter_kind not in ("pca", "none"):
        raise _todo(f"filter kind {filter_kind!r}", "A3")
    if low_dtype != "float32":
        raise _todo(f"low_dtype={low_dtype}", "A3")


def build_packed(g: HNSWGraph, x_low: np.ndarray, *,
                 low_dtype: Optional[str] = None,
                 device="cuda") -> PackedDB:
    """Pack a graph into layout (3) on ``device`` for the PCA filter.
    ``x_low`` is the payload ([N, dl] rows); ``low_dtype`` (default
    ``g.cfg.low_dtype``) must be float32 in this slice. All-padding top
    layers are dropped (the level assignment rarely reaches
    ``cfg.n_layers``). The neighbor-payload gather runs on ``device``."""
    _check_slice("pca", low_dtype or g.cfg.low_dtype)
    adjs = list(g.layers)
    while len(adjs) > 1 and not (adjs[-1] >= 0).any():
        adjs.pop()
    low = torch.as_tensor(np.asarray(x_low, np.float32), device=device)
    layers = []
    for adj in adjs:
        a = torch.as_tensor(np.asarray(adj, np.int32), device=device)
        packed = low[a.clamp(min=0).long()]                 # [N, M, P]
        packed[a < 0] = 0
        layers.append(PackedLayer(adj=a, packed_low=packed))
    high = torch.as_tensor(np.asarray(g.x, np.float32), device=device)
    return PackedDB(layers=layers, low=low, high=high, entry=int(g.entry),
                    cfg=g.cfg)


def from_reference(db_np: dict, cfg: PHNSWConfig, *,
                   device="cuda") -> PackedDB:
    """The port's PackedDB from a reference ``PackedDB``'s arrays given as
    numpy: ``{"adj": [..], "packed_low": [..], "low", "high", "entry",
    "filter_kind"}`` — so both engines search the very same state. This
    is how an identity-filter ("none") db is made in this slice."""
    _check_slice(db_np["filter_kind"], str(np.asarray(db_np["low"]).dtype))
    t = lambda a: torch.tensor(np.asarray(a), device=device)  # a copy
    layers = [PackedLayer(adj=t(a).to(torch.int32), packed_low=t(p))
              for a, p in zip(db_np["adj"], db_np["packed_low"])]
    return PackedDB(layers=layers, low=t(db_np["low"]),
                    high=t(db_np["high"]), entry=int(db_np["entry"]),
                    cfg=cfg, filter_kind=db_np["filter_kind"])


def _rank_sort_with_payload(d, p):
    """Stable ascending sort of each row of d (ties -> lower slot), the
    int payload p carried along: the same (dist, slot) order as the
    reference's comparison-matrix rank sort."""
    sd, order = torch.sort(d, dim=1, stable=True)
    return sd, torch.gather(p, 1, order)


def _bits(ids):
    """Word index (int64, for gather/scatter) and int32 bit mask of each
    id in the visited bitmap; ``1 << 31`` is -2**31 in int32, as in the
    reference."""
    safe = ids.clamp(min=0)
    return (safe // 32).long(), torch.ones_like(safe) << (safe % 32)


def _layer_init(db: PackedDB, start_d, start_i, *, ef: int, k: int,
                CAP: int):
    """The fixed-capacity SORTED layer state seeded from a start set:
    (C_d, C_i, F_d, F_i, V, Cp)."""
    B, E = start_d.shape
    N = db.high.shape[0]
    dev = start_d.device
    C_d = torch.cat([start_d, start_d.new_full((B, CAP - E), INF)], 1)
    C_i = torch.cat([start_i, start_i.new_full((B, CAP - E), -1)], 1)
    F_d, F_i = C_d[:, :ef].contiguous(), C_i[:, :ef].contiguous()
    # visited bitmap: one bit per node in int32 words; the insert is a
    # scatter-add of disjoint bit masks (== bitwise or)
    V = torch.zeros((B, -(-N // 32)), dtype=torch.int32, device=dev)
    w, m = _bits(start_i)
    V.scatter_add_(1, w, torch.where(start_i >= 0, m, 0))
    # C_pca threshold heap (k-bounded filter dists of accepted candidates,
    # ascending; Cp[:, -1] is the filter threshold f_pca)
    Cp = torch.full((B, k), INF, dtype=torch.float32, device=dev)
    return C_d, C_i, F_d, F_i, V, Cp


def _layer_body(db: PackedDB, layer: int, q_high, qprep, *, ef: int,
                k: int, W: int, steps: int):
    """The ONE-expansion-iteration body over the layer state
    ``(C_d, C_i, F_d, F_i, V, Cp, done, nsteps, dhe)``. The visited
    bitmap V is updated in place."""
    B = q_high.shape[0]
    lay = db.layers[layer]
    M = lay.adj.shape[1]
    fkind = db.filter_kind
    kk = W * M if fkind == "none" else W * k
    dev = q_high.device
    lane = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    jj = torch.arange(kk, device=dev)
    later = (jj[:, None] > jj[None, :])[None]              # [1, kk, kk]
    zeros_k = torch.zeros((B, k), dtype=torch.int32, device=dev)
    zeros_kk = torch.zeros((B, kk), dtype=torch.int32, device=dev)

    def body(state):
        C_d, C_i, F_d, F_i, V, Cp, done, nsteps, dhe = state
        bnd = F_d[:, -1:]
        # -- pop the W nearest candidates: slots 0..W-1 of sorted C --
        d_w, c_w = C_d[:, :W], C_i[:, :W]
        # termination is monotone, so the freeze is latched; an exhausted
        # frontier (slot 0 is the -1/INF pad) latches too (lines 7-8)
        done = done | (C_d[:, 0] > bnd[:, 0]) | (C_i[:, 0] < 0)
        exp = (d_w <= bnd) & ~done[:, None] & (nsteps[:, None] + lane < steps)
        C_d = torch.cat([C_d[:, W:], C_d.new_full((B, W), INF)], 1)
        C_i = torch.cat([C_i[:, W:], C_i.new_full((B, W), -1)], 1)
        # gated-off slots gather row 0 (cheap, discarded via the mask)
        c_safe = torch.where(exp, c_w.clamp(min=0), 0).reshape(-1)
        # -- step 2: W row gathers = paper layout (3) bursts --
        nb_i = lay.adj.index_select(0, c_safe).reshape(B, W * M)
        nb_mask = (nb_i >= 0) & exp.repeat_interleave(M, dim=1)
        if fkind == "none":
            # filter bypass: every valid neighbor is a candidate
            cand, kv, valid = nb_i, None, nb_mask
        else:
            nb_pay = lay.packed_low.index_select(0, c_safe) \
                .reshape(B, W * M, -1)
            # -- fused expand: Dist.L + mask + f_pca threshold + kSort.L --
            kv, ki = ops.fused_expand(nb_pay, qprep, nb_mask, Cp[:, -1], kk)
            cand = torch.gather(nb_i, 1, ki.long())          # [B, W*k]
            valid = (kv < VALID_MAX) & (cand >= 0)
        # -- visited check: one bit gather per candidate --
        cw, cm = _bits(cand)
        seen = (torch.gather(V, 1, cw) & cm) != 0
        if W > 1:
            # intra-iteration dedup: the W neighbor lists may overlap;
            # keep the first occurrence
            dup = ((cand[:, :, None] == cand[:, None, :]) & later
                   & valid[:, None, :]).any(-1)
            seen |= dup
        valid &= ~seen
        # -- step 3: kk irregular high-dim fetches + Dist.H --
        xh = db.high.index_select(0, cand.clamp(min=0).reshape(-1)) \
            .reshape(B, kk, -1)
        dh = torch.where(valid, ops.dist_h(xh, q_high), INF)
        dhe = dhe + valid.sum(1, dtype=torch.int32)
        # -- mark visited: disjoint bit masks (valid slots are distinct
        #    ids, so the add is a bitwise or); in place --
        V.scatter_add_(1, cw, torch.where(valid, cm, 0))
        # -- accept: d < F.max or F not full (F starts padded with INF) --
        accept = dh < bnd
        rows_d = [torch.where(accept, dh, INF)]
        rows_i = [torch.where(accept, cand, -1)]
        if fkind != "none":
            rows_d.append(torch.where(accept, kv, INF))
            rows_i.append(zeros_kk)
        s_d, s_i = _rank_sort_with_payload(torch.cat(rows_d, 0),
                                           torch.cat(rows_i, 0))
        sd, si = s_d[:B], s_i[:B]                    # C feed (dh order)
        # -- fold into the sorted frontiers: O(ef+k) sorted merges --
        F_d, F_i = ops.merge_topk_sorted(F_d, F_i, sd, si, ef)
        C_d, C_i = ops.merge_topk_sorted(C_d, C_i, sd, si, C_d.shape[1])
        if fkind != "none":
            # C_pca feed: the accepted candidates' filter dists
            Cp, _ = ops.merge_topk_sorted(Cp, zeros_k, s_d[B:], zeros_kk, k)
        nsteps = nsteps + exp.sum(1, dtype=torch.int32)
        return (C_d, C_i, F_d, F_i, V, Cp, done, nsteps, dhe)

    return body


def search_layer_batched(db: PackedDB, layer: int, q_high, qprep,
                         start_d, start_i, *, ef: int, k: int,
                         max_steps: Optional[int] = None):
    """One layer of Algorithm 1 for a batch of queries.

    ``qprep`` is the filter's per-query data (the PCA-projected query
    [B, dl] for "pca", a zero-width tensor for "none"). start_d/start_i:
    [B, E] entry candidates ascending. Each trip pops the W =
    ``cfg.expand_width`` nearest frontier candidates and expands them
    jointly.

    Returns (F_dist [B, ef], F_idx [B, ef] ascending, steps [B] int32,
    dist_h [B] int32 = per-query Dist.H evaluations in this layer)."""
    B = q_high.shape[0]
    M = db.layers[layer].adj.shape[1]
    W = db.cfg.expand_width
    kk = W * M if db.filter_kind == "none" else W * k
    CAP = max(ef + kk, 8)
    steps = max_steps or db.cfg.max_steps_for_layer(layer)
    iters = -(-steps // W)                       # expansion budget / W
    C_d, C_i, F_d, F_i, V, Cp = _layer_init(db, start_d, start_i, ef=ef,
                                            k=k, CAP=CAP)
    dev = q_high.device
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    nsteps = torch.zeros((B,), dtype=torch.int32, device=dev)
    dhe = torch.zeros((B,), dtype=torch.int32, device=dev)
    state = (C_d, C_i, F_d, F_i, V, Cp, done, nsteps, dhe)
    body = _layer_body(db, layer, q_high, qprep, ef=ef, k=k, W=W,
                       steps=steps)
    for t in range(iters):
        if t and t % DONE_CHECK_EVERY == 0 and bool(state[6].all()):
            break
        state = body(state)
    _, _, F_d, F_i, _, _, _, nsteps, dhe = state
    return F_d, F_i, nsteps, dhe


def _entry_start(db: PackedDB, queries):
    """The descent's start set: the entry point and its Dist.H, [B, 1]."""
    B = queries.shape[0]
    ep = torch.full((B, 1), int(db.entry), dtype=torch.int32,
                    device=db.device)
    ep_d = ops.dist_h(db.high.index_select(0, ep.reshape(-1))
                      .reshape(B, 1, -1), queries)
    return ep_d, ep


def _check_device(db: PackedDB, device) -> None:
    if db.device.type != torch.device(device).type:
        raise ValueError(f"db lives on {db.device}, call asked for {device}")


def probe_neighborhoods(db: PackedDB, queries, qprep, ef: int, k: int,
                        filter_deleted: bool = False,
                        ef_upper: Optional[int] = None, *, device="cuda"):
    """Neighborhood probe for a batch of to-be-inserted vectors: the
    serving traversal run at every layer with the construction beam
    (ef = ef_construction), each layer's full top-ef seeding the next.
    The device half of the wave builder (``core/build.py``).
    ``ef_upper`` narrows the beam at layers above 0. Returns
    ([L, B, ef] dists, [L, B, ef] ids), bottom layer FIRST; upper-layer
    rows are padded to ef width with INF/-1 when ``ef_upper`` trims
    them."""
    if filter_deleted:
        raise _todo("filter_deleted (tombstones)", "A3")
    _check_device(db, device)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=db.device)
    qprep = torch.as_tensor(qprep, dtype=torch.float32, device=db.device)
    B = queries.shape[0]
    ep_d, ep = _entry_start(db, queries)
    out_d, out_i = [], []
    for layer in range(len(db.layers) - 1, -1, -1):
        ef_l = ef if layer == 0 else min(ef_upper or ef, ef)
        fd, fi, _, _ = search_layer_batched(
            db, layer, queries, qprep, ep_d, ep, ef=ef_l, k=k,
            max_steps=2 * ef_l + 16)
        ep_d, ep = fd, fi
        if ef_l < ef:
            fd = torch.cat([fd, fd.new_full((B, ef - ef_l), INF)], 1)
            fi = torch.cat([fi, fi.new_full((B, ef - ef_l), -1)], 1)
        out_d.append(fd)
        out_i.append(fi)
    return torch.stack(out_d[::-1]), torch.stack(out_i[::-1])


def search_batched(db: PackedDB, queries, qprep=None, *, pca=None,
                   return_stats: bool = False,
                   deferred: bool = False,
                   rerank_mult: Optional[int] = None,
                   device="cuda"):
    """Full multi-layer pHNSW search for a batch. queries: [B, D] (numpy
    or tensor; moved to the db's device, which must be ``device``).
    Returns (dists [B, ef0], idx [B, ef0]) tensors; with
    ``return_stats=True`` also a dict with ``steps_per_layer``
    [n_layers, B] (top layer first), ``steps_total`` [B],
    ``dist_h_evals`` [B], and ``coverage``/``degraded`` (1.0/False for a
    single shard).

    ``qprep`` is the filter's per-query data; leave it None and pass
    ``pca`` for the PCA filter. The identity filter needs neither.
    ``ef0`` and the per-layer k come from ``db.cfg``. Deferred
    re-ranking (``deferred``, ``rerank_mult``) is not in this slice."""
    if deferred or rerank_mult is not None:
        raise _todo("deferred re-ranking (deferred, rerank_mult)", "A3")
    _check_device(db, device)
    queries = torch.as_tensor(queries, dtype=torch.float32,
                              device=db.device)
    if qprep is None:
        if pca is not None:
            qprep = pca.transform_torch(queries)
        elif db.filter_kind == "none":
            qprep = queries[:, :0]
        else:
            raise ValueError("qprep or pca required for the "
                             f"{db.filter_kind!r} filter")
    qprep = torch.as_tensor(qprep, dtype=torch.float32, device=db.device)
    fd, fi, steps, dhe = _search_batched_impl(db, queries, qprep)
    if return_stats:
        return fd, fi, {"steps_per_layer": steps,
                        "steps_total": steps.sum(0),
                        "dist_h_evals": dhe,
                        "coverage": 1.0, "degraded": False}
    return fd, fi


def _search_batched_impl(db: PackedDB, queries, qprep):
    """Descend the upper routing layers, then run the layer-0 beam."""
    cfg = db.cfg
    ks = cfg.k_schedule_for(db.filter_kind, False)
    k_of = lambda l: ks[min(l, len(ks) - 1)]
    ep_d, ep = _entry_start(db, queries)
    dhe = torch.ones((queries.shape[0],), dtype=torch.int32,
                     device=db.device)
    steps = []
    for layer in range(len(db.layers) - 1, 0, -1):
        ep_d, ep, st, de = search_layer_batched(
            db, layer, queries, qprep, ep_d, ep,
            ef=cfg.ef_for_layer(layer), k=k_of(layer))
        steps.append(st)
        dhe = dhe + de
    fd, fi, st, de = search_layer_batched(
        db, 0, queries, qprep, ep_d, ep, ef=cfg.ef0, k=k_of(0))
    steps.append(st)
    dhe = dhe + de
    return fd, fi, torch.stack(steps), dhe
