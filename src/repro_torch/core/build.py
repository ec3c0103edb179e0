"""Wave-based bulk construction (port of ``repro/core/build.py``).

The pipeline, as in the reference:

  1. **Levels up front.** ``sample_levels`` draws every node's level
     before any insert (same levels and final entry point as the
     sequential builder for a seed).
  2. **Batched probe on the card.** Each wave of ``cfg.wave_size``
     vectors runs ONE beam search (``search_torch.probe_neighborhoods``
     at ``ef = ef_construction``, every layer's top-ef seeding the next)
     against the snapshot published by the previous waves, through an
     identity-filter snapshot (zero-width payload: construction is pure
     high-dim). It runs the ``merge_sorted`` and ``dist_h`` kernels.
  3. **Intra-wave block.** One brute-force [B, B] distance block
     supplies the wave-internal neighbors the snapshot cannot see.
  4. **Vectorized linking on the host.** Diversity selection (Alg. 4)
     and degree-bounded bidirectional linking over the whole wave as
     masked numpy array ops — the reference's arithmetic, unchanged, so
     the graph can be held bit-for-bit against the reference's.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import PHNSWConfig
from repro_torch.constants import INF, VALID_MAX
from repro_torch.core.graph import HNSWGraph, sample_levels


def pad_rows_pow2(rows: np.ndarray) -> np.ndarray:
    """Pad a dirty-row id list to a power-of-two length (repeating the
    last id — an idempotent re-set) so the device refreshes
    (``index_copy_``) only ever see O(log N) distinct index shapes, as
    the reference's scatters do."""
    n = max(len(rows), 1)
    b = 1
    while b < n:
        b *= 2
    return np.pad(rows, (0, b - len(rows)), mode="edge") if len(rows) \
        else np.zeros(1, np.int64)


def pairwise_sq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[n, D] x [m, D] -> [n, m] squared L2 distances (f32)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    sa = np.einsum("id,id->i", a, a)
    sb = np.einsum("id,id->i", b, b)
    d = sa[:, None] + sb[None, :] - 2.0 * (a @ b.T)
    return np.maximum(d, 0.0, out=d)


def select_heuristic_batch(x: np.ndarray, cand_d: np.ndarray,
                           cand_i: np.ndarray, m: int):
    """Malkov-Yashunin Algorithm 4 over a BATCH of nodes at once.

    ``cand_d``/``cand_i``: [B, C] per-node candidate dists/ids sorted
    ascending (INF / -1 padding). Keep a candidate only if it is closer
    to its node than to every already-selected neighbor; backfill with
    the nearest rejected when underfull — identical acceptance rule to
    the scalar ``graph._select_heuristic``, restated as C rounds of
    [B, C] masked vector ops (the greedy dependency is along C, so the
    batch dimension vectorizes cleanly).

    Float caveat: inter-candidate distances use the clamped expansion
    formula (one batched matmul), which can land an ulp below the
    oracle's direct-difference sum — EXACT ties (duplicate points)
    may therefore resolve differently than the scalar oracle (the
    strict ``<`` flips and the tied candidate is backfilled instead of
    heuristic-accepted: closest-M behavior around duplicates, a
    quality-neutral degeneracy). Duplicate-free data matches the
    oracle bit-for-bit (tests/test_build.py).

    Returns (rows [B, m] int32 — selected ids, accepted-then-backfilled
    order, -1 padded; total [B]; sel_final [B, C] bool mask over the
    candidate grid)."""
    B, C = cand_d.shape
    valid = (cand_i >= 0) & (cand_d < VALID_MAX)
    safe = np.where(cand_i >= 0, cand_i, 0)
    xc = x[safe]                                        # [B, C, D]
    sq = np.einsum("bcd,bcd->bc", xc, xc)
    d_cc = sq[:, :, None] + sq[:, None, :] \
        - 2.0 * np.matmul(xc, xc.transpose(0, 2, 1))    # [B, C, C]
    np.maximum(d_cc, 0.0, out=d_cc)     # expansion can go ulp-negative
    sel = np.zeros((B, C), bool)
    count = np.zeros(B, np.int64)
    for c in range(C):
        viol = (sel & (d_cc[:, c, :] < cand_d[:, c, None])).any(1)
        ok = valid[:, c] & ~viol & (count < m)
        sel[:, c] = ok
        count += ok
    # backfill with the nearest rejected (candidates are ascending)
    rej = valid & ~sel
    fill = rej & (np.cumsum(rej, axis=1) <= (m - count)[:, None])
    total = count + fill.sum(1)
    # row order: heuristic-accepted ascending, then backfilled ascending
    cols = np.arange(C)[None, :]
    key = np.where(sel, cols, np.where(fill, C + cols, 2 * C + cols))
    w = min(m, C)                   # C < m: fewer candidates than slots
    order = np.argsort(key, axis=1, kind="stable")[:, :w]
    picked = np.take_along_axis(cand_i, order, axis=1)
    rows = np.full((B, m), -1, np.int32)
    rows[:, :w] = np.where(np.arange(w)[None, :] < total[:, None],
                           picked, -1)
    return rows, total, sel | fill


def link_wave_layer(x: np.ndarray, adj_l: np.ndarray,
                    node_ids: np.ndarray, cand_d: np.ndarray,
                    cand_i: np.ndarray) -> np.ndarray:
    """Link one wave at one layer, fully vectorized: batched forward
    diversity selection, then batched degree-bounded bidirectional
    (reverse) linking — free-slot appends scattered in one shot,
    overfull rows re-selected with the SAME batched heuristic (the
    hnswlib re-selection ``graph.add_link`` does one edge at a time).
    Mutates ``adj_l`` in place; returns the ids of every row that
    changed."""
    m = adj_l.shape[1]
    node_ids = np.asarray(node_ids, np.int64)
    if len(node_ids) == 0 or cand_d.shape[1] == 0:
        return np.empty(0, np.int64)

    # --- forward: each wave node's own neighbor row ---
    rows, total, sel = select_heuristic_batch(x, cand_d, cand_i, m)
    has = total > 0
    adj_l[node_ids[has]] = rows[has]

    # --- reverse: add each wave node to its selected neighbors ---
    bb, cc = np.nonzero(sel)
    tgt = cand_i[bb, cc].astype(np.int64)
    src = node_ids[bb]
    d_ts = cand_d[bb, cc].astype(np.float32)
    # intra-wave symmetry dedup: if tgt is itself a wave node whose
    # forward row already selected src, don't add src twice
    dup = (adj_l[tgt] == src[:, None]).any(1)
    if dup.any():
        tgt, src, d_ts = tgt[~dup], src[~dup], d_ts[~dup]
    if len(tgt) == 0:
        return np.unique(node_ids[has])

    order = np.argsort(tgt, kind="stable")       # group by target;
    t_s, s_s, d_s = tgt[order], src[order], d_ts[order]  # stable keeps
    ut, start, cnt = np.unique(t_s, return_index=True,   # wave order
                               return_counts=True)
    within = np.arange(len(t_s)) - np.repeat(start, cnt)
    inv = np.repeat(np.arange(len(ut)), cnt)
    first_free = (adj_l[ut] >= 0).sum(1)         # -1 pad is a suffix
    overfull = first_free + cnt > m

    # free-slot appends (no re-selection needed): one scatter
    app = ~overfull[inv]
    if app.any():
        adj_l[t_s[app], (first_free[inv] + within)[app]] = s_s[app]

    # overfull targets: re-select {existing row + all incoming} with the
    # batched diversity heuristic
    if overfull.any():
        uo = ut[overfull]                        # [U]
        o_of = np.cumsum(overfull) - 1           # ut idx -> uo idx
        pm = overfull[inv]                       # pairs on overfull tgts
        R = int(cnt[overfull].max())
        U = len(uo)
        inc_i = np.full((U, R), -1, np.int64)
        inc_d = np.full((U, R), INF, np.float32)
        inc_i[o_of[inv[pm]], within[pm]] = s_s[pm]
        inc_d[o_of[inv[pm]], within[pm]] = d_s[pm]
        ex_i = adj_l[uo].astype(np.int64)        # [U, m]
        ex_ok = ex_i >= 0
        diff = x[np.where(ex_ok, ex_i, 0)] - x[uo][:, None, :]
        ex_d = np.einsum("umd,umd->um", diff, diff).astype(np.float32)
        ex_d = np.where(ex_ok, ex_d, INF)
        c2_d = np.concatenate([ex_d, inc_d], 1)
        c2_i = np.concatenate([ex_i, inc_i], 1)
        o2 = np.argsort(c2_d, axis=1, kind="stable")
        c2_d = np.take_along_axis(c2_d, o2, 1)
        c2_i = np.take_along_axis(c2_i, o2, 1)
        rows2, _, _ = select_heuristic_batch(x, c2_d, c2_i, m)
        adj_l[uo] = rows2

    return np.unique(np.concatenate([node_ids[has], ut]))


def link_wave(x: np.ndarray, adj: List[np.ndarray],
              node_ids: np.ndarray, levels: np.ndarray,
              probe_d: Optional[np.ndarray],
              probe_i: Optional[np.ndarray], block_d: np.ndarray,
              cfg: PHNSWConfig, *, max_cand: Optional[int] = None
              ) -> List[np.ndarray]:
    """Link a wave of new nodes into the graph at every layer they
    occupy. Per layer, each node's candidate set is the union of its
    device-probe results (level-masked: a link at layer l may only
    target nodes with level >= l — the probe can hand back lower-level
    seeds at layers above the snapshot's top) and its intra-wave peers
    from ``block_d``, merged ascending and truncated to ``max_cand``
    (default ef_construction, the sequential beam width).

    ``probe_d``/``probe_i``: [Lp, B, E] bottom-layer-first (fewer
    layers than the wave's max level is fine). ``block_d``: [B, B]
    squared dists among the wave, diagonal = INF. Mutates ``adj`` in
    place; returns the changed row ids per layer (len(adj) entries) —
    the mutable index feeds these to its incremental publish."""
    node_ids = np.asarray(node_ids, np.int64)
    lvls = np.asarray(levels)[node_ids]
    Lp = 0 if probe_d is None else probe_d.shape[0]
    C_cap = int(max_cand or cfg.ef_construction)
    dirty = [np.empty(0, np.int64) for _ in range(len(adj))]
    for l in range(min(int(lvls.max()) + 1, len(adj)) - 1, -1, -1):
        rows = np.nonzero(lvls >= l)[0]
        if len(rows) == 0:
            continue
        parts_d, parts_i = [], []
        if l < Lp:
            pd = np.asarray(probe_d[l][rows], np.float32)
            pi = np.asarray(probe_i[l][rows], np.int64)
            ok = (pi >= 0) & (pd < VALID_MAX)
            ok &= np.asarray(levels)[np.where(pi >= 0, pi, 0)] >= l
            parts_d.append(np.where(ok, pd, INF))
            parts_i.append(np.where(ok, pi, -1))
        if len(rows) > 1:
            bd = np.asarray(block_d[np.ix_(rows, rows)], np.float32)
            parts_d.append(bd)            # diag already INF (self)
            parts_i.append(np.broadcast_to(node_ids[rows][None, :],
                                           bd.shape).copy())
        if not parts_d:
            continue
        cd = np.concatenate(parts_d, 1)
        ci = np.concatenate(parts_i, 1)
        if cd.shape[1] > C_cap:
            # cheap top-C preselection before the full sort: the block
            # contributes a wave-width column span, most of it far
            part = np.argpartition(cd, C_cap - 1, axis=1)[:, :C_cap]
            cd = np.take_along_axis(cd, part, 1)
            ci = np.take_along_axis(ci, part, 1)
        o = np.argsort(cd, axis=1, kind="stable")
        cd = np.take_along_axis(cd, o, 1)
        ci = np.take_along_axis(ci, o, 1)
        dirty[l] = link_wave_layer(x, adj[l], node_ids[rows], cd, ci)
    return dirty


def build_hnsw_wave(x: np.ndarray, cfg: PHNSWConfig, *, seed: int = 0,
                    wave_size: Optional[int] = None,
                    verbose: bool = False, device="cuda",
                    timings: Optional[dict] = None) -> HNSWGraph:
    """The wave pipeline, one-shot form: levels up front, then waves of
    ``wave_size`` — a probe on ``device`` against the running snapshot +
    vectorized wave linking on the host. The snapshot holds full-N
    buffers and all final layers from the start (empty top layers are
    inert: the probe's frontier exhausts in one pop). ``timings``, when
    given, accumulates host-clock seconds per stage: "probe" (up to the
    probe results on the host), "link" (block + ``link_wave``) and
    "refresh" (device adjacency update)."""
    from repro_torch.core.search_torch import (PackedDB, PackedLayer,
                                               probe_neighborhoods)
    n, dim = x.shape
    rng = np.random.default_rng(seed)
    levels = sample_levels(n, cfg, rng)
    n_layers = int(levels.max()) + 1
    adj = [np.full((n, cfg.degree(l)), -1, np.int32)
           for l in range(n_layers)]
    entry, top = 0, int(levels[0])
    if n > 1:
        B = int(wave_size or cfg.wave_size)
        x32 = np.asarray(x, np.float32)
        high = torch.as_tensor(x32, device=device)
        low = torch.zeros((n, 0), dtype=torch.float32, device=device)
        pl0 = [torch.zeros((n, cfg.degree(l), 0), dtype=torch.float32,
                           device=device) for l in range(n_layers)]
        qprep = torch.zeros((B, 0), dtype=torch.float32, device=device)
        # device-resident adjacency, refreshed INCREMENTALLY: only the
        # rows link_wave changed are copied back each wave. Unlike the
        # reference's immutable arrays, the port updates the device
        # tensors in place (index_copy_) instead of building new ones.
        dev_adj = [torch.as_tensor(a, device=device) for a in adj]
        db = PackedDB(
            layers=[PackedLayer(adj=dev_adj[l], packed_low=pl0[l])
                    for l in range(n_layers)],
            low=low, high=high, entry=entry, cfg=cfg, filter_kind="none")
        t0 = time.perf_counter()
        done = 1                               # node 0 seeds the graph
        while done < n:
            ids = np.arange(done, min(done + B, n))
            b = len(ids)
            xb = x32[ids]
            db.entry = entry
            qx = xb if b == B else np.concatenate(
                [xb, np.broadcast_to(x32[entry], (B - b, dim))])
            t_probe = time.perf_counter()
            fd, fi = probe_neighborhoods(
                db, qx, qprep, cfg.ef_construction, cfg.ef_construction_k,
                filter_deleted=False, ef_upper=cfg.wave_ef_upper,
                device=device)
            fd = fd[:, :b].cpu().numpy()
            fi = fi[:, :b].cpu().numpy()
            t_link = time.perf_counter()
            block = pairwise_sq(xb, xb)
            np.fill_diagonal(block, INF)
            dirty = link_wave(x, adj, ids, levels, fd, fi, block, cfg)
            t_refresh = time.perf_counter()
            for l, d in enumerate(dirty):
                if len(d):
                    rows = pad_rows_pow2(d)    # repeats: idempotent re-set
                    dev_adj[l].index_copy_(
                        0, torch.as_tensor(rows, device=device),
                        torch.as_tensor(adj[l][rows], device=device))
            if timings is not None:
                for key, dt in (("probe", t_link - t_probe),
                                ("link", t_refresh - t_link),
                                ("refresh", time.perf_counter() - t_refresh)):
                    timings[key] = timings.get(key, 0.0) + dt
            wmax = int(levels[ids].max())
            if wmax > top:
                entry = int(ids[int(np.argmax(levels[ids] == wmax))])
                top = wmax
            done = int(ids[-1]) + 1
            if verbose:
                vps = done / max(time.perf_counter() - t0, 1e-9)
                print(f"  wave {done}/{n} ({vps:.0f} vec/s)",
                      flush=True)
    # pad adjacency list count up to cfg.n_layers for uniform access
    while len(adj) < cfg.n_layers:
        adj.append(np.full((n, cfg.M), -1, np.int32))
    return HNSWGraph(cfg=cfg, x=x, levels=levels, layers=adj,
                     entry=entry)


# --------------------- structural invariant checker -----------------------

def graph_invariants(g: HNSWGraph) -> dict:
    """Check the structural invariants every builder must uphold.
    Returns {"ok", "violations": [...], "reachable_frac": [per layer],
    "mean_degree": [per layer]} — the test suite asserts ok, the CI
    build-smoke gate cross-checks wave output against the sequential
    oracle with it."""
    n = g.n
    violations = []
    reach_frac, mean_deg = [], []
    for l, a in enumerate(g.layers):
        present = np.nonzero(g.levels >= l)[0]
        valid = a >= 0
        if (a >= n).any():
            violations.append(f"layer {l}: id out of range")
        # -1 padding must be a strict suffix of each row
        if (valid[:, 1:] & ~valid[:, :-1]).any():
            violations.append(f"layer {l}: -1 pad not a suffix")
        rows_absent = np.ones(n, bool)
        rows_absent[present] = False
        if valid[rows_absent].any():
            violations.append(f"layer {l}: links on absent node rows")
        sub = a[present]
        if (sub == present[:, None]).any():
            violations.append(f"layer {l}: self link")
        s = np.sort(sub, axis=1)
        if ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any():
            violations.append(f"layer {l}: duplicate link")
        safe = np.where(sub >= 0, sub, 0)
        if ((g.levels[safe] < l) & (sub >= 0)).any():
            violations.append(f"layer {l}: link to node below layer")
        mean_deg.append(float((sub >= 0).sum(1).mean())
                        if len(present) else 0.0)
        # entry-reachability of every present node within the layer
        if len(present) == 0:
            reach_frac.append(1.0)
            continue
        reach = np.zeros(n, bool)
        if g.levels[g.entry] >= l:
            frontier = np.asarray([g.entry])
            reach[g.entry] = True
            while len(frontier):
                nb = a[frontier]
                nb = np.unique(nb[nb >= 0])
                nb = nb[~reach[nb]]
                reach[nb] = True
                frontier = nb
        reach_frac.append(float(reach[present].mean()))
    return {"ok": not violations, "violations": violations,
            "reachable_frac": reach_frac, "mean_degree": mean_deg}
