"""HNSW graph construction (paper's C phase), port of
``repro/core/graph.py``.

Standard Malkov-Yashunin insertion: geometric level assignment
(mL = 1/ln(M)), greedy descent through upper layers, ef_construction beam
search + closest-M neighbor selection with degree-bounded bidirectional
linking. Two builders share those semantics:

  * ``build_hnsw_ref`` — the sequential host insertion loop (numpy +
    heapq), kept as the recall/structure oracle;
  * the WAVE builder (``core/build.py``) — inserts in batches of
    ``cfg.wave_size``, probing each wave on the card with the port's
    search kernels and linking the whole wave with vectorized diversity
    selection. ``build_hnsw`` dispatches on ``cfg.builder`` ("wave" by
    default).

The host code here is numpy, the same arithmetic as the reference, so a
seed gives the same levels and the same graph. Adjacency is stored as
fixed-degree arrays ([N, M_l] int32, -1 padded). ``cached_graph`` keeps
built graphs on disk under the reference's file names and npz keys, so a
cache written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import PHNSWConfig


@dataclass
class HNSWGraph:
    cfg: PHNSWConfig
    x: np.ndarray                  # [N, D] high-dim data
    levels: np.ndarray             # [N] max layer of each point
    layers: List[np.ndarray]       # adjacency per layer [N, M_l], -1 pad
    entry: int

    @property
    def n(self) -> int:
        return len(self.x)

    def degree(self, layer: int) -> int:
        return self.layers[layer].shape[1]

    def stats(self) -> dict:
        return {
            "n": self.n,
            "levels_max": int(self.levels.max()),
            "layer_sizes": [int((self.levels >= l).sum())
                            for l in range(len(self.layers))],
            "mean_degree0": float((self.layers[0] >= 0).sum(1).mean()),
        }


def _search_layer_build(x, adj, q, eps, ef):
    """Beam search in one layer during construction. Returns list of
    (dist, idx), ascending, len <= ef."""
    visited = set(eps)
    cand = [(float(np.sum((x[e] - q) ** 2)), e) for e in eps]
    heapq.heapify(cand)                          # min-heap on dist
    best = [(-d, e) for d, e in cand]            # max-heap (neg dist)
    heapq.heapify(best)
    while cand:
        d_c, c = heapq.heappop(cand)
        d_f = -best[0][0]
        if d_c > d_f and len(best) >= ef:
            break
        neigh = adj[c]
        neigh = neigh[neigh >= 0]
        new = [int(e) for e in neigh if e not in visited]
        if not new:
            continue
        visited.update(new)
        ds = np.sum((x[new] - q) ** 2, axis=1)
        for d_e, e in zip(ds, new):
            d_f = -best[0][0]
            if d_e < d_f or len(best) < ef:
                heapq.heappush(cand, (float(d_e), e))
                heapq.heappush(best, (-float(d_e), e))
                if len(best) > ef:
                    heapq.heappop(best)
    out = sorted([(-d, e) for d, e in best])
    return out


def _select_heuristic(x, cand, m):
    """Malkov-Yashunin Algorithm 4: keep a candidate only if it is closer
    to the query point than to every already-selected neighbor (diversity
    pruning). cand: ascending [(dist_to_new, idx)]."""
    selected: list = []
    for d_e, e in cand:
        ok = True
        for s in selected:
            if float(np.sum((x[e] - x[s]) ** 2)) < d_e:
                ok = False
                break
        if ok:
            selected.append(e)
            if len(selected) >= m:
                break
    # backfill with nearest rejected if underfull
    if len(selected) < m:
        chosen = set(selected)
        for _, e in cand:
            if e not in chosen:
                selected.append(e)
                chosen.add(e)
                if len(selected) >= m:
                    break
    return selected


def sample_levels(n: int, cfg: PHNSWConfig,
                  rng: np.random.Generator) -> np.ndarray:
    """Geometric level assignment (mL = 1/ln(M)), capped at the config's
    layer count — shared by the one-shot builder and online inserts."""
    mL = 1.0 / math.log(cfg.M)
    return np.minimum(
        (-np.log(rng.uniform(1e-12, 1.0, size=n)) * mL).astype(np.int64),
        cfg.n_layers - 1)


def add_link(x: np.ndarray, adj_layer: np.ndarray, i: int, j: int) -> bool:
    """Add j to i's neighbor list in ``adj_layer`` ([N, M_l], -1 pad);
    when overfull, re-select the list with the diversity heuristic
    (hnswlib behavior — plain furthest-eviction strands nodes and breaks
    graph connectivity). Returns True iff i's row changed."""
    row = adj_layer[i]
    free = np.where(row < 0)[0]
    if len(free):
        row[free[0]] = j
        return True
    cand_ids = np.append(row, j)
    ds = np.sum((x[cand_ids] - x[i]) ** 2, axis=1)
    order = np.argsort(ds)
    cand = [(float(ds[o]), int(cand_ids[o])) for o in order]
    sel = _select_heuristic(x, cand, len(row))
    if len(sel) == len(row) and (row == sel).all():
        return False
    row[:] = -1
    row[:len(sel)] = sel
    return True


def build_hnsw_ref(x: np.ndarray, cfg: PHNSWConfig, *, seed: int = 0,
                   verbose: bool = False) -> HNSWGraph:
    """Sequential Malkov-Yashunin insertion — the recall/structure
    oracle for the wave builder (``core/build.py``), and the fallback
    selected by ``cfg.builder == "ref"``."""
    n, dim = x.shape
    rng = np.random.default_rng(seed)
    levels = sample_levels(n, cfg, rng)
    n_layers = int(levels.max()) + 1
    adj = [np.full((n, cfg.degree(l)), -1, np.int32)
           for l in range(n_layers)]

    entry = 0
    top = int(levels[0])
    t0 = time.perf_counter()
    for i in range(1, n):
        if verbose and i % 10000 == 0:
            vps = i / max(time.perf_counter() - t0, 1e-9)
            print(f"  insert {i}/{n} ({vps:.0f} vec/s)", flush=True)
        l_i = int(levels[i])
        q = x[i]
        eps = [entry]
        # greedy descent through layers above l_i
        for l in range(top, l_i, -1):
            if l >= n_layers:
                continue
            res = _search_layer_build(x, adj[l], q, eps, ef=1)
            eps = [res[0][1]]
        # insert at layers min(top, l_i)..0
        for l in range(min(top, l_i), -1, -1):
            res = _search_layer_build(x, adj[l], q, eps,
                                      ef=cfg.ef_construction)
            m_l = cfg.degree(l)
            neigh = _select_heuristic(x, res, m_l)
            adj[l][i, :len(neigh)] = neigh
            for e in neigh:
                add_link(x, adj[l], int(e), i)
            eps = [e for _, e in res]
        if l_i > top:
            entry = int(i)
            top = l_i
    # pad adjacency list count up to cfg.n_layers for uniform access
    while len(adj) < cfg.n_layers:
        adj.append(np.full((n, cfg.M), -1, np.int32))
    return HNSWGraph(cfg=cfg, x=x, levels=levels, layers=adj, entry=entry)


def build_hnsw(x: np.ndarray, cfg: PHNSWConfig, *, seed: int = 0,
               verbose: bool = False, builder: Optional[str] = None,
               wave_size: Optional[int] = None,
               device="cuda", timings: Optional[dict] = None) -> HNSWGraph:
    """Build the C-phase graph with the builder selected by ``builder``
    (default ``cfg.builder``): "wave" — the batched wave pipeline
    (``core/build.py``), whose probe runs on ``device``; "ref" — the
    sequential host oracle. ``timings`` (wave only) accumulates the
    builder's per-stage seconds. Both share ``sample_levels``, so a given seed
    yields the SAME level assignment (and therefore the same entry point)
    under either builder."""
    builder = builder or getattr(cfg, "builder", "wave")
    if builder == "ref":
        return build_hnsw_ref(x, cfg, seed=seed, verbose=verbose)
    if builder != "wave":
        raise ValueError(f"unknown builder {builder!r} "
                         "(expected 'wave' or 'ref')")
    from repro_torch.core.build import build_hnsw_wave  # graph <-> build
    return build_hnsw_wave(x, cfg, seed=seed, verbose=verbose,
                           wave_size=wave_size, device=device,
                           timings=timings)


# --------------------------- disk cache -------------------------------------

# Bump whenever ANY builder's output changes for a fixed (cfg, seed) —
# stale cache entries from an older construction pipeline must never be
# served as if freshly built. Equal to the reference's: both builders give
# the same graph for a seed.
GRAPH_BUILD_VERSION = 2


def _cfg_fingerprint(cfg: PHNSWConfig) -> str:
    """Short stable hash over the FULL config (not just M/efc): any
    field can steer construction (wave_size, n_layers, degrees, ...),
    so two configs that differ anywhere must never share a cache
    entry. The port's config has the reference's fields, so a config
    hashes alike in both packages."""
    items = sorted(dataclasses.asdict(cfg).items())
    return hashlib.sha1(repr(items).encode()).hexdigest()[:10]


def cached_graph(x: np.ndarray, cfg: PHNSWConfig, cache_dir: Path,
                 *, seed: int = 0, verbose: bool = False,
                 builder: Optional[str] = None,
                 device="cuda") -> HNSWGraph:
    """``build_hnsw`` behind an npz cache in ``cache_dir`` (the wave
    builder's probe runs on ``device`` when the entry is missing)."""
    cache_dir = Path(cache_dir)
    builder = builder or getattr(cfg, "builder", "wave")
    key = f"hnsw_{cfg.name}_{len(x)}_{x.shape[1]}_M{cfg.M}" \
          f"_efc{cfg.ef_construction}_s{seed}" \
          f"_{builder}v{GRAPH_BUILD_VERSION}_{_cfg_fingerprint(cfg)}"
    f = cache_dir / f"{key}.npz"
    if f.exists():
        z = np.load(f)
        n_layers = int(z["n_layers"])
        return HNSWGraph(cfg=cfg, x=x, levels=z["levels"],
                         layers=[z[f"adj{l}"] for l in range(n_layers)],
                         entry=int(z["entry"]))
    g = build_hnsw(x, cfg, seed=seed, verbose=verbose, builder=builder,
                   device=device)
    cache_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        f, levels=g.levels, entry=g.entry, n_layers=len(g.layers),
        **{f"adj{l}": a for l, a in enumerate(g.layers)})
    return g
