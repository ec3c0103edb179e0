"""Shared bench fixtures (port of ``benchmarks/common.py``): the cached
SIFT-like graph and queries, the benches' filters, and the batched
search's measurement protocol on a device.

The graph cache and the query file live in ``experiments/data/`` under
the reference's names and npz keys, so a fixture written by either
package loads in the other."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[3]
DATA_DIR = ROOT / "experiments" / "data"


def synchronizer(device):
    """A callable that waits for ``device``'s queued work (the host
    clock's end point for every timed section); a no-op on the CPU."""
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def card(device) -> dict:
    """What a bench's numbers were measured on: torch's name for the
    device and, on a card, ``nvidia-smi``'s name and power limit (the
    line ``--query-gpu=name,power.limit``), None where it cannot be
    read."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": str(dev), "card": None, "nvidia_smi": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return {"device": str(dev), "card": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi}


def recall_mean(ids, gt, at: int) -> float:
    """Mean recall@``at`` of the id rows ``ids`` against ``gt``."""
    from repro_torch.core.search_ref import recall_at
    ids = np.asarray(ids)
    return float(np.mean([recall_at(ids[i], gt[i], at)
                          for i in range(len(gt))]))


def load_bench_db(n_points: int = 50_000, n_queries: int = 200, *,
                  device="cuda"):
    """(cfg, x, graph, pca, x_low, queries, ground_truth) — cached. A
    missing graph is built with the wave builder's probe on
    ``device``."""
    from repro_torch.configs.sift1m_phnsw import SMALL
    from repro_torch.core.graph import cached_graph
    from repro_torch.core.pca import fit_pca
    from repro_torch.data.vectors import (brute_force_topk, make_queries,
                                          make_sift_like)

    cfg = SMALL if n_points == SMALL.n_points else \
        SMALL.__class__(**{**SMALL.__dict__, "n_points": n_points,
                           "name": f"sift{n_points // 1000}k"})
    x = make_sift_like(cfg.n_points)
    g = cached_graph(x, cfg, DATA_DIR, device=device)
    pca = fit_pca(x, cfg.d_low)
    x_low = pca.transform(x).astype(np.float32)
    qf = DATA_DIR / f"queries_{cfg.name}.npz"
    if qf.exists():
        z = np.load(qf)
        q, gt = z["q"][:n_queries], z["gt"][:n_queries]
    else:
        q = make_queries(x, n_queries)
        gt = brute_force_topk(x, q, cfg.recall_at)
        DATA_DIR.mkdir(parents=True, exist_ok=True)
        np.savez(qf, q=q, gt=gt)
    return cfg, x, g, pca, x_low, q, gt


# the PQ-trained filters a process has fitted, by (kind, config, data):
# Lloyd training takes seconds on the host at the benches' sizes, and the
# runner's modes train the same codebooks again and again
_TRAINED: dict = {}


def _digest(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(a) if a is not None else np.empty(0)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def make_bench_filter(kind: str, cfg, x, pca, levels=None):
    """The filter used by the batched benches: adopt the cached PCA for
    "pca"/"cascade", fit PQ/identity from cfg (4 Lloyd iterations for
    plain PQ, the config's schedule for the cascade). "pq<N>" (e.g.
    "pq64") overrides cfg.pq_n_sub. ``levels`` trains the codebooks
    density-aware. A PQ or cascade filter is trained once a process for
    the same kind, config, points, PCA and levels."""
    from repro_torch.core.filters import PCAFilter, make_filter
    if kind == "pca":
        return PCAFilter(pca, low_dtype=cfg.low_dtype)
    n_sub = cfg.pq_n_sub
    if kind.startswith("pq") and kind != "pq":
        kind, n_sub = "pq", int(kind[2:])
    iters = cfg.pq_train_iters if kind == "cascade" else 4
    fcfg = dataclasses.replace(cfg, filter_kind=kind, pq_n_sub=n_sub,
                               pq_train_iters=iters)
    if kind not in ("pq", "cascade"):
        return make_filter(fcfg, x, pca=pca, levels=levels)
    key = (repr(fcfg), _digest(x, pca.mean, pca.components, levels))
    if key not in _TRAINED:
        _TRAINED[key] = make_filter(fcfg, x, pca=pca, levels=levels)
    return _TRAINED[key]


def batched_filter_ab(cfg, x, g, pca, q, gt, *, batch: int = 64,
                      reps: int = 3, rerank_mult=None, modes=None,
                      device="cuda"):
    """The batched search across filter stages on one device: same
    graph, same queries, only the filter payload and kernel (and
    optionally the re-rank mode) swap. The first ``batch`` queries run
    as ONE batch of ``batch`` rows; fewer are padded with the entry
    point's vector (as the service pads), and only the real ones count
    in QPS and recall. Returns one dict per mode: qps, recall@
    cfg.recall_at, Dist.H evals and steps per query, payload bytes per
    vector, the packed db's layout-(3) bytes, the batch's seconds
    (``wall_s``, device synchronised) and its ``return_stats`` telemetry
    (``stats``)."""
    import torch
    from repro_torch.core.search_torch import build_packed, search_batched

    modes = modes or [("pca", False), ("pq", False), ("none", False),
                      ("pca", True), ("cascade", True)]
    dev = torch.device(device)
    sync = synchronizer(dev)
    n = min(batch, len(q))
    qb = np.asarray(q[:n], np.float32)
    if n < batch:
        pad = np.broadcast_to(g.x[int(g.entry)], (batch - n, qb.shape[1]))
        qb = np.concatenate([qb, pad], axis=0).astype(np.float32)
    qd = torch.as_tensor(qb, device=dev)
    filt_cache, db_cache = {}, {}
    out = []
    for kind, deferred in modes:
        if kind not in filt_cache:
            filt_cache[kind] = make_bench_filter(kind, cfg, x, pca,
                                                 levels=g.levels)
            db_cache[kind] = build_packed(g, filt_cache[kind].encode(x),
                                          filt=filt_cache[kind],
                                          device=dev)
        filt, db = filt_cache[kind], db_cache[kind]
        rm = int(rerank_mult or
                 (2 if kind == "cascade" else cfg.rerank_mult))
        kw = dict(filt=filt, deferred=deferred, rerank_mult=rm,
                  device=dev)
        search_batched(db, qd, **kw)                    # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            _, fi, stc = search_batched(db, qd, return_stats=True, **kw)
        sync()
        dt = (time.perf_counter() - t0) / reps
        rec = recall_mean(fi.cpu().numpy()[:n], gt[:n], cfg.recall_at)
        dhe = stc["dist_h_evals"].cpu().numpy()[:n]
        steps = stc["steps_total"].cpu().numpy()[:n]
        out.append({
            "name": kind + ("-deferred" if deferred else ""),
            "queries": n, "batch": batch,
            "qps": n / dt, "us_per_query": dt / n * 1e6,
            "recall": rec, "dist_h_mean": float(dhe.mean()),
            "steps_mean": float(steps.mean()),
            "steps_p99": float(np.percentile(steps, 99)),
            "steps_max": int(steps.max()),
            "bytes_per_vec": filt.bytes_per_vec,
            "bytes_layout3": db.bytes_layout3,
            "sidecar_bytes_per_vec": getattr(filt, "mid_bytes_per_vec",
                                             0),
            "rerank_mult": rm if deferred else 1,
            "promote_mult": cfg.promote_mult
            if (deferred and filt.kind == "cascade") else 1,
            "wall_s": dt, "filt": filt,
            "stats": {"steps_total": steps, "dist_h_evals": dhe,
                      "coverage": stc["coverage"]},
        })
    return out


def emit(rows, out=None, **meta):
    """Print the ``name,us_per_call,derived`` CSV rows; with ``out``,
    also write them as JSON there beside ``meta``."""
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")
    if out:
        with open(out, "w") as f:
            json.dump({**meta, "rows": [{"name": n, "us": us, "derived": d}
                                        for n, us, d in rows]}, f,
                      indent=2)
    return rows
