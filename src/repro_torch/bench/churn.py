"""Churn: recall@10 and QPS under a mixed insert / delete / query workload
against the mutable index (port of ``benchmarks/bench_churn.py``).

    python -m repro_torch.bench.churn [--device cuda|cpu] [--n-points N]
        [--queries Q] [--rounds R] [--shards P] [--out FILE]

Workload: the cached ``--n-points`` graph adopted as a ``MutableIndex``
(``--shards`` > 1: a ``ShardedMutableIndex`` built over the same points,
round-robin upserts, owner-routed deletes) behind a
``VectorSearchService`` on ``--device``; one warm upsert, then ``rounds -
1`` rounds of {upsert one ``insert_batch``, delete half a batch of random
live ids, serve one query batch}, each op class timed on the host clock
(each op returns its results to the host). Fresh vectors come from the
same generator (seed 1234), the deletions from ``default_rng(7)``. Ends
with recall@10 against exact brute force over the FINAL live set, the
tombstone density and the PCA-drift report.

Rows (name,us_per_call,derived):
  churn/upsert   — mean us per upserted vector; derived: vectors/s
  churn/delete   — mean us per deleted id;     derived: ids/s
  churn/query    — mean us per query;          derived: qps + p99 ms
  churn/final    — 0; derived: recall@10, live size, tombstone frac,
                   pca drift

``--out`` writes the rows and the figures (the op counts, the expected
live size and tombstone fraction, the final answers' non-live ids) as
JSON; nothing here writes ``BENCH_table3.json``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np

from repro_torch.bench.common import card, emit, load_bench_db, recall_mean


def run_churn(cfg, x, g, pca, q, *, rounds: int = 8, batch: int = 64,
              n_shards: int = 1, device="cuda") -> dict:
    """The workload over graph ``g`` of points ``x`` (``n_shards`` > 1:
    a sharded index built over ``x``), queries ``q``. Returns ``{"rows":
    [...], "entry": {...}}``."""
    from repro_torch.core.filters import PCAFilter
    from repro_torch.data.vectors import make_sift_like
    from repro_torch.index import MutableIndex, ShardedMutableIndex
    from repro_torch.serve.vector_service import VectorSearchService

    n_points = len(x)
    fresh = make_sift_like(rounds * cfg.insert_batch, seed=1234)
    if n_shards > 1:
        idx = ShardedMutableIndex.build(
            x, cfg, n_shards, seed=1,
            filt=PCAFilter(pca, low_dtype=cfg.low_dtype), device=device)
        idx.reserve(-(-(n_points + len(fresh)) // n_shards))
    else:
        idx = MutableIndex.from_graph(g, pca, seed=1, device=device)
        idx.reserve(n_points + len(fresh))       # no growth mid-run
    svc = VectorSearchService(idx, batch_size=batch, ef0=cfg.ef0,
                              device=device)
    # warm the insert probe before timing (as a service would)
    svc.upsert(fresh[:cfg.insert_batch])
    n_warm = cfg.insert_batch

    rng = np.random.default_rng(7)
    t_up = t_del = t_q = 0.0
    n_up = n_del = n_q = 0
    for r in range(1, rounds):
        xb = fresh[r * cfg.insert_batch:(r + 1) * cfg.insert_batch]
        t0 = time.perf_counter()
        svc.upsert(xb)
        t_up += time.perf_counter() - t0
        n_up += len(xb)

        live = idx.live_ids()
        doomed = rng.choice(live, size=cfg.insert_batch // 2,
                            replace=False)
        t0 = time.perf_counter()
        svc.delete(doomed)
        t_del += time.perf_counter() - t0
        n_del += len(doomed)

        qb = q[(r * batch) % max(len(q) - batch, 1):][:batch]
        if len(qb) < batch:
            qb = q[:batch]
        t0 = time.perf_counter()
        svc.query(qb)
        t_q += time.perf_counter() - t0
        n_q += len(qb)

    # final recall against brute force over the live set
    live = idx.live_ids()
    gt_live = idx.live_ground_truth(q, cfg.recall_at)
    _, fi = idx.search(q)
    fi = fi.cpu().numpy()
    rec = recall_mean(fi, gt_live, cfg.recall_at)
    drift = idx.pca_drift()
    found = fi[:, :cfg.recall_at]
    found = found[found >= 0]
    rows = [
        ("churn/upsert", t_up / max(n_up, 1) * 1e6,
         f"vecs_per_s={n_up / max(t_up, 1e-9):.0f}"),
        ("churn/delete", t_del / max(n_del, 1) * 1e6,
         f"ids_per_s={n_del / max(t_del, 1e-9):.0f}"),
        ("churn/query", t_q / max(n_q, 1) * 1e6,
         f"qps={n_q / max(t_q, 1e-9):.0f};"
         f"p99_ms={svc.stats.percentile(99):.1f}"),
        ("churn/final", 0.0,
         f"recall@10={rec:.3f};live={len(live)};"
         f"tombstone_frac={idx.tombstone_frac:.3f};"
         f"pca_drift={drift['drift']:.4f}"),
    ]
    total = n_points + n_warm + n_up
    entry = {"bench": "churn", "n_points": n_points, "rounds": rounds,
             "n_shards": n_shards, "batch": batch, "queries": len(q),
             "qps": n_q / max(t_q, 1e-9),
             "upserts_per_s": n_up / max(t_up, 1e-9),
             "deletes_per_s": n_del / max(t_del, 1e-9),
             "p99_ms": svc.stats.percentile(99),
             "recall_at_10": rec, "tombstone_frac": idx.tombstone_frac,
             "pca_drift": drift["drift"], "live": len(live),
             "upserts": n_warm + n_up, "deletes": n_del,
             "expected_live": total - n_del,
             "expected_tombstone_frac": n_del / total,
             "non_live_returned": int((~np.isin(found, live)).sum())}
    return {"rows": rows, "entry": entry}


def main(n_points: int = 8_000, n_queries: int = 64, *, rounds: int = 8,
         batch: int = 64, n_shards: int = 1, device="cuda",
         out: Optional[str] = None):
    cfg, x, g, pca, _, q, _ = load_bench_db(n_points, n_queries,
                                            device=device)
    res = run_churn(cfg, x, g, pca, q, rounds=rounds, batch=batch,
                    n_shards=n_shards, device=device)
    emit(res["rows"], out, **res["entry"], **card(device))
    return res


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-points", type=int, default=8_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--out", help="also write the rows and figures as JSON")
    args = ap.parse_args(argv)
    return main(args.n_points, args.queries, rounds=args.rounds,
                n_shards=args.shards, device=args.device, out=args.out)


if __name__ == "__main__":
    cli()
