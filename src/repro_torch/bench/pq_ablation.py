"""Filter-stage ablation on the batched search (port of
``benchmarks/bench_pq_ablation.py``).

    python -m repro_torch.bench.pq_ablation [--device cuda|cpu]
        [--n-points N] [--queries Q] [--out FILE]

Same graph, same queries, one batch on ``--device``; only the filter
stage (``core/filters.py``) and the re-rank mode swap:

  pca              — the paper's dense low-dim projection (60 B/vec),
  pq               — product quantization scored by the fused ADC expand
                     (16 B/vec),
  pq64             — PQ at the matched byte budget (64 B/vec, about
                     PCA-15's 60),
  none             — filter bypass (HNSW-Std: every neighbour re-ranked),
  pca-deferred     — PCA filter, traversal in filter space, one batched
                     Dist.H a query,
  cascade-deferred — PQ-code traversal, a PCA promote pass over the
                     layer-0 exit list (60 B/vec side-car), one batched
                     Dist.H.

Per mode: QPS, recall@10, mean Dist.H evaluations a query, the payload
bytes a vector (inline, and the cascade's side-car apart) and the
multipliers. ``--out`` writes the rows as JSON; nothing here writes
``BENCH_table3.json``.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.bench.common import (batched_filter_ab, card, emit,
                                      load_bench_db)

MODES = [("pca", False), ("pq", False), ("pq64", False), ("none", False),
         ("pca", True), ("cascade", True)]
KEYS = ("qps", "us_per_query", "recall", "dist_h_mean", "steps_mean",
        "bytes_per_vec", "sidecar_bytes_per_vec", "bytes_layout3",
        "rerank_mult", "promote_mult")


def run_pq_ablation(cfg, x, g, pca, q, gt, *, device="cuda") -> dict:
    """The six modes over graph ``g`` at a batch of ``min(64, len(q))``.
    Returns ``{"rows": [...], "modes": {name: figures}}``."""
    ab = batched_filter_ab(cfg, x, g, pca, q, gt, batch=min(64, len(q)),
                           modes=MODES, device=device)
    rows = [(f"pq_ablation/{m['name']}", m["us_per_query"],
             f"qps={m['qps']:.0f};recall@10={m['recall']:.3f};"
             f"dist_h_mean={m['dist_h_mean']:.1f};"
             f"bytes_per_vec={m['bytes_per_vec']};"
             f"sidecar_bytes_per_vec={m['sidecar_bytes_per_vec']};"
             f"rerank_mult={m['rerank_mult']};"
             f"promote_mult={m['promote_mult']}") for m in ab]
    return {"rows": rows,
            "modes": {m["name"]: {k: m[k] for k in KEYS} for m in ab}}


def main(n_points: int = 50_000, n_queries: int = 64, *, device="cuda",
         out: Optional[str] = None):
    cfg, x, g, pca, _, q, gt = load_bench_db(n_points, n_queries,
                                             device=device)
    res = run_pq_ablation(cfg, x, g, pca, q, gt, device=device)
    emit(res["rows"], out, bench="pq_ablation", n_points=n_points,
         queries=len(q), modes=res["modes"], **card(device))
    return res


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-points", type=int, default=50_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    return main(args.n_points, args.queries, device=args.device,
                out=args.out)


if __name__ == "__main__":
    cli()
