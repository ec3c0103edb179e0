"""Table III: single-query search throughput (QPS), the port of
``benchmarks/bench_table3_qps.py``.

    python -m repro_torch.bench.table3_qps [--device cuda|cpu]
        [--n-points N] [--queries Q] [--batch B] [--out FILE]

Rows:
  HNSW-CPU / pHNSW-CPU     — measured wall time of the host oracle
                             (``core/search_ref.py``, numpy) on this
                             machine's CPU (the paper's CPU rows; ratios
                             are what transfer).
  HNSW-Std / pHNSW-Sep / pHNSW x {DDR4, HBM}
                           — the cost model of the PAPER's 65 nm pHNSW
                             processor (``core/cost_model.py``) driven by
                             the oracle's traversal traces. These are the
                             modeled processor's numbers, not the card's.
  layout3_memory           — the layout-(3) bytes against the raw data.
  pHNSW-torch-batched/pca and /none
                           — measured QPS of the batched search
                             (``search_torch.search_batched``) on
                             ``--device``: the paper's filter against
                             standard HNSW (the identity filter), the
                             first ``--batch`` queries as one batch
                             (fewer are padded with the entry point).

derived column = QPS normalized to HNSW-CPU (the paper's normalization),
and for the cost-model rows the ratio to HNSW-Std. The oracle runs four
passes (HNSW timed, pHNSW timed — whose traces are the packed layout's —,
HNSW in hw_mode, pHNSW with layout (4)). ``--out`` writes the rows as
JSON; nothing here writes ``BENCH_table3.json``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.bench.common import batched_filter_ab, emit, load_bench_db
from repro_torch.core.cost_model import hw_variant_stats, table3
from repro_torch.core.search_ref import run_queries

VARIANTS = ("HNSW-Std", "pHNSW-Sep", "pHNSW")
DRAMS = ("DDR4", "HBM")


def host_rows(g, x_low, pca, q, gt):
    """The host oracle's rows: (rows, traces, summary). ``traces`` are
    ``hw_variant_stats``' three variants; ``summary`` holds each pass's
    seconds and recall."""
    t0 = time.perf_counter()
    r_h, _ = run_queries(g, q, gt, algo="hnsw")
    t_h = (time.perf_counter() - t0) / len(q)
    t0 = time.perf_counter()
    r_p, st_p = run_queries(g, q, gt, algo="phnsw", x_low=x_low, pca=pca)
    t_p = (time.perf_counter() - t0) / len(q)
    t0 = time.perf_counter()
    _, st_h = run_queries(g, q, gt, algo="hnsw", hw_mode=True)
    _, st_s = run_queries(g, q, gt, algo="phnsw", x_low=x_low, pca=pca,
                          layout="separate")
    t_traces = time.perf_counter() - t0
    rows = [("table3/HNSW-CPU", t_h * 1e6,
             f"norm=1.00;recall@10={r_h:.3f}"),
            ("table3/pHNSW-CPU", t_p * 1e6,
             f"norm={t_h / t_p:.2f};recall@10={r_p:.3f}")]
    summary = {"queries": len(q), "hnsw_us": t_h * 1e6,
               "phnsw_us": t_p * 1e6, "hnsw_recall": r_h,
               "phnsw_recall": r_p,
               "seconds": (t_h + t_p) * len(q) + t_traces}
    return rows, hw_variant_stats(st_h, st_p, st_s), summary


def cost_rows(traces, n_queries: int, dim: int, d_low: int):
    """The cost model's six rows over the oracle's traces: (rows, the
    ``table3`` grid)."""
    t3 = table3(traces, n_queries=n_queries, dim=dim, d_low=d_low)
    base = {d: t3["HNSW-Std"][d].qps for d in DRAMS}
    rows = []
    for variant in VARIANTS:
        for dram in DRAMS:
            c = t3[variant][dram]
            rows.append((f"table3/{variant}/{dram}", c.total_ns / 1e3,
                         f"qps={c.qps:.0f};vs_std={c.qps / base[dram]:.2f}x"))
    return rows, t3


def layout3_row(bytes_layout3: int, x):
    return ("table3/layout3_memory", 0.0,
            f"bytes={bytes_layout3};vs_raw="
            f"{bytes_layout3 / (x.size * 4):.2f}x")


def batched_rows(cfg, x, g, pca, q, gt, *, batch: int, reps: int,
                 device):
    """The batched search's pca and none rows on ``device``: (rows, the
    ``batched_filter_ab`` dicts)."""
    ms = batched_filter_ab(cfg, x, g, pca, q, gt, batch=batch, reps=reps,
                           modes=[("pca", False), ("none", False)],
                           device=device)
    rows = [(f"table3/pHNSW-torch-batched/{m['name']}", m["us_per_query"],
             f"qps={m['qps']:.0f};recall@10={m['recall']:.3f};"
             f"steps_mean={m['steps_mean']:.1f};"
             f"steps_p99={m['steps_p99']:.1f};"
             f"dist_h_mean={m['dist_h_mean']:.1f};batch={m['batch']}")
            for m in ms]
    return rows, ms


def main(n_points: int = 50_000, n_queries: int = 200, *,
         device="cuda", batch: int = 64, reps: int = 5,
         out: Optional[str] = None):
    cfg, x, g, pca, x_low, q, gt = load_bench_db(n_points, n_queries,
                                                 device=device)
    rows, traces, _ = host_rows(g, x_low, pca, q, gt)
    crows, _ = cost_rows(traces, len(q), x.shape[1], x_low.shape[1])
    rows += crows
    brows, ms = batched_rows(cfg, x, g, pca, q, gt, batch=batch, reps=reps,
                             device=device)
    rows.append(layout3_row(ms[0]["bytes_layout3"], x))
    rows += brows
    return emit(rows, out, bench="table3_qps", n_points=n_points,
                queries=len(q), device=str(device), batch=batch)


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-points", type=int, default=50_000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    return main(args.n_points, args.queries, device=args.device,
                batch=args.batch, out=args.out)


if __name__ == "__main__":
    cli()
