"""Fig 2: recall@10 and modeled QPS vs the per-layer filter size k; the
port of ``benchmarks/bench_fig2_kselect.py``.

    python -m repro_torch.bench.fig2_kselect [--device cuda|cpu]
        [--n-points N] [--queries Q] [--out FILE]

(a) sweep k(layer1) at fixed k(layer0)=16;
(b) sweep k(layer0) at fixed k(layer1)=8.
Also runs the automated knee-finding (``core/kselect.select_schedule``)
and reports the schedule it picks — the paper picked (16, 8, 3...). The
recall is the host oracle's; the QPS is the cost model of the PAPER's
65 nm processor, not the card's. ``--device`` is where a missing graph
is built."""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.bench.common import emit, load_bench_db
from repro_torch.core.kselect import select_schedule, sweep_k0, sweep_k1


def main(n_points: int = 50_000, n_queries: int = 100, *, device="cuda",
         out: Optional[str] = None):
    cfg, x, g, pca, x_low, q, gt = load_bench_db(n_points, n_queries,
                                                 device=device)
    rows = []
    for p in sweep_k1(g, x_low, pca, q, gt, k0=16):
        rows.append((f"fig2a/k1={p.k1}", 1e6 / p.qps_hbm,
                     f"recall={p.recall:.3f};qps_ddr4={p.qps_ddr4:.0f};"
                     f"qps_hbm={p.qps_hbm:.0f}"))
    for p in sweep_k0(g, x_low, pca, q, gt, k1=8):
        rows.append((f"fig2b/k0={p.k0}", 1e6 / p.qps_hbm,
                     f"recall={p.recall:.3f};qps_ddr4={p.qps_ddr4:.0f};"
                     f"qps_hbm={p.qps_hbm:.0f}"))
    sched, _ = select_schedule(g, x_low, pca, q, gt)
    rows.append(("fig2/selected_schedule", 0.0,
                 f"k={'-'.join(map(str, sched))};paper=16-8-3-3-3-3"))
    return emit(rows, out, bench="fig2_kselect", n_points=n_points,
                queries=len(q))


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-points", type=int, default=50_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    return main(args.n_points, args.queries, device=args.device,
                out=args.out)


if __name__ == "__main__":
    cli()
