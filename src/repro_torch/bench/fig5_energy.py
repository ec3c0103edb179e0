"""Fig 5: normalized single-query energy (vs HNSW-Std), with the
DRAM-vs-core breakdown; the port of ``benchmarks/bench_fig5_energy.py``.

    python -m repro_torch.bench.fig5_energy [--device cuda|cpu]
        [--n-points N] [--queries Q] [--out FILE]

Every number is the cost model of the PAPER's 65 nm pHNSW processor with
DDR4 / HBM1.0 (``core/cost_model.py``), driven by the host oracle's
traces; none is the card's. ``--device`` is where a missing graph is
built. Paper claims: DRAM 82-87% (DDR4) / 63-72% (HBM) of total; pHNSW
saves up to 57.4% vs HNSW-Std; pHNSW vs pHNSW-Sep ~ -11%."""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.bench.common import emit, load_bench_db
from repro_torch.core.cost_model import hw_variant_stats, table3
from repro_torch.core.search_ref import run_queries


def energy_rows(t3):
    rows = []
    for dram in ("DDR4", "HBM"):
        base = t3["HNSW-Std"][dram].energy_uj
        for variant in ("HNSW-Std", "pHNSW-Sep", "pHNSW"):
            c = t3[variant][dram]
            rows.append((f"fig5/{variant}/{dram}", c.total_ns / 1e3,
                         f"energy_uj={c.energy_uj:.3f};"
                         f"norm={c.energy_uj / base:.3f};"
                         f"dram_share={c.dram_energy_share:.2f}"))
    saved = 1 - t3["pHNSW"]["DDR4"].energy_uj \
        / t3["HNSW-Std"]["DDR4"].energy_uj
    rows.append(("fig5/savings_ddr4", 0.0,
                 f"saved={saved:.1%};paper=57.4%max"))
    return rows


def main(n_points: int = 50_000, n_queries: int = 200, *, device="cuda",
         out: Optional[str] = None):
    cfg, x, g, pca, x_low, q, gt = load_bench_db(n_points, n_queries,
                                                 device=device)
    _, st_h = run_queries(g, q, gt, algo="hnsw", hw_mode=True)
    _, st_p = run_queries(g, q, gt, algo="phnsw", x_low=x_low, pca=pca)
    _, st_s = run_queries(g, q, gt, algo="phnsw", x_low=x_low, pca=pca,
                          layout="separate")
    t3 = table3(hw_variant_stats(st_h, st_p, st_s), n_queries=len(q),
                dim=x.shape[1], d_low=x_low.shape[1])
    return emit(energy_rows(t3), out, bench="fig5_energy",
                n_points=n_points, queries=len(q))


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-points", type=int, default=50_000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    return main(args.n_points, args.queries, device=args.device,
                out=args.out)


if __name__ == "__main__":
    cli()
