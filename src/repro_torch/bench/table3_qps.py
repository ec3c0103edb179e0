"""Table III: single-query search throughput (QPS), the port of
``benchmarks/bench_table3_qps.py``.

    python -m repro_torch.bench.table3_qps [--device cuda|cpu]
        [--n-points N] [--queries Q] [--batch B] [--filter KIND]
        [--deferred] [--rerank-mult R] [--shards P] [--out FILE]

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
  pHNSW-torch-batched/<mode> and /none
                           — measured QPS of the batched search
                             (``search_torch.search_batched``) on
                             ``--device`` in the ``--filter`` /
                             ``--deferred`` / ``--rerank-mult`` mode (pca
                             by default: the paper's filter) and, beside
                             it, standard HNSW (the identity filter), the
                             first ``--batch`` queries as one batch
                             (fewer are padded with the entry point).
  pHNSW-torch-sharded/p<P>-<mode>
                           — with ``--shards`` P > 1: the same mode over a
                             P-way sharded build, searched through
                             ``core.distributed.distributed_search`` on a
                             (1, P) mesh (the first P cards, or the first
                             card P times).
  filter_ab/<mode>         — with ``--out`` in the canonical
                             configuration (pca, per-step, one shard):
                             the filter-stage A/B (pca, pq, none,
                             pca-deferred, cascade-deferred) on the same
                             graph and queries, written to the JSON's
                             ``filters`` section with the reference
                             entry's keys.

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

import numpy as np

from repro_torch.bench.common import (batched_filter_ab, card, emit,
                                      load_bench_db, make_bench_filter,
                                      recall_mean, synchronizer)
from repro_torch.core.cost_model import hw_variant_stats, table3
from repro_torch.core.search_ref import run_queries

VARIANTS = ("HNSW-Std", "pHNSW-Sep", "pHNSW")
DRAMS = ("DDR4", "HBM")
FILTER_KINDS = ("pca", "pq", "cascade", "none")
# the keys of the reference entry's ``filters`` section
FILTER_KEYS = ("qps", "recall", "dist_h_mean", "bytes_per_vec",
               "sidecar_bytes_per_vec", "rerank_mult", "promote_mult")


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
                 device, filter_kind: str = "pca", deferred: bool = False,
                 rerank_mult: Optional[int] = None):
    """The batched search's rows on ``device``: the chosen mode's, then
    the identity filter's (unless it is the chosen one): (rows, the
    ``batched_filter_ab`` dicts, the chosen mode first)."""
    modes = [(filter_kind, deferred)]
    if modes[0] != ("none", False):
        modes.append(("none", False))
    ms = batched_filter_ab(cfg, x, g, pca, q, gt, batch=batch, reps=reps,
                           rerank_mult=rerank_mult, modes=modes,
                           device=device)
    rows = [(f"table3/pHNSW-torch-batched/{m['name']}", m["us_per_query"],
             f"qps={m['qps']:.0f};recall@10={m['recall']:.3f};"
             f"steps_mean={m['steps_mean']:.1f};"
             f"steps_p99={m['steps_p99']:.1f};"
             f"dist_h_mean={m['dist_h_mean']:.1f};batch={m['batch']}")
            for m in ms]
    return rows, ms


def filter_ab(cfg, x, g, pca, q, gt, *, batch: int, device):
    """The filter-stage A/B of the reference's tracked entry (pca, pq,
    none, pca-deferred, cascade-deferred): (rows, ``filters``)."""
    ab = batched_filter_ab(cfg, x, g, pca, q, gt, batch=batch,
                           device=device)
    rows = [(f"table3/filter_ab/{a['name']}", a["us_per_query"],
             f"qps={a['qps']:.0f};recall@10={a['recall']:.3f};"
             f"dist_h_mean={a['dist_h_mean']:.1f};"
             f"bytes_per_vec={a['bytes_per_vec']};"
             f"sidecar_bytes_per_vec={a['sidecar_bytes_per_vec']}")
            for a in ab]
    return rows, {a["name"]: {k: a[k] for k in FILTER_KEYS} for a in ab}


def mesh_devices(n_shards: int, device) -> list:
    """The devices of a (1, P) mesh: the first P cards where there are as
    many, else the first card P times (on the CPU, "cpu" P times)."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n_shards
    many = torch.cuda.device_count() >= n_shards
    return [torch.device("cuda", i if many else 0) for i in range(n_shards)]


def sharded_row(cfg, x, g, pca, q, gt, *, n_shards: int, filter_kind: str,
                deferred: bool, rerank_mult: Optional[int], batch: int,
                reps: int, single_qps: float, device):
    """The chosen mode over a ``n_shards``-way sharded build of ``x``,
    searched through ``distributed_search`` on a (1, P) mesh: (row,
    figures)."""
    from repro_torch.core.distributed import (build_sharded,
                                              distributed_search, make_mesh)
    sync = synchronizer(device)
    filt = make_bench_filter(filter_kind, cfg, x, pca, levels=g.levels)
    sdb = build_sharded(x, cfg, filt, n_shards, device=device)
    devs = mesh_devices(n_shards, device)
    mesh = make_mesh((1, n_shards), ("data", "model"), devices=devs)
    n = min(batch, len(q))
    qb = np.asarray(q[:n], np.float32)
    kw = dict(filt=filt, deferred=deferred,
              rerank_mult=int(rerank_mult or cfg.rerank_mult))
    distributed_search(mesh, sdb, qb, **kw)          # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        _, fi = distributed_search(mesh, sdb, qb, **kw)
    sync()
    dt = (time.perf_counter() - t0) / reps
    rec = recall_mean(fi.cpu().numpy(), gt[:n], cfg.recall_at)
    mode = filter_kind + ("-deferred" if deferred else "")
    row = (f"table3/pHNSW-torch-sharded/p{n_shards}-{mode}", dt / n * 1e6,
           f"qps={n / dt:.0f};recall@10={rec:.3f};path=mesh;"
           f"vs_1shard={single_qps / (n / dt):.2f}x_slowdown")
    return row, {"name": row[0], "qps": n / dt, "recall": rec,
                 "queries": n, "n_shards": n_shards,
                 "mesh_devices": [str(d) for d in devs]}


def main(n_points: int = 50_000, n_queries: int = 200, *,
         device="cuda", batch: int = 64, reps: int = 5,
         filter_kind: str = "pca", deferred: bool = False,
         rerank_mult: Optional[int] = None, n_shards: int = 1,
         out: Optional[str] = None):
    """``filter_kind`` / ``deferred`` / ``rerank_mult`` select the
    measured batched row's filter stage and re-rank mode (the oracle and
    cost-model rows stay on the paper's pca configuration); ``n_shards``
    > 1 adds the sharded row. With ``out`` in the canonical configuration
    (pca, per-step, one shard) the JSON also carries the ``filters``
    A/B."""
    if filter_kind not in FILTER_KINDS:
        raise ValueError(f"filter_kind {filter_kind!r}: expected one of "
                         f"{FILTER_KINDS}")
    cfg, x, g, pca, x_low, q, gt = load_bench_db(n_points, n_queries,
                                                 device=device)
    rows, traces, _ = host_rows(g, x_low, pca, q, gt)
    crows, _ = cost_rows(traces, len(q), x.shape[1], x_low.shape[1])
    rows += crows
    brows, ms = batched_rows(cfg, x, g, pca, q, gt, batch=batch, reps=reps,
                             device=device, filter_kind=filter_kind,
                             deferred=deferred, rerank_mult=rerank_mult)
    layout_m = next((m for m in ms if m["name"] == "pca"), None)
    if layout_m is None:
        # the layout-(3) row is the paper's pca payload's
        from repro_torch.core.search_torch import build_packed
        rows.append(layout3_row(build_packed(g, x_low, device=device)
                                .bytes_layout3, x))
    else:
        rows.append(layout3_row(layout_m["bytes_layout3"], x))
    rows += brows
    meta = dict(bench="table3_qps", n_points=n_points, queries=len(q),
                batch=batch, filter_kind=filter_kind, deferred=deferred,
                rerank_mult=ms[0]["rerank_mult"], n_shards=n_shards,
                batched={m["name"]: {k: m[k] for k in (
                    "qps", "us_per_query", "recall", "steps_mean",
                    "steps_p99", "steps_max", "dist_h_mean")}
                    for m in ms}, **card(device))
    if n_shards > 1:
        row, meta["sharded"] = sharded_row(
            cfg, x, g, pca, q, gt, n_shards=n_shards,
            filter_kind=filter_kind, deferred=deferred,
            rerank_mult=rerank_mult, batch=batch, reps=reps,
            single_qps=ms[0]["qps"], device=device)
        rows.append(row)
    if out and (filter_kind, deferred, n_shards) == ("pca", False, 1):
        arows, meta["filters"] = filter_ab(cfg, x, g, pca, q, gt,
                                           batch=batch, device=device)
        rows += arows
    return emit(rows, out, **meta)


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-points", type=int, default=50_000)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--filter", choices=FILTER_KINDS, default="pca",
                    dest="filter_kind")
    ap.add_argument("--deferred", action="store_true")
    ap.add_argument("--rerank-mult", type=int, default=None)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    return main(args.n_points, args.queries, device=args.device,
                batch=args.batch, filter_kind=args.filter_kind,
                deferred=args.deferred, rerank_mult=args.rerank_mult,
                n_shards=args.shards, out=args.out)


if __name__ == "__main__":
    cli()
