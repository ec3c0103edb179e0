"""The bench runner (port of ``benchmarks/run.py``): one function per
paper table or figure, and the service benches. Prints
``name,us_per_call,derived`` CSV (plus a roofline appendix when dry-run
records exist).

    python -m repro_torch.bench.run [--fast] [--n-points N] [--perf-smoke]
        [--churn] [--build [--wave-size W]] [--faults] [--load
        [--prom-out FILE]] [--filter pca|pq|cascade|none] [--deferred]
        [--rerank-mult R] [--shards P] [--device cuda|cpu] [--out DIR]

The reference's flags and defaults, and two of its own: ``--device``
(default ``cuda``: without a card the runner raises; the CPU runs only
when asked for with ``--device cpu``) and ``--out DIR``, where each bench
writes its own JSON (``<bench>.json``). It never writes
``BENCH_table3.json`` or anything under ``benchmarks/``; ``--shards``
sets no device flag (the sharded row runs on a (1, P) mesh of the
card).

Modes (each alone): ``--load``, ``--build``, ``--faults``, ``--churn``,
``--perf-smoke`` (Table III's batched row on the 8k fixture, in the
``--filter`` / ``--deferred`` / ``--rerank-mult`` / ``--shards`` mode).
Without one, the full suite runs in the reference's order: table3_qps,
fig2_kselect, fig5_energy, kernel_footprint (on a card only: the port
times it by CUDA-graph replays), pq_ablation, churn; a failed bench is
re-raised.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback
from pathlib import Path
from typing import Optional


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="smaller database (8k points) for quick runs")
    ap.add_argument("--n-points", type=int, default=None)
    ap.add_argument("--perf-smoke", action="store_true",
                    help="only the batched-QPS bench on the 8k database "
                         "(QPS, recall, mean/p99 steps)")
    ap.add_argument("--churn", action="store_true",
                    help="only the mutable-index churn bench (mixed "
                         "insert/delete/query workload)")
    ap.add_argument("--build", action="store_true",
                    help="only the build bench: wave pipeline against the "
                         "sequential oracle (vectors/s) and recall after "
                         "each build")
    ap.add_argument("--wave-size", type=int, default=None,
                    help="override cfg.wave_size for --build")
    ap.add_argument("--faults", action="store_true",
                    help="only the fault-tolerance bench: recall against "
                         "dead shards (P=4) and the kill / degraded / "
                         "failover / reseed / recover cycle")
    ap.add_argument("--load", action="store_true",
                    help="only the open-loop latency-under-load bench")
    ap.add_argument("--prom-out", type=str, default=None,
                    help="with --load: write the Prometheus text of the "
                         "run's metrics registry here")
    ap.add_argument("--filter", choices=("pca", "pq", "cascade", "none"),
                    default="pca", dest="filter_kind",
                    help="filter stage of the measured batched row")
    ap.add_argument("--deferred", action="store_true",
                    help="deferred re-ranking: traverse on filter "
                         "distances, one batched Dist.H a query")
    ap.add_argument("--rerank-mult", type=int, default=None,
                    help="deferred-rerank candidate multiplier (default: "
                         "cfg.rerank_mult)")
    ap.add_argument("--shards", type=int, default=1,
                    help="shard the database P ways: the perf-smoke's "
                         "sharded row and the churn bench's sharded index")
    ap.add_argument("--device", default="cuda",
                    help="where the benches run (cuda, or cpu on request)")
    ap.add_argument("--out", type=str, default=None,
                    help="directory where each bench writes its JSON")
    return ap.parse_args(argv)


def _json(out_dir: Optional[Path], name: str) -> Optional[str]:
    return str(out_dir / f"{name}.json") if out_dir else None


def _check_device(device: str) -> None:
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the benches run on a card: no CUDA device "
                           "here (pass --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {device}: expected cuda or cpu")


def roofline_rows() -> list:
    """The roofline appendix's rows from the dry-run's records
    (``launch.roofline.load_all``); none when there are none."""
    from repro_torch.launch.roofline import load_all
    rows = []
    for r in load_all("pod16x16"):
        step_s = max(r["compute_s"], r["memory_s"], r["collective_s"])
        rows.append((f"roofline/{r['arch']}/{r['shape']}", step_s * 1e6,
                     f"bottleneck={r['bottleneck']};"
                     f"roofline_frac={r['roofline_fraction']};"
                     f"useful_flops={r['useful_flops_ratio']}"))
    return rows


def main(argv=None) -> None:
    args = parse_args(argv)
    _check_device(args.device)
    from repro_torch.bench import (build, churn, faults, fig2_kselect,
                                   fig5_energy, kernel_footprint, load,
                                   pq_ablation, table3_qps)
    dev = args.device
    out_dir = Path(args.out) if args.out else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    n_points = args.n_points or \
        (8_000 if args.fast or args.perf_smoke else 50_000)
    n_queries = 64 if args.fast or args.perf_smoke else 200
    t0 = time.time()
    print("name,us_per_call,derived")

    if args.load:
        load.main(args.n_points or 8_000, device=dev,
                  out=_json(out_dir, "load"), prom_path=args.prom_out)
    elif args.build:
        build.main(args.n_points or 8_000, n_queries,
                   wave_size=args.wave_size, device=dev,
                   out=_json(out_dir, "build"))
    elif args.faults:
        faults.main(args.n_points or 8_000, 64, n_shards=4, device=dev,
                    out=_json(out_dir, "faults"))
    elif args.churn:
        # an explicit --n-points is honoured; only the default shrinks
        churn.main(args.n_points or 8_000, n_queries, n_shards=args.shards,
                   device=dev, out=_json(out_dir, "churn"))
    elif args.perf_smoke:
        table3_qps.main(n_points, n_queries, device=dev,
                        filter_kind=args.filter_kind,
                        deferred=args.deferred,
                        rerank_mult=args.rerank_mult,
                        n_shards=args.shards,
                        out=_json(out_dir, "table3_qps"))
    else:
        suite = [
            (table3_qps, lambda: table3_qps.main(
                n_points, n_queries, device=dev,
                filter_kind=args.filter_kind, deferred=args.deferred,
                rerank_mult=args.rerank_mult, n_shards=args.shards,
                out=_json(out_dir, "table3_qps"))),
            (fig2_kselect, lambda: fig2_kselect.main(
                n_points, min(n_queries, 100), device=dev,
                out=_json(out_dir, "fig2_kselect"))),
            (fig5_energy, lambda: fig5_energy.main(
                n_points, n_queries, device=dev,
                out=_json(out_dir, "fig5_energy"))),
            (kernel_footprint, lambda: kernel_footprint.main(
                ["--out", _json(out_dir, "kernel_footprint")]
                if out_dir else [])),
            (pq_ablation, lambda: pq_ablation.main(
                n_points, min(n_queries, 64), device=dev,
                out=_json(out_dir, "pq_ablation"))),
            (churn, lambda: churn.main(
                args.n_points or 8_000, min(n_queries, 64),
                n_shards=args.shards, device=dev,
                out=_json(out_dir, "churn"))),
        ]
        for mod, run in suite:
            if mod is kernel_footprint and dev == "cpu":
                print("# kernel_footprint skipped: it times CUDA-graph "
                      "replays on a card", file=sys.stderr)
                continue
            try:
                run()
            except Exception:
                print(f"# {mod.__name__} FAILED", file=sys.stderr)
                traceback.print_exc()
                raise
        # the roofline appendix, where the dry-run has left records
        try:
            for name, us, derived in roofline_rows():
                print(f"{name},{us:.1f},{derived}")
        except Exception:
            pass
    print(f"# total {time.time() - t0:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
