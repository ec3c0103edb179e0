"""Fault tolerance: the recall-vs-dead-shards curve and the kill ->
degraded -> replica failover -> snapshot reseed -> recover cycle, with
the distinct-key accounting (port of ``benchmarks/bench_faults.py``).

    python -m repro_torch.bench.faults [--device cuda|cpu] [--n-points N]
        [--queries Q] [--shards P] [--out FILE]

Data: ``--n-points`` SIFT-like points (seed 11, ``ef_construction`` 32)
in a ``ShardedMutableIndex`` of P shards on ``--device`` and one batch of
queries (seed 12). Two recall yardsticks per dead-shard count:

* ``recall_full``     — against the FULL live ground truth: the price of
  losing shards (a query whose true neighbours lived on a dead shard
  cannot recall them);
* ``recall_survivor`` — against ground truth over the SURVIVING shards'
  live vectors: what degraded mode answers for (the reference CI's
  floor: >= 0.90 at P = 4 with one dead shard).

The cycle runs on a ``ReplicaSet`` of 2 over a ``FaultPolicy`` service:
``kill_shard`` 0 (degraded), ``kill_replica`` 0 (failover), ``heal`` /
``clear``, ``recover(0)`` and ``recover_shard`` for every shard.
``zero_recompiles`` holds when ``core.distributed.search_cache_sizes()``
and ``resilient_cache_sizes()`` — the distinct (shape, static argument)
keys of the search programs, the counterpart of the reference's
compiled-program caches — are the same after the cycle as before it.
Times are host-clock seconds ending in a device synchronisation.

Rows: ``faults/dead{k}`` for k = 0 .. P-1 and ``faults/cycle``. ``--out``
writes the rows and the curve as JSON; nothing here writes
``BENCH_table3.json``.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional

import numpy as np

from repro_torch.bench.common import card, emit, recall_mean, synchronizer


def survivor_gt(idx, q: np.ndarray, mask: np.ndarray, at: int = 10
                ) -> np.ndarray:
    """Exact top-``at`` over the live vectors of the SURVIVING shards, as
    global ids."""
    from repro_torch.data.vectors import brute_force_topk
    xs, gids = [], []
    for s_i, s in enumerate(idx.shards):
        if not mask[s_i]:
            continue
        li = s.live_ids()
        xs.append(s.x[li])
        gids.append(li + s_i * idx.stride)
    g = np.concatenate(gids)
    return g[brute_force_topk(np.concatenate(xs), q, at)]


def run_faults(idx, qb, *, seed: int = 0, reps: int = 5,
               device="cuda") -> dict:
    """The curve and the cycle over the sharded index ``idx`` with the
    query batch ``qb``. Returns ``{"rows": [...], "entry": {...}}``."""
    from repro_torch.core import distributed as dist
    from repro_torch.distributed import faults
    from repro_torch.distributed.faults import FaultPlan, FaultPolicy
    from repro_torch.serve import ReplicaSet, VectorSearchService

    sync = synchronizer(device)
    P = idx.n_shards
    B = len(qb)
    # ground truth in the GLOBAL id space (shard * stride + local), which
    # is what the searches return
    gt_full = idx.live_ground_truth(qb, 10)
    pol = FaultPolicy(deadline_ms=250.0, max_retries=2, backoff_ms=5.0,
                      dead_after_failures=2)
    svc = VectorSearchService(idx, batch_size=B, fault_policy=pol,
                              device=device)

    rows, curve = [], []
    # the degradation curve: the mask is data, one program for every count
    idx.search(qb, live=np.ones(P, bool))
    sync()
    for k_dead in range(P):
        mask = np.ones(P, bool)
        mask[:k_dead] = False
        t0 = time.perf_counter()
        for _ in range(reps):
            _, fi, st = idx.search(qb, live=mask, return_stats=True)
        sync()
        us = (time.perf_counter() - t0) / reps / B * 1e6
        fi = fi.cpu().numpy()
        rec_full = recall_mean(fi, gt_full, 10)
        rec_surv = recall_mean(fi, survivor_gt(idx, qb, mask), 10)
        cov = st["coverage"]
        curve.append({"dead_shards": k_dead, "coverage": cov,
                      "live_share": float(
                          sum(s.n_live for s, m in zip(idx.shards, mask)
                              if m) / idx.n_live),
                      "recall_full": rec_full,
                      "recall_survivor": rec_surv, "us_per_query": us})
        rows.append((f"faults/dead{k_dead}", us,
                     f"coverage={cov:.4f};recall_full={rec_full:.3f};"
                     f"recall_survivor={rec_surv:.3f};"
                     f"live_shards={int(mask.sum())}/{P}"))

    # the cycle, the distinct-key counters frozen across all of it
    with tempfile.TemporaryDirectory(prefix="phnsw_faults_") as snap_dir:
        rs = ReplicaSet.replicate(svc, 2, snapshot_dir=snap_dir)
        rs.query(qb)                              # both replicas warm
        counters = (dist.search_cache_sizes(), dist.resilient_cache_sizes())

        t0 = time.perf_counter()
        for _ in range(reps):
            rs.query(qb)
        sync()
        healthy_ms = (time.perf_counter() - t0) / reps * 1e3

        plan = faults.install(FaultPlan(seed=seed))
        try:
            plan.add("kill_shard", 0)
            rs.query(qb)                          # detection and retries
            t0 = time.perf_counter()
            for _ in range(reps):
                _, _, st = rs.query(qb, return_stats=True)
            sync()
            degraded_ms = (time.perf_counter() - t0) / reps * 1e3
            degraded_cov = st["coverage"]

            plan.add("kill_replica", 0)           # the primary dies
            t0 = time.perf_counter()
            rs.query(qb)                          # fails over mid-request
            sync()
            failover_ms = (time.perf_counter() - t0) * 1e3
            plan.heal()                           # faults repaired
        finally:
            faults.clear()
        t0 = time.perf_counter()
        rs.recover(0)                             # snapshot ship + replay
        sync()
        reseed_ms = (time.perf_counter() - t0) * 1e3
        for r in rs.replicas:                     # dead-marks clear
            if r.svc.health is not None:
                for s in range(P):
                    r.svc.recover_shard(s)
        _, _, st = rs.query(qb, return_stats=True)
        recovered_cov = st["coverage"]
        zero_recompiles = (dist.search_cache_sizes(),
                           dist.resilient_cache_sizes()) == counters
        events = [list(e) for e in rs.events]
        del rs
    rows.append(("faults/cycle", degraded_ms * 1e3 / B,
                 f"healthy_ms={healthy_ms:.2f};"
                 f"degraded_ms={degraded_ms:.2f};"
                 f"degraded_coverage={degraded_cov:.4f};"
                 f"failover_ms={failover_ms:.2f};"
                 f"reseed_ms={reseed_ms:.1f};"
                 f"recovered_coverage={recovered_cov:.4f};"
                 f"zero_recompiles={int(zero_recompiles)}"))
    entry = {"bench": "faults", "n_points": idx.n_live, "n_shards": P,
             "batch": B, "curve": curve, "healthy_query_ms": healthy_ms,
             "degraded_query_ms": degraded_ms,
             "degraded_coverage": degraded_cov, "failover_ms": failover_ms,
             "reseed_ms": reseed_ms, "recovered_coverage": recovered_cov,
             "zero_recompiles": bool(zero_recompiles), "events": events}
    return {"rows": rows, "entry": entry}


def faults_index(n_points: int, n_queries: int, n_shards: int, *,
                 device="cuda"):
    """The reference bench's fixture: (sharded index, query batch) —
    ``SMALL`` at ``n_points`` with ``ef_construction`` 32, points seed
    11, queries seed 12, at most 64 of them."""
    from repro_torch.configs.sift1m_phnsw import SMALL
    from repro_torch.data.vectors import make_queries, make_sift_like
    from repro_torch.index import ShardedMutableIndex
    cfg = SMALL.__class__(**{**SMALL.__dict__, "n_points": n_points,
                             "name": f"faults{n_points // 1000}k",
                             "ef_construction": 32})
    x = make_sift_like(n_points, seed=11)
    q = make_queries(x, n_queries, seed=12)
    idx = ShardedMutableIndex.build(x, cfg, n_shards, seed=1, device=device)
    return idx, q[:min(64, n_queries)]


def main(n_points: int = 8_000, n_queries: int = 64, *, n_shards: int = 4,
         seed: int = 0, reps: int = 5, device="cuda",
         out: Optional[str] = None):
    idx, qb = faults_index(n_points, n_queries, n_shards, device=device)
    res = run_faults(idx, qb, seed=seed, reps=reps, device=device)
    emit(res["rows"], out, **res["entry"], **card(device))
    return res


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-points", type=int, default=8_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--out", help="also write the rows and curve as JSON")
    args = ap.parse_args(argv)
    return main(args.n_points, args.queries, n_shards=args.shards,
                device=args.device, out=args.out)


if __name__ == "__main__":
    cli()
