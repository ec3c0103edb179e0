"""End-to-end serving example on the PyTorch/CUDA port: build or load the
cached 50k index, adopt it as a ``MutableIndex`` on the card, stream
queries through the batched pHNSW service while upserting and deleting
under traffic, and report QPS, latency percentiles and recall against
the live set.

    PYTHONPATH=src python examples/serve_vector_search_torch.py \
        [--n 50000] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.bench.common import load_bench_db
from repro_torch.core.search_ref import recall_at
from repro_torch.data.vectors import make_queries, make_sift_like
from repro_torch.index import MutableIndex
from repro_torch.serve.vector_service import VectorSearchService


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--churn-batches", type=int, default=4,
                    help="upsert/delete batches interleaved mid-stream")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg, x, g, pca, x_low, q, gt = load_bench_db(
        args.n, min(args.queries, 200), device=args.device)
    if args.queries > len(q):
        q = make_queries(x, args.queries, seed=11)

    idx = MutableIndex.from_graph(g, pca, device=args.device)
    db = idx.db
    print(f"index: {idx.n_live} live points (capacity {idx.cap}) on "
          f"{idx.device}, layout(3) store {db.bytes_layout3 / 1e6:.0f} MB "
          f"({db.bytes_layout3 / (x.size * 4):.1f}x the raw data)")
    svc = VectorSearchService(idx, batch_size=args.batch,
                              device=args.device)

    # mixed workload: serve the stream, folding in upserts + deletes
    fresh = make_sift_like((args.churn_batches + 1) * cfg.insert_batch,
                           seed=123)
    # warm the insert probe and the first post-swap query before the
    # timed stream, as the service constructor warms the query path
    svc.upsert(fresh[:cfg.insert_batch])
    fresh = fresh[cfg.insert_batch:]
    svc.query(q[:args.batch])
    svc.stats.reset()
    rng = np.random.default_rng(5)
    outs = []
    epoch0 = svc.epoch
    churn_every = max(len(q) // args.batch // max(args.churn_batches, 1),
                      1)
    step = 0
    for i in range(0, len(q), args.batch):
        _, fi = svc.query(q[i:i + args.batch])
        outs.append(fi)
        if step % churn_every == churn_every - 1 and len(fresh):
            svc.upsert(fresh[:cfg.insert_batch])
            fresh = fresh[cfg.insert_batch:]
            live = idx.live_ids()
            svc.delete(rng.choice(live, cfg.insert_batch // 2,
                                  replace=False))
        step += 1
    idx_out = np.concatenate(outs, axis=0)

    # recall against the FINAL live set (tombstones excluded by search)
    gt_live = idx.live_ground_truth(q, cfg.recall_at)
    rec = float(np.mean([recall_at(idx_out[i], gt_live[i], cfg.recall_at)
                         for i in range(len(q))]))
    drift = idx.pca_drift()
    print(f"served {len(q)} queries in batches of {args.batch} "
          f"with {svc.stats.upserts} upserts + {svc.stats.deletes} "
          f"deletes interleaved (epoch {epoch0} -> {svc.epoch}): "
          f"{svc.stats.qps:.0f} QPS over the mixed stream, "
          f"p50 {svc.stats.percentile(50):.1f} ms, "
          f"p99 {svc.stats.percentile(99):.1f} ms per query batch, "
          f"recall@10 {rec:.3f} vs the live set")
    print(f"tombstones {idx.tombstone_frac:.1%} "
          f"(compaction at {cfg.compact_tombstone_frac:.0%}); "
          f"PCA drift {drift['drift']:+.4f} "
          f"(refit_recommended={drift['refit_recommended']})")


if __name__ == "__main__":
    main()
