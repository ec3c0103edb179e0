"""Quickstart on the PyTorch/CUDA port: build a pHNSW index, search it,
reproduce the paper's headline comparison.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The batched search runs on the card by default (``--device cuda``); the
wave builder's probe runs there too. The host oracle (Algorithm 1) and
the cost model are numpy on the host; the cost model's QPS and energy
are the PAPER's 65 nm processor's, not the card's.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import PHNSWConfig
from repro_torch.core import (build_hnsw, build_packed, fit_pca,
                              hw_variant_stats, recall_at, run_queries,
                              search_batched, table3)
from repro_torch.data.vectors import (brute_force_topk, make_queries,
                                      make_sift_like)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8_000)
    args = ap.parse_args()
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    N = args.n
    print(f"1. dataset: {N} SIFT-like 128-dim vectors")
    x = make_sift_like(N)
    q = make_queries(x, 64)
    gt = brute_force_topk(x, q, 10)

    print("2. build: six-layer HNSW graph (paper C phase) + PCA 128->15")
    cfg = PHNSWConfig(name="quickstart", n_points=N, ef_construction=60)
    t0 = time.time()
    g = build_hnsw(x, cfg, device=dev)
    pca = fit_pca(x, cfg.d_low)
    x_low = pca.transform(x).astype(np.float32)
    print(f"   built in {time.time() - t0:.1f}s; "
          f"PCA-15 keeps {pca.explained.sum():.0%} of variance")

    print("3. search: standard HNSW vs pHNSW (Algorithm 1, host oracle)")
    r_h, st_h = run_queries(g, q, gt, algo="hnsw", hw_mode=True)
    r_p, st_p = run_queries(g, q, gt, algo="phnsw", x_low=x_low, pca=pca)
    print(f"   recall@10: HNSW {r_h:.3f} | pHNSW {r_p:.3f} "
          f"(paper: filtering costs ~no recall)")
    print(f"   high-dim distance computations per query: "
          f"{st_h.dist_high // len(q)} -> {st_p.dist_high // len(q)} "
          f"({st_h.dist_high / st_p.dist_high:.1f}x fewer)")

    print("4. the paper's processor cost model (Table III, DDR4/HBM):")
    _, st_s = run_queries(g, q, gt, algo="phnsw", x_low=x_low, pca=pca,
                          layout="separate")
    t3 = table3(hw_variant_stats(st_h, st_p, st_s), n_queries=len(q),
                dim=128, d_low=cfg.d_low)
    for v in ("HNSW-Std", "pHNSW-Sep", "pHNSW"):
        row = "   " + v.ljust(10)
        for d in ("DDR4", "HBM"):
            c = t3[v][d]
            row += f" | {d} {c.qps:>9.0f} QPS {c.energy_uj:6.2f} uJ"
        print(row)

    print(f"5. batched search on {dev}:")
    db = build_packed(g, x_low, device=dev)
    qd = torch.as_tensor(q, device=dev)
    search_batched(db, qd, pca=pca, device=dev)
    sync()
    t0 = time.time()
    _, fi = search_batched(db, qd, pca=pca, device=dev)
    sync()
    dt = time.time() - t0
    fi = fi.cpu().numpy()
    rec = float(np.mean([recall_at(fi[i], gt[i], 10)
                         for i in range(len(q))]))
    print(f"   {len(q) / dt:.0f} QPS, recall@10 {rec:.3f}")
    print("done.")


if __name__ == "__main__":
    main()
