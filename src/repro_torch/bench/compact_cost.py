"""Seconds of ``MutableIndex.compact()`` (a host loop per node) at a
given size and tombstone share.

    python -m repro_torch.bench.compact_cost [--n N] [--frac F]
                                             [--device cpu|cuda] [--seed S]

Builds the SIFT1M-shaped config's graph over ``N`` SIFT-like points
(seed ``S``, the wave builder's probe on ``--device``), adopts it as a
``MutableIndex`` with a fitted PCA, deletes a seeded ``F`` share of the
points without compaction, then times ``compact()`` on the host clock.
Prints one JSON line: the build and compaction seconds, the sizes before
and after, and the host's CPU count. The graph repair and the remap run
in numpy on the host whatever the device; the device only receives the
republished buffers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--frac", type=float, default=0.25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from repro_torch.configs.sift1m_phnsw import CONFIG
    from repro_torch.core.graph import build_hnsw
    from repro_torch.core.pca import fit_pca
    from repro_torch.data.vectors import make_sift_like
    from repro_torch.index import MutableIndex
    cfg = dataclasses.replace(CONFIG, n_points=args.n)
    x = make_sift_like(args.n, seed=args.seed)
    t0 = time.perf_counter()
    g = build_hnsw(x, cfg, seed=args.seed, device=args.device)
    t_build = time.perf_counter() - t0
    idx = MutableIndex.from_graph(g, fit_pca(x, cfg.d_low),
                                  seed=args.seed + 1, device=args.device)
    rng = np.random.default_rng(args.seed + 2)
    doomed = rng.choice(args.n, int(args.frac * args.n), replace=False)
    idx.delete(doomed, auto_compact=False)
    t0 = time.perf_counter()
    rep = idx.compact()
    out = {"bench": "compact_cost", "device": args.device,
           "n_points": args.n, "deleted": int(len(doomed)),
           "build_seconds": t_build,
           "compact_seconds": time.perf_counter() - t0,
           "n_after": rep["n_after"], "capacity_after": rep["capacity"],
           "host_cpus": os.cpu_count()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
