"""Serving launcher (port of ``repro/launch/serve.py``): LM generation
or pHNSW vector search, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --vector \\
      --n-points 8000 --cache-dir experiments/data
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS


@torch.no_grad()
def serve_lm(args):
    """Generate ``--max-new`` tokens for a synthetic batch with a seeded
    model (``--smoke``: the arch's reduced config); returns the
    ``GenerationResult``."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.tokens import batch_extras_for, synthetic_batch
    from repro_torch.models import get_model
    from repro_torch.models.common import dtype_of
    from repro_torch.serve.engine import GenerationEngine

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = get_model(cfg).init(gen, dev)
    eng = GenerationEngine(cfg, model, max_new=args.max_new,
                           temperature=args.temperature, seed=args.seed,
                           device=dev)
    batch = synthetic_batch(args.seed, 0, args.batch, args.prompt_len,
                            cfg.vocab, extras=batch_extras_for(cfg))
    batch.pop("labels")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    for k in ("frames", "patches"):      # the frontend stubs' outputs
        if k in batch:
            batch[k] = batch[k].to(dtype_of(cfg))
    res = eng.generate(batch)
    print(f"[serve] {cfg.name} on {dev}: batch={args.batch} "
          f"prompt={args.prompt_len} new={res.steps}: prefill "
          f"{res.prefill_s:.2f}s, decode {res.decode_s:.2f}s "
          f"({res.tokens_per_s:.1f} tok/s)")
    print(f"[serve] sample tokens: {res.tokens[0][:16].tolist()}")
    return res


@torch.no_grad()
def serve_vectors(args):
    """Build (or load from ``--cache-dir``) a graph over ``--n-points``
    SIFT-like vectors, serve ``--n-queries`` through the batched
    service's stream; returns (ids, stats)."""
    from repro_torch.configs.base import PHNSWConfig
    from repro_torch.core.graph import cached_graph
    from repro_torch.core.pca import fit_pca
    from repro_torch.core.search_torch import build_packed
    from repro_torch.data.vectors import make_queries, make_sift_like
    from repro_torch.serve.vector_service import VectorSearchService

    cfg = PHNSWConfig(name=f"serve{args.n_points}", n_points=args.n_points,
                      ef_construction=60)
    x = make_sift_like(args.n_points)
    g = cached_graph(x, cfg, args.cache_dir, device=args.device)
    pca = fit_pca(x, cfg.d_low)
    db = build_packed(g, pca.transform(x).astype(np.float32),
                      device=args.device)
    svc = VectorSearchService(db, pca, batch_size=args.batch,
                              device=args.device)
    queries = make_queries(x, args.n_queries)
    idx, stats = svc.run_stream(queries)
    print(f"[serve] {args.n_queries} queries on {args.device}: "
          f"{stats['qps']:.0f} QPS, p50 {stats['p50_ms']:.1f}ms, "
          f"p99 {stats['p99_ms']:.1f}ms")
    return idx, stats


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vector", action="store_true")
    ap.add_argument("--arch", default="starcoder2-3b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-points", type=int, default=8000)
    ap.add_argument("--n-queries", type=int, default=256)
    ap.add_argument("--cache-dir", default="experiments/data",
                    help="where the vector graph is cached")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.vector:
        serve_vectors(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
