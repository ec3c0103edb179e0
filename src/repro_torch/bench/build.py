"""Build throughput: the wave pipeline against the sequential oracle
(port of ``benchmarks/bench_build.py``).

    python -m repro_torch.bench.build [--device cuda|cpu] [--n-points N]
        [--queries Q] [--wave-size W] [--out FILE]

Rows (``name,us_per_call,derived``; us_per_call is per VECTOR):

  build/ref   — ``core.graph.build_hnsw_ref`` (host numpy) wall-clock;
                vps, recall@10 after the build, graph invariants.
  build/wave  — ``core.build.build_hnsw_wave`` (its probe on
                ``--device``, its linking on the host), timed after one
                warm build; vps, speedup against ref, recall after the
                build on the same queries (``search_torch.search_batched``
                on ``--device``), the invariants, and the structural
                cross-check: both builders share ``sample_levels``, so a
                seed gives the same levels and entry point.

``--out`` writes the rows and the reference's tracked keys (``wave_vps``,
``ref_vps``, ``speedup_vs_ref``, ``recall_at_10_wave``,
``recall_at_10_ref``, ``invariants_ok``, ``levels_match``) with the
device's name as JSON; nothing here writes ``BENCH_table3.json``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np

from repro_torch.bench.common import card, emit, recall_mean, synchronizer


def recall_after_build(g, x, pca, q, gt, at: int, device) -> float:
    """recall@``at`` of the batched pca search over ``g`` on ``device``,
    all queries in one batch."""
    from repro_torch.core.search_torch import build_packed, search_batched
    db = build_packed(g, pca.transform(x).astype(np.float32), device=device)
    _, fi = search_batched(db, np.asarray(q, np.float32), pca=pca,
                           device=device)
    return recall_mean(fi.cpu().numpy(), gt, at)


def run_build(cfg, x, pca, q, gt, *, wave_size: Optional[int] = None,
              seed: int = 0, device="cuda") -> dict:
    """Both builders over ``x`` with ``cfg``, then recall after each on
    ``q`` against ``gt``. Returns ``{"rows": [...], "entry": {...}}``:
    the CSV rows and the figures they print (the reference's tracked keys
    among them)."""
    from repro_torch.core.build import build_hnsw_wave, graph_invariants
    from repro_torch.core.graph import build_hnsw_ref
    sync = synchronizer(device)
    n = len(x)
    t0 = time.perf_counter()
    g_ref = build_hnsw_ref(x, cfg, seed=seed)
    t_ref = time.perf_counter() - t0
    # one warm build first: the timed one measures steady-state build
    # throughput, not the kernels' first launches
    build_hnsw_wave(x, cfg, seed=seed, wave_size=wave_size, device=device)
    sync()
    t0 = time.perf_counter()
    g_wave = build_hnsw_wave(x, cfg, seed=seed, wave_size=wave_size,
                             device=device)
    sync()
    t_wave = time.perf_counter() - t0

    inv_r, inv_w = graph_invariants(g_ref), graph_invariants(g_wave)
    rec_r = recall_after_build(g_ref, x, pca, q, gt, cfg.recall_at, device)
    rec_w = recall_after_build(g_wave, x, pca, q, gt, cfg.recall_at, device)
    lv_match = int((g_ref.levels == g_wave.levels).all())
    en_match = int(g_ref.entry == g_wave.entry)
    rows = [
        ("build/ref", t_ref / n * 1e6,
         f"vps={n / t_ref:.0f};recall@10={rec_r:.3f};"
         f"invariants={'ok' if inv_r['ok'] else 'FAIL'};"
         f"mean_deg0={inv_r['mean_degree'][0]:.1f}"),
        ("build/wave", t_wave / n * 1e6,
         f"vps={n / t_wave:.0f};recall@10={rec_w:.3f};"
         f"speedup_vs_ref={t_ref / t_wave:.2f};"
         f"recall_delta={rec_w - rec_r:+.4f};"
         f"invariants={'ok' if inv_w['ok'] else 'FAIL'};"
         f"mean_deg0={inv_w['mean_degree'][0]:.1f};"
         f"levels_match={lv_match};entry_match={en_match}"),
    ]
    entry = {"bench": "build", "n_points": n,
             "wave_size": wave_size or cfg.wave_size,
             "wave_vps": n / t_wave, "ref_vps": n / t_ref,
             "speedup_vs_ref": t_ref / t_wave,
             "recall_at_10_wave": rec_w, "recall_at_10_ref": rec_r,
             "recall_delta": rec_w - rec_r,
             "invariants_ok": bool(inv_w["ok"] and inv_r["ok"]),
             "levels_match": bool(lv_match), "entry_match": bool(en_match),
             "mean_deg0_ref": float(inv_r["mean_degree"][0]),
             "mean_deg0_wave": float(inv_w["mean_degree"][0]),
             "ref_s": t_ref, "wave_s": t_wave}
    return {"rows": rows, "entry": entry}


def bench_data(n_points: int, n_queries: int):
    """The reference bench's data: (cfg, x, pca, queries, ground truth) —
    ``SMALL`` at ``n_points``, fresh queries (seed 1) and their exact
    top-``recall_at``."""
    from repro_torch.configs.sift1m_phnsw import SMALL
    from repro_torch.core.pca import fit_pca
    from repro_torch.data.vectors import (brute_force_topk, make_queries,
                                          make_sift_like)
    cfg = SMALL.__class__(**{**SMALL.__dict__, "n_points": n_points,
                             "name": f"sift{n_points // 1000}k"})
    x = make_sift_like(cfg.n_points)
    q = make_queries(x, n_queries)
    gt = brute_force_topk(x, q, cfg.recall_at)
    return cfg, x, fit_pca(x, cfg.d_low), q, gt


def main(n_points: int = 8_000, n_queries: int = 64, *,
         wave_size: Optional[int] = None, seed: int = 0, device="cuda",
         out: Optional[str] = None):
    cfg, x, pca, q, gt = bench_data(n_points, n_queries)
    res = run_build(cfg, x, pca, q, gt, wave_size=wave_size, seed=seed,
                    device=device)
    emit(res["rows"], out, **res["entry"], queries=len(q), **card(device))
    return res


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-points", type=int, default=8_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--wave-size", type=int, default=None)
    ap.add_argument("--out", help="also write the rows and figures as JSON")
    args = ap.parse_args(argv)
    return main(args.n_points, args.queries, wave_size=args.wave_size,
                device=args.device, out=args.out)


if __name__ == "__main__":
    cli()
