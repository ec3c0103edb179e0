#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--n N] [--queries Q] [--batch B] [--seed S]

Phases, each printing one JSON object per line; any failure exits
non-zero:

  1. device   — ``nvidia-smi`` name and power limit, torch's device name;
  2. build    — ``nvcc`` builds the three kernels from ``kernels/csrc``
                (one process per source, started together);
  3. kernels  — each kernel at the main path's shapes (B=1024 for search,
                2048 for the build probe) plus edge rows, held against its
                plain PyTorch version on the card (indices and distances
                exact on integer-valued inputs, distances to rtol 1e-5 /
                atol 1e-3 on float inputs: the f32 summation order
                differs); kernel, plain and library times from CUDA-graph
                replays timed with CUDA events;
  4. build    — the wave builder at the paper's SIFT1M configuration
                (``--n`` points), ``graph_invariants`` must hold;
  5. search   — PCA-15, layout (3) on the card, ``--queries`` queries in
                batches of ``--batch``: QPS, recall@10 (must be >= 0.80),
                ``steps_mean``, ``dist_h_mean``;
  6. parity   — on the 8k bench fixture, the same graph packed on the card
                and on the CPU: bit-identical ids, dists, steps and Dist.H
                counts on integer-valued data, recall within 0.005 and ids
                equal for >= 99% of queries on float data;
  7. the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
     ``{"ok": true, "device": {...}}``.

Launch counts are reset just before each main-path phase (4 and 5) and
read just after; every kernel of the phase must have launched. It needs
no network and one card, and exits non-zero without CUDA or without the
``src/repro_torch`` package beside it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIME_LIMIT_S = 1200
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# f32 rate outside the tensor cores, used for each kernel's bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# SIFT1M is 1M points; the smoke builds 200k by default. The wave
# builder's linking runs in numpy on the host (the reference's
# arithmetic, kept so the graph can be held bit-for-bit against it) and
# takes ~93% of the build: a 1M build does not fit a third of the time
# limit, 200k does (PERF.md, "Cells").
FULL_N = 1_000_000
DEFAULT_N = 200_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------ timing -------------------------------------

def graph_ms(torch, fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between two CUDA events — no
    host launch overhead in the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


def bound_ms(nbytes: float, ops: float) -> tuple:
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


# ------------------------------ kernels ------------------------------------

def _expand_case(np, rng, B, M, dl, integer):
    if integer:
        x = rng.integers(0, 16, (B, M, dl)).astype(np.float32)
        q = rng.integers(0, 16, (B, dl)).astype(np.float32)
        th = np.where(rng.random(B) < 0.5, 4.0 * 16 * dl, 3.4e38)
    else:
        x = rng.standard_normal((B, M, dl)).astype(np.float32)
        q = rng.standard_normal((B, dl)).astype(np.float32)
        th = np.where(rng.random(B) < 0.5, 2.0 * dl, 3.4e38)
    valid = rng.random((B, M)) < 0.8
    if integer and B >= 8:
        # edge rows: all invalid, all-equal distances, every slot above
        # the threshold (all INF pads)
        valid[0] = False
        x[1] = x[1, :1]
        valid[1] = True
        th[2] = 0.0
    return x, q, valid, th.astype(np.float32)


def _merge_case(np, rng, B, Na, Nb, integer):
    pool = rng.integers(0, 8, 16) if integer else rng.standard_normal(16)
    a = np.sort(rng.choice(pool, (B, Na)), 1).astype(np.float32)
    b = np.sort(rng.choice(pool, (B, Nb)), 1).astype(np.float32)
    if B >= 4:
        a[0, Na // 2:] = 3.4e38           # INF pads on both sides
        b[1, :] = 3.4e38
        a[2, :], b[2, :] = 1.0, 1.0        # all equal: a side, then slot
    ia = rng.integers(0, 1 << 20, (B, Na)).astype(np.int32)
    ib = rng.integers(0, 1 << 20, (B, Nb)).astype(np.int32)
    return a, ia, b, ib


def _library_expand(torch, x, q, valid, th, k):
    """The fused expand as library calls: distances, mask, stable sort."""
    d = ((x - q[:, None]) ** 2).sum(-1)
    d = torch.where(valid & (d < th[:, None]), d, 3.4e38)
    return torch.sort(d, dim=1, stable=True)[0][:, :k]


def phase_kernels(torch, np, seed: int, device: str = "cuda") -> dict:
    from repro_torch.kernels import ops, ref
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    T = lambda *arrs: [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in arrs]
    results = {}

    def compare(name, shape, got, want, exact):
        gd, gi = got if isinstance(got, tuple) else (got, None)
        wd, wi = want if isinstance(want, tuple) else (want, None)
        torch.cuda.synchronize()
        err = float((gd - wd).abs().max()) if gd.numel() else 0.0
        if exact:
            need(torch.equal(gd, wd), f"{name}{shape}: distances differ "
                 f"from the plain version on exact inputs (max {err})")
        else:
            need(torch.allclose(gd, wd, rtol=1e-5, atol=1e-3),
                 f"{name}{shape}: max abs err {err} vs plain")
        if gi is not None and exact:
            need(torch.equal(gi, wi), f"{name}{shape}: indices differ")
        return err

    # --- fused_expand: search layers 0 / 1 / 2+ (M, k) at dl = 15 ---
    fe_shapes = [(1024, 32, 15, 16), (1024, 16, 15, 8), (1024, 16, 15, 3),
                 (1024, 32, 15, 1), (1024, 64, 15, 32)]
    for B, M, dl, k in fe_shapes:
        errs = []
        for integer in (True, False):
            x, q, v, th = T(*_expand_case(np, rng, B, M, dl, integer))
            errs.append(compare("fused_expand", (B, M, dl, k),
                                ops.fused_expand(x, q, v, th, k),
                                ref.fused_expand_ref(x, q, v, th, k),
                                integer))
        nbytes = B * M * dl * 4 + B * dl * 4 + B * M + B * 4 + B * k * 8
        nops = B * M * dl * 3 + B * M * M
        results[("fused_expand", (B, M, dl, k))] = dict(
            max_abs_err=max(errs),
            ms=graph_ms(torch, lambda: ops.fused_expand(x, q, v, th, k)),
            plain_ms=graph_ms(torch, lambda: ref.fused_expand_ref(
                x, q, v, th, k)),
            library_ms=graph_ms(torch, lambda: _library_expand(
                torch, x, q, v, th, k)),
            bound=bound_ms(nbytes, nops))

    # --- merge_sorted: search L0 F/C/Cp, L1 C, L2+ C, probe F/C ---
    mg_shapes = [(1024, 10, 10, 10), (1024, 26, 16, 26), (1024, 16, 16, 16),
                 (1024, 9, 8, 9), (1024, 8, 3, 8), (1024, 1, 1, 1),
                 (2048, 100, 32, 100), (2048, 132, 32, 132),
                 (2048, 32, 16, 32)]
    for B, Na, Nb, k in mg_shapes:
        errs = []
        for integer in (True, False):
            a, ia, b, ib = T(*_merge_case(np, rng, B, Na, Nb, integer))
            errs.append(compare("merge_sorted", (B, Na, Nb, k),
                                ops.merge_topk_sorted(a, ia, b, ib, k),
                                ref.merge_topk_sorted_ref(a, ia, b, ib, k),
                                True))
        nbytes = B * (Na + Nb) * 8 + B * k * 8
        nops = B * (Na * max(Nb, 1).bit_length()
                    + Nb * max(Na, 1).bit_length())
        results[("merge_sorted", (B, Na, Nb, k))] = dict(
            max_abs_err=max(errs),
            ms=graph_ms(torch, lambda: ops.merge_topk_sorted(a, ia, b, ib,
                                                             k)),
            plain_ms=graph_ms(torch, lambda: ref.merge_topk_sorted_ref(
                a, ia, b, ib, k)),
            library_ms=graph_ms(torch, lambda: torch.sort(
                torch.cat([a, b], 1), dim=1, stable=True)[0][:, :k]),
            bound=bound_ms(nbytes, nops))

    # --- dist_h: search K = 16/8/3 and the entry (1); probe K = 32/16 ---
    dh_shapes = [(1024, 16, 128), (1024, 8, 128), (1024, 3, 128),
                 (1024, 1, 128), (2048, 32, 128), (2048, 16, 128)]
    for B, K, D in dh_shapes:
        errs = []
        for integer in (True, False):
            if integer:
                xn = rng.integers(0, 220, (B, K, D)).astype(np.float32)
                qn = rng.integers(0, 220, (B, D)).astype(np.float32)
            else:
                xn = rng.standard_normal((B, K, D)).astype(np.float32)
                qn = rng.standard_normal((B, D)).astype(np.float32)
            x, q = T(xn, qn)
            errs.append(compare("dist_h", (B, K, D), ops.dist_h(x, q),
                                ref.dist_h_ref(x, q), integer))
        results[("dist_h", (B, K, D))] = dict(
            max_abs_err=max(errs),
            ms=graph_ms(torch, lambda: ops.dist_h(x, q)),
            plain_ms=graph_ms(torch, lambda: ref.dist_h_ref(x, q)),
            library_ms=graph_ms(torch, lambda: ((x - q[:, None]) ** 2)
                                .sum(-1)),
            bound=bound_ms(B * K * D * 4 + B * D * 4 + B * K * 4,
                           B * K * D * 3))
    for (name, shape), r in results.items():
        emit({"phase": "kernel", "name": name, "shape": list(shape),
              "max_abs_err": r["max_abs_err"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1]})
    return results


# --------------------------- main-path phases ------------------------------

def run_build(torch, np, n: int, seed: int, device: str):
    from repro_torch.configs.sift1m_phnsw import CONFIG
    from repro_torch.core.build import graph_invariants
    from repro_torch.core.graph import build_hnsw
    from repro_torch.data.vectors import make_sift_like
    from repro_torch.kernels import ops
    import dataclasses
    cfg = dataclasses.replace(CONFIG, n_points=n)
    x = make_sift_like(n, seed=seed)
    timings = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    g = build_hnsw(x, cfg, seed=seed, device=device, timings=timings)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    inv = graph_invariants(g)
    out = {"phase": "build", "n_points": n, "seconds": secs,
           "vec_per_s": n / secs, "invariants_ok": inv["ok"],
           "violations": inv["violations"][:5],
           "reachable_frac": inv["reachable_frac"],
           "mean_degree": inv["mean_degree"],
           "levels_max": int(g.levels.max()), "entry": int(g.entry),
           "stage_seconds": timings, "launches": counts}
    return x, g, out


def recall_at_10(fi, gt) -> float:
    return float(sum(len(set(a[:10].tolist()) & set(b[:10].tolist()))
                     for a, b in zip(fi, gt)) / (10 * len(gt)))


def ground_truth(torch, x, q, k: int, device: str):
    """Exact top-k by squared L2 in f32, chunked matmul on ``device``."""
    xt = torch.as_tensor(x, device=device)
    n2 = (xt * xt).sum(1)
    out = []
    for i in range(0, len(q), 1024):
        qt = torch.as_tensor(q[i:i + 1024], device=device)
        d = n2[None, :] - 2.0 * (qt @ xt.T)
        out.append(torch.topk(d, k, dim=1, largest=False).indices.cpu())
    return torch.cat(out).numpy()


def run_search(torch, np, x, g, n_queries: int, batch: int, seed: int,
               device: str):
    from repro_torch.core.pca import fit_pca
    from repro_torch.core.search_torch import build_packed, search_batched
    from repro_torch.data.vectors import make_queries
    from repro_torch.kernels import ops
    pca = fit_pca(x, g.cfg.d_low)
    t0 = time.perf_counter()
    db = build_packed(g, pca.transform(x).astype(np.float32), device=device)
    pack_s = time.perf_counter() - t0
    q = make_queries(x, n_queries, seed=seed + 1)
    gt = ground_truth(torch, x, q, 10, device)
    search_batched(db, q[:batch], pca=pca, device=device)      # warm-up
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fis, steps, dhe = [], [], []
    for i in range(0, n_queries, batch):
        _, fi, st = search_batched(db, q[i:i + batch], pca=pca,
                                   return_stats=True, device=device)
        fis.append(fi)
        steps.append(st["steps_total"])
        dhe.append(st["dist_h_evals"])
    sync()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    fi = torch.cat(fis).cpu().numpy()
    prof = profile_batch(torch, lambda: search_batched(
        db, q[:batch], pca=pca, device=device)) if device == "cuda" else None
    return {"phase": "search", "n_points": len(x), "queries": n_queries,
            "batch": batch, "seconds": secs, "qps": n_queries / secs,
            "recall_at_10": recall_at_10(fi, gt),
            "steps_mean": float(torch.cat(steps).float().mean()),
            "dist_h_mean": float(torch.cat(dhe).float().mean()),
            "pack_seconds": pack_s,
            "bytes_layout3": db.bytes_layout3,
            "bytes_layout4": db.bytes_layout4,
            "launches": counts, "profile_one_batch": prof}


def profile_batch(torch, fn, top: int = 10) -> dict:
    """One extra call of ``fn`` under torch.profiler: device time by
    kernel name and the device's busy share of the profiled window (the
    profiler slows the host, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((float(us), e.key, int(e.count)))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    ported = {n: sum(us for us, k, _ in rows if f"{n}_kernel" in k) / 1e3
              for n in ("fused_expand", "merge_sorted", "dist_h")}
    return {"wall_ms": wall * 1e3, "device_ms": busy_ms,
            "busy_share": busy_ms / (wall * 1e3),
            "launches": sum(r[2] for r in rows),
            "ported_kernels_ms": ported,
            "top": [{"kernel": k[:80], "ms": us / 1e3, "count": c}
                    for us, k, c in rows[:top]]}


def run_parity(torch, np, seed: int = 0, device: str = "cuda") -> dict:
    """The 8k bench fixture (SIFT50k-shaped config at 8000 points, seed
    0, 200 queries): one graph, built on ``device``, packed on ``device``
    and on the CPU."""
    import dataclasses
    from repro_torch.configs.sift1m_phnsw import SMALL
    from repro_torch.core.graph import HNSWGraph, build_hnsw
    from repro_torch.core.pca import fit_pca
    from repro_torch.core.search_torch import build_packed, search_batched
    from repro_torch.data.vectors import (brute_force_topk, make_queries,
                                          make_sift_like)
    cfg = dataclasses.replace(SMALL, n_points=8000, name="sift8k")
    x = make_sift_like(8000, seed=seed)
    q = make_queries(x, 200, seed=seed + 1)
    gt = brute_force_topk(x, q, 10)
    g = build_hnsw(x, cfg, seed=seed, device=device)
    pca = fit_pca(x, cfg.d_low)
    xl = pca.transform(x).astype(np.float32)
    res, outs = {}, {}
    for dev in (device, "cpu"):
        db = build_packed(g, xl, device=dev)
        fd, fi, st = search_batched(db, q, pca=pca, return_stats=True,
                                    device=dev)
        res[dev] = (fd.cpu().numpy(), fi.cpu().numpy(),
                    st["dist_h_evals"].cpu().numpy())
    card, host = res[device], res["cpu"]
    rec_card, rec_host = recall_at_10(card[1], gt), recall_at_10(host[1], gt)
    rec64 = recall_at_10(card[1][:64], gt[:64])
    dhe64 = float(card[2][:64].mean())
    same = float((card[1] == host[1]).all(1).mean())
    need(abs(rec_card - rec_host) <= 0.005,
         f"8k float parity: recall card {rec_card} vs cpu {rec_host}")
    need(same >= 0.99, f"8k float parity: ids equal for {same:.4f} < 0.99")
    # integer-valued fixture: every f32 sum exact in any order
    xi = np.round(x)
    qi = np.round(q)
    gi = HNSWGraph(cfg=cfg, x=xi, levels=g.levels, layers=g.layers,
                   entry=g.entry)
    xli = np.round(pca.transform(xi)).astype(np.float32)
    qpi = np.round(pca.transform(qi)).astype(np.float32)
    for dev in (device, "cpu"):
        db = build_packed(gi, xli, device=dev)
        fd, fi, st = search_batched(db, qi, qpi, return_stats=True,
                                    device=dev)
        outs[dev] = [fd.cpu(), fi.cpu(), st["steps_per_layer"].cpu(),
                     st["dist_h_evals"].cpu()]
    bit = all(torch.equal(a, b) for a, b in zip(outs[device], outs["cpu"]))
    need(bit, "8k integer parity: card and CPU differ")
    return {"phase": "parity_8k", "recall_card": rec_card,
            "recall_cpu": rec_host, "recall_first64_card": rec64,
            "ids_equal_frac": same,
            "dist_h_mean_card": float(card[2].mean()),
            "dist_h_mean_first64_card": dhe64,
            "tracked_filters_pca": {"recall": 0.9984, "dist_h_mean": 48.9},
            "integer_bit_identical": bit}


# --------------------------------- main ------------------------------------

KERNEL_META = {
    "fused_expand": ("cuda", "src/repro_torch/kernels/csrc/fused_expand.cu",
                     "src/repro/kernels/fused_filter.py:91",
                     (1024, 32, 15, 16)),
    "merge_sorted": ("cuda", "src/repro_torch/kernels/csrc/merge_sorted.cu",
                     "src/repro/kernels/merge_sorted.py:52",
                     (1024, 26, 16, 26)),
    "dist_h": ("cuda", "src/repro_torch/kernels/csrc/dist_h.cu",
               "src/repro/kernels/dist_h.py:21", (1024, 16, 128)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=DEFAULT_N,
                    help="points in the SIFT1M-shaped build and search")
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_device": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build_kernels", "seconds": time.perf_counter() - t0,
          "sources": built})

    kres = phase_kernels(torch, np, args.seed)

    x, g, bout = run_build(torch, np, args.n, args.seed, "cuda")
    emit(bout)
    need(bout["invariants_ok"], f"graph invariants: {bout['violations']}")
    for name in ("merge_sorted", "dist_h"):
        need(bout["launches"][name] > 0, f"build never launched {name}")
    if args.n < FULL_N:
        emit({"reduced": {"n_points": args.n, "of": FULL_N, "why": (
            "the wave builder links on the host in numpy (the "
            "reference's arithmetic); a 1M build does not fit a third "
            f"of the {TIME_LIMIT_S} s smoke limit")}})

    sout = run_search(torch, np, x, g, args.queries, args.batch, args.seed,
                      "cuda")
    emit(sout)
    for name, c in sout["launches"].items():
        need(c > 0, f"search never launched {name}")
    need(sout["recall_at_10"] >= 0.80,
         f"recall@10 {sout['recall_at_10']} < 0.80")
    del x, g

    emit(run_parity(torch, np))

    rows = []
    for name, (route, src, replaces, shape) in KERNEL_META.items():
        r = kres[(name, shape)]
        rows.append({"name": name, "route": route, "source": src,
                     "replaces": replaces, "shape": list(shape),
                     "launches": bout["launches"][name]
                     + sout["launches"][name],
                     "launches_build": bout["launches"][name],
                     "launches_search": sout["launches"][name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1],
                     "library_ms": r["library_ms"]})
    emit({"total_seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
