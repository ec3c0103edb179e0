"""Open-loop latency under load: the synchronous service against the
continuous-batching scheduler (port of ``benchmarks/bench_load.py``).

    python -m repro_torch.bench.load [--device cuda|cpu] [--n N]
        [--requests K] [--out FILE]

A closed loop (the next request starts when the previous one ends)
measures capacity but hides queueing; a service is OPEN-loop: requests
arrive on their own clock, and the latency an operator sees includes the
wait in the queue. The protocol:

1. **Capacity** in a closed loop of ``req_size`` (16) query requests
   through the service (64 rows a batch, underfull batches padded), and
   tracing on against off, interleaved rep by rep on the same service.
2. **Offered-load points**: for each fraction of capacity, seeded
   Poisson arrivals at that request rate (``--requests`` of them, 0.5
   and 0.9 of capacity); each request is served at its
   scheduled arrival (or as soon as the server frees up) and its latency
   runs from the scheduled arrival, queue wait included. Both arms serve
   at the same fixed width: the synchronous arm pads each request's dead
   lanes up to the service's width, the scheduler arm (as many
   slots) packs queries of different requests into one bank. The
   ``sync_tight`` row is a service whose width is the request size (no
   padding), at 0.8 of its own capacity. ``mixed_k`` is ragged traffic
   (1 to ``req_size`` queries a request, k drawn from {1, 10, 100})
   through one ``ef=100`` scheduler.
3. **Exact sample percentiles** (``numpy.percentile`` of the raw
   latencies); the samples also land in the obs histograms.
4. **The cost bridge**: one ``return_stats`` batch folded through
   ``obs.record_search_stats`` (measured against predicted us/query).

Rows print as ``name,us,derived`` CSV; ``--out`` writes them and the
points as JSON. Nothing here writes ``BENCH_table3.json``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np


def _closed_loop(svc, batches, reps: int) -> float:
    """Back-to-back serving; returns queries/second."""
    n_q = 0
    t0 = time.perf_counter()
    for _ in range(reps):
        for b in batches:
            svc.query(b)
            n_q += len(b)
    return n_q / (time.perf_counter() - t0)


def _overhead_ab(svc, batches, tracer, reps: int = 4) -> dict:
    """Traced against untraced closed loops on the SAME service,
    alternating rep by rep so drift hits both arms alike."""
    from repro_torch.obs.trace import NULL_TRACER
    t = {True: 0.0, False: 0.0}
    n = {True: 0, False: 0}
    for r in range(2 * reps):
        traced = r % 2 == 0
        svc.tracer = tracer if traced else NULL_TRACER
        t0 = time.perf_counter()
        for b in batches:
            svc.query(b)
        t[traced] += time.perf_counter() - t0
        n[traced] += sum(len(b) for b in batches)
    svc.tracer = NULL_TRACER
    on, off = n[True] / t[True], n[False] / t[False]
    return {"qps_traced": on, "qps_untraced": off,
            "overhead_ratio": on / off}


def _percentiles(lats) -> dict:
    if not len(lats):
        return {"p50_ms": 0.0, "p99_ms": 0.0, "p999_ms": 0.0,
                "mean_ms": 0.0}
    return {"p50_ms": float(np.percentile(lats, 50)),
            "p99_ms": float(np.percentile(lats, 99)),
            "p999_ms": float(np.percentile(lats, 99.9)),
            "mean_ms": float(np.mean(lats))}


def open_loop_sync(svc, rng, q, req_size: int, rate_rps: float,
                   n_requests: int, hist) -> dict:
    """One offered-load point of the synchronous arm: Poisson arrivals
    at ``rate_rps`` requests/second, latency from the scheduled arrival
    (no coordinated omission)."""
    gaps = rng.exponential(1.0 / rate_rps, n_requests)
    picks = rng.integers(0, len(q) - req_size + 1, n_requests)
    lats = []
    t_start = time.perf_counter()
    for t_a, p in zip(t_start + np.cumsum(gaps), picks):
        now = time.perf_counter()
        if t_a > now:
            time.sleep(t_a - now)
        svc.query(q[p:p + req_size])
        ms = (time.perf_counter() - t_a) * 1e3
        lats.append(ms)
        hist.observe(ms)
    span_s = time.perf_counter() - t_start
    return {"offered_qps": rate_rps * req_size,
            "achieved_qps": len(lats) * req_size / span_s,
            "n_requests": len(lats), **_percentiles(lats)}


def _recall_at(ids_row, gt_row, k: int) -> float:
    m = min(k, len(gt_row))
    return len(set(np.asarray(ids_row[:m]).tolist())
               & set(np.asarray(gt_row[:m]).tolist())) / m


def open_loop_sched(sched, rng, q, req_size: int, rate_rps: float,
                    n_requests: int, hist, *, gt=None, k_mix=None,
                    ragged: bool = False) -> dict:
    """One offered-load point of the scheduler arm: the same Poisson
    arrivals, each request's queries SUBMITTED at the scheduled arrival
    and the scheduler ticking while the clock waits; a request's latency
    is its LAST query's retirement, from the scheduled arrival.
    ``k_mix`` ((ks, p)) draws a seeded k per query and ``ragged`` a
    request size in [1, req_size]. Adds recall (with ``gt``) and the
    requests shed."""
    gaps = rng.exponential(1.0 / rate_rps, n_requests)
    sizes = (rng.integers(1, req_size + 1, n_requests) if ragged
             else np.full(n_requests, req_size))
    picks = rng.integers(0, len(q) - req_size, n_requests)
    n_q_total = int(sizes.sum())
    ks = (rng.choice(k_mix[0], size=n_q_total, p=k_mix[1])
          if k_mix is not None else np.full(n_q_total, 10))
    remaining, worst_ms, rid2req, qmeta = {}, {}, {}, {}
    recalls, lats = [], []

    def absorb(comps):
        for c in comps:
            r = rid2req.pop(c.rid)
            remaining[r] -= 1
            worst_ms[r] = max(worst_ms[r], c.latency_ms)
            if gt is not None:
                row, kq = qmeta.pop(c.rid)
                recalls.append(_recall_at(c.ids, gt[row], kq))
            if remaining[r] == 0:
                lats.append(worst_ms[r])
                hist.observe(worst_ms[r])

    shed = sched.svc.stats.registry.get("phnsw_sched_shed_total")
    n_shed = lambda: sum(c.value for c in shed.children()) if shed else 0
    shed_before = n_shed()
    t0 = time.monotonic()
    arrivals = t0 + np.cumsum(gaps)
    rid = qi = 0
    for i in range(n_requests):
        t_a = arrivals[i]
        while True:
            now = time.monotonic()
            if now >= t_a:
                break
            if sched.in_flight or sched.queue_depth:
                absorb(sched.tick())
            else:
                time.sleep(min(t_a - now, 5e-4))
        remaining[i], worst_ms[i] = 0, 0.0
        for j in range(int(sizes[i])):
            kq = int(ks[qi])
            if sched.submit(q[picks[i] + j], k=kq, rid=rid,
                            t_sched=t_a) is not None:
                rid2req[rid] = i
                qmeta[rid] = (picks[i] + j, kq)
                remaining[i] += 1
            rid += 1
            qi += 1
        if remaining[i] == 0:
            del remaining[i], worst_ms[i]
        # when arrivals outrun service, keep serving while admitting
        if sched.queue_depth >= sched.S:
            absorb(sched.tick())
    absorb(sched.drain())
    span_s = time.monotonic() - t0
    n_shed_now = n_shed() - shed_before
    pt = {"offered_qps": rate_rps * float(sizes.mean()),
          "achieved_qps": (n_q_total - n_shed_now) / span_s,
          "n_requests": len(lats), **_percentiles(lats),
          "shed": int(n_shed_now)}
    if gt is not None:
        pt["recall"] = float(np.mean(recalls)) if recalls else 0.0
    return pt


def _row(name, pt, keys):
    return (name, pt["p50_ms"] * 1e3,
            ";".join(f"{k}={pt[k]:.3f}" if isinstance(pt[k], float)
                     else f"{k}={pt[k]}" for k in keys))


def run_load(svc, q, gt, *, req_size: int = 16,
             offered_fracs: Sequence[float] = (0.5, 0.9),
             n_requests: int = 120, calib_reps: int = 6, seed: int = 0,
             mixed_k: bool = True,
             point_seconds: Optional[float] = None) -> dict:
    """The whole protocol on a built service ``svc`` (its batch size is
    the fixed width both arms serve at; the scheduler gets as many
    slots) over queries ``q`` with ground truth ``gt``. Each point
    offers ``n_requests`` requests, or with ``point_seconds`` as many as
    arrive in that time at its rate (at least 20). Returns ``{"rows":
    [...], "entry": {...}}``: the CSV rows and every point's numbers."""
    from repro_torch.core.search_torch import search_batched, \
        slot_cache_sizes
    from repro_torch.obs import (Registry, Tracer, parse_prometheus,
                                 prometheus_families, record_search_stats,
                                 to_prometheus)
    from repro_torch.serve.vector_service import VectorSearchService

    rng = np.random.default_rng(seed)
    reg = svc.stats.registry
    count = lambda rate: n_requests if point_seconds is None \
        else max(20, int(rate * point_seconds))
    svc_batch = svc.batch
    rows = []
    batches = [q[i:i + req_size]
               for i in range(0, len(q) - req_size + 1, req_size)]
    _closed_loop(svc, batches, 1)                         # warm
    cap_qps = _closed_loop(svc, batches, calib_reps)
    rows.append(("load/capacity", 1e6 / cap_qps,
                 f"qps={cap_qps:.1f};req_size={req_size};"
                 f"svc_batch={svc_batch};closed_loop=1"))
    # the width tailored to the request size: no padded lanes
    backing = next(b for b in (svc.index, svc.sindex, svc.sdb, svc.db)
                   if b is not None)
    svc_tight = VectorSearchService(backing, filt=svc.filt,
                                    batch_size=req_size, ef0=svc.ef0,
                                    registry=Registry(), device=svc.device)
    _closed_loop(svc_tight, batches, 1)
    cap_tight = _closed_loop(svc_tight, batches, calib_reps)
    rows.append(("load/capacity_tight", 1e6 / cap_tight,
                 f"qps={cap_tight:.1f};req_size={req_size};"
                 f"svc_batch={req_size};closed_loop=1"))
    ab = _overhead_ab(svc, batches, Tracer())
    rows.append(("obs/overhead", 0.0,
                 f"qps_traced={ab['qps_traced']:.1f};"
                 f"qps_untraced={ab['qps_untraced']:.1f};"
                 f"ratio={ab['overhead_ratio']:.3f}"))

    fam = reg.histogram("phnsw_load_latency_ms",
                        "open-loop request latency from scheduled arrival "
                        "(ms), queue wait included",
                        labels=("offered_qps",))
    points = []
    for frac in offered_fracs:
        rate = frac * cap_qps / req_size
        pt = open_loop_sync(svc, rng, q, req_size, rate, count(rate),
                            fam.labels(offered_qps=f"{frac * cap_qps:.0f}"))
        pt["offered_frac"] = frac
        points.append(pt)
        rows.append(_row(f"load/offered{pt['offered_qps']:.0f}", pt,
                         ("offered_qps", "achieved_qps", "p50_ms",
                          "p99_ms", "p999_ms")))
    rate = 0.8 * cap_tight / req_size
    pt_tight = open_loop_sync(svc_tight, rng, q, req_size, rate, count(rate),
                              fam.labels(offered_qps="tight0.8"))
    rows.append(_row("load/sync_tight", pt_tight,
                     ("offered_qps", "achieved_qps", "p50_ms", "p99_ms")))

    fam_s = reg.histogram("phnsw_sched_load_latency_ms",
                          "open-loop request latency through the "
                          "continuous-batching scheduler (ms), queue wait "
                          "included", labels=("offered_qps",))
    sched = svc.scheduler(n_slots=svc_batch)
    sched_mk = svc.scheduler(ef=100, ef_policy=10, n_slots=svc_batch) \
        if mixed_k else None
    warm = slot_cache_sizes()
    sched_points = []
    for frac in offered_fracs:
        rate = frac * cap_qps / req_size
        pt = open_loop_sched(
            sched, rng, q, req_size, rate, count(rate),
            fam_s.labels(offered_qps=f"{frac * cap_qps:.0f}"), gt=gt)
        pt["offered_frac"] = frac
        sched_points.append(pt)
        rows.append(_row(f"load/sched{pt['offered_qps']:.0f}", pt,
                         ("offered_qps", "achieved_qps", "p50_ms",
                          "p99_ms", "shed", "recall")))
    top = max(offered_fracs)
    s_sync = next(p for p in points if p["offered_frac"] == top)
    s_sched = next(p for p in sched_points if p["offered_frac"] == top)
    speedup = s_sync["p99_ms"] / s_sched["p99_ms"] \
        if s_sched["p99_ms"] > 0 else None
    if speedup is not None:
        rows.append(("load/speedup_p99", 0.0,
                     f"frac={top};sync_p99_ms={s_sync['p99_ms']:.3f};"
                     f"sched_p99_ms={s_sched['p99_ms']:.3f};"
                     f"speedup={speedup:.3f}"))
    pt_mk = None
    if mixed_k:
        k_mix = (np.array([1, 10, 100]), np.array([0.45, 0.45, 0.10]))
        rate = 0.5 * cap_qps / req_size
        pt_mk = open_loop_sched(
            sched_mk, rng, q, req_size, rate, count(rate),
            fam_s.labels(offered_qps="mixed_k"), gt=gt,
            k_mix=k_mix, ragged=True)
        pt_mk["k_mix"] = {"ks": k_mix[0].tolist(), "p": k_mix[1].tolist()}
        rows.append(_row("load/mixed_k", pt_mk,
                         ("achieved_qps", "p50_ms", "p99_ms", "shed",
                          "recall")))
    new_keys = [a - b for a, b in zip(slot_cache_sizes(), warm)]
    rows.append(("load/new_keys", 0.0,
                 f"steady_state={sum(max(r, 0) for r in new_keys)}"))

    # the cost bridge: one return_stats batch, predicted against measured
    import torch
    snap = svc.db                 # None on a sharded service: no bridge
    summary = None
    if snap is not None:
        sync = torch.cuda.synchronize if snap.device.type == "cuda" \
            else (lambda: None)
        qb = np.asarray(q[:req_size], np.float32)
        qp = svc.filt.prepare(qb)
        kw = dict(ef0=svc.ef0, return_stats=True, device=snap.device)
        search_batched(snap, qb, qp, **kw)
        sync()
        t0 = time.perf_counter()
        _, _, stats = search_batched(snap, qb, qp, **kw)
        sync()
        wall = time.perf_counter() - t0
        summary = record_search_stats(stats, wall_s=wall, registry=reg,
                                      cfg=snap.cfg, filt=svc.filt)
        rows.append(("obs/cost_model", summary["measured_us"],
                     f"predicted_us={summary['predicted_us']:.1f};"
                     f"ratio={summary['cost_ratio']:.3f};"
                     f"steps_mean={summary['steps_mean']:.1f};"
                     f"dist_h_mean={summary['dist_h_mean']:.1f}"))

    text = to_prometheus(reg)
    fams = prometheus_families(text)
    parsed = parse_prometheus(text)
    for name in ("phnsw_load_latency_ms", "phnsw_sched_load_latency_ms",
                 "phnsw_request_latency_ms"):
        if name not in fams:
            raise RuntimeError(f"the exporter lost the {name} family")
    if "phnsw_load_latency_ms_count" not in parsed:
        raise RuntimeError("the exporter lost phnsw_load_latency_ms_count")

    entry = {"bench": "load", "req_size": req_size, "svc_batch": svc_batch,
             "capacity_qps": cap_qps, "capacity_tight_qps": cap_tight,
             "sync_tight_point": pt_tight, "points": points,
             "sched_points": sched_points,
             "speedup_p99_at_top": speedup, "top_frac": top,
             "sched_slots": svc_batch, "new_keys": new_keys,
             "mixed_k": pt_mk, "overhead": ab, "cost_model": summary}
    return {"rows": rows, "entry": entry}


def main(n_points: int = 8_000, *, device="cuda", n_requests: int = 120,
         out: Optional[str] = None, prom_path: Optional[str] = None):
    """The bench over the cached SIFT-like fixture
    (``bench.common.load_bench_db``, its first 64 queries) served by a
    pca service of 64 on ``device``, at ``run_load``'s defaults.
    ``prom_path`` receives the Prometheus text of the run's registry
    (row ``obs/prometheus``)."""
    from repro_torch.bench.common import emit, load_bench_db
    from repro_torch.core.filters import PCAFilter
    from repro_torch.core.search_torch import build_packed
    from repro_torch.obs import prometheus_families, to_prometheus
    from repro_torch.serve.vector_service import VectorSearchService

    cfg, _, g, pca, x_low, q, gt = load_bench_db(n_points, 64,
                                                 device=device)
    filt = PCAFilter(pca, low_dtype=cfg.low_dtype)
    db = build_packed(g, x_low, filt=filt, device=device)
    svc = VectorSearchService(db, filt=filt, batch_size=64,
                              device=device)
    res = run_load(svc, q, gt, n_requests=n_requests)
    if prom_path:
        text = to_prometheus(svc.stats.registry)
        with open(prom_path, "w") as f:
            f.write(text)
        res["rows"].append(("obs/prometheus", 0.0,
                            f"families={len(prometheus_families(text))};"
                            f"path={prom_path}"))
    emit(res["rows"])
    if out:
        with open(out, "w") as f:
            json.dump({"n_points": n_points, "device": str(device),
                       **res["entry"]}, f, indent=2, default=float)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8_000)
    ap.add_argument("--requests", type=int, default=120)
    ap.add_argument("--out", help="also write rows and points as JSON")
    ap.add_argument("--prom-out", help="write the Prometheus text here")
    a = ap.parse_args()
    main(a.n, device=a.device, n_requests=a.requests, out=a.out,
         prom_path=a.prom_out)
