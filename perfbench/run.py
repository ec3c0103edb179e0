"""One run of one benchmark cell of the port ``repro_torch``.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up, timed from process start as ``setup_s``: the seeded data, the wave
build of the graph (``core.graph.build_hnsw``), the filter that the
configuration's ``filter_kind`` selects (``core.filters.make_filter``),
the layout (3) pack (``core.search_torch.build_packed``), the service
(``serve.vector_service.VectorSearchService``, whose constructor warms
its path) and one more warm call. Then the traffic's loop
(``generator.py``) for ``--seconds``. With ``--trace 1`` the loop runs
with the port's tracer on, and is followed by one counting call
(``search_batched(..., return_stats=True)``) and ``PROFILED`` calls
under ``torch.profiler``.
Then the program's state is freed and every answer of the window is
judged (``reference/check.py``). The last line of standard output is the
result; the last lines of standard error are the numbers judged, each
beside its limit. A run needs a CUDA card and never falls back to the
CPU; ``run`` itself takes a device so that the tests can drive it."""
from __future__ import annotations

import os
import time

_MONO0 = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from perfbench import cell, generator, guard  # noqa: E402
from perfbench import trace as device_trace  # noqa: E402
from perfbench.reference import check, data  # noqa: E402

PROFILED = 2
OUT = cell.HERE / "out"


def _age_at_start() -> float:
    """Seconds from this process's start to ``_MONO0`` (Linux ``/proc``;
    0 where it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(up - start / os.sysconf("SC_CLK_TCK")
               - (time.monotonic() - _MONO0), 0.0)


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"[{time.monotonic() - _MONO0:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# keys of a configuration file that the harness reads itself, beside the
# fields of the port's PHNSWConfig
HARNESS_KEYS = frozenset({"source", "reduced", "reduced_why", "assumed",
                          "data_seed", "build_seed", "data",
                          "recall10_min"})
# PHNSWConfig fields of the mutable index, which a frozen PackedDB never
# reads: a file that sets one asks for a path the harness does not drive
MUTABLE_KEYS = frozenset({"insert_batch", "compact_tombstone_frac",
                          "pca_drift_tol", "min_capacity"})


def phnsw_config(conf: dict):
    """The port's PHNSWConfig of a configuration file, after refusing
    every key that the harness would not apply."""
    from repro_torch.configs.base import PHNSWConfig
    fields = {f.name for f in dataclasses.fields(PHNSWConfig)}
    unused = (set(conf) - fields - HARNESS_KEYS) | (set(conf) & MUTABLE_KEYS)
    if unused:
        raise ValueError(f"configuration keys the harness does not apply: "
                         f"{sorted(unused)}")
    kw = {k: v for k, v in conf.items() if k in fields}
    for k in ("k_schedule", "step_budget"):
        if kw.get(k) is not None:
            kw[k] = tuple(kw[k])
    return PHNSWConfig(**kw)


def seeds(seed: int):
    """The run's seeds, drawn from ``--seed``: the query pool, the ring of
    calls, an open loop's arrivals."""
    return np.random.SeedSequence(seed).spawn(3)


def inputs(conf: dict, traffic: dict, seed: int):
    """The inputs of a run: the database vectors (from the configuration's
    ``data_seed``: one index in every run, as a deployment serves one),
    and from ``seed`` the query pool, the ring of calls (the pool rows
    each asks for) and their query arrays."""
    s_query, s_ring, _ = seeds(seed)
    x = data.make_vectors(conf["n_points"], conf["dim"], conf["data"],
                          conf["data_seed"])
    pool = data.make_queries(x, traffic["pool"], conf["data"]["jitter"],
                             s_query)
    calls = generator.ring(len(pool), traffic, s_ring)
    return x, pool, calls, [np.ascontiguousarray(pool[c]) for c in calls]


def scaled(bench: dict, wl: dict, scale: dict = None):
    """The cell's configuration and traffic, with ``scale``'s overrides
    (the CPU tests' small sizes)."""
    conf = cell.config(bench, wl["config"])
    traffic = cell.traffic(wl["traffic"])
    if scale:
        conf = {**conf, **scale.get("config", {})}
        traffic = {**traffic, **scale.get("traffic", {})}
    return conf, generator.checked(traffic)


def counting(cfg, stats, batch: int, ef0: int) -> dict:
    """The counting call's counts: expansion steps by layer (bottom
    first), with each layer's ef and k, and the Dist.H evaluations."""
    steps = stats["steps_per_layer"].cpu().numpy().sum(1)[::-1]
    deferred = cfg.deferred_rerank
    ks = cfg.k_schedule
    return {"queries": batch, "dim": cfg.dim, "deferred": deferred,
            "expand_width": cfg.expand_width,
            "steps": [int(s) for s in steps],
            "ef": [ef0 * (cfg.rerank_mult if deferred else 1) if L == 0
                   else cfg.ef_upper for L in range(len(steps))],
            "k": [ks[min(L, len(ks) - 1)] for L in range(len(steps))],
            "dist_h_evals": int(stats["dist_h_evals"].sum())}


def run(bench: dict, wl: dict, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", scale: dict = None) -> dict:
    """Set-up, window, traced extras and the judgement of one run.
    ``scale`` overrides configuration and traffic keys (the CPU tests'
    small sizes). Returns the result line's dict."""
    conf, traffic = scaled(bench, wl, scale)
    import torch
    from repro_torch.core import search_torch
    from repro_torch.core.filters import make_filter
    from repro_torch.core.graph import build_hnsw
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.vector_service import VectorSearchService

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cfg = phnsw_config(conf)
    x, pool, ring, batches = inputs(conf, traffic, seed)
    log(f"{wl['name']} seed {seed}: inputs made")
    timings = {}
    g = build_hnsw(x, cfg, seed=conf["build_seed"], device=device,
                   timings=timings)
    log(f"graph built: {timings}")
    filt = make_filter(cfg, x, seed=conf["build_seed"], levels=g.levels)
    db = search_torch.build_packed(g, filt=filt, device=device)
    k = traffic["k"]
    ef0 = max(k, cfg.ef0)
    tracer = Tracer(capacity=1 << 16) if trace else None
    svc = VectorSearchService(db, filt=filt, batch_size=traffic["batch"],
                              ef0=ef0, tracer=tracer, device=device)
    svc.query(batches[-1])
    sync()
    if tracer is not None:
        tracer.clear()
    setup_s = _age_at_start() + time.monotonic() - _MONO0
    log(f"set-up done: {setup_s:.2f} s")

    trips0 = search_torch.trip_counts()["layer"]
    launches0 = sum(ops.launch_counts().values())
    win = generator.drive(svc.query, batches, traffic, seconds,
                          seeds(seed)[2])
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if win["lat_s"]:
        q = np.percentile(win["lat_s"], [0, 50, 100]) * 1e3
        log(f"window: {win['calls']} calls in {win['seconds']:.3f} s, "
            f"latency ms min {q[0]:.1f} median {q[1]:.1f} max {q[2]:.1f}")
    calls = max(win["calls"], 1)
    out = {"config": conf, "traffic": traffic, "setup_s": setup_s,
           "window_s": win["seconds"], "queries": win["queries"],
           "calls": win["calls"], "latency_s": win["lat_s"],
           "peak_bytes": peak,
           "n_points": cfg.n_points, "build": timings,
           "trips": (search_torch.trip_counts()["layer"] - trips0) / calls,
           "launches": (sum(ops.launch_counts().values()) - launches0)
           / calls,
           "db_bytes": sum(t.numel() * t.element_size() for t in
                           [db.low, db.high, db.deleted, db.low2]
                           + [t for l in db.layers
                              for t in (l.adj, l.packed_low)]
                           if t is not None)}
    if trace:
        out["spans"] = list(tracer.finished)
        search_ms = [sum(c.duration_ms for c in r.children)
                     for r in out["spans"]]
        self_ms = [r.duration_ms - m for r, m in zip(out["spans"], search_ms)]
        for name, v in (("search", search_ms), ("service self", self_ms)):
            q = np.percentile(v, [0, 50, 100])
            log(f"{name} ms a call: min {q[0]:.1f} median {q[1]:.1f} "
                f"max {q[2]:.1f}")
        _, _, stats = search_torch.search_batched(
            db, batches[0], filt.prepare(batches[0]), ef0=ef0,
            return_stats=True, device=device)
        out["counts"] = counting(cfg, stats, traffic["batch"], ef0)
        if on_card:
            out["trace"] = device_trace.profile(
                [lambda r=r: svc.query(batches[r % len(batches)])
                 for r in range(PROFILED)],
                OUT / f"trace-{wl['name']}.json")
        log("traced calls done")
    del svc, db, g, filt
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    verdict = check.judge(x, pool, ring, win["records"], k=k,
                          recall10_min=conf["recall10_min"],
                          failed=win["failed"], device=device)
    out["recall10"] = verdict["recall10"]
    log("answers judged")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(bench, wl["name"], kind):
        v = cell.reader(m["name"])(out)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    res = {"correct": verdict["correct"],
           "attempted": win["queries"] + win["failed"],
           "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace and "trace" in out:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
        res["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                            "idle_gaps": out["trace"]["idle_gaps"]}
    res["card"] = card() if on_card else "cpu"
    if win["error"]:
        res["error"] = win["error"]
    res["checks"] = verdict["checks"]
    return res


def check_lines(checks: dict) -> list:
    return [f"check {name} {c['value']!r} {c['op']} {c['limit']!r}"
            for name, c in checks.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = cell.benchmark()
    wl = cell.workload(bench, args.workload)
    found = guard.forbidden(sys.modules)
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cell.ROOT / "src"))
    res = run(bench, wl, args.seed, args.seconds, bool(args.trace))
    found = guard.forbidden(sys.modules)
    if found:
        print(f"forbidden modules loaded after the window: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(res), flush=True)
    for line in check_lines(res["checks"]):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
