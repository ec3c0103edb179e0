"""Device-telemetry bridge: fold per-batch search stats into the
metrics plane, and record predicted-vs-measured query cost (port of
``repro/obs/bridge.py``).

``search_torch.search_batched(..., return_stats=True)`` (and the
sharded paths) return per-query device telemetry as tensors — ``steps_total`` [B],
``dist_h_evals`` [B], ``coverage``/``degraded``. ``record_search_stats``
folds one such batch into log-bucketed histograms (one vectorized
``observe_many`` per array — O(B), no samples retained), so the
steps/Dist.H distributions that bound QPS are scrapeable alongside the
service latency percentiles instead of riding in ad-hoc dicts. A tensor
on the card is copied to the host first (``.cpu()``, duck-typed: this
module imports no torch, and ``repro_torch.obs`` stays numpy-only).

The **cost accounting** half is the raw feed an autotuner needs before
it can close the loop: ``predicted_query_ns``
prices a query from the SAME device telemetry through the paper-priced
cost model (``core/cost_model.query_cost``) by synthesizing the
per-query ``SearchStats`` the model expects from batched counters —
per expansion step: one fused Dist.L over the layer's M neighbors, one
kSort.L, one Min.H, M visited checks, and one random DRAM fetch of the
layout-(3) packed row; per Dist.H eval: dim floats of random traffic.
This is an analytic *approximation* of the trace-instrumented host
path (upper-layer step mix and eviction counts are folded into the
dominant layer-0 terms), documented here so the recorded
``phnsw_cost_ratio`` histogram (measured wall / predicted) is read as
what it is: a calibration residual to be LEARNED by the autotuner, not
an identity. On the card it compares an H100's wall time with the
model of the paper's 65 nm processor, so it has no expected value.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.obs.metrics import Registry, default_registry

# metric family names (the reference's, so one scraper reads both)
STEPS = "phnsw_search_steps"
DIST_H = "phnsw_search_dist_h_evals"
COVERAGE = "phnsw_search_coverage"
MEASURED_US = "phnsw_query_measured_us"
PREDICTED_US = "phnsw_query_predicted_us"
COST_RATIO = "phnsw_cost_ratio"
BATCHES = "phnsw_search_batches_total"


def _host(a):
    """A tensor (on any device) as a host array; anything else as is."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else a


def predicted_query_ns(cfg, *, steps_mean: float, dist_h_mean: float,
                       filt=None, dram=None) -> float:
    """Cost-model prediction (ns/query) from batched device telemetry.

    ``cfg`` is a ``PHNSWConfig``; ``filt`` (a ``FilterSpec``) supplies
    the filter-distance pipeline depth and payload bytes (defaults to
    the PCA spelling: ``cfg.d_low`` / 4-byte floats). ``dram`` is a
    ``core.cost_model.DramConfig`` (default HBM)."""
    from repro_torch.core.cost_model import HBM, query_cost
    from repro_torch.core.search_ref import SearchStats
    dram = dram or HBM
    d_low = filt.cost_dims if filt is not None else cfg.d_low
    payload_bytes = filt.bytes_per_vec if filt is not None \
        else 4 * cfg.d_low
    M = cfg.M0                     # layer 0 dominates the step mix
    ew = max(cfg.expand_width, 1)
    steps = float(steps_mean)
    dist_h = float(dist_h_mean)
    # cascade promote stage: one batched PCA pass over the wide
    # PQ-space exit list (ef0 * promote_mult side-car gathers + mid
    # distances), once per query
    mid_evals = 0.0
    mid_bytes = 0
    if filt is not None and hasattr(filt, "mid_cost_dims"):
        mid_evals = float(cfg.ef0 * max(cfg.promote_mult,
                                        cfg.rerank_mult))
        mid_bytes = filt.mid_bytes_per_vec
    # layout-(3) packed row: M neighbor ids + M inline payloads
    row_bytes = M * (4 + payload_bytes)
    st = SearchStats(
        expansions=steps * ew,
        dist_low=steps * ew * M,
        dist_mid=mid_evals,
        dist_high=dist_h,
        ksort_calls=steps,
        minh_calls=steps,
        visit_checks=steps * ew * M,
        f_updates=steps * ew,
        evictions=steps,
        rand_accesses=steps * ew + dist_h + mid_evals,
        rand_bytes=steps * ew * row_bytes + dist_h * cfg.dim * 4
        + mid_evals * mid_bytes,
        seq_bursts=0, seq_bytes=0,
    )
    return query_cost(st, n_queries=1, dim=cfg.dim, d_low=d_low,
                      dram=dram, filt=filt).total_ns


def record_search_stats(stats: dict, *, wall_s: Optional[float] = None,
                        n_queries: Optional[int] = None,
                        registry: Optional[Registry] = None,
                        cfg=None, filt=None, dram=None) -> dict:
    """Fold one batch's ``return_stats`` telemetry into the metrics
    plane. With ``wall_s`` (the batch's measured wall time) the
    measured us/query lands in ``phnsw_query_measured_us``; with
    ``cfg`` additionally the cost-model prediction and the
    measured/predicted ratio are recorded — the autotuner's
    calibration feed. Returns a small summary dict."""
    reg = registry or default_registry()
    steps = np.asarray(_host(stats["steps_total"]), np.float64).ravel()
    dhe = np.asarray(_host(stats["dist_h_evals"]), np.float64).ravel()
    B = n_queries or len(steps)
    reg.histogram(STEPS, "expansion steps per query",
                  lo=1.0, hi=1e5, growth=2 ** 0.25).observe_many(steps[:B])
    reg.histogram(DIST_H, "high-dim distance evals per query",
                  lo=1.0, hi=1e6, growth=2 ** 0.25).observe_many(dhe[:B])
    reg.gauge(COVERAGE, "live-vector coverage of the last batch") \
        .set(float(stats.get("coverage", 1.0)))
    reg.counter(BATCHES, "telemetry batches folded").inc()
    out = {"steps_mean": float(steps[:B].mean()),
           "dist_h_mean": float(dhe[:B].mean()),
           "coverage": float(stats.get("coverage", 1.0))}
    if wall_s is not None:
        measured_us = wall_s / max(B, 1) * 1e6
        reg.histogram(MEASURED_US, "measured query wall time (us)") \
            .observe(measured_us)
        out["measured_us"] = measured_us
        if cfg is not None:
            pred_us = predicted_query_ns(
                cfg, steps_mean=out["steps_mean"],
                dist_h_mean=out["dist_h_mean"], filt=filt,
                dram=dram) / 1e3
            reg.histogram(PREDICTED_US,
                          "cost-model predicted query time (us)") \
                .observe(pred_us)
            reg.histogram(COST_RATIO,
                          "measured / predicted query time",
                          lo=1e-3, hi=1e4, growth=2 ** 0.125) \
                .observe(measured_us / max(pred_us, 1e-9))
            out["predicted_us"] = pred_us
            out["cost_ratio"] = measured_us / max(pred_us, 1e-9)
    return out
