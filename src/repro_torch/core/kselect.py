"""Per-layer k selection (paper Section III-B, Fig 2); port of
``repro/core/kselect.py`` over the port's host oracle and cost model
(the modeled QPS is the paper's processor's, not the card's).

The paper's method:
  * upper layers (2..5): k = 3 x ef = 3 (pKNN's recommendation of three
    times the search-candidate count, ef=1);
  * denser layers get larger k: sweep k(layer1) at fixed k(layer0), pick
    the recall knee; then sweep k(layer0) at the chosen k(layer1);
  * stop increasing k when recall saturates — beyond the knee QPS drops
    (paper: up to 21.4% at k0=18) with no recall gain.

``sweep`` reproduces the Fig 2 curves (recall@10 + modeled QPS per k);
``select_schedule`` automates the paper's manual procedure.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import DDR4, HBM, query_cost
from repro_torch.core.search_ref import run_queries


@dataclass
class SweepPoint:
    k0: int
    k1: int
    recall: float
    qps_ddr4: float
    qps_hbm: float


def _eval_schedule(g, x_low, pca, queries, gt, k0: int, k1: int,
                   upper: int = 3) -> SweepPoint:
    ks = (k0, k1, upper, upper, upper, upper)
    recall, st = run_queries(g, queries, gt, algo="phnsw", x_low=x_low,
                             pca=pca, k_schedule=ks)
    dim, d_low = g.x.shape[1], x_low.shape[1]
    n = len(queries)
    c4 = query_cost(st, n_queries=n, dim=dim, d_low=d_low, dram=DDR4)
    ch = query_cost(st, n_queries=n, dim=dim, d_low=d_low, dram=HBM)
    return SweepPoint(k0=k0, k1=k1, recall=recall, qps_ddr4=c4.qps,
                      qps_hbm=ch.qps)


def sweep_k1(g, x_low, pca, queries, gt, *, k0: int = 16,
             k1_values=(2, 4, 6, 8, 10, 12)) -> List[SweepPoint]:
    """Fig 2(a): vary k(layer1) at fixed k(layer0)."""
    return [_eval_schedule(g, x_low, pca, queries, gt, k0, k1)
            for k1 in k1_values]


def sweep_k0(g, x_low, pca, queries, gt, *, k1: int = 8,
             k0_values=(8, 10, 12, 14, 16, 18, 20)) -> List[SweepPoint]:
    """Fig 2(b): vary k(layer0) at fixed k(layer1)."""
    return [_eval_schedule(g, x_low, pca, queries, gt, k0, k1)
            for k0 in k0_values]


def select_schedule(g, x_low, pca, queries, gt, *,
                    recall_tolerance: float = 0.005
                    ) -> Tuple[Tuple[int, ...], Dict]:
    """Automated version of the paper's manual knee-finding: choose the
    smallest k at which recall is within ``recall_tolerance`` of the
    saturated (max) recall — first for layer1, then layer0."""
    s1 = sweep_k1(g, x_low, pca, queries, gt)
    best_r1 = max(p.recall for p in s1)
    k1 = next(p.k1 for p in s1 if p.recall >= best_r1 - recall_tolerance)
    s0 = sweep_k0(g, x_low, pca, queries, gt, k1=k1)
    best_r0 = max(p.recall for p in s0)
    k0 = next(p.k0 for p in s0 if p.recall >= best_r0 - recall_tolerance)
    schedule = (k0, k1, 3, 3, 3, 3)
    return schedule, {"sweep_k1": s1, "sweep_k0": s0}
