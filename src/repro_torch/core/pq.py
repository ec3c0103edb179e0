"""Product quantization for the PQ and cascade filters (port of
``repro/core/pq.py``): split the vector into n_sub subspaces and code
each with an 8-bit codebook.

Training and encoding stay in numpy with the reference's random calls
and arithmetic, so a codebook trained on the same data and seed is
bit-identical to the reference's (``tests/test_torch_filters.py``). The
per-query ADC tables for the device path come from ``adc_tables_torch``
on the tensors' device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PQCodebook:
    centroids: np.ndarray      # [M, 256, dsub]

    @property
    def n_sub(self) -> int:
        return self.centroids.shape[0]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]

    @property
    def bytes_per_vec(self) -> int:
        return self.n_sub            # one uint8 code per subspace


def _init_centroids(xs: np.ndarray, rng: np.random.Generator,
                    p: np.ndarray = None) -> np.ndarray:
    """256 initial centroids from ``xs`` (optionally ``p``-weighted).
    When the training set (or the weighted support) is smaller than the
    code count, sample WITH replacement and jitter the duplicates
    apart."""
    n = len(xs)
    support = n if p is None else int(np.count_nonzero(p))
    if support >= 256:
        return xs[rng.choice(n, 256, replace=False, p=p)].copy()
    idx = rng.choice(n, 256, replace=True, p=p)
    c = xs[idx].copy()
    scale = float(xs.std(0).mean()) if n > 1 else 1.0
    c += rng.normal(0.0, max(scale, 1e-6) * 1e-3,
                    c.shape).astype(np.float32)
    return c


def train_pq(x: np.ndarray, n_sub: int, *, iters: int = 8,
             seed: int = 0, weights: np.ndarray = None) -> PQCodebook:
    """Lloyd k-means (k=256) per subspace.

    ``weights`` (optional, [n] non-negative): per-point training
    weights — density-aware codebooks weight points by graph-layer
    occupancy. Weighted init sampling + weighted cluster means;
    assignment stays nearest-centroid."""
    n, d = x.shape
    assert d % n_sub == 0, (d, n_sub)
    dsub = d // n_sub
    rng = np.random.default_rng(seed)
    p = None
    w = None
    if weights is not None:
        w = np.asarray(weights, np.float64)
        assert w.shape == (n,) and (w >= 0).all() and w.sum() > 0, \
            "weights must be [n] non-negative with positive sum"
        p = w / w.sum()
    cents = np.empty((n_sub, 256, dsub), np.float32)
    for m in range(n_sub):
        xs = x[:, m * dsub:(m + 1) * dsub].astype(np.float32)
        c = _init_centroids(xs, rng, p)
        for _ in range(iters):
            if n <= 20000:
                assign = ((xs[:, None, :] - c[None]) ** 2).sum(-1).argmin(1)
            else:
                # blockwise assignment for larger n
                assign = np.empty(n, np.int64)
                for i in range(0, n, 8192):
                    blk = xs[i:i + 8192]
                    d2b = ((blk[:, None, :] - c[None]) ** 2).sum(-1)
                    assign[i:i + 8192] = d2b.argmin(1)
            empty = []
            for k in range(256):
                sel = assign == k
                if not sel.any():
                    empty.append(k)
                elif w is None:
                    c[k] = xs[sel].mean(0)
                else:
                    ws = w[sel]
                    tot = ws.sum()
                    c[k] = ((ws[:, None] * xs[sel]).sum(0) / tot
                            if tot > 0 else xs[sel].mean(0))
            if empty:
                # reseed empty clusters to the farthest-assigned points
                d_assigned = ((xs - c[assign]) ** 2).sum(-1)
                far = np.argsort(-d_assigned)
                for k, i in zip(empty, far):
                    c[k] = xs[i]
        cents[m] = c
    return PQCodebook(centroids=cents)


def encode_pq(cb: PQCodebook, x: np.ndarray) -> np.ndarray:
    """x: [N, D] -> codes [N, M] uint8."""
    n, d = x.shape
    dsub = cb.dsub
    codes = np.empty((n, cb.n_sub), np.uint8)
    for m in range(cb.n_sub):
        xs = x[:, m * dsub:(m + 1) * dsub].astype(np.float32)
        for i in range(0, n, 8192):
            blk = xs[i:i + 8192]
            d2 = ((blk[:, None, :] - cb.centroids[m][None]) ** 2).sum(-1)
            codes[i:i + 8192, m] = d2.argmin(1).astype(np.uint8)
    return codes


def adc_table(cb: PQCodebook, q: np.ndarray) -> np.ndarray:
    """Asymmetric distance tables for one query: [M, 256]."""
    dsub = cb.dsub
    tabs = np.empty((cb.n_sub, 256), np.float32)
    for m in range(cb.n_sub):
        qs = q[m * dsub:(m + 1) * dsub].astype(np.float32)
        tabs[m] = ((cb.centroids[m] - qs[None]) ** 2).sum(-1)
    return tabs


def adc_table_batch(cb: PQCodebook, q: np.ndarray) -> np.ndarray:
    """Batched ADC tables: q [B, D] -> [B, n_sub, 256] f32 — the
    per-query preparation of the PQ filter on the host."""
    B = q.shape[0]
    M, _, dsub = cb.centroids.shape
    qs = q.astype(np.float32).reshape(B, M, 1, dsub)
    return ((qs - cb.centroids[None]) ** 2).sum(-1)


def adc_tables_torch(centroids_t: torch.Tensor,
                     q_t: torch.Tensor) -> torch.Tensor:
    """Batched ADC tables on the tensors' device: centroids [M, 256,
    dsub], q [B, D] -> [B, M, 256] f32 (the device prep of the PQ and
    cascade filters; the arithmetic of ``adc_table_batch``)."""
    B = q_t.shape[0]
    M, _, dsub = centroids_t.shape
    qs = q_t.to(torch.float32).reshape(B, M, 1, dsub)
    return ((qs - centroids_t[None]) ** 2).sum(-1)


def adc_distances(tabs: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """codes: [N, M] -> approximate squared distances [N]."""
    return tabs[np.arange(tabs.shape[0])[None, :], codes].sum(1)
