"""Synthetic SIFT1M-like vector datasets.

Real SIFT descriptors are 128-dim, non-negative, and strongly correlated
(PCA to 15 dims preserves enough structure for recall 0.92 at the paper's
operating point — Section III-B). An isotropic Gaussian would NOT have
that property, so we generate a clustered low-intrinsic-dimension mixture
with added full-rank noise, scaled to SIFT's value range.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_sift_like(n: int, dim: int = 128, *, n_clusters: int = 64,
                   intrinsic: int = 16, noise: float = 0.04,
                   seed: int = 0) -> np.ndarray:
    """[n, dim] float32, SIFT-like: clustered, low intrinsic dimension,
    non-negative, magnitudes in SIFT's typical 0..220 range."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((intrinsic, dim)) / np.sqrt(intrinsic)
    centers = rng.standard_normal((n_clusters, intrinsic)) * 2.2
    assign = rng.integers(0, n_clusters, size=n)
    z = centers[assign] + rng.standard_normal((n, intrinsic))
    x = z @ basis + noise * rng.standard_normal((n, dim))
    # non-negativity via offset + clip (NOT folding: |x| would destroy the
    # low-rank structure PCA-15 relies on; real SIFT keeps ~80% variance
    # in 15 PCs)
    x = np.clip(x * 20.0 + 80.0, 0.0, None)
    return x.astype(np.float32)


def make_queries(x: np.ndarray, n_queries: int, *, seed: int = 1,
                 jitter: float = 0.05) -> np.ndarray:
    """Queries near the data manifold: perturbed database points."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), size=n_queries)
    q = x[idx] + jitter * x.std() * rng.standard_normal((n_queries,
                                                         x.shape[1]))
    return np.abs(q).astype(np.float32)


def brute_force_topk(x: np.ndarray, q: np.ndarray, k: int,
                     block: int = 4096) -> np.ndarray:
    """Exact top-k (squared L2) ground truth: [n_queries, k] indices."""
    n2 = (x * x).sum(axis=1)
    out = np.empty((len(q), k), np.int64)
    for i in range(0, len(q), block):
        qb = q[i:i + block]
        d = n2[None, :] - 2.0 * (qb @ x.T)    # + ||q||^2 (rank-invariant)
        part = np.argpartition(d, k, axis=1)[:, :k]
        rows = np.arange(len(qb))[:, None]
        order = np.argsort(d[rows, part], axis=1)
        out[i:i + block] = part[rows, order]
    return out
