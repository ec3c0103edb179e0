"""SIFT-shaped synthetic vectors and queries, made from a seed.

A frozen copy of the arithmetic of the port's ``data/vectors.py``
(``make_sift_like``, ``make_queries``): a clustered mixture of low
intrinsic dimension plus full-rank noise, offset and clipped into SIFT's
0..220 range, and queries jittered from database points. SIFT1M itself
needs a download; these keep its width (128), its value range and the
property the pHNSW filter relies on (most variance in ~15 directions)."""
from __future__ import annotations

import numpy as np


def make_vectors(n: int, dim: int, data: dict, seed) -> np.ndarray:
    """[n, dim] float32 database vectors. ``data`` holds ``n_clusters``,
    ``intrinsic``, ``noise``, ``scale`` and ``offset``; ``seed`` is
    anything ``np.random.default_rng`` takes."""
    rng = np.random.default_rng(seed)
    k = data["intrinsic"]
    basis = rng.standard_normal((k, dim)) / np.sqrt(k)
    centers = rng.standard_normal((data["n_clusters"], k)) * 2.2
    assign = rng.integers(0, data["n_clusters"], size=n)
    z = centers[assign] + rng.standard_normal((n, k))
    x = z @ basis + data["noise"] * rng.standard_normal((n, dim))
    x = np.clip(x * data["scale"] + data["offset"], 0.0, None)
    return x.astype(np.float32)


def make_queries(x: np.ndarray, n: int, jitter: float, seed) -> np.ndarray:
    """[n, dim] float32 queries: database points plus Gaussian jitter of
    ``jitter`` times the data's standard deviation, made non-negative."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), size=n)
    q = x[idx] + jitter * x.std() * rng.standard_normal((n, x.shape[1]))
    return np.abs(q).astype(np.float32)
