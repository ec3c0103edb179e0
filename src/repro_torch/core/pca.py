"""PCA transform for pHNSW Step 1 (paper Fig. 1(c)): project the database
from dim -> d_low, preserving maximum variance (port of
``repro/core/pca.py``).

Fit is exact (eigendecomposition of the covariance; numpy, once at index
build time on the host). ``transform_torch`` is a plain ``torch.matmul``
on the caller's device, as the reference leaves its projection to XLA
outside any kernel. Float32 products on the card run in full f32:
importing this module sets ``torch.backends.cuda.matmul.allow_tf32 =
False`` (PyTorch's default, stated here because TF32 would keep only
about three decimal digits of the projected query)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False


@dataclass
class PCA:
    mean: np.ndarray        # [D]
    components: np.ndarray  # [D, d_low]  (orthonormal columns)
    explained: np.ndarray   # [d_low] fraction of variance per component
    # device-tensor cache for transform_torch, keyed by device: the
    # projection is frozen after fit, so mean and components are uploaded
    # once per device and reused (excluded from ==/repr)
    _dev: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def d_low(self) -> int:
        return self.components.shape[1]

    def transform(self, x):
        return (x - self.mean) @ self.components

    def transform_torch(self, x: torch.Tensor) -> torch.Tensor:
        """[B, D] tensor -> [B, d_low] float32 tensor on x's device."""
        key = str(x.device)
        if key not in self._dev:
            self._dev[key] = (
                torch.as_tensor(self.mean, device=x.device),
                torch.as_tensor(self.components, device=x.device))
        mean, comps = self._dev[key]
        return torch.matmul(x.to(torch.float32) - mean, comps)

    def inverse(self, z):
        return z @ self.components.T + self.mean


def fit_pca(x: np.ndarray, d_low: int) -> PCA:
    """x: [N, D] float; exact PCA via covariance eigendecomposition."""
    x = np.asarray(x, np.float64)
    mean = x.mean(axis=0)
    xc = x - mean
    cov = xc.T @ xc / max(len(x) - 1, 1)
    w, v = np.linalg.eigh(cov)            # ascending
    order = np.argsort(w)[::-1][:d_low]
    comps = v[:, order]
    explained = w[order] / max(w.sum(), 1e-12)
    return PCA(mean.astype(np.float32), comps.astype(np.float32),
               explained.astype(np.float32))
