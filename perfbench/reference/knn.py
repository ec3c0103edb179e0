"""Exact k nearest neighbours under squared L2, in plain PyTorch.

``exact_knn`` scores each block of queries against every vector with one
float32 product of the centred data, TF32 off, keeps the ``k + MARGIN``
best, re-scores those exactly in float64 from the raw vectors and sorts
them. The float32 product's rounding (about 0.1 on squared distances of
about 300 at SIFT's scale) can only reorder candidates inside the margin.

``tf32_knn`` is the control: the same search with the product in TF32
(inputs rounded to 10 mantissa bits, as the tensor cores take them; on a
CPU the rounding is done here), returning the distances that product
gives. It stands in for the port computing its answers one precision
below the float32 the configurations state."""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

MARGIN = 32


@contextmanager
def tf32(enabled: bool):
    """Set both of PyTorch's TF32 switches for the block, then restore
    them."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (nearest, ties to
    even)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def _blocks(n: int, block: int):
    for a in range(0, n, block):
        yield a, min(a + block, n)


def exact_knn(x: np.ndarray, q: np.ndarray, k: int, *, device,
              block: int = 2048):
    """The exact ``k`` nearest rows of ``x`` [N, D] to each row of ``q``
    [n, D]: (squared distances [n, k] float64 ascending, ids [n, k]
    int64)."""
    x64 = torch.as_tensor(x, dtype=torch.float64, device=device)
    mean = x64.mean(0)
    xc64 = x64 - mean
    xc = xc64.float()
    xn = (xc64 * xc64).sum(1).float()
    m = min(k + MARGIN, len(x))
    out_d = torch.empty((len(q), k), dtype=torch.float64, device=device)
    out_i = torch.empty((len(q), k), dtype=torch.int64, device=device)
    with tf32(False):
        for a, b in _blocks(len(q), block):
            qc64 = torch.as_tensor(q[a:b], dtype=torch.float64,
                                   device=device) - mean
            d = xn[None] - 2.0 * (qc64.float() @ xc.T)
            cand = d.topk(m, dim=1, largest=False).indices
            ex = ((xc64[cand] - qc64[:, None]) ** 2).sum(-1)
            ex, order = ex.sort(dim=1, stable=True)
            out_d[a:b] = ex[:, :k]
            out_i[a:b] = cand.gather(1, order[:, :k])
    return out_d, out_i


def tf32_knn(x: np.ndarray, q: np.ndarray, k: int, *, device,
             block: int = 2048):
    """The control: ``exact_knn``'s top ``k`` with the product in TF32 and
    no float64 re-scoring. Returns (squared distances [n, k] float32 as
    the TF32 product gives them, ids [n, k] int64)."""
    x64 = torch.as_tensor(x, dtype=torch.float64, device=device)
    mean = x64.mean(0)
    xc = (x64 - mean).float()
    xn = (xc * xc).sum(1)
    on_card = torch.device(device).type == "cuda"
    xt = xc if on_card else round_tf32(xc)
    out_d = torch.empty((len(q), k), dtype=torch.float32, device=device)
    out_i = torch.empty((len(q), k), dtype=torch.int64, device=device)
    with tf32(True):
        for a, b in _blocks(len(q), block):
            qc = (torch.as_tensor(q[a:b], dtype=torch.float64,
                                  device=device) - mean).float()
            qt = qc if on_card else round_tf32(qc)
            d = (qc * qc).sum(1, keepdim=True) + xn[None] - 2.0 * (qt @ xt.T)
            v, i = d.topk(k, dim=1, largest=False)
            out_d[a:b], out_i[a:b] = v, i
    return out_d, out_i
