"""CUDA wrapper of the kSort.L kernel (``csrc/ksort_l.cu``).

Replaces ``repro/kernels/ksort_l.py: ksort_l_pallas``: the k smallest
(value, index) pairs of each row of [B, M], ascending, ties to the lower
index; one block per row, one thread per element ranks it against the
row in shared memory. Bound on the card: bytes. On the search path it is
the cross-shard merge of ``core/distributed.py``. The plain version is
``ref.ksort_l_ref``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, stream_of

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def ksort_l_cuda(d, k: int):
    """d: [B, M] f32, contiguous on a CUDA device; 1 <= k <= M.
    Returns (vals [B, k] f32 ascending, idx [B, k] int32)."""
    B, M = d.shape
    check_cuda(d, torch.float32, (B, M), "d")
    if not 1 <= k <= M or M > 12288:
        raise ValueError(f"ksort_l kernel needs 1 <= k <= M <= 12288, got "
                         f"k={k}, M={M}")
    ov = torch.empty((B, k), dtype=torch.float32, device=d.device)
    oi = torch.empty((B, k), dtype=torch.int32, device=d.device)
    if B == 0:
        return ov, oi
    lib = _build.load("ksort_l")
    fn = lib.ksort_l_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(d.device):
        err = fn(d.data_ptr(), ov.data_ptr(), oi.data_ptr(), B, M, k,
                 stream_of(d))
    _build.check(lib, "ksort_l", err)
    ksort_l_cuda.launches += 1
    return ov, oi


ksort_l_cuda.launches = 0
