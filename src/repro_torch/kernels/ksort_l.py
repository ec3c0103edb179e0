"""CUDA wrapper of the kSort.L kernel (``csrc/ksort_l.cu``).

Replaces ``repro/kernels/ksort_l.py: ksort_l_pallas``: the k smallest
(value, index) pairs of each row of [B, M], ascending, ties to the lower
index; one block per row, one thread per element ranks it against the
row in shared memory, or in global memory for rows past the card's
opt-in maximum (``ksort_plan``). Bound on the card: bytes. On the
search path it is the cross-shard merge of ``core/distributed.py``. The
plain version is ``ref.ksort_l_ref``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, smem_optin, stream_of
from repro_torch.kernels.merge_sorted import staged_plan

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def ksort_plan(M: int, smem_optin: int) -> dict:
    """``staged_plan`` of a row of M values."""
    return staged_plan(M, smem_optin)


def ksort_l_cuda(d, k: int):
    """d: [B, M] f32, contiguous on a CUDA device; 1 <= k <= M.
    Returns (vals [B, k] f32 ascending, idx [B, k] int32)."""
    B, M = d.shape
    check_cuda(d, torch.float32, (B, M), "d")
    if not 1 <= k <= M:
        raise ValueError(f"ksort_l kernel needs 1 <= k <= M, got k={k}, "
                         f"M={M}")
    ov = torch.empty((B, k), dtype=torch.float32, device=d.device)
    oi = torch.empty((B, k), dtype=torch.int32, device=d.device)
    if B == 0:
        return ov, oi
    plan = ksort_plan(M, smem_optin(d.device))
    lib = _build.load("ksort_l")
    fn = lib.ksort_l_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(d.device):
        err = fn(d.data_ptr(), ov.data_ptr(), oi.data_ptr(), B, M, k,
                 int(plan["staged"]), stream_of(d))
    _build.check(lib, "ksort_l", err)
    ksort_l_cuda.launches += 1
    return ov, oi


ksort_l_cuda.launches = 0
