"""CUDA wrapper of the fused expand kernel (``csrc/fused_expand.cu``).

Replaces ``repro/kernels/fused_filter.py: fused_expand_pallas`` (with its
``ksort_block`` helper): Dist.L + validity mask + C_pca threshold +
kSort.L for one expansion step, one warp per query row. Bound on the
card: bytes (the [B, M, dl] neighbor block). The plain version is
``ref.fused_expand_ref``; ``ops.fused_expand`` picks between them by
tensor device."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, stream_of

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_expand_cuda(x, q, valid, th, k: int):
    """x: [B, M, dl] f32; q: [B, dl] f32; valid: [B, M] bool; th: [B]
    f32 — all contiguous on one CUDA device; 1 <= k <= M <= 128.
    Returns (vals [B, k] f32 ascending, idx [B, k] int32)."""
    B, M, dl = x.shape
    check_cuda(x, torch.float32, (B, M, dl), "x")
    check_cuda(q, torch.float32, (B, dl), "q", like=x)
    check_cuda(valid, torch.bool, (B, M), "valid", like=x)
    check_cuda(th, torch.float32, (B,), "th", like=x)
    if not 1 <= k <= M or M > 128:
        raise ValueError(f"fused_expand kernel needs 1 <= k <= M <= 128, "
                         f"got k={k}, M={M}")
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return vals, idx
    lib = _build.load("fused_expand")
    fn = lib.fused_expand_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), valid.data_ptr(),
                 th.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                 B, M, dl, k, stream_of(x))
    _build.check(lib, "fused_expand", err)
    fused_expand_cuda.launches += 1
    return vals, idx


fused_expand_cuda.launches = 0
