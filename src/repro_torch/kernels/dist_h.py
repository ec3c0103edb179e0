"""CUDA wrapper of the Dist.H kernel (``csrc/dist_h.cu``).

Replaces ``repro/kernels/dist_h.py: dist_h_pallas``: [B, K, D] against
[B, D] squared L2 in f32, one warp per (b, K-row) with float4 loads.
Bound on the card: bytes (the gathered [B, K, D] block). The plain
version is ``ref.dist_h_ref``; the candidate gather stays outside the
kernel, as in the reference."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, stream_of

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def dist_h_cuda(x, q):
    """x: [B, K, D] f32; q: [B, D] f32, contiguous on one CUDA device.
    Returns [B, K] f32 squared distances."""
    B, K, D = x.shape
    check_cuda(x, torch.float32, (B, K, D), "x")
    check_cuda(q, torch.float32, (B, D), "q", like=x)
    out = torch.empty((B, K), dtype=torch.float32, device=x.device)
    if B * K == 0:
        return out
    lib = _build.load("dist_h")
    fn = lib.dist_h_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), out.data_ptr(), B, K, D,
                 stream_of(x))
    _build.check(lib, "dist_h", err)
    dist_h_cuda.launches += 1
    return out


dist_h_cuda.launches = 0
