"""CUDA wrapper of the Dist.L kernel (``csrc/dist_l.cu``).

Replaces ``repro/kernels/dist_l.py: dist_l_pallas``: [B, K, dl] against
[B, dl] squared L2 in f32, one thread per (b, K-row). Bound on the card:
bytes. On the search path it scores the deferred entry point (K = 1) and
the cascade's promote pool (K = promote_mult * ef0). The plain version
is ``ref.dist_l_ref``; the row gather stays outside the kernel, as in
the reference."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, stream_of

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def dist_l_cuda(x, q):
    """x: [B, K, dl] f32; q: [B, dl] f32, contiguous on one CUDA device.
    Returns [B, K] f32 squared distances."""
    B, K, dl = x.shape
    check_cuda(x, torch.float32, (B, K, dl), "x")
    check_cuda(q, torch.float32, (B, dl), "q", like=x)
    out = torch.empty((B, K), dtype=torch.float32, device=x.device)
    if B * K == 0:
        return out
    lib = _build.load("dist_l")
    fn = lib.dist_l_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), out.data_ptr(), B, K, dl,
                 stream_of(x))
    _build.check(lib, "dist_l", err)
    dist_l_cuda.launches += 1
    return out


dist_l_cuda.launches = 0
