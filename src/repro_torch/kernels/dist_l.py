"""CUDA wrapper of the Dist.L kernel (``csrc/dist_l.cu``).

Replaces ``repro/kernels/dist_l.py: dist_l_pallas``: [B, K, dl] rows (f32
or bf16, read as they are and widened in the kernel) against [B, dl] f32
queries, squared L2 in f32, a thread a row with the row's loads unrolled.
Bound on the card: bytes. On the search path it scores the deferred
entry point (K = 1) and the cascade's promote pool (K = promote_mult *
ef0). The plain version is ``ref.dist_l_ref``; the row gather stays
outside the kernel, as in the reference."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (PAYLOAD_DTYPES, check_cuda, sm_count,
                                         stream_of)

# x, q, out, B, K, dl, threads, bf16, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
THREADS = (64, 128)        # fewest and most threads a block


def dist_l_plan(rows: int, sms: int) -> dict:
    """The launch of ``csrc/dist_l.cu`` for ``rows`` rows on a card of
    ``sms`` SMs: a thread a row, ``threads`` a block (128, fewer in whole
    warps down to 64 where that gives more of the SMs a block) and
    ``grid`` blocks."""
    per_sm = -(-rows // sms)
    threads = min(THREADS[1], max(THREADS[0], -(-per_sm // 32) * 32))
    return {"threads": threads, "grid": -(-rows // threads)}


def dist_l_cuda(x, q):
    """x: [B, K, dl] f32 or bf16; q: [B, dl] f32, contiguous on one CUDA
    device. Returns [B, K] f32 squared distances."""
    B, K, dl = x.shape
    check_cuda(x, PAYLOAD_DTYPES, (B, K, dl), "x")
    check_cuda(q, torch.float32, (B, dl), "q", like=x)
    out = torch.empty((B, K), dtype=torch.float32, device=x.device)
    if B * K == 0:
        return out
    plan = dist_l_plan(B * K, sm_count(x.device))
    lib = _build.load("dist_l")
    fn = lib.dist_l_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), out.data_ptr(), B, K, dl,
                 plan["threads"], int(x.dtype == torch.bfloat16),
                 stream_of(x))
    _build.check(lib, "dist_l", err)
    dist_l_cuda.launches += 1
    return out


dist_l_cuda.launches = 0
