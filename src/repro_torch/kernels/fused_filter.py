"""CUDA wrappers of the fused filter kernels (``csrc/fused_expand.cu``
and ``csrc/fused_filter.cu``).

``fused_expand_cuda`` replaces ``repro/kernels/fused_filter.py:
fused_expand_pallas`` (with its ``ksort_block`` helper): Dist.L +
validity mask + C_pca threshold + kSort.L for one expansion step.
``fused_filter_cuda`` replaces ``fused_filter_pallas``: Dist.L + kSort.L
with no mask and no threshold (the kernel-footprint bench's row). Both
are one body, ``csrc/filter_rows.cuh``, with the mask on or off: one warp
per query row and the top-k of ``csrc/warp_topk.cuh`` up to M = 128, one
block per row above (``expand_plan`` picks the tier). Bound on the card:
bytes (the [B, M, dl] neighbor block). The plain versions are
``ref.fused_expand_ref`` and ``ref.fused_filter_ref``; ``ops`` picks
between kernel and plain version by tensor device."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (check_cuda, ptr, scratch_rows,
                                         smem_optin, stream_of, warps_for)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p] * 2
_FILTER_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p] * 2


def expand_plan(M: int, smem_optin: int) -> dict:
    """The tier of an expand row of M distances (``filter_rows.cuh``,
    also ``pq_adc.py``'s): a warp per row with ``per_lane`` 1, 2 or 4
    elements a lane up to M = 128; above, a block of ``threads`` per row
    with the row's ``smem`` bytes of shared memory (opting in past 48 KB)
    while they fit ``smem_optin`` (the card's opt-in maximum, bytes),
    else a ``scratch`` row of M f32 in global memory. Every M >= 1 is
    served."""
    for per_lane in (1, 2, 4):
        if M <= 32 * per_lane:
            return {"tier": "warp", "per_lane": per_lane, "threads": 128,
                    "smem": 0, "scratch": 0}
    threads = warps_for(M, 512)
    if 4 * M <= smem_optin:
        return {"tier": "block", "per_lane": 0, "threads": threads,
                "smem": 4 * M, "scratch": 0}
    return {"tier": "global", "per_lane": 0, "threads": threads, "smem": 0,
            "scratch": M}


def fused_expand_cuda(x, q, valid, th, k: int):
    """x: [B, M, dl] f32; q: [B, dl] f32; valid: [B, M] bool; th: [B]
    f32 — all contiguous on one CUDA device; 1 <= k <= M.
    Returns (vals [B, k] f32 ascending, idx [B, k] int32)."""
    B, M, dl = x.shape
    check_cuda(x, torch.float32, (B, M, dl), "x")
    check_cuda(q, torch.float32, (B, dl), "q", like=x)
    check_cuda(valid, torch.bool, (B, M), "valid", like=x)
    check_cuda(th, torch.float32, (B,), "th", like=x)
    if not 1 <= k <= M:
        raise ValueError(f"fused_expand kernel needs 1 <= k <= M, got k={k}, "
                         f"M={M}")
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return vals, idx
    plan = expand_plan(M, smem_optin(x.device))
    scratch = scratch_rows(plan, B, x.device)
    lib = _build.load("fused_expand")
    fn = lib.fused_expand_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), valid.data_ptr(),
                 th.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                 B, M, dl, k, plan["per_lane"], plan["threads"],
                 ptr(scratch), stream_of(x))
    _build.check(lib, "fused_expand", err)
    fused_expand_cuda.launches += 1
    return vals, idx


fused_expand_cuda.launches = 0


def fused_filter_cuda(x, q, k: int):
    """x: [B, M, dl] f32; q: [B, dl] f32 — contiguous on one CUDA device;
    1 <= k <= M. Returns (vals [B, k] f32 ascending, idx [B, k]
    int32)."""
    B, M, dl = x.shape
    check_cuda(x, torch.float32, (B, M, dl), "x")
    check_cuda(q, torch.float32, (B, dl), "q", like=x)
    if not 1 <= k <= M:
        raise ValueError(f"fused_filter kernel needs 1 <= k <= M, got k={k}, "
                         f"M={M}")
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return vals, idx
    plan = expand_plan(M, smem_optin(x.device))
    scratch = scratch_rows(plan, B, x.device)
    lib = _build.load("fused_filter")
    fn = lib.fused_filter_launch
    fn.argtypes, fn.restype = _FILTER_ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                 B, M, dl, k, plan["per_lane"], plan["threads"],
                 ptr(scratch), stream_of(x))
    _build.check(lib, "fused_filter", err)
    fused_filter_cuda.launches += 1
    return vals, idx


fused_filter_cuda.launches = 0
