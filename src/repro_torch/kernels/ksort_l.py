"""CUDA wrapper of the kSort.L kernel (``csrc/ksort_l.cu``).

Replaces ``repro/kernels/ksort_l.py: ksort_l_pallas``: the k smallest
(value, index) pairs of each row of [B, M], ascending, ties to the lower
index. Rows of up to 512 values (every main-path width) are sorted by
one warp each, a bitonic network on 64-bit (value, index) keys
(``csrc/warp_sort.cuh``; ``sort_keys`` is its key in plain PyTorch);
wider rows are ranked by a block each, in shared memory, or in global
memory past the card's opt-in maximum (``ksort_plan``). Bound on the
card: bytes. On the search path it is the cross-shard merge of
``core/distributed.py``. The plain version is ``ref.ksort_l_ref``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, smem_optin, stream_of
from repro_torch.kernels.merge_sorted import staged_plan

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
WARP_MAX = 512            # widest row the warp tier sorts (16 values a lane)
ROWS_PER_BLOCK = 4        # rows (warps) of a warp-tier block
_MODES = {"global": 0, "shared": 1, "shared_optin": 1, "warp": 2}


def ksort_plan(M: int, smem_optin: int) -> dict:
    """The tier of a row of M values: ``warp`` up to ``WARP_MAX`` (``run``
    values a lane, a power of two with 32 * run >= M; ``rows_per_block``
    rows a block), else ``staged_plan``'s block tiers, one row a block."""
    if M <= WARP_MAX:
        run = 1
        while 32 * run < M:
            run *= 2
        return {"tier": "warp", "staged": False, "smem": 0,
                "threads": 32 * ROWS_PER_BLOCK,
                "rows_per_block": ROWS_PER_BLOCK, "run": run}
    return {**staged_plan(M, smem_optin), "rows_per_block": 1, "run": 0}


def sort_keys(d):
    """The warp tier's 64-bit keys of d [B, M] f32 as int64, in plain
    PyTorch: -0.0 folded to +0.0, then the f32 bits made orderable (a
    clear sign bit set, a set one flipping every bit), shifted above the
    index. Read as unsigned, their ascending order is the stable sort's;
    the int64 here is that order with the top bit flipped."""
    u = d.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = u & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    neg = (u & 0x80000000) != 0
    u = torch.where(neg, u ^ 0xFFFFFFFF, u | 0x80000000)
    idx = torch.arange(d.shape[-1], dtype=torch.int64, device=d.device)
    # (u << 32 | idx) - 2**63: unsigned order -> signed int64 order
    return (u - 0x80000000) * (1 << 32) + idx


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
                 _MODES[plan["tier"]], plan["run"], plan["rows_per_block"],
                 stream_of(d))
    _build.check(lib, "ksort_l", err)
    ksort_l_cuda.launches += 1
    return ov, oi


ksort_l_cuda.launches = 0
