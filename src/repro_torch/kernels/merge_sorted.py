"""CUDA wrapper of the sorted-merge kernel (``csrc/merge_sorted.cu``).

Replaces ``repro/kernels/merge_sorted.py: merge_sorted_pallas``: merge
two ascending (dist, idx) lists and keep the k smallest, ties to the a
side, then the lower slot; one block per row, one thread per element,
binary searches in shared memory, or in global memory for rows past
the card's opt-in maximum (``merge_plan``). Bound on the card: bytes.
The plain version is ``ref.merge_topk_sorted_ref``. On the search path
``trip_fold`` folds a trip's merges into one launch; this kernel stays
the counterpart of the reference's op."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (SMEM_DEFAULT, check_cuda,
                                         smem_optin, stream_of, warps_for)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def staged_plan(n: int, smem_optin: int) -> dict:
    """The tier of a block-per-row kernel over a row of n f32 (merge and
    kSort.L): staged in the default shared memory up to 12288 elements,
    in opted-in shared memory up to ``smem_optin`` bytes (the card's
    opt-in maximum), else read in
    place from global memory. Every n >= 1 is served."""
    smem = 4 * n
    tier = "shared" if smem <= SMEM_DEFAULT else \
        "shared_optin" if smem <= smem_optin else "global"
    return {"tier": tier, "staged": tier != "global",
            "smem": smem if tier != "global" else 0,
            "threads": warps_for(n)}


def merge_plan(Na: int, Nb: int, smem_optin: int) -> dict:
    """``staged_plan`` of the merged row (Na + Nb elements)."""
    return staged_plan(Na + Nb, smem_optin)


def merge_sorted_cuda(d_a, i_a, d_b, i_b, k: int):
    """d_a/i_a: [B, Na] f32/int32, d_b/i_b: [B, Nb], each row ascending,
    contiguous on one CUDA device; 1 <= k <= Na + Nb.
    Returns (d [B, k] f32, i [B, k] int32) ascending."""
    B, Na = d_a.shape
    Nb = d_b.shape[1]
    check_cuda(d_a, torch.float32, (B, Na), "d_a")
    check_cuda(i_a, torch.int32, (B, Na), "i_a", like=d_a)
    check_cuda(d_b, torch.float32, (B, Nb), "d_b", like=d_a)
    check_cuda(i_b, torch.int32, (B, Nb), "i_b", like=d_a)
    if not 1 <= k <= Na + Nb:
        raise ValueError(f"merge_sorted kernel needs 1 <= k <= Na + Nb, got "
                         f"k={k}, Na={Na}, Nb={Nb}")
    od = torch.empty((B, k), dtype=torch.float32, device=d_a.device)
    oi = torch.empty((B, k), dtype=torch.int32, device=d_a.device)
    if B == 0:
        return od, oi
    plan = merge_plan(Na, Nb, smem_optin(d_a.device))
    lib = _build.load("merge_sorted")
    fn = lib.merge_sorted_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(d_a.device):
        err = fn(d_a.data_ptr(), i_a.data_ptr(), d_b.data_ptr(),
                 i_b.data_ptr(), od.data_ptr(), oi.data_ptr(),
                 B, Na, Nb, k, int(plan["staged"]), stream_of(d_a))
    _build.check(lib, "merge_sorted", err)
    merge_sorted_cuda.launches += 1
    return od, oi


merge_sorted_cuda.launches = 0
