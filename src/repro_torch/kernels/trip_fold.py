"""CUDA wrapper of the trip fold kernel (``csrc/trip_fold.cu``).

One traversal trip's frontier update in one launch: the accept test
against F's bound, the 1-3 feeds (the C row, the F row with tombstones
masked, the C_pca heap's row), each ranked by (dist, slot) and merged
k-bounded into its frontier with ``merge_sorted``'s tie rules (C's
frontier is the trip's pop, C[W:] and W (INF, -1) pads). It replaces the
search's accept, ``where`` rows, ``cat``, stable sort, ``gather``, the
pop's two ``cat`` and the three merges of ``repro/core/search_jax.py:
_layer_body`` (each merge the reference's ``merge_sorted_pallas``). A
warp per query row with the row in its slice of shared memory; long
rows a block per row, in shared or global memory (``fold_plan``). It
only compares and moves, so it equals the plain version
``ref.trip_fold_ref`` bit for bit; ``ops.trip_fold`` picks between them
by tensor device. The slotted search gates it per row: ``ef_eff`` picks
the slot of F that bounds the accept test, and ``pop`` keeps C unshifted
on a row that is done or frozen at its step budget; without them the
kernel runs the synchronous search's fold. Stacked tombstone words
[P, nw] (the slotted sharded programs over
``core.distributed.stacked_db_view``) fold every shard's rows in one
launch, row r masked with shard r // (B / P)'s words."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (SMEM_DEFAULT, check_cuda, ptr,
                                         scratch_rows, smem_optin, stream_of,
                                         warps_for)

# Fd, Fi, Cd, Ci, Cp, dh, cand, kv, deleted, del_stride, shard_b, ef_eff,
# pop, the five outputs, B, ef, cap, k, kk, W, threads, scratch, stream
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int] \
    + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
WARPS_PER_BLOCK = 4            # csrc/trip_fold.cu kWarpsPerBlock
WARP_MAX_FEED = 64             # the warp tier's widest feed (W * k)


def slice_words(ef: int, cap: int, k: int, kk: int) -> int:
    """4-byte words of one row's slice (csrc/trip_fold.cu slice_words):
    F and C (dists and ids), the heap's k dists (k = 0 without one), the
    feed as read (dh, cand, kv), its masked rows and its sorted dists."""
    return 2 * ef + 2 * cap + k + 8 * kk


def fold_plan(ef: int, cap: int, k: int, kk: int, smem_optin: int) -> dict:
    """The fold's tier for frontiers F [ef], C [cap], a heap of k (0
    without one) and a feed of kk: a warp per row, four rows' slices in
    the default 48 KB of shared memory, while the feed is at most
    ``WARP_MAX_FEED`` wide; else a block of ``threads`` per row with the
    slice in (opted-in) shared memory, or past ``smem_optin`` (the card's
    opt-in maximum, bytes) in a ``scratch`` row of global memory. Every shape is served."""
    n = slice_words(ef, cap, k, kk)
    if kk <= WARP_MAX_FEED and WARPS_PER_BLOCK * 4 * n <= SMEM_DEFAULT:
        return {"tier": "warp", "threads": 0,
                "smem": WARPS_PER_BLOCK * 4 * n, "scratch": 0}
    threads = warps_for(max(kk, cap, ef), 512)
    if 4 * n <= smem_optin:
        return {"tier": "block", "threads": threads, "smem": 4 * n,
                "scratch": 0}
    return {"tier": "global", "threads": threads, "smem": 0, "scratch": n}


def trip_fold_cuda(F_d, F_i, C_d, C_i, W: int, Cp, dh, cand, kv=None,
                   deleted=None, ef_eff=None, pop=None):
    """F_d/F_i: [B, ef] f32/int32 and C_d/C_i: [B, cap], each row
    ascending (C as it was before the trip's pop of W); Cp: [B, k] f32
    ascending, or None (the filter bypass); dh/cand: [B, kk] f32/int32;
    kv: [B, kk] f32, or None (the heap is fed the C row's dists; needs
    Cp); deleted: the tombstone words [nw] int32, stacked [P, nw] (row r
    reads shard r // (B / P)'s, P dividing B), or None; ef_eff: [B]
    int32 in [1, ef], the slot of F that bounds each row's accept test,
    or None (slot ef - 1); pop: [B] bool or uint8, 0 where the row keeps
    C unpopped, or None (every row pops). All contiguous on one CUDA
    device. Returns new (F_d, F_i, C_d, C_i, Cp)."""
    B, ef = F_d.shape
    cap, kk = C_d.shape[1], dh.shape[1]
    check_cuda(F_d, torch.float32, (B, ef), "F_d")
    check_cuda(F_i, torch.int32, (B, ef), "F_i", like=F_d)
    check_cuda(C_d, torch.float32, (B, cap), "C_d", like=F_d)
    check_cuda(C_i, torch.int32, (B, cap), "C_i", like=F_d)
    check_cuda(dh, torch.float32, (B, kk), "dh", like=F_d)
    check_cuda(cand, torch.int32, (B, kk), "cand", like=F_d)
    k = 0
    if Cp is not None:
        k = Cp.shape[1]
        check_cuda(Cp, torch.float32, (B, k), "Cp", like=F_d)
    if kv is not None:
        if Cp is None:
            raise ValueError("trip_fold: kv feeds the heap; Cp is None")
        check_cuda(kv, torch.float32, (B, kk), "kv", like=F_d)
    shard_b, del_stride = max(B, 1), 0
    if deleted is not None:
        check_cuda(deleted, torch.int32, tuple(deleted.shape), "deleted",
                   like=F_d)
        if deleted.dim() == 2:
            P = deleted.shape[0]
            if P < 1 or B % P:
                raise ValueError(f"trip_fold: {B} rows do not split into "
                                 f"{P} shards")
            shard_b, del_stride = max(B // P, 1), deleted.shape[1]
        elif deleted.dim() != 1:
            raise ValueError("deleted: expected [nw] or [P, nw] words")
    if ef_eff is not None:
        check_cuda(ef_eff, torch.int32, (B,), "ef_eff", like=F_d)
    if pop is not None:
        check_cuda(pop, (torch.bool, torch.uint8), (B,), "pop", like=F_d)
    if ef < 1 or cap < 1 or kk < 1 or (Cp is not None and k < 1) \
            or W < 0:
        raise ValueError(f"trip_fold kernel needs ef, cap, kk, k >= 1 and "
                         f"W >= 0, got ef={ef}, cap={cap}, kk={kk}, k={k}, "
                         f"W={W}")
    dev = F_d.device
    oFd, oFi = torch.empty_like(F_d), torch.empty_like(F_i)
    oCd, oCi = torch.empty_like(C_d), torch.empty_like(C_i)
    oCp = None if Cp is None else torch.empty_like(Cp)
    if B == 0:
        return oFd, oFi, oCd, oCi, oCp
    plan = fold_plan(ef, cap, k, kk, smem_optin(dev))
    scratch = scratch_rows(plan, B, dev)
    lib = _build.load("trip_fold")
    fn = lib.trip_fold_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(F_d.data_ptr(), F_i.data_ptr(), C_d.data_ptr(),
                 C_i.data_ptr(), ptr(Cp), dh.data_ptr(), cand.data_ptr(),
                 ptr(kv), ptr(deleted), del_stride, shard_b, ptr(ef_eff),
                 ptr(pop),
                 oFd.data_ptr(), oFi.data_ptr(),
                 oCd.data_ptr(), oCi.data_ptr(), ptr(oCp), B, ef, cap, k,
                 kk, W, plan["threads"], ptr(scratch), stream_of(F_d))
    _build.check(lib, "trip_fold", err)
    trip_fold_cuda.launches += 1
    if ef_eff is not None or pop is not None:
        trip_fold_gated.launches += 1
    return oFd, oFi, oCd, oCi, oCp


def trip_fold_gated():
    """The launch count of ``trip_fold_cuda`` gated per row (``ef_eff``
    or ``pop`` given: the slotted search); each is also one of
    ``trip_fold_cuda.launches``."""


trip_fold_cuda.launches = 0
trip_fold_gated.launches = 0
