"""CUDA wrappers of the fused PQ ADC expand kernel
(``csrc/pq_adc_expand.cu``), with and without the row gathers.

``pq_adc_expand_cuda`` replaces ``repro/kernels/pq_adc.py:
pq_adc_expand_pallas``: ADC gather-accumulate + validity mask + C_pca
threshold + kSort.L over a gathered [B, M, S] code block. It stays the
counterpart of the reference's op. ``pq_expand_rows_cuda`` is the same
body with the gathers fused in, the PQ and cascade traversals' expand:
from the layer's ``adj`` [N, M0] and layout-(3) codes [N, M0, S], the
popped ids and their gates, it reads each popped node's adjacency row
and its neighbours' codes in place and returns the winners' neighbour
ids. It replaces the search's ``clamp``/``where`` of the popped ids, the
two ``index_select`` (the [B, W*M0, S] code block is never written),
the mask's ops and the id ``gather`` around the kernel.

One warp per query row up to M = 128, one block per row above
(``fused_filter.expand_plan``, the filter expand's tiers). Codes stay
uint8 (16 B per neighbor at S = 16; the reference casts them to int32
only for the TPU). The table is passed
with its row stride, so the cascade's strided view of its flat
per-query row is read in place; so are the popped ids (a view of the
frontier C) and the threshold (a column of the C_pca heap). Stacked
(``adj`` [P, N, M0], codes [P, N, M0, S]: the slotted sharded programs
over ``core.distributed.stacked_db_view``), one launch expands every
shard's rows, row r reading shard r // (B / P). Bound on the
card: bytes (the tables). The plain versions are
``ref.pq_adc_expand_ref`` and ``ref.pq_expand_rows_ref``; ``ops`` picks
between kernel and plain version by tensor device."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (check_cuda, ptr, scratch_rows,
                                         smem_optin, stream_of)
from repro_torch.kernels.fused_filter import expand_plan, stacked_layer

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] \
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
# adj, codes, cw, cw_stride, gate, lut, lut_stride, th, th_stride, out_d,
# out_i, B, W, M0, S, k, shard_b, shard_n, per_lane, threads, scratch,
# stream
_ROWS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
    + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p,
                               ctypes.c_longlong] \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2


def lut_rows_ok(lut) -> bool:
    """True iff ``lut`` [B, S, 256] has unit strides inside a row (stride
    (r, 256, 1) for any row stride r): the layout the kernel reads."""
    return lut.dim() == 3 and lut.stride(2) == 1 \
        and (lut.shape[1] <= 1 or lut.stride(1) == 256) \
        and lut.stride(0) >= lut.shape[1] * 256


def _check_lut(lut, like, B: int, S: int) -> None:
    if not (isinstance(lut, torch.Tensor) and lut.device == like.device
            and lut.dtype == torch.float32 and tuple(lut.shape) == (B, S, 256)
            and lut_rows_ok(lut)):
        raise ValueError("lut: expected a float32 [B, S, 256] CUDA tensor "
                         "with strides (r, 256, 1) on the codes' device")


def pq_adc_expand_cuda(codes, lut, valid, th, k: int):
    """codes: [B, M, S] uint8 contiguous; lut: [B, S, 256] f32 with
    strides (r, 256, 1); valid: [B, M] bool; th: [B] f32 — all on one
    CUDA device; 1 <= k <= M.
    Returns (vals [B, k] f32 ascending, idx [B, k] int32)."""
    B, M, S = codes.shape
    check_cuda(codes, torch.uint8, (B, M, S), "codes")
    _check_lut(lut, codes, B, S)
    check_cuda(valid, torch.bool, (B, M), "valid", like=codes)
    check_cuda(th, torch.float32, (B,), "th", like=codes)
    if not 1 <= k <= M:
        raise ValueError(f"pq_adc_expand kernel needs 1 <= k <= M, got "
                         f"k={k}, M={M}")
    vals = torch.empty((B, k), dtype=torch.float32, device=codes.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=codes.device)
    if B == 0:
        return vals, idx
    plan = expand_plan(M, smem_optin(codes.device))
    scratch = scratch_rows(plan, B, codes.device)
    lib = _build.load("pq_adc_expand")
    fn = lib.pq_adc_expand_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(codes.device):
        err = fn(codes.data_ptr(), lut.data_ptr(), lut.stride(0),
                 valid.data_ptr(), th.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), B, M, S, k, plan["per_lane"],
                 plan["threads"], ptr(scratch),
                 stream_of(codes))
    _build.check(lib, "pq_adc_expand", err)
    pq_adc_expand_cuda.launches += 1
    return vals, idx


pq_adc_expand_cuda.launches = 0


def pq_expand_rows_cuda(adj, codes, c_w, exp, lut, th, k: int):
    """adj: [N, M0] int32 and codes: [N, M0, S] uint8, contiguous (a
    layer of the db), or stacked [P, N, M0] and [P, N, M0, S] (row r
    reads shard r // (B / P), P dividing B); c_w: [B, W] int32 popped
    ids and th: [B] f32, each with any row stride (and unit inner
    stride); exp: [B, W] bool
    contiguous; lut: [B, S, 256] f32 with strides (r, 256, 1); all on one
    CUDA device; 1 <= k <= W * M0.
    Returns (vals [B, k] f32 ascending, cand [B, k] int32 neighbour
    ids)."""
    B, W = c_w.shape
    P, N, M0, shard_b, shard_n = stacked_layer(adj, codes, B,
                                               "pq_expand_rows")
    lead = (N, M0) if adj.dim() == 2 else (P, N, M0)
    S = codes.shape[-1]
    check_cuda(adj, torch.int32, lead, "adj")
    check_cuda(codes, torch.uint8, lead + (S,), "codes", like=adj)
    check_cuda(exp, torch.bool, (B, W), "exp", like=adj)
    for t, name, dt in ((c_w, "c_w", torch.int32), (th, "th", torch.float32)):
        if not (isinstance(t, torch.Tensor) and t.device == adj.device
                and t.dtype == dt and t.shape[0] == B
                and (t.dim() == 1 or t.stride(1) == 1)):
            raise ValueError(f"{name}: expected a {dt} tensor on the adj's "
                             "device with B rows and unit inner stride")
    if th.dim() != 1:
        raise ValueError("th: expected [B]")
    _check_lut(lut, adj, B, S)
    M = W * M0
    if not 1 <= k <= M:
        raise ValueError(f"pq_expand_rows kernel needs 1 <= k <= W * M0, got "
                         f"k={k}, W={W}, M0={M0}")
    vals = torch.empty((B, k), dtype=torch.float32, device=adj.device)
    cand = torch.empty((B, k), dtype=torch.int32, device=adj.device)
    if B == 0:
        return vals, cand
    plan = expand_plan(M, smem_optin(adj.device))
    scratch = scratch_rows(plan, B, adj.device)
    lib = _build.load("pq_adc_expand")
    fn = lib.pq_expand_rows_launch
    fn.argtypes, fn.restype = _ROWS_ARGTYPES, ctypes.c_int
    with torch.cuda.device(adj.device):
        err = fn(adj.data_ptr(), codes.data_ptr(), c_w.data_ptr(),
                 c_w.stride(0), exp.data_ptr(), lut.data_ptr(),
                 lut.stride(0), th.data_ptr(), th.stride(0),
                 vals.data_ptr(), cand.data_ptr(), B, W, M0, S, k, shard_b,
                 shard_n, plan["per_lane"], plan["threads"], ptr(scratch),
                 stream_of(adj))
    _build.check(lib, "pq_adc_expand", err)
    pq_expand_rows_cuda.launches += 1
    return vals, cand


pq_expand_rows_cuda.launches = 0
