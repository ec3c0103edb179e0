"""CUDA wrapper of the fused PQ ADC expand kernel
(``csrc/pq_adc_expand.cu``).

Replaces ``repro/kernels/pq_adc.py: pq_adc_expand_pallas``: ADC
gather-accumulate + validity mask + C_pca threshold + kSort.L for one
expansion step of the PQ and cascade traversals, one warp per query
row. Codes stay uint8 (16 B per neighbor at S = 16; the reference casts
them to int32 only for the TPU). The table is passed with its row
stride, so the cascade's strided view of its flat per-query row is read
in place. Bound on the card: bytes (the tables). The plain version is
``ref.pq_adc_expand_ref``; ``ops.pq_adc_expand`` picks between them by
tensor device."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, stream_of

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] \
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def lut_rows_ok(lut) -> bool:
    """True iff ``lut`` [B, S, 256] has unit strides inside a row (stride
    (r, 256, 1) for any row stride r): the layout the kernel reads."""
    return lut.dim() == 3 and lut.stride(2) == 1 \
        and (lut.shape[1] <= 1 or lut.stride(1) == 256) \
        and lut.stride(0) >= lut.shape[1] * 256


def pq_adc_expand_cuda(codes, lut, valid, th, k: int):
    """codes: [B, M, S] uint8 contiguous; lut: [B, S, 256] f32 with
    strides (r, 256, 1); valid: [B, M] bool; th: [B] f32 — all on one
    CUDA device; 1 <= k <= M <= 128.
    Returns (vals [B, k] f32 ascending, idx [B, k] int32)."""
    B, M, S = codes.shape
    check_cuda(codes, torch.uint8, (B, M, S), "codes")
    if not (isinstance(lut, torch.Tensor) and lut.device == codes.device
            and lut.dtype == torch.float32 and tuple(lut.shape) == (B, S, 256)
            and lut_rows_ok(lut)):
        raise ValueError("lut: expected a float32 [B, S, 256] CUDA tensor "
                         "with strides (r, 256, 1) on the codes' device")
    check_cuda(valid, torch.bool, (B, M), "valid", like=codes)
    check_cuda(th, torch.float32, (B,), "th", like=codes)
    if not 1 <= k <= M or M > 128:
        raise ValueError(f"pq_adc_expand kernel needs 1 <= k <= M <= 128, "
                         f"got k={k}, M={M}")
    vals = torch.empty((B, k), dtype=torch.float32, device=codes.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=codes.device)
    if B == 0:
        return vals, idx
    lib = _build.load("pq_adc_expand")
    fn = lib.pq_adc_expand_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(codes.device):
        err = fn(codes.data_ptr(), lut.data_ptr(), lut.stride(0),
                 valid.data_ptr(), th.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), B, M, S, k, stream_of(codes))
    _build.check(lib, "pq_adc_expand", err)
    pq_adc_expand_cuda.launches += 1
    return vals, idx


pq_adc_expand_cuda.launches = 0
