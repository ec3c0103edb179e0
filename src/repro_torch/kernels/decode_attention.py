"""CUDA wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py: decode_attention_pallas``:
one query token per (b, h) against a [T, d] KV cache, masked by a
per-batch valid prefix ``length`` read on the card. Flash-decoding: the
cache axis is split into chunks so that B*H*n_split blocks fill the
card, and a second kernel merges the chunks' partial softmax states.
Bound on the card: bytes (the valid K/V prefix). The plain version is
``ref.decode_attention_ref``; ``ops.decode_attention`` picks between
them by tensor device."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, stream_of

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                          ctypes.c_int,
                                                          ctypes.c_void_p]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WARPS = 4                 # csrc/decode_attention.cu kWarps
BLOCKS_PER_SM = 8         # blocks the split aims to put on each SM


def split_plan(bh: int, T: int, sms: int) -> tuple:
    """(chunk, n_split): the cache axis in ``n_split`` chunks of ``chunk``
    keys (a multiple of the 4 warps' 32-key tiles), enough of them that
    ``bh * n_split`` blocks put ``BLOCKS_PER_SM`` on each of ``sms`` SMs
    where T allows."""
    ceil = lambda a, b: -(-a // b)
    T = max(T, 1)
    want = ceil(BLOCKS_PER_SM * sms, max(bh, 1))
    tile = 32 * WARPS
    chunk = ceil(ceil(T, want), tile) * tile
    return chunk, ceil(T, chunk)


def smem_bytes(d: int) -> int:
    """Static shared memory of one partial block at head dim d (the
    kernel's ``decode_attention_smem_bytes``)."""
    e = 1 if d <= 32 else 2 if d <= 64 else 4 if d <= 128 else 8
    return 4 * (2 * WARPS + WARPS * 32 * e)


def decode_attention_cuda(q, k, v, length):
    """q: [B, H, d]; k, v: [B, H, T, d], all one dtype (f32 or bf16);
    length: [B] int32 — contiguous on one CUDA device; 1 <= d <= 256.
    Returns [B, H, d] in q's dtype."""
    B, H, d = q.shape
    T = k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    check_cuda(q, q.dtype, (B, H, d), "q")
    check_cuda(k, q.dtype, (B, H, T, d), "k", like=q)
    check_cuda(v, q.dtype, (B, H, T, d), "v", like=q)
    check_cuda(length, torch.int32, (B,), "length", like=q)
    if not 1 <= d <= 256:
        raise ValueError(f"decode_attention kernel needs 1 <= d <= 256, "
                         f"got d={d}")
    out = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    if B * H == 0:
        return out
    if T == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, n_split = split_plan(B * H, T, sms)
    part_ml = torch.empty((B * H * n_split * 2,), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B * H * n_split * d,), dtype=torch.float32,
                           device=q.device)
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                 part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                 B, H, T, d, chunk, n_split, d ** -0.5, DTYPES[q.dtype],
                 stream_of(q))
    _build.check(lib, "decode_attention", err)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
