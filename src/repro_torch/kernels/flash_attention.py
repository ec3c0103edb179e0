"""CUDA wrapper of the flash attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py: flash_attention_pallas``:
tiled online-softmax attention, causal with an optional sliding window,
q aligned to the end of the kv axis, logits in f32. One block per (b*h,
64-row query tile) loops over the kv tiles it can see (64 x 64, the
kernel's own tiles: any S, T and d <= 256), f32 FMA. Bound on the card:
operations at model widths, bytes at small S*T. The plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` picks between them
by tensor device."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, stream_of

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                          ctypes.c_int,
                                                          ctypes.c_void_p]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BQ = BK = 64              # csrc/flash_attention.cu kBQ, kBK
LD = 68                   # its shared-memory row stride kLd


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block at head dim d (the kernel's
    ``flash_attention_smem_bytes``): Q^T and K^T [DP][68] and V
    [64][DP + 4] in f32, DP = d padded to 64, 128 or 256."""
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    return 4 * (2 * dp * LD + BK * (dp + 4))


def flash_attention_cuda(q, k, v, *, causal: bool, window: int):
    """q: [B, H, S, d]; k, v: [B, H, T, d], all one dtype (f32 or bf16),
    contiguous on one CUDA device; 1 <= d <= 256; window >= 0 (0: none).
    Returns [B, H, S, d] in q's dtype."""
    B, H, S, d = q.shape
    T = k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    check_cuda(q, q.dtype, (B, H, S, d), "q")
    check_cuda(k, q.dtype, (B, H, T, d), "k", like=q)
    check_cuda(v, q.dtype, (B, H, T, d), "v", like=q)
    if not 1 <= d <= 256 or window < 0 or -(-S // BQ) > 65535:
        raise ValueError(f"flash_attention kernel needs 1 <= d <= 256, "
                         f"window >= 0 and S <= {65535 * BQ}, got d={d}, "
                         f"window={window}, S={S}")
    out = torch.empty((B, H, S, d), dtype=q.dtype, device=q.device)
    if B * H * S == 0:
        return out
    if T == 0:
        return out.zero_()
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B * H, S, T, d, int(bool(causal)), int(window), d ** -0.5,
                 DTYPES[q.dtype], stream_of(q))
    _build.check(lib, "flash_attention", err)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
