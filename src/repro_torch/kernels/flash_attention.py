"""CUDA wrapper of the flash attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py: flash_attention_pallas``:
tiled online-softmax attention, causal with an optional sliding window,
q aligned to the end of the kv axis, logits in f32, grouped-query
attention (q heads a multiple of kv heads; query head h reads kv head
h // (H // KV)). Two kernels, any S,
T and d <= 256, ragged edges masked: bf16 runs on the tensor cores
(``mma.sync``; one block per 128-row query tile, K and V in a ring of
``cp.async`` stages), and where the grid would not fill the card
each tile's kv range is split over several blocks whose partial states a
second kernel merges (``split_plan``); f32 runs on the f32 FMA units (64
x 64 tiles). Bound on the card: operations at model widths, bytes at
small S*T. The plain version is ``ref.flash_attention_ref``.

The dispatcher sees the kernel as the operator
``repro_torch::flash_attention`` (``torch.ops.repro_torch
.flash_attention``): a CUDA tensor launches the kernel, a CPU tensor
takes the plain version, a "meta" tensor gets the output's shape and
dtype, and ``torch.utils.flop_counter`` counts it by ``flops``, so a
``FlopCounterMode`` or the dry-run's counter around a step on the card
or on "meta" sees the attention. It is registered through
``torch.library.Library``, one Python kernel a dispatch key (lighter
than ``torch.library.custom_op``, whose wrapper adds its own Python
layers). Even so, on the
H100's host the operator adds 10.26-13.17 us a call over
``flash_attention_cuda`` at row 8b's shape, 4.38-6.22 us of it the
dispatcher alone (PERF.md), so ``ops.flash_attention`` takes it
only where a dispatch mode watches or on "meta" (``ops._watched``)."""
from __future__ import annotations

import ctypes

import torch

from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, ref
from repro_torch.kernels._launch import check_cuda, stream_of

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BQ_F32 = 64               # csrc/flash_attention.cu kBQ (f32 kernel)
BQ = 128                  # tc::Shape::kBQ (bf16 kernel: 8 warps of 16 rows)
BK = 64                   # kBK, both kernels
LD = 68                   # the f32 kernel's shared-memory row stride kLd
MAX_SPLIT = 16            # most blocks one query tile's kv range is split over
SMS = 132                 # SMs of an H100 SXM, split_plan's default


def padded_dim(d: int) -> int:
    """d padded to the kernels' 64, 128 or 256."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def stages(d: int) -> int:
    """Depth of the bf16 kernel's K/V ring (tc::Shape::kStages)."""
    return 3 if padded_dim(d) <= 128 else 2


def blocks_per_sm(d: int) -> int:
    """bf16 blocks that fit on one SM (tc::Shape::kBlocksPerSM, the
    kernel's ``__launch_bounds__``): two at DP = 64, one above."""
    return 2 if padded_dim(d) == 64 else 1


def smem_bytes(d: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one block at head dim d (the kernel's
    ``flash_attention_smem_bytes``). bf16: Q [128][DP] and ``stages(d)``
    stages of K and V [64][DP] in bf16, and two 8-byte mbarriers a stage;
    f32: Q^T and K^T [DP][68] and V [64][DP + 4], f32. DP = d padded to
    64, 128 or 256."""
    dp = padded_dim(d)
    if dtype == torch.float32:
        return 4 * (2 * dp * LD + BK * (dp + 4))
    return 2 * dp * (BQ + 2 * stages(d) * BK) + 16 * stages(d)


def kv_tiles(q_tile: int, S: int, T: int, causal: bool, window: int,
             bq: int) -> tuple:
    """(first key, number of BK-key tiles) that the rows of query tile
    ``q_tile`` (rows q_tile*bq .. +bq-1, at positions row + T - S) can
    see, as the kernel computes it: from the window's start rounded down
    to a tile to the causal end (or T)."""
    pos_lo = q_tile * bq + T - S
    pos_hi = min(q_tile * bq + bq, S) - 1 + T - S
    begin = max(0, (pos_lo - window + 1) // BK * BK) if window > 0 else 0
    end = min(T, pos_hi + 1) if causal else T
    return begin, (-(-(end - begin) // BK) if end > begin else 0)


def chunk_tiles(n_tiles: int, n_split: int, split: int) -> tuple:
    """Tiles [lo, hi) of chunk ``split`` of ``n_split``, as the kernel
    splits a query tile's ``n_tiles`` kv tiles; a chunk may be empty."""
    return split * n_tiles // n_split, (split + 1) * n_tiles // n_split


def split_plan(B: int, H: int, S: int, T: int, d: int, causal: bool,
               window: int, sms: int = SMS) -> int:
    """Blocks each bf16 query tile's kv range is split over. 1 where the
    B*H*ceil(S/128) tiles give two waves or more on ``sms`` SMs;
    else the count (at most ``MAX_SPLIT`` and the most kv tiles a query
    tile has) that best fills whole waves, each larger count taken only
    if it cuts the waves per unit of work by a tenth."""
    n_qt = -(-S // BQ)
    tiles = B * H * n_qt
    slots = sms * blocks_per_sm(d)
    if tiles >= 2 * slots:
        return 1
    most = max(kv_tiles(i, S, T, causal, window, BQ)[1]
               for i in range(n_qt))
    best, cost = 1, -(-tiles // slots)
    for s in range(2, min(most, MAX_SPLIT) + 1):
        c = -(-tiles * s // slots) / s
        if c < 0.9 * cost:
            best, cost = s, c
    return best


def flash_attention_cuda(q, k, v, *, causal: bool, window: int,
                         n_split: int | None = None):
    """q: [B, H, S, d]; k, v: [B, KV, T, d] with H a multiple of KV, all
    one dtype (f32 or bf16), contiguous on one CUDA device; 1 <= d <= 256;
    window >= 0 (0: none).
    ``n_split`` forces the bf16 kernel's split count (default
    ``split_plan``'s); the f32 kernel takes only 1. Returns [B, H, S, d]
    in q's dtype."""
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention kernel needs q heads a multiple "
                         f"of kv heads, got {H} and {KV}")
    check_cuda(q, q.dtype, (B, H, S, d), "q")
    check_cuda(k, q.dtype, (B, KV, T, d), "k", like=q)
    check_cuda(v, q.dtype, (B, KV, T, d), "v", like=q)
    if not 1 <= d <= 256 or window < 0 or -(-S // BQ_F32) > 65535:
        raise ValueError(f"flash_attention kernel needs 1 <= d <= 256, "
                         f"window >= 0 and S <= {65535 * BQ_F32}, got d={d}, "
                         f"window={window}, S={S}")
    bf16 = q.dtype == torch.bfloat16
    if n_split is not None and not (1 <= n_split <= (MAX_SPLIT if bf16
                                                      else 1)):
        raise ValueError(f"flash_attention: n_split={n_split} outside "
                         f"1..{MAX_SPLIT if bf16 else 1} for {q.dtype}")
    out = torch.empty((B, H, S, d), dtype=q.dtype, device=q.device)
    if B * H * S == 0:
        return out
    if T == 0:
        return out.zero_()
    if n_split is None:
        n_split = split_plan(B, H, S, T, d, causal, window, torch.cuda.
                             get_device_properties(q.device)
                             .multi_processor_count) if bf16 else 1
    part_ml = part_acc = None
    if n_split > 1:
        rows = B * H * S * n_split
        part_ml = torch.empty((rows * 2,), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((rows * d,), dtype=torch.float32,
                               device=q.device)
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if part_ml is None else part_ml.data_ptr(),
                 None if part_acc is None else part_acc.data_ptr(),
                 B * H, S, T, d, H // KV, int(bool(causal)), int(window),
                 d ** -0.5,
                 DTYPES[q.dtype], n_split, stream_of(q))
    _build.check(lib, "flash_attention", err)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


# --------------------------------------------------------------------------
# the operator the dispatcher sees
# --------------------------------------------------------------------------

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window) -> Tensor")
_LIB.impl("flash_attention", lambda q, k, v, causal, window:
          ref.flash_attention_ref(q, k, v, causal=causal, window=window),
          "CPU")
_LIB.impl("flash_attention", lambda q, k, v, causal, window:
          flash_attention_cuda(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window),
          "CUDA")
_LIB.impl("flash_attention", lambda q, k, v, causal, window:
          q.new_empty(q.shape), "Meta")


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """4 B H S T d: the plain version's two matmuls (q k^T and p v) over
    the whole S x T score matrix, no causal or window skipping, as the
    reference's jnp oracle's dots count on the CPU."""
    B, H, S, d = q_shape
    return 4 * B * H * S * k_shape[2] * d
