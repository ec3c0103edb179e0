"""CUDA wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py: decode_attention_pallas``:
one query token per (b, h) against a [T, d] KV cache (grouped-query
attention: query head h reads kv head h // (H // KV)), masked by a
per-batch valid prefix ``length`` read on the card. One launch: the cache
axis is split into ``n_split`` chunks, one block each; each block copies
its chunk's K and V tiles into shared memory before any arithmetic (a
ring of tiles where the chunk does not fit), and the last block of a
(b, h) to finish, found by a per-(b, h) counter, merges the chunks'
softmax states in chunk order and zeroes the counter again. Bound on the
card: bytes (the valid K/V prefix). The plain version is
``ref.decode_attention_ref``; ``ops.decode_attention`` picks between
them by tensor device."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda, stream_of

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                          ctypes.c_int,
                                                          ctypes.c_void_p]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COPIES = {"bulk": 0, "cp.async": 1, "ld": 2}   # csrc kCopy*
WARPS = 8              # compute warps a block (kWarps); one more copies
STEPS = 4              # key groups a compute warp takes a tile (kSteps)
MAX_SPLIT = 64         # chunks a (b, h) row (kMaxSplit)
MAX_STAGES = 4         # tiles of a short chunk in flight at once
RING_STAGES = 2        # stages of the ring a longer chunk streams through
STAGE_BUDGET = 128 * 1024  # bytes of K and V tiles a block holds
BLOCKS_PER_SM = 8      # blocks the split aims to put on each SM
SMS = 132              # an H100 SXM's SMs, for plans made without a card


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def lanes(d: int, itemsize: int) -> tuple:
    """(E, G): each key's row is read by G lanes (a power of two, 4..32),
    E consecutive elements each (16 bytes where d allows); the kernel's
    template arguments."""
    ve = 16 // itemsize
    if d <= 32 * ve:
        g = 4
        while g * ve < d:
            g *= 2
        return ve, g
    e = ve
    while 32 * e < d:
        e *= 2
    return e, 32


def copy_mode(d: int, itemsize: int, align: int) -> str:
    """How a tile reaches shared memory. ``bulk``: one TMA bulk copy per
    K or V tile, which needs 16-byte aligned addresses and sizes (rows
    of a multiple of 16 bytes, caches aligned to 16); ``cp.async``:
    4-byte copies (rows of a multiple of 4 bytes); ``ld``: plain loads
    (bf16 rows of odd d). ``align``: the largest power of two, at most
    16, dividing both caches' addresses."""
    row = d * itemsize
    if row % 16 == 0 and align >= 16:
        return "bulk"
    if row % 4 == 0 and align >= 4:
        return "cp.async"
    return "ld"


def smem_bytes(d: int, itemsize: int, tile: int, stages: int) -> int:
    """Dynamic shared memory of one block (the kernel's
    ``decode_attention_smem_bytes``): the stages' full and empty
    barriers, the warps' and the block's softmax states (m, l, acc[d]),
    and ``stages`` K and V tiles of ``tile`` rows."""
    r16 = lambda x: _ceil(x, 16) * 16
    states = 4 * (WARPS + 1) * state_floats(d)
    return r16(16 * stages) + r16(states) + stages * 2 * tile * d * itemsize


def state_floats(d: int) -> int:
    """Floats of one softmax state: m, l and acc[d] (d padded to 4)."""
    return _ceil(d, 4) * 4 + 2


def split_plan(bh: int, T: int, d: int, itemsize: int, sms: int = SMS,
               align: int = 16) -> dict:
    """The launch of one call: ``n_split`` chunks of ``chunk`` keys per
    (b, h) (at most ``MAX_SPLIT``; enough that ``bh * n_split`` blocks
    put ``BLOCKS_PER_SM`` on each of ``sms`` SMs where T allows), tiles of ``tile`` keys (``STEPS`` steps of 32 / G
    keys for each compute warp), ``stages`` of them in shared memory
    (every tile of a chunk at once when it has at most ``MAX_STAGES``,
    else a ring of ``RING_STAGES``; within ``STAGE_BUDGET``), the copy
    mode and the shared memory."""
    E, G = lanes(d, itemsize)
    tile = WARPS * STEPS * (32 // G)
    T = max(T, 1)
    n = min(MAX_SPLIT, _ceil(BLOCKS_PER_SM * sms, max(bh, 1)),
            _ceil(T, tile))
    chunk = _ceil(_ceil(T, n), tile) * tile
    n = _ceil(T, chunk)
    fit = max(1, STAGE_BUDGET // (2 * tile * d * itemsize))
    tiles = _ceil(chunk, tile)
    stages = min(tiles if tiles <= MAX_STAGES else RING_STAGES, fit)
    return {"chunk": chunk, "n_split": n, "tile": tile, "stages": stages,
            "copy": copy_mode(d, itemsize, align), "per_lane": E,
            "lanes_per_key": G,
            "smem": smem_bytes(d, itemsize, tile, stages)}


# per device: the [B*H] int32 tickets of the last-block merge, zeroed
# once here and zeroed again by the kernel's last block of each row
_COUNTERS = {}


def _counter(dev, n: int):
    c = _COUNTERS.get(dev)
    if c is None or c.numel() < n:
        c = _COUNTERS[dev] = torch.zeros(max(n, 2 * (0 if c is None
                                                     else c.numel())),
                                         dtype=torch.int32, device=dev)
    return c


def _align(*ts) -> int:
    a = 0
    for t in ts:
        a |= t.data_ptr()
    return min(a & -a, 16) if a else 16


def decode_attention_cuda(q, k, v, length):
    """q: [B, H, d]; k, v: [B, KV, T, d] with H a multiple of KV, all one
    dtype (f32 or bf16); length: [B] int32 — contiguous on one CUDA
    device; 1 <= d <= 256.
    Returns [B, H, d] in q's dtype. Calls on one device share its
    counters, so two calls must not run at once on two streams."""
    B, H, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if KV < 1 or H % KV:
        raise ValueError(f"decode_attention kernel needs q heads a multiple "
                         f"of kv heads, got {H} and {KV}")
    check_cuda(q, q.dtype, (B, H, d), "q")
    check_cuda(k, q.dtype, (B, KV, T, d), "k", like=q)
    check_cuda(v, q.dtype, (B, KV, T, d), "v", like=q)
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
    plan = split_plan(B * H, T, d, q.element_size(), sms, _align(k, v))
    counter = _counter(q.device, B * H)
    part = torch.empty((B * H * plan["n_split"] * state_floats(d),),
                       dtype=torch.float32, device=q.device) \
        if plan["n_split"] > 1 else counter
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                 out.data_ptr(), part.data_ptr(), counter.data_ptr(), B, H,
                 H // KV, T, d, plan["chunk"], plan["n_split"],
                 plan["tile"], plan["stages"], COPIES[plan["copy"]], d ** -0.5,
                 DTYPES[q.dtype], stream_of(q))
    _build.check(lib, "decode_attention", err)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
