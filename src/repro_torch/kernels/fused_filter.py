"""CUDA wrappers of the fused filter kernels (``csrc/fused_expand.cu``
and ``csrc/fused_filter.cu``).

``fused_expand_cuda`` replaces ``repro/kernels/fused_filter.py:
fused_expand_pallas`` (with its ``ksort_block`` helper): Dist.L +
validity mask + C_pca threshold + kSort.L for one expansion step over a
gathered [B, M, dl] block. ``fused_expand_rows_cuda`` is the same op with
the row gathers fused in, the pca traversal's expand: from the layer's
``adj`` [N, M0] and layout-(3) ``packed_low`` [N, M0, dl], the popped ids
and their gates, it stages each popped node's adjacency row and [M0, dl]
block itself and returns the winners' neighbour ids. It replaces the
search's ``clamp``/``where`` of the popped ids, the two ``index_select``
(the [B, W*M0, dl] block is never written), the mask's ops, the
threshold column's copy and the id ``gather`` around the kernel.
Stacked (``adj`` [P, N, M0], ``packed_low`` [P, N, M0, dl]: the slotted
sharded programs over ``core.distributed.stacked_db_view``), one launch
expands every shard's rows, row r reading shard r // (B / P), as the
reference's ``vmap`` adds a shard axis to the Pallas grid.
``fused_filter_cuda`` replaces ``fused_filter_pallas``: Dist.L + kSort.L
with no mask and no threshold (the kernel-footprint bench's row).

The payload (``x``, ``packed_low``) is f32 or bf16 rows, read as they
are and widened in the kernels; q and the threshold are f32. The two
expands are one body, ``csrc/filter_rows.cuh``: one warp per query row
and the top-k of ``csrc/warp_topk.cuh`` up to M = 128 slots, one block
per row above (``expand_plan`` picks the tier). The gathered blocks are
read in place; the popped rows are staged in shared memory by
``cp.async`` where their staging area fits (``filter_plan``).
``fused_filter`` reads each row's block in chunks of four elements into
f32 rows in shared memory, a warp a row (``fused_filter_plan``), and
falls back to the in-place body. Bound on
the card: bytes (the payload rows). The popped ids and the threshold are
read through their row strides, so a view of the frontier and a column
of the C_pca heap are never copied. The plain versions are
``ref.fused_expand_ref``, ``ref.fused_expand_rows_ref`` and
``ref.fused_filter_ref``; ``ops`` picks between kernel and plain version
by tensor device."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (PAYLOAD_DTYPES, check_cuda, ptr,
                                         scratch_rows, smem_optin, stream_of,
                                         warps_for)

# ..., B, M, dl, k, per_lane, threads, bf16, scratch, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p] * 2
# ..., B, M, dl, k, per_lane, threads, staged, vec, rw, bf16, scratch,
# stream
_FILTER_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
    + [ctypes.c_void_p] * 2
# ..., B, W, M0, dl, k, shard_b, shard_n, per_lane, threads, staged,
# copy, rw, bf16, scratch, stream
_ROWS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
    + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2 \
    + [ctypes.c_int] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p] * 2
WARPS_PER_BLOCK = 4            # csrc/filter_rows.cuh kWarpsPerBlock


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


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def stage_words(W: int, M0: int, dl: int, rw: int, itemsize: int = 4) -> int:
    """4-byte words of one row's staging area (``filter_rows.cuh:
    stage_words``): q (f32), then the W * M0 slot rows of ``rw``
    elements of ``itemsize`` bytes, each part a whole number of 16-byte
    chunks."""
    return _round4(dl) + _round4(-(-W * M0 * rw * itemsize // 4))


def stage_layout(M0: int, dl: int, itemsize: int, base_aligned: bool,
                 base_word_aligned: bool = True):
    """How the pca expand copies a popped node's [M0, dl] block of
    ``itemsize``-byte elements into shared memory, as (copy, rw): 16-byte
    ``cp.async`` of the dense block (``copy`` 16, ``rw`` = dl) where every
    node's block starts 16-byte aligned (the table's base
    ``base_aligned`` and M0 * dl * itemsize a multiple of 16) and the
    dense row keeps the lanes' reads apart; else 4-byte copies (``copy``
    4) where a row is a whole number of words on a word-aligned table,
    each slot row at a stride of ``rw`` elements that is an odd number of
    words, so the 32 lanes' reads of one column fall in 32 distinct
    banks (f32: dl | 1; bf16 at even dl: dl or dl + 2, whichever is 2
    mod 4); else (0, 0): not staged. A row of an odd number of words is
    kept apart dense; so is a bf16 row of odd dl, which is not a whole
    number of words: no stride gives each of its lanes a bank of its own,
    the dense one costs at most two-way conflicts, and its rows, 2 bytes
    into a word half the time, cannot take 4-byte copies."""
    rb = dl * itemsize
    dense_ok = rb % 4 != 0 or (rb // 4) % 2 == 1
    if base_aligned and (M0 * rb) % 16 == 0 and dense_ok:
        return 16, dl
    if rb % 4 == 0 and base_word_aligned:
        per = 4 // itemsize               # elements a word
        return 4, per * ((rb // 4) | 1)
    return 0, 0


def filter_plan(W: int, M0: int, dl: int, base_aligned: bool,
                smem_optin: int, itemsize: int = 4,
                base_word_aligned: bool = True) -> dict:
    """``expand_plan``'s tier for the pca expand's row of W popped nodes'
    M0 slots with dl-wide payload rows of ``itemsize`` bytes an element
    (4: f32, 2: bf16), and its staging (``filter_rows.cuh``): where a
    copy exists (``stage_layout``) and the staging area fits
    ``smem_optin`` (the card's opt-in maximum, bytes), the row's q and
    each popped node's [M0, dl] block are copied into shared memory
    first, by ``copy``-byte ``cp.async`` with slot rows at a stride of
    ``rw`` elements; else the rows are read in place (``staged`` False,
    ``copy`` = ``rw`` = 0). ``smem`` is the launch's dynamic shared
    memory in bytes, as the C launcher sizes it."""
    M = W * M0
    plan = dict(expand_plan(M, smem_optin))
    copy, rw = stage_layout(M0, dl, itemsize, base_aligned,
                            base_word_aligned)
    dist_words = _round4(M) if plan["tier"] == "block" else 0
    per_row = WARPS_PER_BLOCK if plan["tier"] == "warp" else 1
    smem = 4 * (dist_words + per_row * stage_words(W, M0, dl, max(rw, dl),
                                                   itemsize))
    staged = copy > 0 and smem <= smem_optin   # never in the global tier
    plan.update(staged=staged, copy=copy if staged else 0,
                rw=rw if staged else 0,
                smem=smem if staged else 4 * dist_words)
    return plan


def fused_filter_plan(M: int, dl: int, base_aligned: bool,
                      smem_optin: int) -> dict:
    """``fused_filter``'s launch (``csrc/fused_filter.cu``): up to M = 128
    the staged warp tier (``staged``: a warp a row, four rows a block,
    reads the row's [M, dl] block into f32 rows at the odd stride ``rw``
    = dl | 1 in shared memory, in chunks of four elements where every
    row's block starts on a chunk boundary (``vec``: the table's base
    ``base_aligned`` to four elements and M * dl a multiple of 4), else
    element by element), where its slices fit ``smem_optin``; else
    ``expand_plan``'s tier read in place. ``smem`` is the staged
    launch's shared memory in bytes."""
    plan = dict(expand_plan(M, smem_optin), staged=False, vec=0, rw=0)
    if plan["tier"] != "warp":
        return plan
    rw = dl | 1
    smem = 4 * WARPS_PER_BLOCK * (_round4(dl) + _round4(M * rw))
    if smem <= smem_optin:
        plan.update(staged=True, rw=rw, smem=smem,
                    vec=int(base_aligned and (M * dl) % 4 == 0))
    return plan


def _run(name: str, fn_name: str, argtypes, args):
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _build.check(lib, name, fn(*args))


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def fused_expand_cuda(x, q, valid, th, k: int):
    """x: [B, M, dl] f32 or bf16; q: [B, dl] f32; valid: [B, M] bool; th:
    [B] f32 — all contiguous on one CUDA device; 1 <= k <= M.
    Returns (vals [B, k] f32 ascending, idx [B, k] int32)."""
    B, M, dl = x.shape
    check_cuda(x, PAYLOAD_DTYPES, (B, M, dl), "x")
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
    with torch.cuda.device(x.device):
        _run("fused_expand", "fused_expand_launch", _ARGTYPES,
             (x.data_ptr(), q.data_ptr(), valid.data_ptr(), th.data_ptr(),
              vals.data_ptr(), idx.data_ptr(), B, M, dl, k,
              plan["per_lane"], plan["threads"], _bf16(x), ptr(scratch),
              stream_of(x)))
    fused_expand_cuda.launches += 1
    return vals, idx


fused_expand_cuda.launches = 0


def stacked_layer(adj, pay, B: int, name: str):
    """(P, N, M0, shard_b, shard_n) of a layer ``adj`` [N, M0] or stacked
    [P, N, M0] (with its payload ``pay``) expanded for B rows: shard_b
    rows a shard and shard_n nodes a shard's table, (B, 0) unstacked.
    Raises unless P divides B."""
    if adj.dim() == 2:
        N, M0 = adj.shape
        return 1, N, M0, max(B, 1), 0
    if adj.dim() != 3 or pay.dim() != 4:
        raise ValueError(f"{name}: expected a layer [N, M0] or a stacked "
                         "layer [P, N, M0]")
    P, N, M0 = adj.shape
    if P < 1 or B % P:
        raise ValueError(f"{name}: {B} rows do not split into {P} shards")
    return P, N, M0, max(B // P, 1), N


def fused_expand_rows_cuda(adj, packed_low, c_w, exp, q, th, k: int):
    """adj: [N, M0] int32 and packed_low: [N, M0, dl] f32 or bf16,
    contiguous (a layer of the db; its base need not be 16-byte
    aligned), or stacked [P, N, M0] and [P, N, M0, dl] (row r reads shard
    r // (B / P), P dividing B); c_w: [B, W]
    int32 popped ids and th: [B] f32, each with any row stride (and unit
    inner stride); exp: [B, W] bool and q: [B, dl] f32 contiguous; all
    on one CUDA device; 1 <= k <= W * M0.
    Returns (vals [B, k] f32 ascending, cand [B, k] int32 neighbour
    ids)."""
    B, W = c_w.shape
    P, N, M0, shard_b, shard_n = stacked_layer(adj, packed_low, B,
                                               "fused_expand_rows")
    lead = (N, M0) if adj.dim() == 2 else (P, N, M0)
    dl = packed_low.shape[-1]
    check_cuda(adj, torch.int32, lead, "adj")
    check_cuda(packed_low, PAYLOAD_DTYPES, lead + (dl,), "packed_low",
               like=adj)
    check_cuda(exp, torch.bool, (B, W), "exp", like=adj)
    check_cuda(q, torch.float32, (B, dl), "q", like=adj)
    for t, name, dt in ((c_w, "c_w", torch.int32), (th, "th", torch.float32)):
        if not (isinstance(t, torch.Tensor) and t.device == adj.device
                and t.dtype == dt and t.shape[0] == B
                and (t.dim() == 1 or t.stride(1) == 1)):
            raise ValueError(f"{name}: expected a {dt} tensor on the adj's "
                             "device with B rows and unit inner stride")
    if th.dim() != 1:
        raise ValueError("th: expected [B]")
    M = W * M0
    if not 1 <= k <= M:
        raise ValueError(f"fused_expand_rows kernel needs 1 <= k <= W * M0, "
                         f"got k={k}, W={W}, M0={M0}")
    vals = torch.empty((B, k), dtype=torch.float32, device=adj.device)
    cand = torch.empty((B, k), dtype=torch.int32, device=adj.device)
    if B == 0:
        return vals, cand
    base = packed_low.data_ptr()
    plan = filter_plan(W, M0, dl, base % 16 == 0, smem_optin(adj.device),
                       packed_low.element_size(), base % 4 == 0)
    scratch = scratch_rows(plan, B, adj.device)
    with torch.cuda.device(adj.device):
        _run("fused_expand", "fused_expand_rows_launch", _ROWS_ARGTYPES,
             (adj.data_ptr(), packed_low.data_ptr(), c_w.data_ptr(),
              c_w.stride(0), exp.data_ptr(), q.data_ptr(), th.data_ptr(),
              th.stride(0), vals.data_ptr(), cand.data_ptr(), B, W, M0, dl,
              k, shard_b, shard_n, plan["per_lane"], plan["threads"],
              int(plan["staged"]), plan["copy"], plan["rw"],
              _bf16(packed_low), ptr(scratch), stream_of(adj)))
    fused_expand_rows_cuda.launches += 1
    return vals, cand


fused_expand_rows_cuda.launches = 0


def fused_filter_cuda(x, q, k: int):
    """x: [B, M, dl] f32 or bf16; q: [B, dl] f32 — contiguous on one
    CUDA device; 1 <= k <= M. Returns (vals [B, k] f32 ascending, idx
    [B, k] int32)."""
    B, M, dl = x.shape
    check_cuda(x, PAYLOAD_DTYPES, (B, M, dl), "x")
    check_cuda(q, torch.float32, (B, dl), "q", like=x)
    if not 1 <= k <= M:
        raise ValueError(f"fused_filter kernel needs 1 <= k <= M, got k={k}, "
                         f"M={M}")
    vals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return vals, idx
    plan = fused_filter_plan(M, dl,
                             x.data_ptr() % (4 * x.element_size()) == 0,
                             smem_optin(x.device))
    scratch = scratch_rows(plan, B, x.device)
    with torch.cuda.device(x.device):
        _run("fused_filter", "fused_filter_launch", _FILTER_ARGTYPES,
             (x.data_ptr(), q.data_ptr(), vals.data_ptr(), idx.data_ptr(), B,
              M, dl, k, plan["per_lane"], plan["threads"],
              int(plan["staged"]), plan["vec"], plan["rw"], _bf16(x),
              ptr(scratch), stream_of(x)))
    fused_filter_cuda.launches += 1
    return vals, idx


fused_filter_cuda.launches = 0
