"""The kernel ops, dispatched by tensor device (port of
``repro/kernels/ops.py``: ``dist_l``, ``ksort_l``, ``dist_h``,
``fused_filter``, ``fused_expand``, ``pq_adc_expand``, ``pq_adc``,
``merge_topk_sorted``, ``flash_attention`` and ``decode_attention``),
plus three ops of the search path that fuse the reference's glue around
its ops: ``trip_fold`` (a trip's accept, feeds and three merges),
``fused_expand_rows`` and ``pq_expand_rows`` (the pca and PQ expands with
their row gathers).

Same op names, signatures and sentinels as the reference. A CPU tensor
takes the plain PyTorch version (``kernels/ref.py``); a CUDA tensor
launches the hand-written kernel, and a kernel that fails to build or
launch raises — there is no switch and no fallback. Under a dispatch
mode (a FLOP counter) and on "meta", B8 and B9 go through the
dispatcher as the operators ``repro_torch::flash_attention`` and
``repro_torch::decode_attention`` (``kernels/flash_attention.py``,
``decode_attention.py``, ``_watched``), which carry their FLOP formulas
for ``torch.utils.flop_counter``. Each CUDA wrapper
counts its launches in a plain integer (``launch_counts``);
``trip_fold_gated`` counts the fold's launches gated per row (the
slotted search), each also one of ``trip_fold``'s. The Dist.L
ops (``dist_l``, ``fused_filter``, ``fused_expand``,
``fused_expand_rows``) take f32 or bf16 rows as they are, on either
device: the kernels widen them in registers, as the TPU kernels do, and
any other payload dtype raises."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.constants import VALID_MAX  # noqa: F401  (re-export:
# callers of fused_expand test returned vals against this sentinel)
from repro_torch.kernels import ref
from repro_torch.kernels._launch import check_payload
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.dist_h import dist_h_cuda
from repro_torch.kernels.dist_l import dist_l_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.fused_filter import (fused_expand_cuda,
                                              fused_expand_rows_cuda,
                                              fused_filter_cuda)
from repro_torch.kernels.ksort_l import ksort_l_cuda
from repro_torch.kernels.merge_sorted import merge_sorted_cuda
from repro_torch.kernels.pq_adc import (lut_rows_ok, pq_adc_expand_cuda,
                                        pq_expand_rows_cuda)
from repro_torch.kernels.trip_fold import trip_fold_cuda, trip_fold_gated

_KERNELS = {"fused_expand": fused_expand_cuda,
            "merge_sorted": merge_sorted_cuda,
            "dist_h": dist_h_cuda,
            "dist_l": dist_l_cuda,
            "pq_adc_expand": pq_adc_expand_cuda,
            "ksort_l": ksort_l_cuda,
            "fused_filter": fused_filter_cuda,
            "flash_attention": flash_attention_cuda,
            "decode_attention": decode_attention_cuda,
            "trip_fold": trip_fold_cuda,
            "trip_fold_gated": trip_fold_gated,
            "fused_expand_rows": fused_expand_rows_cuda,
            "pq_expand_rows": pq_expand_rows_cuda}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0


def _on_cuda(*ts) -> bool:
    """True iff every tensor is on CUDA, False iff every one is on the
    CPU; anything else raises."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: expected all "
                     "on the CPU or all on CUDA")


def dist_l(x, q):
    """x: [B, M, dl] f32 or bf16; q: [B, dl] -> [B, M] f32 squared
    distances."""
    check_payload(x, "dist_l: x")
    if _on_cuda(x, q):
        return dist_l_cuda(x.contiguous(), q.to(torch.float32).contiguous())
    return ref.dist_l_ref(x, q)


def ksort_l(d, k: int):
    """kSort.L: d [B, M] -> (vals [B, k] ascending, idx [B, k] int32),
    ties to the lower index. k must not exceed M (the reference would
    leave slots M..k-1 as (0.0, 0))."""
    if k > d.shape[1]:
        raise ValueError(f"ksort_l: k={k} exceeds M={d.shape[1]}")
    if _on_cuda(d):
        return ksort_l_cuda(d.to(torch.float32).contiguous(), k)
    return ref.ksort_l_ref(d, k)


def dist_h(x, q):
    """x: [B, K, D]; q: [B, D] -> [B, K] f32 squared distances."""
    if _on_cuda(x, q):
        return dist_h_cuda(x.to(torch.float32).contiguous(),
                           q.to(torch.float32).contiguous())
    return ref.dist_h_ref(x, q)


def fused_filter(x, q, k: int):
    """pHNSW step 2 with no mask and no threshold: Dist.L + kSort.L.
    x: [B, M, dl] f32 or bf16; q: [B, dl] -> (vals [B, k] ascending,
    idx [B, k] int32). k must not exceed M (the reference would leave
    slots M..k-1 as (0.0, 0))."""
    if k > x.shape[1]:
        raise ValueError(f"fused_filter: k={k} exceeds M={x.shape[1]}")
    check_payload(x, "fused_filter: x")
    if _on_cuda(x, q):
        return fused_filter_cuda(x.contiguous(),
                                 q.to(torch.float32).contiguous(), k)
    return ref.fused_filter_ref(x, q, k)


def fused_expand(x, q, valid, th, k: int):
    """One traversal expansion's full filter stage (Dist.L + validity
    mask + C_pca threshold + kSort.L) in a single kernel.
    x: [B, M, dl] f32 or bf16; q: [B, dl]; valid: [B, M] bool; th: [B]
    f32. Returns (vals [B, k] ascending, idx [B, k]); filtered-out slots
    get vals >= VALID_MAX. k must not exceed M (the reference would leave
    slots M..k-1 as (0.0, 0))."""
    if k > x.shape[1]:
        raise ValueError(f"fused_expand: k={k} exceeds M={x.shape[1]}")
    check_payload(x, "fused_expand: x")
    if _on_cuda(x, q, valid, th):
        return fused_expand_cuda(x.contiguous(),
                                 q.to(torch.float32).contiguous(),
                                 valid.to(torch.bool).contiguous(),
                                 th.to(torch.float32).contiguous(), k)
    return ref.fused_expand_ref(x, q, valid, th, k)


def _stacked_rows(leaf, flat_dims: int, B: int, name: str) -> None:
    """Check a stacked leaf (one more dim than ``flat_dims``, the shard
    dim P first): the B rows must split into P shards."""
    if leaf.dim() == flat_dims + 1 and (leaf.shape[0] < 1
                                        or B % leaf.shape[0]):
        raise ValueError(f"{name}: {B} rows do not split into "
                         f"{leaf.shape[0]} shards")


def fused_expand_rows(adj, packed_low, c_w, exp, q, th, k: int):
    """The pca traversal's expand with its row gathers fused: for the W
    popped ids ``c_w`` [B, W] (a strided view is read in place) and their
    gates ``exp`` [B, W] bool, the layer's ``adj`` [N, M0] and layout-(3)
    ``packed_low`` [N, M0, dl] f32 or bf16 give the W * M0 neighbour
    slots of each row (a gated-off slot reads row 0 and is masked, as is
    a -1 neighbour; a -1 pop with its gate set reads node 0, as the
    reference's clamp); Dist.L against ``q`` [B, dl], the C_pca threshold
    ``th`` [B] (a column view is read in place), kSort.L. Returns (kv
    [B, k] ascending, cand [B, k] int32 neighbour ids); filtered-out
    slots get kv >= VALID_MAX. k must not exceed W * M0.
    Stacked (``core.distributed.stacked_db_view``): ``adj`` [P, N, M0]
    and ``packed_low`` [P, N, M0, dl], the B rows shard-major (row r
    reads shard r // (B / P); ids are the shard's own), one launch for
    every shard; B must be a multiple of P."""
    W, M0 = c_w.shape[1], adj.shape[-1]
    _stacked_rows(adj, 2, c_w.shape[0], "fused_expand_rows")
    if k > W * M0:
        raise ValueError(f"fused_expand_rows: k={k} exceeds W * M0 = "
                         f"{W * M0}")
    check_payload(packed_low, "fused_expand_rows: packed_low")
    if _on_cuda(adj, packed_low, c_w, exp, q, th):
        c_w = c_w.to(torch.int32)
        if c_w.stride(1) != 1:
            c_w = c_w.contiguous()
        return fused_expand_rows_cuda(adj.to(torch.int32).contiguous(),
                                      packed_low.contiguous(), c_w,
                                      exp.to(torch.bool).contiguous(),
                                      q.to(torch.float32).contiguous(),
                                      th.to(torch.float32), k)
    return ref.fused_expand_rows_ref(adj, packed_low, c_w, exp, q, th, k)


def pq_adc_expand(codes, lut, valid, th, k: int):
    """One traversal expansion's PQ filter stage (ADC gather-accumulate
    + validity mask + C_pca threshold + kSort.L) in a single kernel, the
    PQ analogue of ``fused_expand``.
    codes: [B, M, S] integer PQ codes; lut: [B, S, 256] f32 (a strided
    view with unit strides inside a row is read in place); valid:
    [B, M] bool; th: [B] f32. Returns (vals [B, k] ascending, idx
    [B, k]); filtered-out slots get vals >= VALID_MAX. k must not
    exceed M, as for ``fused_expand``."""
    if k > codes.shape[1]:
        raise ValueError(f"pq_adc_expand: k={k} exceeds M={codes.shape[1]}")
    if _on_cuda(codes, lut, valid, th):
        lut = lut.to(torch.float32)
        if not lut_rows_ok(lut):
            lut = lut.contiguous()
        return pq_adc_expand_cuda(codes.to(torch.uint8).contiguous(), lut,
                                  valid.to(torch.bool).contiguous(),
                                  th.to(torch.float32).contiguous(), k)
    return ref.pq_adc_expand_ref(codes, lut, valid, th, k)


def pq_expand_rows(adj, codes, c_w, exp, lut, th, k: int):
    """The PQ traversal's expand with its row gathers fused: for the W
    popped ids ``c_w`` [B, W] and their gates ``exp`` [B, W] bool, the
    layer's ``adj`` [N, M0] and layout-(3) ``codes`` [N, M0, S] give the
    W * M0 neighbour slots of each row (a gated-off slot reads row 0 and
    is masked, as is a -1 neighbour); ADC against ``lut`` [B, S, 256] (a
    strided view is read in place), the C_pca threshold ``th`` [B] (a
    column view is read in place), kSort.L. Returns (kv [B, k]
    ascending, cand [B, k] int32 neighbour ids); filtered-out slots get
    kv >= VALID_MAX. k must not exceed W * M0.
    Stacked (``core.distributed.stacked_db_view``): ``adj`` [P, N, M0]
    and ``codes`` [P, N, M0, S], the B rows shard-major (row r reads
    shard r // (B / P); ids are the shard's own), one launch for every
    shard; B must be a multiple of P."""
    W, M0 = c_w.shape[1], adj.shape[-1]
    _stacked_rows(adj, 2, c_w.shape[0], "pq_expand_rows")
    if k > W * M0:
        raise ValueError(f"pq_expand_rows: k={k} exceeds W * M0 = {W * M0}")
    if _on_cuda(adj, codes, c_w, exp, lut, th):
        lut = lut.to(torch.float32)
        if not lut_rows_ok(lut):
            lut = lut.contiguous()
        th = th.to(torch.float32)
        c_w = c_w.to(torch.int32)
        if c_w.stride(1) != 1:
            c_w = c_w.contiguous()
        return pq_expand_rows_cuda(adj.to(torch.int32).contiguous(),
                                   codes.to(torch.uint8).contiguous(), c_w,
                                   exp.to(torch.bool).contiguous(), lut, th,
                                   k)
    return ref.pq_expand_rows_ref(adj, codes, c_w, exp, lut, th, k)


def trip_fold(F_d, F_i, C_d, C_i, W: int, Cp, dh, cand, kv=None,
              deleted=None, ef_eff=None, pop=None):
    """One traversal trip's frontier update in one op: pop W slots off
    the sorted candidate frontier C [B, cap], accept ``dh < F_d[:, -1]``,
    feed the accepted candidates (with ``deleted`` words, tombstoned ids
    masked out of F's feed) into F [B, ef] and C, and their filter dists
    (``kv``, or the C feed's dists when None) into the C_pca heap Cp
    [B, k] (None for the filter bypass), each a k-bounded sorted merge
    with ties to the frontier, then the lower slot. The slotted search
    gates it per row: ``ef_eff`` [B] int32 in [1, ef] bounds the accept
    test by ``F_d[i, ef_eff[i] - 1]``, and a row whose ``pop`` [B] (bool)
    is False keeps C unpopped. Stacked ``deleted`` [P, nw]
    (``core.distributed.stacked_db_view``): the B rows are shard-major,
    row r masked with shard r // (B / P)'s words, one launch for every
    shard; B must be a multiple of P. Returns new (F_d, F_i, C_d, C_i,
    Cp); the inputs are not modified."""
    if deleted is not None:
        _stacked_rows(deleted, 1, F_d.shape[0], "trip_fold")
    ts = [t for t in (F_d, F_i, C_d, C_i, Cp, dh, cand, kv, deleted,
                      ef_eff, pop) if t is not None]
    if _on_cuda(*ts):
        f32 = lambda t: None if t is None else \
            t.to(torch.float32).contiguous()
        i32 = lambda t: None if t is None else t.to(torch.int32).contiguous()
        return trip_fold_cuda(f32(F_d), i32(F_i), f32(C_d), i32(C_i), W,
                              f32(Cp), f32(dh), i32(cand), f32(kv),
                              i32(deleted), i32(ef_eff),
                              None if pop is None else pop.contiguous())
    return ref.trip_fold_ref(F_d, F_i, C_d, C_i, W, Cp, dh, cand, kv,
                             deleted, ef_eff=ef_eff, pop=pop)


def pq_adc(codes, lut):
    """Plain batched ADC distances (no mask, no sort): codes [B, K, S],
    lut [B, S, 256] -> [B, K] f32. It scores only the deferred entry
    point ([B, 1, S]) once per search, and the reference has no Pallas
    kernel for it (it always runs the jnp oracle), so on both devices it
    is the plain PyTorch version: no kernel, no launch count."""
    return ref.pq_adc_ref(codes, lut)


def merge_topk_sorted(d_a, i_a, d_b, i_b, k: int):
    """Merge two ascending-sorted (dist, idx) lists, keep the k smallest
    (ties -> a side, then lower slot). d_a: [B, Na]; d_b: [B, Nb]."""
    if d_b.shape[1] > k:
        # only the first k of a sorted b can reach a k-wide output
        d_b, i_b = d_b[:, :k], i_b[:, :k]
    if k > d_a.shape[1] + d_b.shape[1]:
        raise ValueError(f"merge_topk_sorted: k={k} exceeds Na + Nb = "
                         f"{d_a.shape[1] + d_b.shape[1]}")
    if _on_cuda(d_a, i_a, d_b, i_b):
        return merge_sorted_cuda(d_a.to(torch.float32).contiguous(),
                                 i_a.to(torch.int32).contiguous(),
                                 d_b.to(torch.float32).contiguous(),
                                 i_b.to(torch.int32).contiguous(), k)
    return ref.merge_topk_sorted_ref(d_a, i_a, d_b, i_b, k)


def _same_attention_dtype(name, *ts):
    dt = {t.dtype for t in ts}
    if len(dt) != 1 or ts[0].dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernel takes q, k and v of one dtype, "
                        f"float32 or bfloat16, got {sorted(map(str, dt))}")


def _attention_device(*ts) -> bool:
    """``_on_cuda`` for the attention operators, which also take "meta"
    tensors (the dry-run counts a step there without running it): True
    iff every tensor is on CUDA, False iff every one is on the CPU or
    every one on "meta"; anything else raises."""
    if {t.device.type for t in ts} == {"meta"}:
        return False
    return _on_cuda(*ts)


def _watched(q) -> bool:
    """Whether B8 / B9 go through the dispatcher as their operators
    (``repro_torch::flash_attention`` / ``decode_attention``): on "meta",
    and wherever a ``TorchDispatchMode`` (``FlopCounterMode``, the
    dry-run's ``StepCounter``) is active, so that it sees them and counts
    their FLOPs. Elsewhere the op calls the kernel's wrapper, or the
    plain version, itself: on the H100's host the operator adds 10-19 us
    a call over the wrapper at rows 8b and 9b, the dispatcher alone
    4.38-6.22 (PERF.md), about the 5 us a serving call may spend on it."""
    return q.device.type == "meta" or torch._C._len_torch_dispatch_stack() > 0


def _refuse_graph(name, *ts) -> None:
    """The attention kernels have no backward: on the card their output
    would carry no ``grad_fn``, and backward would leave the projections
    before them without gradients, silently. So neither op builds a
    graph on any device; training takes ``blocked_attention``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name}: the kernel has no backward; train "
                           "through models.attention.blocked_attention "
                           "(attn_forward(..., train=True)), or serve "
                           "under torch.no_grad()")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = 128, bk: int = 128):
    """q: [B, H, S, d]; k, v: [B, KV, T, d] -> [B, H, S, d] in q's dtype,
    H a multiple of KV (grouped-query attention: query head h reads kv
    head h // (H // KV)). q aligned to the end of the kv axis; ``window``
    > 0 adds a sliding window. A row that sees no key gives 0, as the TPU
    kernel. ``bq`` and
    ``bk`` are the reference's TPU tile sizes, kept for its signature;
    the CUDA kernels tile by their own (128 x 64 in bf16, 64 x 64 in f32)
    and take any S and T."""
    del bq, bk
    if window < 0:
        raise ValueError(f"flash_attention: window={window} < 0")
    _refuse_graph("flash_attention", q, k, v)
    cuda = _attention_device(q, k, v)
    if cuda:
        _same_attention_dtype("flash_attention", q, k, v)
    if _watched(q):
        return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal),
                                                     int(window))
    if cuda:
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, length, *, bk: int = 512):
    """q: [B, H, d]; k, v: [B, KV, T, d], H a multiple of KV (query head h
    reads kv head h // (H // KV)); length [B] (the valid cache prefix) ->
    [B, H, d] in q's dtype; a row with length <= 0 gives 0,
    as the TPU kernel. ``bk`` is the reference's TPU block size, kept for
    its signature; the CUDA kernel splits the cache by its own plan."""
    del bk
    _refuse_graph("decode_attention", q, k, v)
    cuda = _attention_device(q, k, v, length)
    if cuda:
        _same_attention_dtype("decode_attention", q, k, v)
    if _watched(q):
        return torch.ops.repro_torch.decode_attention(q, k, v, length)
    if cuda:
        return decode_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(),
                                     length.to(torch.int32).contiguous())
    return ref.decode_attention_ref(q, k, v, length)
