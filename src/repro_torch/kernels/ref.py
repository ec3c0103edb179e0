"""Plain PyTorch versions of the traversal kernels (port of
``repro/kernels/ref.py``).

Each ``*_ref`` is the definitional semantics: ``kernels/ops.py`` sends a
CPU tensor here, and ``chip_smoke.py`` holds each CUDA kernel against its
plain version on the card. Order is ``(dist, index)`` lexicographic with
ties to the lower index, and the merge breaks ties to the a side, then
the lower slot — ``merge_topk_sorted``'s determinism depends on it."""
from __future__ import annotations

import torch

from repro_torch.constants import INF


def dist_l_ref(x, q):
    """Low-dim squared distances (paper Dist.L).
    x: [B, M, dl]; q: [B, dl] -> [B, M] float32."""
    d = x.to(torch.float32) - q.to(torch.float32)[:, None, :]
    return torch.sum(d * d, dim=-1)


def ksort_l_ref(d, k: int):
    """kSort.L: the k smallest (dist, index) pairs of each row, ascending,
    ties -> lower index (a stable sort gives exactly the reference's
    comparison-matrix rank order). d: [B, M] -> (vals [B, k] f32, idx
    [B, k] int32). For k > M the reference leaves slots M..k-1 as
    (0.0, 0); this version keeps that quirk."""
    d = d.to(torch.float32)
    B, M = d.shape
    vals, idx = torch.sort(d, dim=1, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    if k > M:
        vals = torch.cat([vals, vals.new_zeros(B, k - M)], 1)
        idx = torch.cat([idx, idx.new_zeros(B, k - M)], 1)
    return vals, idx


def dist_h_ref(x, q):
    """High-dim re-rank distances (paper Dist.H).
    x: [B, K, D]; q: [B, D] -> [B, K] float32."""
    d = x.to(torch.float32) - q.to(torch.float32)[:, None, :]
    return torch.sum(d * d, dim=-1)


def fused_expand_ref(x, q, valid, th, k: int):
    """The whole pHNSW expansion filter (step 2) in one op: Dist.L +
    adjacency/active masking + C_pca threshold + kSort.L.
    x: [B, M, dl]; q: [B, dl]; valid: [B, M] bool; th: [B] f32.
    Returns (vals [B, k], idx [B, k]): the k nearest surviving neighbors
    ascending; non-survivors carry vals >= VALID_MAX."""
    d = dist_l_ref(x, q)
    d = torch.where(valid & (d < th[:, None]), d, torch.full_like(d, INF))
    return ksort_l_ref(d, k)


def pq_adc_ref(codes, lut):
    """Asymmetric-distance computation (the PQ filter's Dist.L):
    d[b, m] = sum_s lut[b, s, codes[b, m, s]].
    codes: [B, M, S] integer PQ codes; lut: [B, S, 256] f32 per-query
    ADC tables -> [B, M] f32 approximate squared distances."""
    ct = codes.to(torch.int64).transpose(1, 2)                # [B, S, M]
    picked = torch.gather(lut.to(torch.float32), 2, ct)       # [B, S, M]
    return picked.sum(1)


def pq_adc_expand_ref(codes, lut, valid, th, k: int):
    """The PQ filter's whole expansion step (ADC + adjacency/active
    masking + C_pca threshold + kSort.L), the PQ analogue of
    ``fused_expand_ref``. codes: [B, M, S]; lut: [B, S, 256]; valid:
    [B, M] bool; th: [B] f32. Returns (vals [B, k] ascending, idx
    [B, k]); non-survivors carry vals >= VALID_MAX."""
    d = pq_adc_ref(codes, lut)
    d = torch.where(valid & (d < th[:, None]), d, torch.full_like(d, INF))
    return ksort_l_ref(d, k)


def merge_topk_sorted_ref(d_a, i_a, d_b, i_b, k: int):
    """Merge two ASCENDING-sorted (dist, idx) lists, keep the k smallest.
    Each element's merged position is its slot plus its count in the
    other list: pos_a[i] = i + #{j : b[j] < a[i]}, pos_b[j] = j +
    #{i : a[i] <= b[j]} — ties to the a side, then the lower slot, so
    the positions form a permutation. d_a: [B, Na], d_b: [B, Nb];
    k <= Na + Nb. Returns (d [B, k] f32, i [B, k] int32) ascending."""
    d_a = d_a.to(torch.float32)
    d_b = d_b.to(torch.float32)
    B, Na = d_a.shape
    Nb = d_b.shape[1]
    dev = d_a.device
    pos_a = torch.arange(Na, device=dev)[None, :] \
        + (d_b[:, None, :] < d_a[:, :, None]).sum(-1)
    pos_b = torch.arange(Nb, device=dev)[None, :] \
        + (d_a[:, None, :] <= d_b[:, :, None]).sum(-1)
    out_d = d_a.new_empty(B, Na + Nb)
    out_i = i_a.new_empty(B, Na + Nb)
    out_d.scatter_(1, pos_a, d_a).scatter_(1, pos_b, d_b)
    out_i.scatter_(1, pos_a, i_a).scatter_(1, pos_b, i_b)
    return out_d[:, :k], out_i[:, :k].to(torch.int32)
