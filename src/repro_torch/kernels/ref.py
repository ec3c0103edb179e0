"""Plain PyTorch versions of the traversal and attention kernels (port
of ``repro/kernels/ref.py``).

Each ``*_ref`` is the definitional semantics: ``kernels/ops.py`` sends a
CPU tensor here, and ``chip_smoke.py`` holds each CUDA kernel against its
plain version on the card. Order is ``(dist, index)`` lexicographic with
ties to the lower index, and the merge breaks ties to the a side, then
the lower slot — ``merge_topk_sorted``'s determinism depends on it.

The attention versions follow the TPU kernels where the reference's
jnp oracle differs from them: a query row that sees no key at all (a
decode row with ``length == 0``, a causal row of a chunk longer than
the cache) gives 0, as the Pallas kernels do by skipping every block,
and not the uniform mean of ``v`` that a softmax over all-``NEG_INF``
logits gives. Every other row is the reference's softmax."""
from __future__ import annotations

import torch

from repro_torch.constants import INF, NEG_INF


def dist_l_ref(x, q):
    """Low-dim squared distances (paper Dist.L).
    x: [B, M, dl]; q: [B, dl] -> [B, M] float32."""
    d = x.to(torch.float32) - q.to(torch.float32)[:, None, :]
    return torch.sum(d * d, dim=-1)


def ksort_l_ref(d, k: int, valid=None):
    """kSort.L: the k smallest (dist, index) pairs of each row, ascending,
    ties -> lower index (a stable sort gives exactly the reference's
    comparison-matrix rank order). d: [B, M] -> (vals [B, k] f32, idx
    [B, k] int32). ``valid``: optional [B, M] bool mask; invalid entries
    become ``float("inf")`` (the reference's ``jnp.inf``, not ``INF``)
    and sort last. For k > M the reference leaves slots M..k-1 as
    (0.0, 0); this version keeps that quirk."""
    d = d.to(torch.float32)
    if valid is not None:
        d = torch.where(valid, d, torch.full_like(d, float("inf")))
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


def fused_filter_ref(x, q, k: int):
    """Fused Dist.L + kSort.L, no mask and no threshold.
    x: [B, M, dl]; q: [B, dl] -> (vals [B, k] f32, idx [B, k] int32)."""
    return ksort_l_ref(dist_l_ref(x, q), k)


def fused_expand_ref(x, q, valid, th, k: int):
    """The whole pHNSW expansion filter (step 2) in one op: Dist.L +
    adjacency/active masking + C_pca threshold + kSort.L.
    x: [B, M, dl]; q: [B, dl]; valid: [B, M] bool; th: [B] f32.
    Returns (vals [B, k], idx [B, k]): the k nearest surviving neighbors
    ascending; non-survivors carry vals >= VALID_MAX."""
    d = dist_l_ref(x, q)
    d = torch.where(valid & (d < th[:, None]), d, torch.full_like(d, INF))
    return ksort_l_ref(d, k)


def shard_base(B: int, P: int, per: int, device):
    """[B, 1] int64: the offset of row r's shard in a flattened stacked
    leaf, ``(r // (B / P)) * per`` (``per`` rows or words a shard): the
    rows of a stacked call are shard-major. Raises unless P divides B."""
    if P < 1 or B % P:
        raise ValueError(f"{B} rows do not split into {P} shards")
    return (torch.arange(B, device=device) // max(B // P, 1) * per)[:, None]


def popped_rows(adj, pay, c_w, exp):
    """The popped rows as the search gathered them before the gathers
    were fused (``repro/core/search_jax.py:_layer_body``'s lines): a
    gated-off pop reads row 0 and a -1 pop with its gate set is clamped
    to node 0; the neighbours' mask is ``adj >= 0`` and the gate.
    adj: [N, M0]; pay: [N, M0, width] (the layer's layout-(3) payload);
    c_w, exp: [B, W]. Stacked (``core.distributed.stacked_db_view``):
    adj [P, N, M0] and pay [P, N, M0, width], row r reading shard
    r // (B / P) (its own row 0 where gated off), as the reference's
    ``vmap`` over the shards. Returns (nb_i [B, W*M0], nb_mask, nb_pay
    [B, W*M0, width])."""
    B, W = c_w.shape
    M0 = adj.shape[-1]
    c_safe = torch.where(exp, c_w.clamp(min=0), 0)
    if adj.dim() == 3:
        c_safe = c_safe + shard_base(B, adj.shape[0], adj.shape[1],
                                     c_w.device)
        adj, pay = adj.flatten(0, 1), pay.flatten(0, 1)
    c_safe = c_safe.reshape(-1)
    nb_i = adj.index_select(0, c_safe).reshape(B, W * M0)
    nb_mask = (nb_i >= 0) & exp.repeat_interleave(M0, dim=1)
    nb_pay = pay.index_select(0, c_safe).reshape(B, W * M0, -1)
    return nb_i, nb_mask, nb_pay


def fused_expand_rows_ref(adj, packed_low, c_w, exp, q, th, k: int):
    """The pca expand with its row gathers, as the search ran it before
    the gathers were fused: ``popped_rows``, ``fused_expand_ref`` and
    the winners' indices mapped back to neighbour ids.
    adj: [N, M0] int32; packed_low: [N, M0, dl] (the layer's layout-(3)
    rows); c_w: [B, W] popped ids; exp: [B, W] bool gates; q: [B, dl];
    th: [B]. Stacked: adj [P, N, M0] and packed_low [P, N, M0, dl], row
    r in shard r // (B / P) (``popped_rows``). Returns (kv [B, k]
    ascending, cand [B, k] int32, the shard's local ids)."""
    nb_i, nb_mask, nb_pay = popped_rows(adj, packed_low, c_w, exp)
    kv, ki = fused_expand_ref(nb_pay, q, nb_mask, th, k)
    return kv, torch.gather(nb_i, 1, ki.long())


def pq_expand_rows_ref(adj, codes, c_w, exp, lut, th, k: int):
    """The PQ expand with its row gathers, as the search ran it before
    the gathers were fused: ``popped_rows``, ``pq_adc_expand_ref`` and
    the winners' indices mapped back to neighbour ids.
    adj: [N, M0] int32; codes: [N, M0, S] uint8 (the layer's layout-(3)
    codes); c_w: [B, W] popped ids; exp: [B, W] bool gates; lut: [B, S,
    256]; th: [B]. Stacked: adj [P, N, M0] and codes [P, N, M0, S], row r
    in shard r // (B / P) (``popped_rows``). Returns (kv [B, k]
    ascending, cand [B, k] int32, the shard's local ids)."""
    nb_i, nb_mask, nb_pay = popped_rows(adj, codes, c_w, exp)
    kv, ki = pq_adc_expand_ref(nb_pay, lut, nb_mask, th, k)
    return kv, torch.gather(nb_i, 1, ki.long())


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


def rank_sort_with_payload(d, p):
    """Stable ascending sort of each row of d (ties -> lower slot), the
    int payload p carried along: the same (dist, slot) order as the
    reference's comparison-matrix rank sort."""
    sd, order = torch.sort(d, dim=1, stable=True)
    return sd, torch.gather(p, 1, order)


def tombstone_bit(deleted, ids):
    """The tombstone bit of each id (any shape) in the word-packed bitmap
    ``deleted`` (bit i of word i >> 5) as a bool tensor. Negative ids
    (padding) read word 0 harmlessly; callers mask them. Stacked
    ``deleted`` [P, nw]: ``ids`` [B, ...] are shard-major rows, row r
    reading shard r // (B / P)'s words."""
    safe = ids.clamp(min=0)
    word = (safe // 32).long()
    if deleted.dim() == 2:
        P, nw = deleted.shape
        base = shard_base(ids.shape[0], P, nw, ids.device)
        word = word + base.reshape((-1,) + (1,) * (ids.dim() - 1))
    return ((torch.take(deleted, word) >> (safe % 32)) & 1) != 0


def trip_fold_ref(F_d, F_i, C_d, C_i, W: int, Cp, dh, cand, kv=None,
                  deleted=None, ef_eff=None, pop=None):
    """One traversal trip's frontier update, the lines of
    ``repro/core/search_jax.py:_layer_body`` after Dist.H: pop W slots
    off C, accept ``dh < F_d[:, -1]``, one stacked stable sort of the
    feeds (an F row with tombstones masked when ``deleted`` is given; a
    separate heap row from ``kv`` when given, else the C row feeds the
    heap), then the three sorted merges into F, C and the C_pca heap
    ``Cp`` (None for the filter bypass). The slotted body's two per-row
    gates: ``ef_eff`` [B] (in [1, ef]) bounds the accept test by
    ``F_d[i, ef_eff[i] - 1]`` instead of ``F_d[i, -1]``, and a row whose
    ``pop`` [B] is False (done, or frozen at its step budget) keeps C
    unpopped. ``deleted`` stacked [P, nw] (``core.distributed.
    stacked_db_view``) masks row r with shard r // (B / P)'s words.
    Returns new (F_d, F_i, C_d, C_i, Cp)."""
    B, kk = dh.shape
    ef = F_d.shape[1]
    if ef_eff is None:
        bnd = F_d[:, -1:]
    else:
        bnd = torch.gather(F_d, 1, (ef_eff.clamp(1, ef) - 1).long()[:, None])
    sh_d = torch.cat([C_d[:, W:], C_d.new_full((B, W), INF)], 1)
    sh_i = torch.cat([C_i[:, W:], C_i.new_full((B, W), -1)], 1)
    if pop is None:
        C_d, C_i = sh_d, sh_i
    else:
        keep = ~pop.bool()[:, None]
        C_d, C_i = torch.where(keep, C_d, sh_d), torch.where(keep, C_i, sh_i)
    accept = dh < bnd
    rows_d = [torch.where(accept, dh, INF)]
    rows_i = [torch.where(accept, cand, -1)]
    if deleted is not None:
        okF = accept & ~tombstone_bit(deleted, cand)
        rows_d.insert(0, torch.where(okF, dh, INF))
        rows_i.insert(0, torch.where(okF, cand, -1))
    if kv is not None:
        rows_d.append(torch.where(accept, kv, INF))
        rows_i.append(torch.zeros_like(cand))
    s_d, s_i = rank_sort_with_payload(torch.cat(rows_d, 0),
                                      torch.cat(rows_i, 0))
    r = B if deleted is not None else 0
    sd, si = s_d[r:r + B], s_i[r:r + B]          # C feed (dh order)
    fd_n, fi_n = s_d[:B], s_i[:B]                # F feed
    F_d, F_i = merge_topk_sorted_ref(F_d, F_i, fd_n, fi_n, ef)
    C_d, C_i = merge_topk_sorted_ref(C_d, C_i, sd, si, C_d.shape[1])
    if Cp is not None:
        k = Cp.shape[1]
        pv = s_d[r + B:] if kv is not None else sd
        Cp, _ = merge_topk_sorted_ref(
            Cp, torch.zeros((B, k), dtype=torch.int32, device=Cp.device), pv,
            torch.zeros((B, kk), dtype=torch.int32, device=Cp.device), k)
    return F_d, F_i, C_d, C_i, Cp


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _masked_softmax_pv(lg, mask, v, out_dtype):
    """Softmax of f32 logits ``lg`` over their last axis where ``mask``
    holds, then the product with ``v``. Masked logits are ``NEG_INF``
    (finite: ``exp(NEG_INF - NEG_INF)`` stays 1) and their weights are
    0, so a row with no visible key gives 0. The weights are cast to
    ``v.dtype`` before the product, as the reference casts them; the
    product accumulates in f32 and the result is cast to ``out_dtype``."""
    lg = torch.where(mask, lg, torch.full_like(lg, NEG_INF))
    m = lg.amax(-1, keepdim=True)
    p = torch.exp(lg - m) * mask
    w = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    w = w.to(v.dtype).to(torch.float32)
    return torch.matmul(w, v.to(torch.float32)).to(out_dtype)


def attention_mask(S: int, T: int, causal: bool, window: int,
                   device=None):
    """[S, T] bool: query row i (at position i + T - S, aligned to the
    end of the kv axis) sees key t iff ``t <= pos`` when causal and
    ``pos - t < window`` when ``window`` is set."""
    qpos = torch.arange(S, device=device)[:, None] + (T - S)
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    return mask


def _group(q, k):
    """G = query heads a kv head, checked: q [B, H, ...], k [B, KV, ...]
    with H a multiple of KV."""
    H, KV = q.shape[1], k.shape[1]
    if KV < 1 or H % KV:
        raise ValueError(f"attention needs q heads a multiple of kv heads, "
                         f"got {H} and {KV}")
    return H // KV


def flash_attention_ref(q, k, v, *, causal=True, window: int = 0):
    """q: [B, H, S, d]; k, v: [B, KV, T, d] -> [B, H, S, d] in q's dtype.
    Plain softmax attention with logits in f32 scaled by d**-0.5;
    grouped-query: H a multiple of KV, query head h reads kv head
    h // (H // KV) (the kv heads broadcast over their group, not copied)."""
    B, H, S, d = q.shape
    T, KV = k.shape[2], k.shape[1]
    G = _group(q, k)
    scale = d ** -0.5
    qg = q.to(torch.float32).reshape(B, KV, G, S, d)
    lg = torch.matmul(qg, k.to(torch.float32)[:, :, None]
                      .transpose(-1, -2)) * scale           # [B,KV,G,S,T]
    mask = attention_mask(S, T, causal, window, device=q.device)
    return _masked_softmax_pv(lg, mask, v[:, :, None], q.dtype
                              ).reshape(B, H, S, d)


def decode_attention_ref(q, k, v, length):
    """One-token decode. q: [B, H, d]; k, v: [B, KV, T, d] with H a
    multiple of KV (query head h reads kv head h // (H // KV)); length:
    [B] integer (the valid cache prefix) -> [B, H, d] in q's dtype."""
    B, H, d = q.shape
    T, KV = k.shape[2], k.shape[1]
    G = _group(q, k)
    scale = d ** -0.5
    lg = torch.einsum("bkgd,bktd->bkgt", q.to(torch.float32)
                      .reshape(B, KV, G, d), k.to(torch.float32)) * scale
    mask = torch.arange(T, device=q.device)[None, :] \
        < length.to(q.device)[:, None]                        # [B, T]
    return _masked_softmax_pv(lg, mask[:, None, None, :], v, q.dtype
                              ).reshape(B, H, d)
