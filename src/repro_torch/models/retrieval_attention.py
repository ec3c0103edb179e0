"""pHNSW retrieval attention: the paper's three-step filter applied to
long-context decode (port of ``repro/models/retrieval_attention.py``).

Attending to a long KV cache is a nearest-neighbour problem: the query
wants the keys with the highest dot products. Per attention head:

  Step 1 (PCA):    keys are projected to ``d_low`` by a fixed orthonormal
                   projection stored with the model, and the low-dim keys
                   live inline in the cache (layout (3)).
  Step 2 (filter): low-dim scores over the whole cache, max-pooled over
                   blocks of ``block`` positions and over the query heads
                   of a GQA group, the top blocks kept per cache
                   partition (the kSort.L filter, partition-local).
  Step 3 (rerank): exact attention over the chosen blocks only, merged
                   by one softmax over every partition.

The reference computes this in jnp with no Pallas kernel; the port is
plain torch, in the cache's layout ``[B, KV, T, ...]``, with
``torch.topk`` for ``lax.top_k``. Blocks wholly past ``pos`` pool to
NEG_INF and tie; ``torch.topk`` may keep other tied blocks than
``lax.top_k`` (which keeps the lower index), but every position of such
a block is masked in Step 3, so the output is the same."""
from __future__ import annotations

import torch
from torch import nn

NEG_INF = -1e30


def init_retrieval(cfg, gen, device=None) -> nn.Parameter:
    """The orthonormal projection [Hd, d_low] f32 (the 'PCA' matrix):
    the first d_low columns of the QR of a normal matrix drawn from
    ``gen`` (``gen`` None: left uninitialised, for weights carried from
    the reference)."""
    hd, dl = cfg.resolved_head_dim, cfg.retrieval.d_low
    a = torch.empty((hd, hd), dtype=torch.float32, device=device)
    if gen is None:
        return nn.Parameter(a[:, :dl].contiguous())
    qm, _ = torch.linalg.qr(a.normal_(generator=gen))
    return nn.Parameter(qm[:, :dl].contiguous())


def project_low(p, k):
    """k: [..., Hd] -> [..., d_low] low-dim keys (Step 1), in f32, cast
    back to k's dtype."""
    return (k.to(torch.float32) @ p.rp_proj).to(k.dtype)


def retrieval_cache_len(cfg, t: int) -> int:
    """The cache length the filter can partition for ``t`` positions: a
    multiple of ``block``, and of ``block * partitions`` once there are
    more blocks than partitions (the reference's reshape needs exactly
    that; it fails on any other length). Serving pads the cache to it;
    the padding is past every position and masked."""
    blk, parts = cfg.retrieval.block, cfg.retrieval.partitions
    n_blocks = -(-t // blk)
    if n_blocks > parts:
        n_blocks = -(-n_blocks // parts) * parts
    return n_blocks * blk


def retrieval_decode_attention(cfg, p, q, cache_k, cache_v, cache_klow,
                               pos):
    """One-token retrieval attention, partition-major.

    q: [B, N, Hd] (rope applied); cache_k, cache_v: [B, KV, T, Hd];
    cache_klow: [B, KV, T, d_low]; pos: [1] integer tensor (the current
    position). T must be ``retrieval_cache_len(cfg, T)``. Returns [B, N,
    Hd] in v's dtype."""
    B, N, Hd = q.shape
    KV, T = cache_k.shape[1], cache_k.shape[2]
    rcfg = cfg.retrieval
    G = N // KV
    blk = rcfg.block
    n_blocks = T // blk
    nP = max(1, min(rcfg.partitions, n_blocks))
    pp = n_blocks // nP                  # blocks per partition
    tpp = pp * blk                       # tokens per partition
    if nP * tpp != T:
        raise ValueError(f"retrieval attention needs a cache of "
                         f"{retrieval_cache_len(cfg, T)} positions for "
                         f"block {blk} and {rcfg.partitions} partitions, "
                         f"got {T}")
    nb = min(max(1, rcfg.topk // blk // nP), pp)   # blocks kept/partition
    scale = Hd ** -0.5
    dev = q.device
    f32 = torch.float32

    # ---- Step 2: low-dim scores, partition-major ----
    q_low = project_low(p, q).reshape(B, KV, G, -1)
    klow_p = cache_klow.reshape(B, KV, nP, tpp, -1)
    lg_low = torch.einsum("bkgc,bkptc->bkgpt", q_low.to(f32),
                          klow_p.to(f32))                 # [B,KV,G,nP,tpp]
    tpos = (torch.arange(nP, device=dev)[:, None] * tpp
            + torch.arange(tpp, device=dev)[None, :])     # [nP, tpp]
    lg_low = lg_low.masked_fill(tpos > pos, NEG_INF)
    # pooled over the block's positions and the GQA group's heads: the
    # group shares one candidate set, so Step 3 gathers per kv head
    bs = lg_low.reshape(B, KV, G, nP, pp, blk).amax(dim=(-1, 2))
    top_idx = torch.topk(bs, nb, dim=-1).indices          # [B,KV,nP,nb]

    # ---- Step 3: block gather + exact attention ----
    idx = top_idx[..., None, None].expand(B, KV, nP, nb, blk, Hd)
    k_sel = torch.gather(cache_k.reshape(B, KV, nP, pp, blk, Hd), 3, idx)
    v_sel = torch.gather(cache_v.reshape(B, KV, nP, pp, blk, Hd), 3, idx)
    qh = q.reshape(B, KV, G, Hd)
    lg = torch.einsum("bkgh,bkpnth->bkgpnt", qh.to(f32),
                      k_sel.to(f32)) * scale
    sel_pos = (torch.arange(nP, device=dev)[:, None, None] * tpp
               + top_idx[..., None] * blk
               + torch.arange(blk, device=dev))           # [B,KV,nP,nb,blk]
    lg = lg.masked_fill(sel_pos[:, :, None] > pos, NEG_INF)
    # one softmax over (nP, nb, blk)
    m = lg.amax(dim=(3, 4, 5), keepdim=True).clamp(min=NEG_INF / 2)
    e = torch.exp(lg - m)
    denom = e.sum(dim=(3, 4, 5))                          # [B,KV,G]
    o = torch.einsum("bkgpnt,bkpnth->bkgh", e.to(v_sel.dtype).to(f32),
                     v_sel.to(f32)).to(v_sel.dtype)
    o = o / denom.clamp(min=1e-30)[..., None].to(o.dtype)
    return o.reshape(B, N, Hd)
