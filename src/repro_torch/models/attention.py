"""Attention for the dense and vlm families (port of
``repro/models/attention.py``): grouped-query self-attention at prefill
and single-token decode against a KV cache.

The reference computes both in jnp (``blocked_attention``, a q-chunked
scan, and an einsum at decode). The port routes them through the
hand-written kernels: prefill through ``ops.flash_attention`` (B8,
causal), decode through ``ops.decode_attention`` (B9) with ``length =
pos + 1`` for every row: the reference's ``kv_pos <= pos`` over a dense
cache is exactly that prefix. On CPU tensors the ops take their plain
versions, the reference's arithmetic in torch. Both kernels take
grouped-query attention, so the kv heads are never expanded.

The cache stays in the kernels' layout, ``[B, KV, T, Hd]`` a layer (the
reference's is ``[B, T, KV, Hd]``), and decode writes each step's slot in
place, so no step copies the cache.

Not ported yet (ROADMAP.md A10): the int8 cache (``kv_quant``), the ring
buffer of a windowed arch, and ``attn_forward`` (the training and
cross-attention path)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import retrieval_attention as ra
from repro_torch.models.common import linear
from repro_torch.models.rope import apply_rope


def _refuse(cfg) -> None:
    if cfg.kv_quant:
        raise NotImplementedError("the int8 KV cache (kv_quant) is not "
                                  "ported yet (ROADMAP.md A10)")
    if cfg.window:
        raise NotImplementedError("the windowed (ring-buffer) KV cache is "
                                  "not ported yet (ROADMAP.md A10)")


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv`` (biases the reference's ``bq``, ``bk``,
    ``bv`` where ``qkv_bias``), ``wo``, and for retrieval archs
    ``rp_proj`` [Hd, d_low] f32."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d, n, kvh = cfg.d_model, cfg.n_heads, cfg.kv_heads
        hd = cfg.resolved_head_dim
        b = cfg.qkv_bias
        self.wq = linear(gen, d, n * hd, b, dtype, device)
        self.wk = linear(gen, d, kvh * hd, b, dtype, device)
        self.wv = linear(gen, d, kvh * hd, b, dtype, device)
        self.wo = linear(gen, n * hd, d, False, dtype, device)
        if cfg.retrieval.enabled:
            self.rp_proj = ra.init_retrieval(cfg, gen, device)


def project_q(cfg, p: Attention, x):
    """x [B, S, D] -> q [B, S, N, Hd]."""
    B, S, _ = x.shape
    return p.wq(x).reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)


def project_kv(cfg, p: Attention, x):
    """x [B, S, D] -> k, v [B, S, KV, Hd]."""
    B, S, _ = x.shape
    shape = (B, S, cfg.kv_heads, cfg.resolved_head_dim)
    return p.wk(x).reshape(shape), p.wv(x).reshape(shape)


def merge_heads(cfg, p: Attention, o):
    """o [B, S, N, Hd] -> [B, S, D]."""
    B, S = o.shape[:2]
    return p.wo(o.reshape(B, S, -1))


def attn_forward(cfg, p, x, positions, **kw):
    raise NotImplementedError("attn_forward (the training and "
                              "cross-attention path) is not ported yet "
                              "(ROADMAP.md A10)")


def attn_prefill(cfg, p: Attention, x, positions):
    """Causal self-attention over the prompt, x [B, S, D] at positions
    [S] = 0..S-1 (the flash kernel masks by index, with q aligned to the
    end of the kv axis; S == T here). Returns (y [B, S, D], (k, v)) with
    k, v [B, KV, S, Hd] in the cache's layout, rope applied."""
    q = project_q(cfg, p, x)
    k, v = project_kv(cfg, p, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k = k.transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()
    o = ops.flash_attention(q.transpose(1, 2), k, v,
                            causal=True)                   # [B, N, S, Hd]
    return merge_heads(cfg, p, o.transpose(1, 2)), (k, v)


def attn_decode(cfg, p: Attention, x, cache: dict, pos):
    """One-token decode. x: [B, 1, D]; cache: {"k", "v"} [B, KV, T, Hd]
    (and ``k_low`` [B, KV, T, d_low] for retrieval archs), updated in
    place: the new k / v (and low-dim key) go to slot ``min(pos, T - 1)``;
    pos: a [1] int64 tensor on x's device (no host read). Attends to the
    slots <= pos through ``ops.decode_attention`` with length pos + 1, or
    through the retrieval filter when the cache has ``k_low``. Returns
    (y [B, 1, D], cache)."""
    _refuse(cfg)
    B = x.shape[0]
    T = cache["k"].shape[2]
    q = project_q(cfg, p, x)
    k_new, v_new = project_kv(cfg, p, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    slot = pos.clamp(max=T - 1)
    cache["k"].index_copy_(2, slot, k_new.transpose(1, 2))
    cache["v"].index_copy_(2, slot, v_new.transpose(1, 2))
    if cfg.retrieval.enabled and "k_low" in cache:
        cache["k_low"].index_copy_(
            2, slot, ra.project_low(p, k_new).transpose(1, 2))
        o = ra.retrieval_decode_attention(cfg, p, q[:, 0], cache["k"],
                                          cache["v"], cache["k_low"], pos)
    else:
        length = (pos + 1).to(torch.int32).expand(B)
        o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], length)
    return merge_heads(cfg, p, o[:, None]), cache


def init_cache(cfg, batch: int, seq_len: int, dtype, device=None) -> dict:
    """One layer's zero KV cache, {"k", "v"} [batch, KV, seq_len, Hd] in
    ``dtype``; retrieval archs add the inline low-dim keys ``k_low``
    [batch, KV, seq_len, d_low] (layout (3))."""
    _refuse(cfg)
    kvh, hd = cfg.kv_heads, cfg.resolved_head_dim
    z = lambda w: torch.zeros((batch, kvh, seq_len, w), dtype=dtype,
                              device=device)
    c = {"k": z(hd), "v": z(hd)}
    if cfg.retrieval.enabled:
        c["k_low"] = z(cfg.retrieval.d_low)
    return c
