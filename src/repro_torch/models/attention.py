"""Attention (port of ``repro/models/attention.py``): grouped-query
self-attention at prefill, with an optional sliding window; the
encoder's bidirectional attention and cross-attention
(``attn_forward``); single-token decode against a KV cache, dense, a
ring buffer (windowed archs) or int8 (``kv_quant``).

The reference computes these in jnp (``blocked_attention``, a q-chunked
scan, and an einsum at decode). The port routes them through the
hand-written kernels: prefill, the encoder and cross-attention through
``ops.flash_attention`` (B8), decode through ``ops.decode_attention``
(B9) with a valid-prefix length a row. On CPU tensors the ops take their
plain versions, the reference's arithmetic in torch. Both kernels take
grouped-query attention, so the kv heads are never expanded.

The cache stays in the kernels' layout, ``[B, KV, T, Hd]`` a layer (the
reference's is ``[B, T, KV, Hd]``), and decode writes each step's slot in
place, so no step copies the cache (the int8 cache is dequantised into
a new tensor each step, as the reference dequantises before its
einsum)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import retrieval_attention as ra
from repro_torch.models.common import linear
from repro_torch.models.rope import apply_rope


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


def to_cache(t):
    """[B, S, KV, Hd] -> the cache's (and the kernels') [B, KV, S, Hd],
    contiguous."""
    return t.transpose(1, 2).contiguous()


def attend(cfg, p: Attention, q, k, v, *, causal: bool, window: int = 0):
    """q [B, S, N, Hd] against k, v [B, KV, T, Hd] through B8 (query row
    i at position i + T - S: the kernel masks by index, the reference by
    positions, the same on every caller's positions) -> [B, S, D]."""
    o = ops.flash_attention(q.transpose(1, 2), k, v, causal=causal,
                            window=window)                 # [B, N, S, Hd]
    return merge_heads(cfg, p, o.transpose(1, 2))


def attn_forward(cfg, p: Attention, x, positions, *, causal=True,
                 window=None, kv_src=None, kv_positions=None):
    """Self- or cross-attention over a whole sequence: x [B, S, D] at
    positions 0..S-1 -> [B, S, D]. ``kv_src`` [B, T, D] (the encoder's
    states) makes it cross-attention: no rope, no causal mask, keys at
    0..T-1 (``kv_positions``, kept for the reference's signature, must be
    those: the kernel masks by index). ``causal=False`` is the encoder's
    bidirectional self-attention. Serving calls it for the encoder and
    for whisper's cross-attention; its training use waits for the
    training port (ROADMAP.md A10c)."""
    q = project_q(cfg, p, x)
    k, v = project_kv(cfg, p, x if kv_src is None else kv_src)
    w = (cfg.window if window is None else window) or 0
    if kv_src is not None and w:
        raise ValueError("attn_forward: a window on cross-attention masks "
                         "decoder positions against encoder ones; no "
                         "config has one")
    if kv_src is None and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return attend(cfg, p, q, to_cache(k), to_cache(v),
                  causal=causal and kv_src is None, window=w)


def attn_prefill(cfg, p: Attention, x, positions, *, window=None):
    """Causal self-attention over the prompt, x [B, S, D] at positions
    [S] = 0..S-1, sliding-window where ``window`` (default
    ``cfg.window``) is set. Returns (y [B, S, D], (k, v)) with k, v [B,
    KV, S, Hd] in the cache's layout, rope applied."""
    q = project_q(cfg, p, x)
    k, v = project_kv(cfg, p, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k, v = to_cache(k), to_cache(v)
    w = (cfg.window if window is None else window) or 0
    return attend(cfg, p, q, k, v, causal=True, window=w), (k, v)


def attn_decode(cfg, p: Attention, x, cache: dict, pos, *, window=None):
    """One-token decode. x: [B, 1, D]; cache: {"k", "v"} [B, KV, T, Hd]
    (int8 with scales ``k_sc`` / ``v_sc`` [B, KV, T, 1] for ``kv_quant``;
    ``k_low`` [B, KV, T, d_low] for retrieval archs), updated in place;
    pos: a [1] int64 tensor on x's device (no host read). Returns (y [B,
    1, D], cache).

    The new k / v go to slot ``min(pos, T - 1)``, or ``pos % T`` in the
    ring buffer of a windowed arch (``window``, default ``cfg.window``).
    B9 attends to the first ``min(pos + 1, T)`` slots. That is exactly
    the reference's mask: a dense cache holds positions 0..pos; a ring
    holds, in slot s, the last position p' <= pos with p' % T == s,
    valid when p' >= 0 and pos - p' < window, and since every ring is
    at most the window long (``init_cache``, the prefills) that is every
    slot once pos >= T - 1 and slots 0..pos before. The slots' order
    does not matter to the softmax. The int8 cache is dequantised, then
    attended, as the reference does."""
    B = x.shape[0]
    T = cache["k"].shape[2]
    w = (cfg.window if window is None else window) or 0
    if w and T > w:
        raise ValueError(f"attn_decode: a ring buffer of {T} slots is "
                         f"longer than the window {w}")
    q = project_q(cfg, p, x)
    k_new, v_new = project_kv(cfg, p, x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    slot = torch.remainder(pos, T) if w else pos.clamp(max=T - 1)
    k_new, v_new = k_new.transpose(1, 2), v_new.transpose(1, 2)
    if cfg.kv_quant and "k_sc" in cache:
        for name, t in (("k", k_new), ("v", v_new)):
            tq, sc = _quantize_kv(t)
            cache[name].index_copy_(2, slot, tq)
            cache[name + "_sc"].index_copy_(2, slot, sc)
        ck = _dequantize_kv(cache["k"], cache["k_sc"])
        cv = _dequantize_kv(cache["v"], cache["v_sc"])
    else:
        cache["k"].index_copy_(2, slot, k_new)
        cache["v"].index_copy_(2, slot, v_new)
        ck, cv = cache["k"], cache["v"]
    if cfg.retrieval.enabled and "k_low" in cache:
        cache["k_low"].index_copy_(2, slot, ra.project_low(p, k_new))
        o = ra.retrieval_decode_attention(cfg, p, q[:, 0], ck, cv,
                                          cache["k_low"], pos)
    else:
        length = (pos + 1).clamp(max=T).to(torch.int32).expand(B)
        o = ops.decode_attention(q[:, 0], ck, cv, length)
    return merge_heads(cfg, p, o[:, None]), cache


def kv_zeros(cfg, batch: int, seq_len: int, dtype, device=None) -> dict:
    """{"k", "v"}: zeros [batch, KV, seq_len, Hd] in ``dtype``."""
    shape = (batch, cfg.kv_heads, seq_len, cfg.resolved_head_dim)
    return {n: torch.zeros(shape, dtype=dtype, device=device)
            for n in ("k", "v")}


def init_cache(cfg, batch: int, seq_len: int, dtype, device=None) -> dict:
    """One layer's zero KV cache, {"k", "v"} [batch, KV, T, Hd] in
    ``dtype``, T = ``seq_len`` bounded by a windowed arch's window (the
    ring buffer). ``kv_quant``: int8 values with ``k_sc`` / ``v_sc``
    [batch, KV, T, 1] in ``dtype`` (the absmax scale of each token and
    head). Retrieval archs add the inline low-dim keys ``k_low`` [batch,
    KV, T, d_low] (layout (3))."""
    T = min(seq_len, cfg.window) if cfg.window else seq_len
    if cfg.kv_quant:
        c = kv_zeros(cfg, batch, T, torch.int8, device)
        sc = (batch, cfg.kv_heads, T, 1)
        c.update({n: torch.zeros(sc, dtype=dtype, device=device)
                  for n in ("k_sc", "v_sc")})
    else:
        c = kv_zeros(cfg, batch, T, dtype, device)
    if cfg.retrieval.enabled:
        c["k_low"] = torch.zeros((batch, cfg.kv_heads, T,
                                  cfg.retrieval.d_low), dtype=dtype,
                                 device=device)
    return c


def _quantize_kv(x):
    """x [..., Hd] -> (int8 [..., Hd], scale [..., 1] in x's dtype): the
    absmax scale in f32 (plus 1e-8), values rounded half to even (as
    ``jnp.round``) and clipped to +-127; the scale is stored in x's
    dtype, the values divided by the f32 one, as the reference does."""
    xf = x.to(torch.float32)
    sc = xf.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8)
    return q, sc.to(x.dtype)


def _dequantize_kv(q, sc):
    """int8 values times their stored scales, in the scales' dtype."""
    return q.to(sc.dtype) * sc
