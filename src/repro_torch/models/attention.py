"""Attention (port of ``repro/models/attention.py``): grouped-query
self-attention over a whole sequence, with an optional sliding window;
the encoder's bidirectional attention and cross-attention
(``attn_forward``); single-token decode against a KV cache, dense, a
ring buffer (windowed archs) or int8 (``kv_quant``).

Serving routes these through the hand-written kernels: prefill, the
encoder and cross-attention through ``ops.flash_attention`` (B8), decode
through ``ops.decode_attention`` (B9) with a valid-prefix length a row.
On CPU tensors the ops take their plain versions, the reference's
arithmetic in torch. Both kernels take grouped-query attention, so the
kv heads are never expanded. Neither has a backward, and both refuse a
graph (``ops``).

Training takes ``blocked_attention``, as the reference trains through
its jnp version (the reference never reads ``attn_impl``): plain torch
that autograd differentiates, q-chunked so the [S, T] scores are never
whole, with the reference's masks by positions; ``attn_forward(...,
train=True)`` routes the families' losses there.

The cache stays in the kernels' layout, ``[B, KV, T, Hd]`` a layer (the
reference's is ``[B, T, KV, Hd]``), and decode writes each step's slot in
place, so no step copies the cache (the int8 cache is dequantised into
a new tensor each step, as the reference dequantises before its
einsum)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import retrieval_attention as ra
from repro_torch.models.common import linear
from repro_torch.models.rope import apply_rope

NEG_INF = -1e30   # the reference's mask value: finite, never float("-inf")


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


# ------------------------ q-chunked core (training) ------------------------

def _mm_f32(a, b):
    """a @ b for bf16 a, b with the f32 accumulator kept (no rounding to
    bf16): ``bmm``'s ``out_dtype`` on the card (which has no backward of
    its own), the inputs widened elsewhere (their products are exact in
    f32)."""
    if a.is_cuda:
        lead = a.shape[:-2]
        return torch.bmm(a.flatten(0, -3), b.flatten(0, -3),
                         out_dtype=torch.float32).view(
            *lead, a.shape[-2], b.shape[-1])
    return a.float() @ b.float()


class _ScoresF32(torch.autograd.Function):
    """q @ k^T in f32 from bf16 q and k, the reference's
    ``einsum(..., preferred_element_type=f32)``. Backward takes the f32
    cotangent to bf16 and multiplies in bf16 with f32 accumulation, the
    gradients in bf16, so the card's two products stay on its bf16
    tensor cores. The reference's transposed products on the CPU keep
    the cotangent f32 (the bf16 operand widened); the whole bf16 step
    against the reference is bounded by
    ``test_bf16_loss_and_grads_match_reference``, where every product
    and activation rounds to bf16 at places that differ anyway."""

    @staticmethod
    def forward(ctx, q, kt):
        ctx.save_for_backward(q, kt)
        return _mm_f32(q, kt)

    @staticmethod
    def backward(ctx, g):
        q, kt = ctx.saved_tensors
        g = g.to(q.dtype)
        return g @ kt.transpose(-1, -2), q.transpose(-1, -2) @ g


def _logits(qc, kc):
    """q . k in f32, as the reference's ``preferred_element_type=f32``:
    a plain product in f32, ``_ScoresF32`` in bf16."""
    kt = kc.transpose(-1, -2)
    if qc.dtype == torch.float32:
        return qc @ kt
    return _ScoresF32.apply(qc, kt)


def blocked_attention(q, k, v, q_pos, kv_pos, *, causal: bool,
                      window: int = 0, q_chunk: int = 256):
    """q: [B, S, N, Hd]; k, v: [B, T, KV, Hd]; positions integer [S] /
    [T]. Returns [B, S, N, Hd]; N a multiple of KV (grouped-query: the
    query heads are reshaped into KV groups of G, the kv heads never
    copied).

    The reference's q-chunked formulation in plain torch: chunks of
    ``q_chunk`` query rows (fewer where S is not a multiple), each
    against every key, or, where ``window > 0 and T > window + c``,
    against the band of ``window + c`` keys that can reach it (kv padded
    on the left by ``window``, the padding at position -1). The masks
    are the reference's, by positions: causal ``q_pos >= kv_pos``, the
    window ``q_pos - kv_pos < window``, and ``kv_pos >= 0``; a masked
    score is ``NEG_INF`` (a row that sees no key averages v, as the
    reference's). Scores and softmax in f32, the weights cast to v's
    dtype for the product."""
    B, S, N, Hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = N // KV
    scale = Hd ** -0.5
    c = min(q_chunk, S)
    while S % c:
        c -= 1
    kt = k.permute(0, 2, 1, 3)                          # [B, KV, T, Hd]
    vt = v.permute(0, 2, 1, 3)
    banded = window > 0 and T > window + c
    if banded:
        kt = F.pad(kt, (0, 0, window, 0))
        vt = F.pad(vt, (0, 0, window, 0))
        kv_pos = F.pad(kv_pos, (window, 0), value=-1)
    outs = []
    for qs in range(0, S, c):
        qc = q[:, qs:qs + c].reshape(B, c, KV, G, Hd).permute(0, 2, 1, 3, 4) \
            .reshape(B, KV, c * G, Hd)
        qp = q_pos[qs:qs + c]
        if banded:
            # query rows [qs, qs + c) reach keys [qs - window, qs + c),
            # padded rows [qs, qs + window + c)
            kc, vc = kt[:, :, qs:qs + window + c], vt[:, :, qs:qs + window + c]
            kpos = kv_pos[qs:qs + window + c]
        else:
            kc, vc, kpos = kt, vt, kv_pos
        lg = _logits(qc, kc) * scale                    # [B, KV, c*G, Tc]
        mask = (kpos[None, :] >= 0).expand(c, -1)
        if causal:
            mask = mask & (qp[:, None] >= kpos[None, :])
        if window > 0:
            mask = mask & ((qp[:, None] - kpos[None, :]) < window)
        Tc = kpos.shape[0]
        lg = torch.where(mask[None, None, :, None, :],
                         lg.view(B, KV, c, G, Tc), NEG_INF)
        w = torch.softmax(lg, dim=-1).view(B, KV, c * G, Tc)
        oc = w.to(v.dtype) @ vc                         # [B, KV, c*G, Hd]
        outs.append(oc.view(B, KV, c, G, Hd).permute(0, 2, 1, 3, 4)
                    .reshape(B, c, N, Hd))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ------------------------ block-level APIs ----------------------------------

def attend(cfg, p: Attention, q, k, v, *, causal: bool, window: int = 0):
    """q [B, S, N, Hd] against k, v [B, KV, T, Hd] through B8 (query row
    i at position i + T - S: the kernel masks by index, the reference by
    positions, the same on every caller's positions) -> [B, S, D]."""
    o = ops.flash_attention(q.transpose(1, 2), k, v, causal=causal,
                            window=window)                 # [B, N, S, Hd]
    return merge_heads(cfg, p, o.transpose(1, 2))


def attn_forward(cfg, p: Attention, x, positions, *, causal=True,
                 window=None, kv_src=None, kv_positions=None, train=False):
    """Self- or cross-attention over a whole sequence: x [B, S, D] at
    ``positions`` -> [B, S, D]. ``kv_src`` [B, T, D] (the encoder's
    states) makes it cross-attention: no rope, no causal mask, keys at
    ``kv_positions`` (default 0..T-1). ``causal=False`` is the encoder's
    bidirectional self-attention.

    ``train=True`` is the families' loss: ``blocked_attention``, with the
    reference's masks by positions, differentiable. Otherwise B8 (the
    encoder and cross-attention at serving), which masks by index: the
    query at i + T - S, the keys at 0..T-1, the same on every serving
    caller's positions (``kv_positions`` must be those)."""
    q = project_q(cfg, p, x)
    src = x if kv_src is None else kv_src
    k, v = project_kv(cfg, p, src)
    w = (cfg.window if window is None else window) or 0
    if kv_src is None and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kv_pos = positions
    else:
        kv_pos = kv_positions if kv_positions is not None else \
            torch.arange(src.shape[1], device=src.device)
    causal = causal and kv_src is None
    if train:
        return merge_heads(cfg, p, blocked_attention(
            q, k, v, positions, kv_pos, causal=causal, window=w))
    if kv_src is not None and w:
        raise ValueError("attn_forward: a window on cross-attention masks "
                         "decoder positions against encoder ones; no "
                         "config has one")
    return attend(cfg, p, q, to_cache(k), to_cache(v), causal=causal,
                  window=w)


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
