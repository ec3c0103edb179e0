"""Whisper-style encoder-decoder (port of ``repro/models/encdec.py``).
The conv audio frontend is a stub: the batch's ``frames`` [B, F, D] are
its output. The encoder is a bidirectional transformer over the frames
(B8, non-causal); the decoder adds causal self-attention (B8 at prefill,
B9 at decode) and cross-attention to the encoder's states (B8
non-causal at prefill, B9 over all F frames at decode). Positions are
sinusoidal (``rope_theta`` 0).

The frames are cast to the model's dtype before the encoder (as the
reference casts a vlm's patches): the reference adds f32 frames to the
table and lets promotion carry a bf16 encoder in f32, which PyTorch's
matrix products refuse. Serving casts them before the call
(``launch.serve``), so both packages see the same values.

The training loss (``loss``) runs the encoder and the decoder over the
whole sequence through ``blocked_attention`` (``attn_forward(...,
train=True)``), as the reference's."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.common import (dtype_of, pos_tensor, scan_layers,
                                       stack_zeros)
from repro_torch.models.layers import (MLP, Norm, apply_mlp, apply_norm,
                                       chunked_xent, embed_tokens,
                                       init_embed, logits_fn)
from repro_torch.models.rope import sinusoidal_positions

MAX_DEC_POS = 65536   # sinusoidal table length for the decoder


class EncLayer(nn.Module):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln_attn = Norm(cfg, device=device)
        self.attn = attn.Attention(cfg, gen, dtype, device)
        self.ln_mlp = Norm(cfg, device=device)
        self.mlp = MLP(cfg, gen, dtype, device)


class DecLayer(EncLayer):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__(cfg, gen, dtype, device)
        self.ln_xattn = Norm(cfg, device=device)
        self.xattn = attn.Attention(cfg, gen, dtype, device)


class EncDec(nn.Module):
    """``emb``, ``lm_head``, ``enc_layers_p`` (``EncLayer``s), ``layers``
    (``DecLayer``s: ``ln_attn``, ``attn``, ``ln_xattn``, ``xattn``,
    ``ln_mlp``, ``mlp``), ``ln_enc``, ``ln_f``: the reference's leaves.
    The buffer ``dec_pos`` is the [MAX_DEC_POS, D] f32 sinusoidal table,
    built once with the model on its device."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        dtype = dtype_of(cfg)
        init_embed(self, cfg, gen, dtype, device)
        self.enc_layers_p = nn.ModuleList(
            EncLayer(cfg, gen, dtype, device) for _ in range(cfg.enc_layers))
        self.layers = nn.ModuleList(DecLayer(cfg, gen, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.ln_enc = Norm(cfg, device=device)
        self.ln_f = Norm(cfg, device=device)
        for name, t in buffers(cfg, device).items():
            self.register_buffer(name, t, persistent=False)


def buffers(cfg, device) -> dict:
    """{"dec_pos": the decoder's [MAX_DEC_POS, D] f32 sinusoidal table}
    on ``device``."""
    return {"dec_pos": sinusoidal_positions(MAX_DEC_POS, cfg.d_model,
                                            device=device)}


def init(cfg, gen, device=None) -> EncDec:
    return EncDec(cfg, gen, device).requires_grad_(False)


def _device(model):
    return model.emb.device


def encode(cfg, model, frames, *, train=False):
    """frames: [B, F, D] (the stubbed frontend's output) -> the encoder's
    states [B, F, D] in the model's dtype; ``train``: through
    ``blocked_attention`` under the remat policy (the loss), else B8."""
    dev = _device(model)
    frames = torch.as_tensor(frames, device=dev).to(dtype_of(cfg))
    F_ = frames.shape[1]
    h = frames + model.dec_pos[:F_].to(frames.dtype)
    pos = torch.arange(F_, device=dev)

    def body(hh, lp):
        hh = hh + attn.attn_forward(cfg, lp.attn,
                                    apply_norm(cfg, lp.ln_attn, hh), pos,
                                    causal=False, train=train)
        return hh + apply_mlp(cfg, lp.mlp, apply_norm(cfg, lp.ln_mlp, hh)), \
            None

    h, _ = scan_layers(cfg, body, h, model.enc_layers_p)
    return apply_norm(cfg, model.ln_enc, h)


def loss(cfg, model, batch):
    """(the mean NLL, {"loss": it}): the encoder over ``batch["frames"]``,
    the decoder over ``tokens`` with causal self-attention and
    cross-attention to the encoder's states, the NLL of ``labels``."""
    dev = _device(model)
    enc = encode(cfg, model, batch["frames"], train=True)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev)
    S = tokens.shape[1]
    h = embed_tokens(cfg, model, tokens)
    h = h + model.dec_pos[:S].to(h.dtype)
    pos = torch.arange(S, device=dev)
    enc_pos = torch.arange(enc.shape[1], device=dev)

    def body(hh, lp):
        hh = hh + attn.attn_forward(cfg, lp.attn,
                                    apply_norm(cfg, lp.ln_attn, hh), pos,
                                    train=True)
        hh = hh + attn.attn_forward(cfg, lp.xattn,
                                    apply_norm(cfg, lp.ln_xattn, hh), pos,
                                    kv_src=enc, kv_positions=enc_pos,
                                    causal=False, train=True)
        return hh + apply_mlp(cfg, lp.mlp, apply_norm(cfg, lp.ln_mlp, hh)), \
            None

    h, _ = scan_layers(cfg, body, h, model.layers)
    nll = chunked_xent(cfg, model, apply_norm(cfg, model.ln_f, h), labels)
    return nll, {"loss": nll}


def init_cache(cfg, batch: int, seq_len: int, device="cuda") -> dict:
    """{"self": {"k", "v"} [L, B, KV, T, Hd], "cross": {"k", "v"} [L, B,
    KV, F, Hd]}, zeros (F = ``enc_frames``)."""
    dtype = dtype_of(cfg)
    cross = attn.kv_zeros(cfg, batch, cfg.enc_frames, dtype, "meta")
    return {"self": stack_zeros(attn.init_cache(cfg, batch, seq_len, dtype,
                                                "meta"), cfg.n_layers,
                                device),
            "cross": stack_zeros(cross, cfg.n_layers, device)}


def prefill(cfg, model, batch, cache_len=None):
    """Encode ``batch["frames"]``, run the decoder over ``batch["tokens"]``
    [B, S]: (last-token logits [B, V] f32, cache). The self cache holds
    the prompt in positions 0..S-1 of ``cache_len`` (None: S); the cross
    cache every layer's k and v of the encoder's states (with the
    ``qkv_bias`` biases), computed once here and read by every decode
    step."""
    dev = _device(model)
    enc = encode(cfg, model, batch["frames"])
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    B, S = tokens.shape
    h = embed_tokens(cfg, model, tokens)
    h = h + model.dec_pos[:S].to(h.dtype)
    pos = torch.arange(S, device=dev)
    L, F_ = cfg.n_layers, enc.shape[1]
    cache = {"self": stack_zeros(attn.kv_zeros(cfg, B, S if cache_len is None
                                               else cache_len, h.dtype,
                                               "meta"), L, dev),
             "cross": stack_zeros(attn.kv_zeros(cfg, B, F_, h.dtype, "meta"),
                                  L, dev)}
    for l, lp in enumerate(model.layers):
        a, (k, v) = attn.attn_prefill(cfg, lp.attn,
                                      apply_norm(cfg, lp.ln_attn, h), pos)
        cache["self"]["k"][l, :, :, :S] = k
        cache["self"]["v"][l, :, :, :S] = v
        h = h + a
        xk, xv = (attn.to_cache(t) for t in attn.project_kv(cfg, lp.xattn,
                                                              enc))
        cache["cross"]["k"][l] = xk
        cache["cross"]["v"][l] = xv
        q = attn.project_q(cfg, lp.xattn, apply_norm(cfg, lp.ln_xattn, h))
        h = h + attn.attend(cfg, lp.xattn, q, xk, xv, causal=False)
        h = h + apply_mlp(cfg, lp.mlp, apply_norm(cfg, lp.ln_mlp, h))
    h = apply_norm(cfg, model.ln_f, h[:, -1])
    return logits_fn(cfg, model, h).to(torch.float32), cache


def decode_step(cfg, model, cache, token, pos):
    """token [B, 1]; pos: int or integer tensor. Self-attention writes
    slot ``min(pos, T - 1)`` of the self cache in place (B9 over pos + 1
    slots); cross-attention reads the whole cross cache (B9, length F
    for every row). Returns (logits [B, V] f32, cache)."""
    dev = _device(model)
    tok = torch.as_tensor(token, device=dev)
    B = tok.shape[0]
    p = pos_tensor(pos, dev)
    h = embed_tokens(cfg, model, tok)
    # the reference's dynamic_slice clamps the row into the table
    h = h + model.dec_pos.index_select(0, p.clamp(0, MAX_DEC_POS - 1)) \
        .to(h.dtype)
    F_ = cache["cross"]["k"].shape[3]
    length = torch.full((B,), F_, dtype=torch.int32, device=dev)
    for l, lp in enumerate(model.layers):
        a, _ = attn.attn_decode(cfg, lp.attn, apply_norm(cfg, lp.ln_attn, h),
                                {k: c[l] for k, c in cache["self"].items()},
                                p)
        h = h + a
        q = attn.project_q(cfg, lp.xattn, apply_norm(cfg, lp.ln_xattn, h))
        o = ops.decode_attention(q[:, 0], cache["cross"]["k"][l],
                                 cache["cross"]["v"][l], length)
        h = h + attn.merge_heads(cfg, lp.xattn, o[:, None])
        h = h + apply_mlp(cfg, lp.mlp, apply_norm(cfg, lp.ln_mlp, h))
    h = apply_norm(cfg, model.ln_f, h[:, -1])
    return logits_fn(cfg, model, h).to(torch.float32), cache
