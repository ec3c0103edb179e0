"""Decoder-only transformer for the dense, moe and vlm families (port of
``repro/models/transformer.py``): init, the training loss
(``forward_hidden``, ``loss``), the KV cache, prefill and decode, with
the sliding-window ring buffer and the int8 cache. The layers are an
``nn.ModuleList`` run in a Python loop (the reference stacks them and
scans; ``common.scan_layers`` keeps its remat policies)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (dtype_of, linear, pos_tensor,
                                       scan_layers, stack_zeros)
from repro_torch.models.layers import (MLP, Norm, apply_mlp, apply_norm,
                                       chunked_xent, embed_tokens,
                                       init_embed, logits_fn)

# the reference's capacity factors at prefill and at decode
# (transformer.py:137, 165)
PREFILL_CAPACITY, DECODE_CAPACITY = 1.25, 2.0


class Block(nn.Module):
    """``ln_attn``, ``attn``, ``ln_mlp`` and ``mlp``, or ``moe`` for the
    moe family."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln_attn = Norm(cfg, device=device)
        self.attn = attn.Attention(cfg, gen, dtype, device)
        self.ln_mlp = Norm(cfg, device=device)
        if cfg.moe is not None:
            self.moe = moe_mod.MoE(cfg, gen, dtype, device)
        else:
            self.mlp = MLP(cfg, gen, dtype, device)


def ffn(cfg, lp: Block, x, capacity_factor: float):
    """The block's MLP, or its MoE at ``capacity_factor`` (its metrics
    dropped: serving does not read them)."""
    if cfg.moe is not None:
        return moe_mod.apply_moe(cfg, lp.moe, x,
                                 capacity_factor=capacity_factor)[0]
    return apply_mlp(cfg, lp.mlp, x)


class Transformer(nn.Module):
    """``emb`` [V, D], ``lm_head`` (untied), ``layers`` (one ``Block``
    each), ``ln_f`` and, for vlm, ``vis_proj``: the reference's leaf
    names."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        dtype = dtype_of(cfg)
        init_embed(self, cfg, gen, dtype, device)
        self.layers = nn.ModuleList(Block(cfg, gen, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = Norm(cfg, device=device)
        if cfg.vis_tokens:
            self.vis_proj = linear(gen, cfg.d_model, cfg.d_model, False,
                                   dtype, device)


def init(cfg, gen, device=None) -> Transformer:
    """Parameters on ``device`` drawn from ``gen`` (a ``torch.Generator``
    on that device; None leaves them uninitialised), without gradients:
    a trainer turns them on for its own model (``train.TrainLoop``)."""
    return Transformer(cfg, gen, device).requires_grad_(False)


def _device(model):
    return model.emb.device


def init_cache(cfg, batch: int, seq_len: int, device="cuda") -> dict:
    """The zero KV cache of every layer, ``attention.init_cache``'s
    stacked: {"k", "v"} [L, B, KV, T, Hd] (T bounded by the window; int8
    with ``k_sc`` / ``v_sc`` for ``kv_quant``; ``k_low`` for retrieval
    archs); layer l's slice is contiguous in the kernels' layout."""
    return stack_zeros(attn.init_cache(cfg, batch, seq_len, dtype_of(cfg),
                                       "meta"), cfg.n_layers, device)


def _embed_inputs(cfg, model, batch):
    """(h [B, S_total, D], positions [S_total]): the token embeddings,
    after the projected patch embeddings for vlm."""
    dev = _device(model)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    h = embed_tokens(cfg, model, tokens)
    if cfg.vis_tokens:
        patches = torch.as_tensor(batch["patches"], device=dev)
        h = torch.cat([model.vis_proj(patches.to(h.dtype)), h], dim=1)
    return h, torch.arange(h.shape[1], device=dev)


# --------------------------- forward (full-seq) -----------------------------

def _layer_fwd(cfg, lp: Block, h, positions):
    """One block in training: ``blocked_attention`` and the MLP, or the
    MoE at the training capacity with its metrics."""
    h = h + attn.attn_forward(cfg, lp.attn, apply_norm(cfg, lp.ln_attn, h),
                              positions, train=True)
    hn = apply_norm(cfg, lp.ln_mlp, h)
    if cfg.moe is not None:
        m, aux = moe_mod.apply_moe(cfg, lp.moe, hn)
    else:
        m, aux = apply_mlp(cfg, lp.mlp, hn), {}
    return h + m, aux


def forward_hidden(cfg, model, h, positions):
    """h: [B, S, D] embedded inputs -> (the final hidden [B, S, D], the
    MoE's metrics, each the mean over the layers)."""
    h, aux = scan_layers(cfg, lambda c, lp: _layer_fwd(cfg, lp, c, positions),
                         h, model.layers)
    h = apply_norm(cfg, model.ln_f, h)
    aux = {k: torch.stack([a[k] for a in aux]).mean() for k in aux[0]} \
        if aux and aux[0] else {}
    return h, aux


def loss(cfg, model, batch):
    """(the total loss, {"loss": the mean NLL, and the MoE's "aux_loss"
    and "dropped_frac"}): ``batch`` holds ``tokens`` and ``labels`` [B,
    S] (and ``patches`` for vlm, whose positions take no loss); the moe
    family adds ``aux_loss_weight`` times its mean ``aux_loss``."""
    h, positions = _embed_inputs(cfg, model, batch)
    h, aux = forward_hidden(cfg, model, h, positions)
    labels = torch.as_tensor(batch["labels"], device=h.device)
    # logits only over text positions (the reference's mask, 0 on the
    # patch positions, which it then slices away)
    nll = chunked_xent(cfg, model, h[:, cfg.vis_tokens:], labels)
    total = nll
    if cfg.moe is not None and "aux_loss" in aux:
        total = total + cfg.moe.aux_loss_weight * aux["aux_loss"]
    return total, {"loss": nll, **aux}


def prefill(cfg, model, batch, cache_len=None):
    """Run the prompt: (last-token logits [B, V] f32, cache {"k", "v"}
    [L, B, KV, T, Hd]). T is ``cache_len`` (None: the prompt's length, as
    the reference returns it; serving preallocates the decode length
    here instead of padding later), bounded by a windowed arch's window.
    The prompt's positions go to slots 0.. in order; past the window,
    its last ``window`` positions, as the reference keeps them (so the
    ring's slots are not ``pos % T`` when the prompt is longer than the
    window and not a multiple of it: the reference's own layout, kept;
    ROADMAP.md C). The cache is in the model's dtype even for
    ``kv_quant``: the reference's prefill returns k and v unquantised,
    and its decode quantises only a cache that has scales (one from
    ``init_cache``)."""
    h, positions = _embed_inputs(cfg, model, batch)
    B, S = h.shape[:2]
    T = S if cache_len is None else cache_len
    keep = min(cfg.window, S) if cfg.window else S
    if cfg.window:
        T = min(T, cfg.window)
    cache = stack_zeros(attn.kv_zeros(cfg, B, T, h.dtype, "meta"),
                        cfg.n_layers, _device(model))
    for l, lp in enumerate(model.layers):
        a, (k, v) = attn.attn_prefill(cfg, lp.attn,
                                      apply_norm(cfg, lp.ln_attn, h),
                                      positions)
        cache["k"][l, :, :, :keep] = k[:, :, S - keep:]
        cache["v"][l, :, :, :keep] = v[:, :, S - keep:]
        h = h + a
        h = h + ffn(cfg, lp, apply_norm(cfg, lp.ln_mlp, h), PREFILL_CAPACITY)
    h = apply_norm(cfg, model.ln_f, h[:, -1])
    return logits_fn(cfg, model, h).to(torch.float32), cache


def decode_step(cfg, model, cache, token, pos):
    """token: [B, 1] integer; pos: int or integer tensor (the current
    position). Updates ``cache`` in place (slot ``min(pos, T - 1)`` of
    every layer, ``pos % T`` in a window's ring) and returns (logits [B,
    V] f32, cache)."""
    dev = _device(model)
    h = embed_tokens(cfg, model, torch.as_tensor(token, device=dev))
    p = pos_tensor(pos, dev)
    for l, lp in enumerate(model.layers):
        a, _ = attn.attn_decode(cfg, lp.attn, apply_norm(cfg, lp.ln_attn, h),
                                {k: c[l] for k, c in cache.items()}, p)
        h = h + a
        h = h + ffn(cfg, lp, apply_norm(cfg, lp.ln_mlp, h), DECODE_CAPACITY)
    h = apply_norm(cfg, model.ln_f, h[:, -1])
    return logits_fn(cfg, model, h).to(torch.float32), cache
