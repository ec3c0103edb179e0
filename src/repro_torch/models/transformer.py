"""Decoder-only transformer for the dense and vlm families (port of
``repro/models/transformer.py``): init, the KV cache, prefill and
decode. The layers are an ``nn.ModuleList`` run in a Python loop (the
reference stacks them and scans).

Not ported yet (ROADMAP.md A10): the moe family, windowed attention, the
int8 cache, and the training loss."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import dtype_of, embed_init, linear
from repro_torch.models.layers import (MLP, Norm, apply_mlp, apply_norm,
                                       embed_tokens, logits_fn)

FAMILIES = ("dense", "vlm")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what this module does not serve
    yet: the moe family, a sliding window, the int8 cache."""
    if cfg.family not in FAMILIES or cfg.moe is not None:
        raise NotImplementedError(f"the {cfg.family} family is not ported "
                                  "yet (ROADMAP.md A10)")
    attn._refuse(cfg)


class Block(nn.Module):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln_attn = Norm(cfg, device=device)
        self.attn = attn.Attention(cfg, gen, dtype, device)
        self.ln_mlp = Norm(cfg, device=device)
        self.mlp = MLP(cfg, gen, dtype, device)


class Transformer(nn.Module):
    """``emb`` [V, D], ``lm_head`` (untied), ``layers`` (one ``Block``
    each: ``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``), ``ln_f`` and, for
    vlm, ``vis_proj``: the reference's leaf names."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        dtype = dtype_of(cfg)
        self.emb = nn.Parameter(embed_init(gen, (cfg.vocab, cfg.d_model),
                                           dtype, device))
        if not cfg.tie_embeddings:
            self.lm_head = linear(gen, cfg.d_model, cfg.vocab, False, dtype,
                                  device)
        self.layers = nn.ModuleList(Block(cfg, gen, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = Norm(cfg, device=device)
        if cfg.vis_tokens:
            self.vis_proj = linear(gen, cfg.d_model, cfg.d_model, False,
                                   dtype, device)


def init(cfg, gen, device=None) -> Transformer:
    """Parameters on ``device`` drawn from ``gen`` (a ``torch.Generator``
    on that device; None leaves them uninitialised), without gradients:
    the port serves, it does not train yet."""
    check_supported(cfg)
    return Transformer(cfg, gen, device).requires_grad_(False)


def _device(model):
    return model.emb.device


def init_cache(cfg, batch: int, seq_len: int, device="cuda") -> dict:
    """The zero KV cache of every layer: {"k", "v"} [L, B, KV, T, Hd]
    (``k_low`` [L, B, KV, T, d_low] for retrieval archs); layer l's slice
    is contiguous in the kernels' layout."""
    one = attn.init_cache(cfg, batch, seq_len, dtype_of(cfg), device)
    return {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=v.dtype,
                           device=device) for k, v in one.items()}


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


def _pos(pos, device):
    """The current position as a [1] int64 tensor on ``device``: an int
    is filled there (no copy from the host), a tensor moved as it is."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.long)
    return torch.full((1,), int(pos), dtype=torch.long, device=device)


def prefill(cfg, model, batch, cache_len=None):
    """Run the prompt: (last-token logits [B, V] f32, cache). The cache
    holds every layer's k and v of the prompt in positions 0..S_total-1
    of ``cache_len`` positions (None: exactly the prompt, as the
    reference returns it; serving preallocates the decode length here
    instead of padding later)."""
    h, positions = _embed_inputs(cfg, model, batch)
    B, S = h.shape[:2]
    cache = init_cache(cfg, B, S if cache_len is None else cache_len,
                       _device(model))
    cache.pop("k_low", None)      # the engine derives it (layout (3))
    for l, lp in enumerate(model.layers):
        a, (k, v) = attn.attn_prefill(cfg, lp.attn,
                                      apply_norm(cfg, lp.ln_attn, h),
                                      positions)
        cache["k"][l, :, :, :S] = k
        cache["v"][l, :, :, :S] = v
        h = h + a
        h = h + apply_mlp(cfg, lp.mlp, apply_norm(cfg, lp.ln_mlp, h))
    h = apply_norm(cfg, model.ln_f, h[:, -1])
    return logits_fn(cfg, model, h).to(torch.float32), cache


def decode_step(cfg, model, cache, token, pos):
    """token: [B, 1] integer; pos: int or integer tensor (the current
    position). Updates ``cache`` in place (slot ``min(pos, T - 1)`` of
    every layer) and returns (logits [B, V] f32, cache)."""
    dev = _device(model)
    h = embed_tokens(cfg, model, torch.as_tensor(token, device=dev))
    p = _pos(pos, dev)
    for l, lp in enumerate(model.layers):
        a, _ = attn.attn_decode(cfg, lp.attn, apply_norm(cfg, lp.ln_attn, h),
                                {k: c[l] for k, c in cache.items()}, p)
        h = h + a
        h = h + apply_mlp(cfg, lp.mlp, apply_norm(cfg, lp.ln_mlp, h))
    h = apply_norm(cfg, model.ln_f, h[:, -1])
    return logits_fn(cfg, model, h).to(torch.float32), cache
