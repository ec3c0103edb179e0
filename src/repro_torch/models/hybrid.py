"""RecurrentGemma-style hybrid (port of ``repro/models/hybrid.py``):
groups of the ``pattern`` (recurrentgemma: rec, rec, attn) of RG-LRU
blocks and LOCAL attention blocks (MQA, window ``local_window``, B8 at
prefill and B9 at decode), each followed by a gated MLP, then the
trailing recurrent blocks (38 layers = 12 groups + 2).

The state is fixed in size: each recurrent block's {"h", "conv"} and
each group's attention ring of ``min(S, local_window)`` slots, S the
prompt's length, as the reference sizes it. Serving never pads it, so a
prompt shorter than the window keeps a ring of its own length, and the
first decode step evicts position 0 (the reference's own behaviour,
kept; ROADMAP.md C).

The training loss (``loss``) runs the groups, then the trailing blocks,
each stack under the remat policy, the local attention through
``blocked_attention`` (banded past its window)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import rglru
from repro_torch.models.common import (dtype_of, pos_tensor, scan_layers,
                                       stack_zeros)
from repro_torch.models.layers import (MLP, Norm, apply_mlp, apply_norm,
                                       chunked_xent, embed_tokens,
                                       init_embed, logits_fn)


def _n_groups(cfg):
    g = len(cfg.pattern)
    return cfg.n_layers // g, cfg.n_layers % g   # (full groups, trailing rec)


class RecBlock(nn.Module):
    """``ln_mix``, ``rec`` (``rglru.RGLRU``), ``ln_mlp``, ``mlp``."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln_mix = Norm(cfg, device=device)
        self.rec = rglru.RGLRU(cfg, gen, dtype, device)
        self.ln_mlp = Norm(cfg, device=device)
        self.mlp = MLP(cfg, gen, dtype, device)


class AttnBlock(nn.Module):
    """``ln_mix``, ``attn``, ``ln_mlp``, ``mlp``."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln_mix = Norm(cfg, device=device)
        self.attn = attn.Attention(cfg, gen, dtype, device)
        self.ln_mlp = Norm(cfg, device=device)
        self.mlp = MLP(cfg, gen, dtype, device)


class Group(nn.Module):
    """One ``pattern``: block i is ``rec{i}`` or ``attn{i}``."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        for i, kind in enumerate(cfg.pattern):
            block = RecBlock if kind == "rec" else AttnBlock
            self.add_module(f"{kind}{i}", block(cfg, gen, dtype, device))


class Hybrid(nn.Module):
    """``emb``, ``lm_head``, ``groups`` (``Group``s), ``trail``
    (``RecBlock``s, when the layers do not fill the last group) and
    ``ln_f``: the reference's leaves."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        if cfg.pattern.count("attn") != 1:
            raise ValueError(f"hybrid: the cache holds one attention block "
                             f"a group, as the reference's; pattern "
                             f"{cfg.pattern}")
        dtype = dtype_of(cfg)
        nG, nT = _n_groups(cfg)
        init_embed(self, cfg, gen, dtype, device)
        self.groups = nn.ModuleList(Group(cfg, gen, dtype, device)
                                    for _ in range(nG))
        self.ln_f = Norm(cfg, device=device)
        if nT:
            self.trail = nn.ModuleList(RecBlock(cfg, gen, dtype, device)
                                       for _ in range(nT))


def init(cfg, gen, device=None) -> Hybrid:
    return Hybrid(cfg, gen, device).requires_grad_(False)


def _device(model):
    return model.emb.device


def _blocks(cfg, model):
    """Every block in order as (kind, block, g, j): g the group (None in
    the trail), j the block's index into the recurrent state."""
    j = 0
    for g, gp in enumerate(model.groups):
        for i, kind in enumerate(cfg.pattern):
            yield kind, getattr(gp, f"{kind}{i}"), g, j
            j += kind == "rec"
    for t, bp in enumerate(getattr(model, "trail", ())):
        yield "trail", bp, None, t


def _train_block(cfg, kind, bp, h, positions):
    """One block of the loss: the RG-LRU over the sequence, or the local
    attention (``blocked_attention``, window ``local_window``); then the
    MLP."""
    hn = apply_norm(cfg, bp.ln_mix, h)
    if kind == "attn":
        h = h + attn.attn_forward(cfg, bp.attn, hn, positions,
                                  window=cfg.local_window, train=True)
    else:
        h = h + rglru.apply_rglru(cfg, bp.rec, hn)
    return h + apply_mlp(cfg, bp.mlp, apply_norm(cfg, bp.ln_mlp, h))


def loss(cfg, model, batch):
    """(the mean NLL, {"loss": it}) of ``labels`` after ``tokens``: the
    groups (a checkpoint a group under the remat policy, as the
    reference scans groups), then the trailing recurrent blocks."""
    dev = _device(model)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev)
    h = embed_tokens(cfg, model, tokens)
    pos = torch.arange(tokens.shape[1], device=dev)

    def group_body(hh, gp):
        for i, kind in enumerate(cfg.pattern):
            hh = _train_block(cfg, kind, getattr(gp, f"{kind}{i}"), hh, pos)
        return hh, None

    h, _ = scan_layers(cfg, group_body, h, model.groups)
    if hasattr(model, "trail"):
        h, _ = scan_layers(
            cfg, lambda hh, bp: (_train_block(cfg, "rec", bp, hh, pos), None),
            h, model.trail)
    nll = chunked_xent(cfg, model, apply_norm(cfg, model.ln_f, h), labels)
    return nll, {"loss": nll}


def init_cache(cfg, batch: int, seq_len: int, device="cuda") -> dict:
    """{"attn": {"k", "v"} [nG, B, KV, W, Hd] (W = min(seq_len,
    local_window)), "rec": {"h" [nG * n_rec, B, lru] f32, "conv" [nG *
    n_rec, B, 3, lru]}, and "trail" like "rec" for the trailing blocks}."""
    dtype = dtype_of(cfg)
    nG, nT = _n_groups(cfg)
    W = min(seq_len, cfg.local_window)
    st = rglru.init_rglru_state(cfg, batch, dtype, "meta")
    cache = {"attn": stack_zeros(attn.kv_zeros(cfg, batch, W, dtype, "meta"),
                                 nG, device),
             "rec": stack_zeros(st, nG * cfg.pattern.count("rec"), device)}
    if nT:
        cache["trail"] = stack_zeros(st, nT, device)
    return cache


def _put(state: dict, j: int, new: dict) -> None:
    for k, v in new.items():
        state[k][j] = v


def prefill(cfg, model, batch, cache_len=None):
    """Run the prompt: (last-token logits [B, V] f32, cache). The
    recurrent states are the scans' last ones; each attention ring holds
    the prompt's last ``min(S, local_window)`` positions in order.
    ``cache_len`` is not read: the state is fixed in size."""
    dev = _device(model)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    B, S = tokens.shape
    h = embed_tokens(cfg, model, tokens)
    pos = torch.arange(S, device=dev)
    W = min(S, cfg.local_window)
    cache = init_cache(cfg, B, S, dev)
    for kind, bp, g, j in _blocks(cfg, model):
        hn = apply_norm(cfg, bp.ln_mix, h)
        if kind == "attn":
            a, (k, v) = attn.attn_prefill(cfg, bp.attn, hn, pos,
                                          window=cfg.local_window)
            cache["attn"]["k"][g] = k[:, :, S - W:]
            cache["attn"]["v"][g] = v[:, :, S - W:]
        else:
            a, st = rglru.rglru_scan(cfg, bp.rec, hn)
            _put(cache["rec" if g is not None else "trail"], j, st)
        h = h + a
        h = h + apply_mlp(cfg, bp.mlp, apply_norm(cfg, bp.ln_mlp, h))
    h = apply_norm(cfg, model.ln_f, h[:, -1])
    return logits_fn(cfg, model, h).to(torch.float32), cache


def decode_step(cfg, model, cache, token, pos):
    """token [B, 1]; pos: int or integer tensor. Each recurrent block
    steps its state and each attention block writes its ring's slot
    ``pos % W`` (B9 over ``min(pos + 1, W)`` slots), all in place.
    Returns (logits [B, V] f32, cache)."""
    dev = _device(model)
    h = embed_tokens(cfg, model, torch.as_tensor(token, device=dev))
    p = pos_tensor(pos, dev)
    for kind, bp, g, j in _blocks(cfg, model):
        hn = apply_norm(cfg, bp.ln_mix, h)
        if kind == "attn":
            a, _ = attn.attn_decode(
                cfg, bp.attn, hn, {k: c[g] for k, c in cache["attn"].items()},
                p, window=cfg.local_window)
        else:
            state = cache["rec" if g is not None else "trail"]
            a, st = rglru.decode_rglru(cfg, bp.rec, hn,
                                       {k: c[j] for k, c in state.items()})
            _put(state, j, st)
        h = h + a
        h = h + apply_mlp(cfg, bp.mlp, apply_norm(cfg, bp.ln_mlp, h))
    h = apply_norm(cfg, model.ln_f, h[:, -1])
    return logits_fn(cfg, model, h).to(torch.float32), cache
