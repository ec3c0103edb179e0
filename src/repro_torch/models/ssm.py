"""The RWKV6 model (port of ``repro/models/ssm.py``): attention-free,
with a recurrent state of fixed size a layer, the time mix's {"x_prev",
"S" [B, H, hd, hd] f32} and the channel mix's {"x_prev"}. It launches
neither attention kernel.

The training loss (``loss``) runs the layers with no state at all, as
the reference's ``_layer(cfg, lp, h, None)``: serving's ``_layers``
writes the states into the cache in place, which autograd refuses."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import rwkv6
from repro_torch.models.common import dtype_of, scan_layers, stack_zeros
from repro_torch.models.layers import (Norm, apply_norm, chunked_xent,
                                       embed_tokens, init_embed, logits_fn)


class Layer(nn.Module):
    """``ln_t``, ``tmix``, ``ln_c``, ``cmix``."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln_t = Norm(cfg, device=device)
        self.tmix = rwkv6.TimeMix(cfg, gen, dtype, device)
        self.ln_c = Norm(cfg, device=device)
        self.cmix = rwkv6.ChannelMix(cfg, gen, dtype, device)


class RWKV(nn.Module):
    """``emb``, ``lm_head``, ``ln_0`` (the rwkv convention: a norm after
    the embedding), ``layers``, ``ln_f``: the reference's leaves."""

    def __init__(self, cfg, gen, device):
        super().__init__()
        dtype = dtype_of(cfg)
        init_embed(self, cfg, gen, dtype, device)
        self.ln_0 = Norm(cfg, device=device)
        self.layers = nn.ModuleList(Layer(cfg, gen, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = Norm(cfg, device=device)


def init(cfg, gen, device=None) -> RWKV:
    return RWKV(cfg, gen, device).requires_grad_(False)


def _device(model):
    return model.emb.device


def loss(cfg, model, batch):
    """(the mean NLL, {"loss": it}) of ``labels`` after ``tokens``: each
    layer's time and channel mix from zero state (the chunked form),
    under the remat policy; no state is kept or written."""
    dev = _device(model)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev)
    h = apply_norm(cfg, model.ln_0, embed_tokens(cfg, model, tokens))

    def body(hh, lp):
        t, _ = rwkv6.tmix_forward(cfg, lp.tmix, apply_norm(cfg, lp.ln_t, hh))
        hh = hh + t
        c, _ = rwkv6.cmix_forward(cfg, lp.cmix, apply_norm(cfg, lp.ln_c, hh))
        return hh + c, None

    h, _ = scan_layers(cfg, body, h, model.layers)
    nll = chunked_xent(cfg, model, apply_norm(cfg, model.ln_f, h), labels)
    return nll, {"loss": nll}


def init_cache(cfg, batch: int, seq_len: int, device="cuda") -> dict:
    """{"t": {"x_prev" [L, B, 1, D], "S" [L, B, H, hd, hd] f32}, "c":
    {"x_prev" [L, B, 1, D]}}, zeros; ``seq_len`` is not read."""
    H, hd, D = cfg.n_heads, cfg.resolved_head_dim, cfg.d_model
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    dt = dtype_of(cfg)
    return {"t": stack_zeros({"x_prev": meta((batch, 1, D), dt),
                              "S": meta((batch, H, hd, hd), torch.float32)},
                             cfg.n_layers, device),
            "c": stack_zeros({"x_prev": meta((batch, 1, D), dt)},
                             cfg.n_layers, device)}


def _layers(cfg, model, h, cache):
    """Every layer over h [B, S, D], from the states in ``cache`` (zeros
    from ``init_cache`` act as none: the reference starts a prefill from
    zero state and a zero shift), writing the new ones in place."""
    for l, lp in enumerate(model.layers):
        st = {m: {k: c[l] for k, c in cache[m].items()} for m in ("t", "c")}
        t, st_t = rwkv6.tmix_forward(cfg, lp.tmix,
                                     apply_norm(cfg, lp.ln_t, h), st["t"])
        h = h + t
        c, st_c = rwkv6.cmix_forward(cfg, lp.cmix,
                                     apply_norm(cfg, lp.ln_c, h), st["c"])
        h = h + c
        for m, new in (("t", st_t), ("c", st_c)):
            for k, v in new.items():
                cache[m][k][l] = v
    h = apply_norm(cfg, model.ln_f, h[:, -1])
    return logits_fn(cfg, model, h).to(torch.float32), cache


def prefill(cfg, model, batch, cache_len=None):
    """Run the prompt (the chunked form): (last-token logits [B, V] f32,
    the state). ``cache_len`` is not read: the state is fixed in
    size."""
    dev = _device(model)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    h = apply_norm(cfg, model.ln_0, embed_tokens(cfg, model, tokens))
    return _layers(cfg, model, h, init_cache(cfg, tokens.shape[0], 0, dev))


def decode_step(cfg, model, cache, token, pos):
    """One token (the recurrence; ``pos`` is not read): (logits [B, V]
    f32, the state, updated in place)."""
    dev = _device(model)
    tok = torch.as_tensor(token, device=dev)
    h = apply_norm(cfg, model.ln_0, embed_tokens(cfg, model, tok))
    return _layers(cfg, model, h, cache)
