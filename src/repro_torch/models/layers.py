"""Norms, MLPs, embeddings and the LM head (port of
``repro/models/layers.py``; ``chunked_xent`` waits for the training
port, ROADMAP.md A10c).

Norm parameters are f32 even in a bf16 model, and the norm runs in f32
and casts back, as the reference does. starcoder2's MLP is GELU in its
tanh form (``jax.nn.gelu(approximate=True)``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import embed_init, linear


# ----------------------------- norms --------------------------------------

class Norm(nn.Module):
    """``scale`` (and ``bias`` for layernorm), f32 [d]."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device))
        if cfg.norm == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                                 device=device))


def apply_norm(cfg, p: Norm, x):
    """LayerNorm (population variance, eps inside the rsqrt) or RMSNorm,
    in f32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p.scale + p.bias
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p.scale
    return y.to(x.dtype)


# ----------------------------- MLPs ---------------------------------------

class MLP(nn.Module):
    """swiglu / geglu: ``w_gate``, ``w_up``, ``w_down`` without bias;
    gelu (whisper, starcoder2): ``w_up`` and ``w_down`` whose biases are
    the reference's ``b_up`` and ``b_down``."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        gated = cfg.mlp in ("swiglu", "geglu")
        if gated:
            self.w_gate = linear(gen, d, f, False, dtype, device)
        self.w_up = linear(gen, d, f, not gated, dtype, device)
        self.w_down = linear(gen, f, d, not gated, dtype, device)


def apply_mlp(cfg, p: MLP, x):
    if cfg.mlp == "swiglu":
        return p.w_down(F.silu(p.w_gate(x)) * p.w_up(x))
    if cfg.mlp == "geglu":
        return p.w_down(F.gelu(p.w_gate(x), approximate="tanh") * p.w_up(x))
    return p.w_down(F.gelu(p.w_up(x), approximate="tanh"))


# ------------------------- embeddings / head -------------------------------

def init_embed(m: nn.Module, cfg, gen, dtype, device) -> None:
    """Give ``m`` the token embedding ``emb`` [V, D] and, untied, the
    head ``lm_head``: the reference's ``init_embed`` leaves."""
    m.emb = nn.Parameter(embed_init(gen, (cfg.vocab, cfg.d_model), dtype,
                                    device))
    if not cfg.tie_embeddings:
        m.lm_head = linear(gen, cfg.d_model, cfg.vocab, False, dtype, device)


def embed_tokens(cfg, p, tokens):
    return F.embedding(tokens, p.emb)


def head_matrix(cfg, p):
    """The LM head as [V, D] (``F.linear``'s layout): the embedding
    ``emb`` when tied, else ``lm_head``'s weight (the reference's [D, V]
    matrix transposed)."""
    return p.emb if cfg.tie_embeddings else p.lm_head.weight


def logits_fn(cfg, p, h):
    return F.linear(h, head_matrix(cfg, p))
