"""Norms, MLPs, embeddings, the LM head and the chunked cross-entropy
loss (port of ``repro/models/layers.py``).

Norm parameters are f32 even in a bf16 model, and the norm runs in f32
and casts back, as the reference does. starcoder2's MLP is GELU in its
tanh form (``jax.nn.gelu(approximate=True)``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


# ------------------------- chunked XENT loss --------------------------------

def _xent_chunk(W, hc, lc, mc):
    """One chunk's (sum of masked NLL, sum of mask): the [B, c, V] logits
    in f32 (the head's product in the model's dtype, then widened, as the
    reference's ``(hc @ W).astype(f32)``)."""
    lg = F.linear(hc, W).to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    tgt = lg.gather(-1, lc[..., None])[..., 0]
    return ((lse - tgt) * mc).sum(), mc.sum()


def chunked_xent(cfg, p, h, labels, mask=None, chunk=512):
    """h: [B, S, D]; labels: [B, S] integer; mask [B, S] f32 (None: all
    ones). Returns the mean NLL over the mask (the count floored at 1).

    The [B, S, V] logits are never whole: the sequence goes in chunks of
    ``chunk`` (the last ``S % chunk`` positions as one more), each under
    ``torch.utils.checkpoint``, so backward recomputes a chunk's logits
    instead of keeping them (the reference's ``jax.checkpoint``). The
    chunks' sums add in order, as the reference's scan."""
    B, S, D = h.shape
    W = head_matrix(cfg, p)
    labels = labels.to(torch.long)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    chunk = min(chunk, S)
    n = S // chunk
    spans = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if S > n * chunk:
        spans.append((n * chunk, S))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for a, b in spans:
        l, c = checkpoint(_xent_chunk, W, h[:, a:b], labels[:, a:b],
                          mask[:, a:b], use_reentrant=False,
                          preserve_rng_state=False)
        tot, cnt = tot + l, cnt + c
    return tot / cnt.clamp(min=1.0)
