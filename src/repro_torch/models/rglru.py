"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427; port of
``repro/models/rglru.py``).

    r_t = sigmoid(W_a x_t)           recurrence gate  (block-diag per head)
    i_t = sigmoid(W_x x_t)           input gate       (block-diag per head)
    a_t = exp(-c * softplus(L) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The Griffin layout: a GELU gate branch times a conv1d -> RG-LRU branch,
projected out. Over a sequence the recurrence is a log-depth scan in
torch (``linear_scan``: ceil(log2 S) doubling steps over the (a, b)
pairs, where the reference calls ``lax.associative_scan``); decode is
the single step. The activations are the reference's: GELU in its tanh
form, softplus as ``logaddexp(x, 0)`` (``F.softplus`` switches to x past
its threshold)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init, linear

_C = 8.0
_CONV_W = 4


class RGLRU(nn.Module):
    """``rg_in_gate``, ``rg_in_x`` [D -> W] and ``rg_out`` [W -> D]
    (``nn.Linear``s, no bias), ``rg_conv`` [4, W], the block-diagonal
    gates ``rg_wa``, ``rg_wx`` [H, W/H, W/H] f32 and ``rg_lam`` [W] f32:
    the reference's leaves."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        h = cfg.n_heads
        wh = w // h
        self.rg_in_gate = linear(gen, d, w, False, dtype, device)
        self.rg_in_x = linear(gen, d, w, False, dtype, device)
        self.rg_conv = nn.Parameter(dense_init(gen, (_CONV_W, w), dtype,
                                               device, fan_in=_CONV_W,
                                               scale=0.5))
        self.rg_wa = nn.Parameter(dense_init(gen, (h, wh, wh), torch.float32,
                                             device, fan_in=wh))
        self.rg_wx = nn.Parameter(dense_init(gen, (h, wh, wh), torch.float32,
                                             device, fan_in=wh))
        # lambda so that a ~ 0.9..0.999 at r = 0.5
        self.rg_lam = nn.Parameter(torch.linspace(0.5, 4.0, w,
                                                  device=device))
        self.rg_out = linear(gen, w, d, False, dtype, device)


def _gates(p: RGLRU, u, h: int, wh: int):
    """u: [B, S, W] f32 -> (recurrence gate, input gate) through the
    block-diagonal projections."""
    B, S, W = u.shape
    uh = u.reshape(B, S, h, wh)
    ra = torch.einsum("bshw,hwv->bshv", uh, p.rg_wa).reshape(B, S, W)
    rx = torch.einsum("bshw,hwv->bshv", uh, p.rg_wx).reshape(B, S, W)
    return torch.sigmoid(ra), torch.sigmoid(rx)


def _log_a(p: RGLRU, r):
    """log a = -c * softplus(lambda) * r, <= 0."""
    sp = torch.logaddexp(p.rg_lam, torch.zeros((), device=p.rg_lam.device))
    return -_C * sp * r


def _causal_conv(p: RGLRU, u, state=None):
    """Depthwise causal conv of width 4 over u [B, S, W]; ``state`` [B, 3,
    W] is the tail of the inputs before (zeros when None). Returns (out,
    the new tail)."""
    B, S, W = u.shape
    pad = u.new_zeros((B, _CONV_W - 1, W)) if state is None \
        else state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    out = sum(up[:, i:i + S] * p.rg_conv[i] for i in range(_CONV_W))
    return out, up[:, -(_CONV_W - 1):]


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 along axis 1, for every
    t: the inclusive prefix of the (a, b) pairs under (a1, b1) . (a2, b2)
    = (a1 a2, a2 b1 + b2), in ceil(log2 S) doubling steps (Hillis-Steele:
    each step combines every element with the one d before it)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _branches(cfg, p: RGLRU, x, conv_state=None):
    """The gate branch and the recurrence's (a, b) and conv tail for x
    [B, S, D]."""
    h_heads = cfg.n_heads
    w = cfg.lru_width or cfg.d_model
    gate = F.gelu(p.rg_in_gate(x), approximate="tanh")
    u, tail = _causal_conv(p, p.rg_in_x(x), conv_state)
    uf = u.to(torch.float32)
    r, i = _gates(p, uf, h_heads, w // h_heads)
    log_a = _log_a(p, r)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return gate, a, b, tail


def rglru_scan(cfg, p: RGLRU, x):
    """Full sequence, x: [B, S, D] -> (y [B, S, D], the final state
    {"h" [B, W] f32, "conv" [B, 3, W]}): the reference's ``apply_rglru``
    and ``hybrid._final_state`` from one scan (they run the same scan
    twice)."""
    gate, a, b, tail = _branches(cfg, p, x)
    hseq = linear_scan(a, b)
    y = p.rg_out(hseq.to(x.dtype) * gate)
    return y, {"h": hseq[:, -1], "conv": tail}


def apply_rglru(cfg, p: RGLRU, x):
    """Full sequence (prefill). x: [B, S, D] -> [B, S, D]."""
    return rglru_scan(cfg, p, x)[0]


def init_rglru_state(cfg, batch: int, dtype, device=None) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, w), dtype=dtype,
                                device=device)}


def decode_rglru(cfg, p: RGLRU, x, state: dict):
    """x: [B, 1, D]; state from ``init_rglru_state``. Returns (y [B, 1,
    D], the new state)."""
    gate, a, b, tail = _branches(cfg, p, x, state["conv"])
    h_new = a[:, 0] * state["h"] + b[:, 0]
    y = p.rg_out(h_new[:, None].to(x.dtype) * gate)
    return y, {"h": h_new, "conv": tail}
