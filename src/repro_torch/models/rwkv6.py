"""RWKV6 "Finch" (arXiv:2404.05892; port of ``repro/models/rwkv6.py``):
an attention-free sequence mixer with a data-dependent decay a channel.

Per head (state S [hd, hd]):
    out_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
    w_t   = exp(-exp(w0 + lora_w(x_t)))          (data-dependent decay)

Prefill uses the reference's chunked parallel form (chunks of
``_CHUNK``, fewer where the length is not a multiple): the work inside
each chunk is batched over all chunks at once, and only the state's
carry from chunk to chunk is a loop (two element-wise operations a
chunk). Decode is the single-step recurrence. r, k, v, the decay and the
state are f32; the log decay is clamped to ``_CLAMP`` so a chunk's
cumulative product stays inside f32's range. The token shift mixes with
static mu for r, k, v, g and a low-rank data-dependent path for the
decay; the channel mix is relu^2, as the reference's."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init, linear

_CHUNK = 16
_LORA_R = 64
_CLAMP = 5.0   # |log decay| a step; 16 * 5 = 80 < f32's exp range (~87)


def _f32(gen, shape, device, **kw):
    return nn.Parameter(dense_init(gen, shape, torch.float32, device, **kw))


class TimeMix(nn.Module):
    """``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_o`` [D -> D] (``nn.Linear``s,
    no bias), ``w0`` [D], the decay's LoRA ``lw_a`` [D, 64] and ``lw_b``
    [64, D], ``u`` [H, hd], ``mu`` [5, D] and ``gn_scale`` [D], all f32
    but the projections: the reference's leaves."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d = cfg.d_model
        h, hd = cfg.n_heads, cfg.resolved_head_dim
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, linear(gen, d, d, False, dtype, device))
        f32 = lambda v: nn.Parameter(torch.full((d,), v, device=device))
        self.w0 = f32(-0.6)                       # base log-log decay
        self.lw_a = _f32(gen, (d, _LORA_R), device, fan_in=d)
        self.lw_b = _f32(gen, (_LORA_R, d), device, fan_in=_LORA_R,
                         scale=0.1)
        self.u = _f32(gen, (h, hd), device, fan_in=1, scale=0.1)
        self.mu = nn.Parameter(torch.full((5, d), 0.5, device=device))
        self.gn_scale = f32(1.0)


class ChannelMix(nn.Module):
    """``c_wk`` [D -> F], ``c_wv`` [F -> D], ``c_wr`` [D -> D] and
    ``c_mu`` [2, D] f32."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.c_wk = linear(gen, d, f, False, dtype, device)
        self.c_wv = linear(gen, f, d, False, dtype, device)
        self.c_wr = linear(gen, d, d, False, dtype, device)
        self.c_mu = nn.Parameter(torch.full((2, d), 0.5, device=device))


def _shift(x, prev=None):
    """Token shift: x_{t-1} (zeros, or the carried ``prev``, at t = 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xprev, mu):
    return x + (xprev - x) * mu.to(x.dtype)


def _log_decay(p: TimeMix, xw):
    """The log decay a channel, in [-_CLAMP, -1e-4]."""
    lw = p.w0 + torch.tanh(xw.to(torch.float32) @ p.lw_a) @ p.lw_b
    return -torch.clamp(torch.exp(lw), 1e-4, _CLAMP)


def _group_norm(p: TimeMix, o):
    """LayerNorm a head (RWKV's 'group_norm') on o [B, S, H, hd], with the
    population variance, then the scale: -> [B, S, D]."""
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, unbiased=False)
    o = (o - mu) * torch.rsqrt(var + 64e-5)
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) * p.gn_scale


def _chunked(r, k, v, logw, u, S0):
    """The chunked parallel form over r, k, v, logw [B, S, H, hd] f32 from
    state S0 [B, H, hd, hd]: (out [B, S, H, hd], the final state)."""
    B, S, H, hd = r.shape
    c = min(_CHUNK, S)
    while S % c:       # the shapes served are powers of two; tests aren't
        c -= 1
    n = S // c
    # [B, S, H, hd] -> [n, B, H, c, hd]
    ch = lambda t: t.reshape(B, n, c, H, hd).permute(1, 0, 3, 2, 4)
    rc, kc, vc, wc = ch(r), ch(k), ch(v), ch(logw)
    cum = torch.cumsum(wc, dim=3)                       # inclusive log P
    pex = cum - wc                                      # exclusive
    r_t = rc * torch.exp(pex)
    k_t = kc * torch.exp(-cum)
    causal = torch.tril(torch.ones((c, c), device=r.device), diagonal=-1)
    intra = torch.einsum("nbhtk,nbhsk->nbhts", r_t, k_t) * causal
    diag = torch.einsum("nbhtk,nbhtk->nbht", rc * u[None, None, :, None, :],
                        kc)
    pc = cum[:, :, :, -1]                               # [n, B, H, hd]
    kv = torch.einsum("nbhsk,nbhsv->nbhkv", k_t * torch.exp(pc)[:, :, :, None],
                      vc)
    decay = torch.exp(pc)[..., None]
    states = []                                         # each chunk's S_in
    st = S0
    for j in range(n):
        states.append(st)
        st = decay[j] * st + kv[j]
    out = torch.einsum("nbhts,nbhsv->nbhtv", intra, vc) \
        + diag[..., None] * vc \
        + torch.einsum("nbhtk,nbhkv->nbhtv", r_t, torch.stack(states))
    return out.permute(1, 0, 3, 2, 4).reshape(B, S, H, hd), st


def tmix_forward(cfg, p: TimeMix, x, state=None):
    """x: [B, S, D]; state: None or {"x_prev" [B, 1, D], "S" [B, H, hd,
    hd] f32}. Returns (y [B, S, D], the new state). S = 1 is the decode
    step; longer sequences take the chunked form."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    xprev = _shift(x, None if state is None else state["x_prev"])
    xr, xk, xv, xg, xw = (_mix(x, xprev, p.mu[i]) for i in range(5))
    heads = lambda t: t.reshape(B, S, H, hd).to(torch.float32)
    r, k, v = heads(p.w_r(xr)), heads(p.w_k(xk)), heads(p.w_v(xv))
    g = F.silu(p.w_g(xg))
    logw = _log_decay(p, xw).reshape(B, S, H, hd)
    S0 = x.new_zeros((B, H, hd, hd), dtype=torch.float32) if state is None \
        else state["S"]
    if S == 1:
        k0, v0 = k[:, 0][..., None], v[:, 0][:, :, None, :]
        o = torch.einsum("bhk,bhkv->bhv", r[:, 0],
                         S0 + p.u[None, :, :, None] * k0 * v0)[:, None]
        S1 = torch.exp(logw[:, 0])[..., None] * S0 + k0 * v0
    else:
        o, S1 = _chunked(r, k, v, logw, p.u, S0)
    o = _group_norm(p, o).to(x.dtype)
    return p.w_o(o * g), {"x_prev": x[:, -1:], "S": S1}


def cmix_forward(cfg, p: ChannelMix, x, state=None):
    """The channel mix: (y [B, S, D], {"x_prev" [B, 1, D]})."""
    xprev = _shift(x, None if state is None else state["x_prev"])
    xk, xr = _mix(x, xprev, p.c_mu[0]), _mix(x, xprev, p.c_mu[1])
    rgate = torch.sigmoid(p.c_wr(xr))
    h = torch.square(F.relu(p.c_wk(xk)))
    return rgate * p.c_wv(h), {"x_prev": x[:, -1:]}
