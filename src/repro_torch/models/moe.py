"""Mixture-of-Experts FFN with top-k routing and capacity-based token
dispatch (port of ``repro/models/moe.py``'s local path).

Assignments are sorted by expert, ranked within their expert, and the
first C of each expert are copied into a dense [E, C, D] buffer; tokens
past capacity are dropped (GShard / Switch) and counted in
``dropped_frac``. The experts run as batched GEMMs over that buffer, as
the reference's einsums do (no Pallas kernel there either).

Traps of the translation, each kept bit for bit where the reference's
result depends on it:

- ``lax.top_k`` gives ties to the lower expert: the port takes the top
  k of a stable descending sort, not ``torch.topk``.
- The expert sort is stable, so the tokens of an expert keep their
  order and the same ones drop.
- C is Python's ``round`` (half to even) of the same float expression.
- The reference scatters with ``mode="drop"``; the port writes the kept
  rows and sends the dropped ones to a spare row of the buffer; their
  outputs are read at slot C - 1 and weighted 0, as the reference's.
- The combine is deterministic: each token's K contributions are
  un-permuted to [T, K, D] and summed over K in rank order, with no
  atomic scatter-add.

The reference's expert-parallel path (``_apply_moe_sharded``, a
``shard_map`` over the mesh's "model" axis) waits for the mesh port
(ROADMAP.md A10d): ``apply_moe`` here is the local path only."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init


class MoE(nn.Module):
    """``router`` [D, E] f32 and the experts ``e_gate``, ``e_up`` [E, D,
    F] and ``e_down`` [E, F, D] in the model's dtype: the reference's
    leaves, in its layout (batched ``x @ W``; not transposed)."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
        par = lambda shape, fan_in, dt: nn.Parameter(
            dense_init(gen, shape, dt, device, fan_in=fan_in))
        self.router = par((d, E), d, torch.float32)
        self.e_gate = par((E, d, f), d, dtype)
        self.e_up = par((E, d, f), d, dtype)
        self.e_down = par((E, f, d), f, dtype)


def capacity(T: int, K: int, E: int, capacity_factor: float) -> int:
    """Slots an expert: ``round(T * K / E * capacity_factor)`` (Python's
    round, half to even), at least K and at most T."""
    return min(int(max(K, round(T * K / E * capacity_factor))), T)


def apply_moe(cfg, p: MoE, x, *, capacity_factor: float = 1.25):
    """x: [B, S, D] -> (y [B, S, D], {"aux_loss", "dropped_frac"} f32
    scalars). The local dispatch of the reference's
    ``_apply_moe_local``."""
    B, S, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.experts_per_tok
    T = B * S
    dev = x.device
    xf = x.reshape(T, D)

    gates = torch.softmax(xf.to(torch.float32) @ p.router, dim=-1)  # [T, E]
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)

    # ---- load-balancing aux loss (Switch-style) ----
    me = gates.mean(0)
    # each expert's share of the top-k picks (the reference's one-hot
    # mean): integer counts, exact in any order
    ce = torch.zeros(E, device=dev).index_add_(
        0, top_e.reshape(-1), torch.ones(T * K, device=dev)) / T
    aux = E * (me * ce).sum()

    # ---- sort-based capacity dispatch ----
    C = capacity(T, K, E, capacity_factor)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, sw = flat_e[order], top_w.reshape(-1)[order]
    stok = torch.div(order, K, rounding_mode="floor")
    ar = torch.arange(T * K, device=dev)
    is_start = torch.ones(T * K, dtype=torch.bool, device=dev)
    is_start[1:] = se[1:] != se[:-1]
    group_start = torch.cummax(torch.where(is_start, ar, 0), 0).values
    rank = ar - group_start                          # position in its expert
    keep = rank < C
    dropped = (1.0 - keep.to(torch.float32)).sum() / (T * K)

    # the kept rows to their slots, the dropped ones to a spare row E * C
    dest = torch.where(keep, se * C + rank, E * C)
    buf = x.new_zeros((E * C + 1, D))
    buf.index_copy_(0, dest, xf[stok])
    buf = buf[:E * C].reshape(E, C, D)

    h = F.silu(torch.bmm(buf, p.e_gate)) * torch.bmm(buf, p.e_up)
    out = torch.bmm(h, p.e_down).reshape(E * C, D)

    contrib = out[se * C + rank.clamp(max=C - 1)]
    contrib = contrib * (sw * keep.to(torch.float32)).to(x.dtype)[:, None]
    y = torch.empty_like(contrib)
    y[order] = contrib                      # back to [T * K] token-major
    y = y.reshape(T, K, D).sum(1)
    return y.reshape(B, S, D), {"aux_loss": aux, "dropped_frac": dropped}
