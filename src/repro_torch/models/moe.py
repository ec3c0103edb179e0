"""Mixture-of-Experts FFN with top-k routing and capacity-based token
dispatch (port of ``repro/models/moe.py``).

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
  outputs are weighted 0, as the reference's.
- The combine is deterministic: each token's K contributions are
  un-permuted to [T, K, D] and summed over K in rank order, with no
  atomic scatter-add.

Two dispatches, chosen as the reference's ``apply_moe`` chooses: the
local one (``_apply_moe_local``), and the expert-parallel one
(``_apply_moe_sharded``, the reference's ``shard_map`` over the mesh's
"model" axis) whenever ``sharding.current_mesh()`` has a "model" axis
above 1 that divides ``n_experts``. There each "model" position of a
data row dispatches only its ``E_loc`` experts over all of the row's
tokens, with C from the row's T; the combine is a sum over "model" in
position order (the reference's ``psum``), and so is the count of
dropped assignments, divided by the row's T * K."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (Sharded, axis_size,
                                              current_mesh, current_row)
from repro_torch.launch import step_cost
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


def _route(cfg, router, xf):
    """(top_w [T, K] renormalised, top_e [T, K], aux): the router's gates
    over these T tokens, their top k (ties to the lower expert) and the
    Switch-style load-balancing loss."""
    E, K = cfg.moe.n_experts, cfg.moe.experts_per_tok
    T = xf.shape[0]
    dev = xf.device
    gates = torch.softmax(xf.to(torch.float32) @ router, dim=-1)  # [T, E]
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    me = gates.mean(0)
    # each expert's share of the top-k picks (the reference's one-hot
    # mean): integer counts, exact in any order
    ce = torch.zeros(E, device=dev).index_add_(
        0, top_e.reshape(-1), torch.ones(T * K, device=dev)) / T
    return top_w, top_e, E * (me * ce).sum()


def _dispatch(xf, top_w, top_e, eg, eu, ed, e_lo: int, C: int):
    """The experts ``e_lo`` .. ``e_lo + E_loc - 1`` (``eg``, ``eu``,
    ``ed``: [E_loc, ...]) over tokens xf [T, D] at C slots an expert:
    (y [T, D], the count of their assignments dropped). An assignment to
    another expert goes to the spare group E_loc, sorted last, and
    weighs 0, as the reference's "trash" expert."""
    T, D = xf.shape
    K = top_e.shape[1]
    E_loc = eg.shape[0]
    dev = xf.device
    local = top_e - e_lo
    mine = (local >= 0) & (local < E_loc)
    flat_e = torch.where(mine, local, E_loc).reshape(-1)
    flat_w = torch.where(mine, top_w, 0.0).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, sw = flat_e[order], flat_w[order]
    stok = torch.div(order, K, rounding_mode="floor")
    ar = torch.arange(T * K, device=dev)
    is_start = torch.ones(T * K, dtype=torch.bool, device=dev)
    is_start[1:] = se[1:] != se[:-1]
    group_start = torch.cummax(torch.where(is_start, ar, 0), 0).values
    rank = ar - group_start                          # position in its expert
    ours = se < E_loc
    keep = (rank < C) & ours
    n_dropped = ((rank >= C) & ours).sum()

    # the kept rows to their slots, the others to a spare row E_loc * C
    dest = torch.where(keep, se * C + rank, E_loc * C)
    buf = xf.new_zeros((E_loc * C + 1, D))
    buf.index_copy_(0, dest, xf[stok])
    buf = buf[:E_loc * C].reshape(E_loc, C, D)

    h = F.silu(torch.bmm(buf, eg)) * torch.bmm(buf, eu)
    out = torch.bmm(h, ed).reshape(E_loc * C, D)

    src = torch.where(ours, se * C + rank.clamp(max=C - 1), 0)
    contrib = out[src] * (sw * keep.to(torch.float32)).to(xf.dtype)[:, None]
    y = torch.empty_like(contrib)
    y[order] = contrib                      # back to [T * K] token-major
    return y.reshape(T, K, D).sum(1), n_dropped


def expert_parallel(cfg, mesh) -> bool:
    """Whether ``cfg``'s MoE dispatches expert-parallel on ``mesh``: a
    "model" axis above 1 that divides ``n_experts`` (the reference's
    choice, ``repro/models/moe.py:52-60``)."""
    m = axis_size(mesh, "model")
    return cfg.moe is not None and m > 1 and cfg.moe.n_experts % m == 0


def apply_moe(cfg, p: MoE, x, *, capacity_factor: float = 1.25):
    """x: [B, S, D] -> (y [B, S, D], {"aux_loss", "dropped_frac"} f32
    scalars): the expert-parallel dispatch under a mesh where
    ``expert_parallel``, else the local one."""
    mesh = current_mesh()
    if mesh is not None and expert_parallel(cfg, mesh):
        if current_row() is None:
            raise ValueError("apply_moe: the expert-parallel dispatch runs "
                             "a data row's tokens; set the row with "
                             "sharding.activation_rules(..., row=)")
        return _apply_moe_sharded(cfg, p, x, mesh, row=current_row(),
                                  capacity_factor=capacity_factor)
    return _apply_moe_local(cfg, p, x, capacity_factor=capacity_factor)


def _apply_moe_local(cfg, p: MoE, x, *, capacity_factor: float = 1.25):
    """The single-device dispatch over all of x's tokens."""
    B, S, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.experts_per_tok
    T = B * S
    xf = x.reshape(T, D)
    top_w, top_e, aux = _route(cfg, p.router, xf)
    C = capacity(T, K, E, capacity_factor)
    y, n_dropped = _dispatch(xf, top_w, top_e, p.e_gate, p.e_up, p.e_down,
                             0, C)
    dropped = n_dropped.to(torch.float32) / (T * K)
    return y.reshape(B, S, D), {"aux_loss": aux, "dropped_frac": dropped}


# ---------------------------------------------------------------------------
# explicit expert-parallel dispatch (the reference's shard_map over "model")
# ---------------------------------------------------------------------------

def _experts(w, dev, lo: int, hi: int, dim: int = 0):
    """Experts lo..hi-1 of ``w`` (along ``dim``) on ``dev``: from a
    ``Sharded`` leaf only the blocks that hold them, gathered (a "model"
    position's own block under the "tp" rules); from a tensor, its
    slice moved."""
    if isinstance(w, Sharded):
        return w.gather(dev, {dim: (lo, hi)})
    return w.narrow(dim, lo, hi - lo).to(dev)


def _apply_moe_sharded(cfg, p: MoE, x, mesh, *, row: int,
                       capacity_factor: float = 1.25):
    """The reference's ``_apply_moe_sharded`` on ``mesh`` for one data
    row: x [B, S, D] is the tokens of grid row ``row`` (on its first
    device; the mesh steps give each data row's tokens their own call,
    where the reference's ``shard_map`` cuts the batch by its
    ``bspec``). Each "model" position m (grid device (row, m))
    dispatches its experts [m E_loc, (m + 1) E_loc) over all of the
    row's tokens at C from the row's T; y is the sum of the positions'
    outputs in position order, on x's device. Metrics: the row's aux
    loss and its dropped assignments summed over "model" over T * K."""
    B, S, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.experts_per_tok
    grid = mesh.grid()
    M = grid.shape[1]
    E_loc = E // M
    T = B * S
    xf = x.reshape(T, D)
    C = capacity(T, K, E, capacity_factor)
    y, n_dropped, aux = None, None, None
    for m in range(M):
        dev = grid[row, m]
        lo, hi = m * E_loc, (m + 1) * E_loc
        with step_cost.at(row * M + m):
            if m:
                step_cost.moved("all-gather", xf.numel() * xf.element_size())
            xm = xf.to(dev)
            router = _experts(p.router, dev, 0, E, dim=1)
            top_w, top_e, a = _route(cfg, router, xm)
            ym, nd = _dispatch(xm, top_w, top_e,
                               _experts(p.e_gate, dev, lo, hi),
                               _experts(p.e_up, dev, lo, hi),
                               _experts(p.e_down, dev, lo, hi), lo, C)
            if m:
                step_cost.moved("all-reduce", ym.numel() * ym.element_size())
        ym, nd = ym.to(x.device), nd.to(x.device)
        y = ym if y is None else y + ym
        n_dropped = nd if n_dropped is None else n_dropped + nd
        aux = a.to(x.device) if aux is None else aux
    return y.reshape(B, S, D), {
        "aux_loss": aux, "dropped_frac": n_dropped.to(torch.float32) / (T * K)}
