"""Sharding rules and the placement of sharded trees (port of
``repro/distributed/sharding.py``): parameter partition specs (FSDP over
``data`` x tensor parallel over ``model``), the batch, activation and
KV-cache layouts, and ``Sharded``, one global tensor stored as blocks on
a ``core.distributed.Mesh``.

Mesh axes (as the reference's):
  pod    -- pure data parallel across pods (multi-pod mesh only)
  data   -- within-pod FSDP / batch axis
  model  -- tensor / expert parallel axis

The rules are the reference's, entry for entry: the table is keyed by
the reference's leaf names (``wq``, ``e_up``, ``emb`` ...), a stacked
layer axis gets a leading None, the "fsdp" profile shards one dim over
("data", "model") jointly, and a dim the axis product does not divide
is replicated. A port parameter is not a reference leaf: a
``nn.Linear`` weight is the transpose of the reference's [in, out]
matrix and the reference stacks its layers [L, ...]. ``param_specs``
therefore maps each port parameter through the one layout map,
``models._reference_path``: the reference's spec of that leaf, the
stack axis dropped, reversed for a transposed matrix.

Why not DTensor or ``torch.distributed``: a mesh here is a grid of
``torch.device``s in ONE process, and a device may repeat (the whole
(2, 4) mesh on one card, or on "cpu"); NCCL cannot put two ranks on one
GPU. So the port runs single-process SPMD over the grid's positions.
Stored state follows the reference's layouts exactly (``Sharded``: one
block a position, each (block, device) pair stored once), and what
GSPMD does implicitly is done at use: a computing position gathers a
layer's weights onto its device (``Sharded.gather``, a ``torch.cat`` of
the blocks moved there) and runs the family's own forward on its rows;
autograd carries the gradient back into each block. Left out: real
tensor-parallel compute (column and row splits with a sum over
"model") and a flash-decoding merge over a sequence-sharded cache (the
cache's blocks are gathered for each decode step); ROADMAP.md B.

In eager mode ``constrain`` is the identity: the layouts are those of
the stored blocks and of each computing position's rows, not of
traced intermediates."""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


class P(tuple):
    """A partition spec (the reference's ``PartitionSpec``): one entry a
    dim, None (replicated), an axis name, or a tuple of axis names
    sharded jointly (row-major); a tuple of one name is that name, as
    jax normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: P


# --------------------------------------------------------------------------
# activation-constraint context (models call constrain(x, name))
# --------------------------------------------------------------------------

_ACT_RULES: contextvars.ContextVar[Optional[Dict[str, Any]]] = \
    contextvars.ContextVar("act_rules", default=None)
_MESH_CTX: contextvars.ContextVar[Optional[Any]] = \
    contextvars.ContextVar("mesh_ctx", default=None)
_ROW_CTX: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("row_ctx", default=None)


@contextlib.contextmanager
def activation_rules(rules: Dict[str, Any], mesh=None, row=None):
    """Make ``rules`` and ``mesh`` visible to model code (``constrain``,
    ``current_mesh``). ``row``: the grid row (``Mesh.grid``) whose
    tokens the model is running, set by the mesh steps; None when the
    inputs are the global batch."""
    toks = (_ACT_RULES.set(rules), _MESH_CTX.set(mesh), _ROW_CTX.set(row))
    try:
        yield
    finally:
        for var, tok in zip((_ACT_RULES, _MESH_CTX, _ROW_CTX), toks):
            var.reset(tok)


def current_mesh():
    """The mesh made visible to model code (for the explicit
    expert-parallel region of the MoE dispatch), or None."""
    return _MESH_CTX.get()


def current_row() -> Optional[int]:
    """The grid row whose tokens the model is running, or None."""
    return _ROW_CTX.get()


def constrain(x, name: str):
    """The identity: the port runs eagerly, and an eager tensor has no
    layout to constrain (the reference's ``with_sharding_constraint``
    only steers GSPMD's choice for a traced value)."""
    return x


# --------------------------------------------------------------------------
# mesh helpers
# --------------------------------------------------------------------------

def batch_axes(mesh, cfg=None) -> Tuple[str, ...]:
    ax = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    if cfg is not None and getattr(cfg, "shard_profile", "tp") == "fsdp":
        ax = ax + ("model",)    # pure data parallelism across the full mesh
    return ax


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def axes_size(mesh, axes) -> int:
    """The product of the sizes of ``axes`` on ``mesh`` (1 for none)."""
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------

def _param_rule_table(cfg, model_size: int) -> Dict[str, P]:
    kv_tp = (cfg.kv_heads % model_size == 0) if cfg.n_heads else False
    kv_m = "model" if kv_tp else None
    moe_ep = cfg.moe is not None and cfg.moe.n_experts % model_size == 0
    heads_tp = cfg.n_heads % model_size == 0 if cfg.n_heads else False
    h_m = "model" if heads_tp else None
    return {
        # embeddings / head
        "emb": P("model", None),
        "lm_head": P(None, "model"),
        "vis_proj": P(None, "model"),
        # norms
        "scale": P(None), "bias": P(None),
        # attention
        "wq": P("data", "model"),
        "wk": P("data", kv_m), "wv": P("data", kv_m),
        "wo": P("model", "data"),
        "bq": P("model"), "bk": P(kv_m), "bv": P(kv_m),
        # dense mlp
        "w_gate": P("data", "model"), "w_up": P("data", "model"),
        "w_down": P("model", "data"),
        "b_up": P("model"), "b_down": P(None),
        # moe
        "router": P(None, None),
        "e_gate": P("model", "data", None) if moe_ep else P(None, "data", "model"),
        "e_up": P("model", "data", None) if moe_ep else P(None, "data", "model"),
        "e_down": P("model", None, "data") if moe_ep else P(None, "model", "data"),
        # rg-lru
        "rg_in_gate": P("data", "model"), "rg_in_x": P("data", "model"),
        "rg_conv": P(None, "model"),
        "rg_wa": P(h_m, None, None), "rg_wx": P(h_m, None, None),
        "rg_lam": P("model"),
        "rg_out": P("model", "data"),
        # rwkv6
        "w_r": P("data", "model"), "w_k": P("data", "model"),
        "w_v": P("data", "model"), "w_g": P("data", "model"),
        "w_o": P("model", "data"),
        "w0": P("model"), "lw_a": P("data", None), "lw_b": P(None, "model"),
        "u": P(h_m, None), "mu": P(None, None), "gn_scale": P(None),
        "c_wk": P("data", "model"), "c_wv": P("model", "data"),
        "c_wr": P("data", "model"), "c_mu": P(None, None),
        # retrieval attention (pHNSW): PCA-projection matrix, replicated
        "rp_proj": P(None, None),
        # whisper positional tables
        "pos_enc": P(None, None), "pos_dec": P(None, None),
    }


def reference_spec(cfg, mesh, name: str, shape) -> P:
    """The reference's ``param_specs`` rule for its leaf ``name`` of
    ``shape`` (the reference's layout, stack axes included)."""
    model_size = axis_size(mesh, "model")
    data_size = axis_size(mesh, "data")
    table = _param_rule_table(cfg, model_size)
    profile = getattr(cfg, "shard_profile", "tp")
    sizes = {"data": data_size, "model": model_size}

    def axis_prod(ax):
        if ax is None:
            return 1
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = 1
        for a in axes:
            n *= sizes.get(a, 1)
        return n

    if name not in table:
        raise KeyError(f"no sharding rule for param leaf {name}")
    spec = table[name]
    ndim, base = len(shape), len(spec)
    lead = ndim - base                  # stacked layer/group axes
    if lead < 0 or lead > 2:
        raise ValueError(f"rank mismatch for {name}: {ndim} vs {base}")
    if profile == "fsdp":
        body = shape[lead:]
        cand = [i for i, ax in enumerate(spec) if ax == "data"]
        if not cand:
            cand = [int(max(range(len(body)), key=lambda i: body[i]))]
        newspec = [None] * base
        i = cand[0]
        if body[i] % (data_size * model_size) == 0:
            newspec[i] = ("data", "model")
        elif body[i] % data_size == 0:
            newspec[i] = "data"
        spec = P(*newspec)
    spec = P(*((None,) * lead + tuple(spec)))
    return P(*(ax if ax is None or dim % axis_prod(ax) == 0 else None
               for dim, ax in zip(shape, spec)))


def _skeleton(cfg, abstract_params):
    if isinstance(abstract_params, nn.Module):
        return abstract_params
    from repro_torch.models import get_model
    return get_model(cfg).init(None, "meta")


def param_specs(cfg, abstract_params, mesh) -> Dict[str, P]:
    """{port parameter name: P} for ``abstract_params`` (the module, on
    the meta device or not, or ``ModelApi.abstract_params()``'s dict).
    Each is the reference's spec of the parameter's leaf
    (``reference_spec``, profiles "tp" and "fsdp"), mapped through
    ``models._reference_path``: the stack axis dropped, the entries
    reversed for a matrix the port stores transposed."""
    from repro_torch.models import _reference_path
    skeleton = _skeleton(cfg, abstract_params)
    out = {}
    for name, p in skeleton.named_parameters():
        path, index, transpose = _reference_path(skeleton, name)
        shape = tuple(p.shape[::-1]) if transpose else tuple(p.shape)
        if index is not None:
            shape = (len(getattr(skeleton, path[0])),) + shape
        spec = tuple(reference_spec(cfg, mesh, path[-1], shape))
        if index is not None:
            spec = spec[1:]
        out[name] = P(*(spec[::-1] if transpose else spec))
    return out


def param_shardings(cfg, abstract_params, mesh) -> Dict[str, NamedSharding]:
    return {n: NamedSharding(mesh, s)
            for n, s in param_specs(cfg, abstract_params, mesh).items()}


# --------------------------------------------------------------------------
# activations / batch / cache
# --------------------------------------------------------------------------

def act_rules(cfg, mesh, global_batch: int) -> Dict[str, NamedSharding]:
    b_ax = batch_axes(mesh, cfg)
    b_size = axes_size(mesh, b_ax)
    while len(b_ax) > 1 and (global_batch % b_size or global_batch < b_size):
        b_size //= axis_size(mesh, b_ax[-1])
        b_ax = b_ax[:-1]
    if global_batch % b_size == 0 and global_batch >= b_size:
        spec = P(b_ax, None, None)
    elif global_batch == 1:
        # batch=1 (long_500k): shard the sequence axis over data instead
        spec = P(None, b_ax, None)
    else:
        spec = P(b_ax[:1], None, None)
    return {"act_btd": NamedSharding(mesh, spec)}


def batch_spec(cfg, mesh, global_batch: int, kind: str):
    """The batch axes a batch of ``global_batch`` rows shards over (the
    reference's ``bspec``: the batch axes, the last ones dropped while
    they do not divide the batch), or None (replicated)."""
    b_ax = batch_axes(mesh, cfg if kind == "train" else None)
    b_size = axes_size(mesh, b_ax)
    while len(b_ax) > 1 and global_batch % b_size:
        b_size //= axis_size(mesh, b_ax[-1])
        b_ax = b_ax[:-1]
    return b_ax if global_batch % b_size == 0 else None


def batch_sharding(cfg, mesh, shape, kind: str) -> Dict[str, NamedSharding]:
    """Shardings for the input batch dict, keyed like it."""
    bspec = batch_spec(cfg, mesh, shape.global_batch, kind)
    ns = lambda *spec: NamedSharding(mesh, P(*spec))
    if kind == "train":
        out = {"tokens": ns(bspec, None), "labels": ns(bspec, None)}
    elif kind == "prefill":
        out = {"tokens": ns(bspec, None)}
    else:  # decode
        out = {"token": ns(bspec, None), "pos": NamedSharding(mesh, P())}
    if cfg.vis_tokens:
        out["patches"] = ns(bspec, None, None)
    if cfg.enc_layers:
        out["frames"] = ns(bspec, None, None)
    return out


def cache_spec(cfg, mesh, batch: int, seq_len: int) -> P:
    """The reference's spec for KV caches [L, B, T, KV, Hd], flash-
    decoding style: the sequence axis over ``model`` (and the batch axes
    too when the batch cannot use them). The port's caches are [L, B,
    KV, T, Hd]: ``steps.cache_shardings`` swaps the two entries."""
    b_ax = batch_axes(mesh)
    if batch % axes_size(mesh, b_ax) == 0:
        return P(None, b_ax, "model", None, None)
    return P(None, None, tuple((*b_ax, "model")), None, None)


def state_spec(cfg, mesh, batch: int):
    """The batch entry of a recurrent state's spec (rwkv, hybrid)."""
    b_ax = batch_axes(mesh)
    return b_ax if batch % axes_size(mesh, b_ax) == 0 else None


# --------------------------------------------------------------------------
# placement: a global tensor as blocks on the mesh
# --------------------------------------------------------------------------

def spec_axes(entry) -> Tuple[str, ...]:
    """A spec entry's axis names, as a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _positions(mesh):
    """Every grid position in row-major order, as (coords {axis: i},
    device)."""
    for pos in np.ndindex(*mesh.devices.shape):
        yield dict(zip(mesh.axis_names, pos)), mesh.devices[pos]


class Sharded:
    """A global tensor of ``shape`` laid out on ``sharding.mesh`` by
    ``sharding.spec`` (port layout): the mesh position with coordinates
    c holds the block whose index along dim d is the row-major index of
    c over the axes of entry d. Each (block index, device) pair is
    stored once, in position order (``blocks``): on a mesh that repeats
    one device, a replicated dim costs one copy, not one a position."""

    def __init__(self, sharding: NamedSharding, shape, dtype,
                 blocks: Dict[tuple, torch.Tensor]):
        self.sharding = sharding
        self.shape = tuple(int(n) for n in shape)
        self.dtype = dtype
        self.blocks = blocks
        spec = tuple(sharding.spec) + (None,) * (len(self.shape)
                                                  - len(sharding.spec))
        if len(spec) != len(self.shape):
            raise ValueError(f"spec {sharding.spec} has more entries than "
                             f"the shape {self.shape} has dims")
        self.spec = spec
        mesh = sharding.mesh
        self.parts = tuple(axes_size(mesh, spec_axes(e)) for e in spec)
        for n, k in zip(self.shape, self.parts):
            if n % k:
                raise ValueError(f"spec {sharding.spec} does not divide "
                                 f"the shape {self.shape}")

    # ---- layout ----
    @staticmethod
    def _index(spec, mesh, coords) -> tuple:
        idx = []
        for e in spec:
            i = 0
            for a in spec_axes(e):
                i = i * axis_size(mesh, a) + coords.get(a, 0)
            idx.append(i)
        return tuple(idx)

    def keys(self):
        """(block index, device) of every position, in position order."""
        mesh = self.sharding.mesh
        return [(self._index(self.spec, mesh, c), d)
                for c, d in _positions(mesh)]

    def block_range(self, idx) -> list:
        return [(i * n // k, (i + 1) * n // k)
                for i, n, k in zip(idx, self.shape, self.parts)]

    @property
    def device(self) -> torch.device:
        """The device of the mesh's first position."""
        return self.sharding.mesh.devices.flat[0]

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.blocks.values())

    # ---- construction ----
    @classmethod
    def place(cls, t: torch.Tensor, sharding: NamedSharding
              ) -> "Sharded":
        """``t`` (global, any device) cut into its blocks, each copied
        into memory of its own on its device (no autograd history)."""
        t = t.detach()
        out = cls(sharding, t.shape, t.dtype, {})
        for key in out.keys():
            if key not in out.blocks:
                sl = tuple(slice(lo, hi) for lo, hi in out.block_range(key[0]))
                blk = torch.empty(t[sl].shape, dtype=t.dtype, device=key[1])
                out.blocks[key] = blk.copy_(t[sl])
        return out

    @classmethod
    def zeros(cls, sharding: NamedSharding, shape, dtype) -> "Sharded":
        out = cls(sharding, shape, dtype, {})
        for key in out.keys():
            if key not in out.blocks:
                shp = [hi - lo for lo, hi in out.block_range(key[0])]
                out.blocks[key] = torch.zeros(shp, dtype=dtype, device=key[1])
        return out

    def like(self, fn) -> "Sharded":
        """A leaf of the same layout whose blocks are ``fn(block)``."""
        return Sharded(self.sharding, self.shape, self.dtype,
                       {k: fn(b) for k, b in self.blocks.items()})

    # ---- use ----
    def _pieces(self, device, ranges):
        """{block index: the block's part inside ``ranges``} from one copy
        of each block index (the one on ``device`` when there is one)."""
        chosen = {}
        for (idx, dev), blk in self.blocks.items():
            if idx not in chosen or dev == device:
                chosen[idx] = blk
        pieces = {}
        for idx, blk in chosen.items():
            sl, empty = [], False
            for d, (lo, hi) in enumerate(self.block_range(idx)):
                a, b = ranges.get(d, (lo, hi))
                a, b = max(a, lo), min(b, hi)
                empty |= a >= b
                sl.append(slice(a - lo, b - lo))
            if not empty:
                pieces[idx] = blk[tuple(sl)]
        return pieces

    def gather(self, device=None, ranges: Optional[Dict[int, tuple]] = None
               ) -> torch.Tensor:
        """The global tensor, or its part inside ``ranges`` ({dim: (lo,
        hi)}), on ``device`` (default: the mesh's first): the blocks it
        covers moved there and concatenated (``torch.cat``, so autograd
        carries a gradient back into each block). A single block already
        on ``device`` is returned as it is."""
        device = self.device if device is None else torch.device(device)
        pieces = {i: p.to(device) for i, p in
                  self._pieces(device, ranges or {}).items()}
        nd = len(self.shape)

        def cat(prefix, d):
            if d == nd:
                return pieces[prefix]
            ks = sorted({k[d] for k in pieces if k[:d] == prefix})
            parts = [cat(prefix + (i,), d + 1) for i in ks]
            return parts[0] if len(parts) == 1 else torch.cat(parts, d)
        return cat((), 0)

    @torch.no_grad()
    def write(self, value: torch.Tensor,
              ranges: Optional[Dict[int, tuple]] = None) -> None:
        """Copy ``value``, the global tensor's part inside ``ranges``
        ({dim: (lo, hi)}; every other dim whole), into every stored
        block it covers, in place."""
        ranges = ranges or {}
        for (idx, _), blk in self.blocks.items():
            sb, sv, empty = [], [], False
            for d, (lo, hi) in enumerate(self.block_range(idx)):
                a, b = ranges.get(d, (0, self.shape[d]))
                c, e = max(a, lo), min(b, hi)
                empty |= c >= e
                sb.append(slice(c - lo, e - lo))
                sv.append(slice(c - a, e - a))
            if not empty:
                blk[tuple(sb)].copy_(value[tuple(sv)])

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, blocks={len(self.blocks)})")


def shard_tree(tree, shardings):
    """Place every tensor leaf of ``tree`` (nested dicts) by the
    ``NamedSharding`` at the same key of ``shardings``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    return Sharded.place(torch.as_tensor(tree), shardings)


def gather_tree(tree, device=None):
    """``shard_tree``'s inverse: every ``Sharded`` leaf as its global
    tensor on ``device`` (default: each leaf's mesh's first device); a
    tensor leaf moved to ``device`` when given."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.gather(device)
    return tree.to(device) if device is not None else tree


def tree_nbytes(tree) -> int:
    """The bytes every ``Sharded`` leaf of ``tree`` stores."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.nbytes if isinstance(tree, Sharded) else 0


@contextlib.contextmanager
def bound(module: nn.Module, tensors: Dict[str, Any]):
    """``module`` with each parameter or buffer named in ``tensors``
    replaced by the given value for the duration (a gathered tensor, or
    a ``Sharded`` leaf left sharded for code that reads it as such: the
    MoE's experts), restored after. The family's own forward then runs
    on the given values; backward may run inside too (remat recomputes
    the forward there)."""
    saved = []
    try:
        for name, t in tensors.items():
            mod, _, leaf = name.rpartition(".")
            owner = module.get_submodule(mod) if mod else module
            table = owner._parameters if leaf in owner._parameters \
                else owner._buffers
            saved.append((table, leaf, table[leaf]))
            table[leaf] = t
        yield module
    finally:
        for table, leaf, old in reversed(saved):
            table[leaf] = old
