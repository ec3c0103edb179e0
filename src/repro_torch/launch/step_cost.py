"""Per-position step costs (port of ``repro/launch/hlo_cost.py``).

The reference walks the compiled per-device HLO of a step: dot FLOPs and
dot operand/result bytes, collective operand bytes in five categories,
while-loop bodies multiplied by their trip count. The port has no HLO:
its steps run eagerly, one process over the grid's positions
(``distributed/sharding.py``). So the counter here runs the step itself,
on the "meta" device (nothing is allocated, no kernel runs) or on real
tensors, under a ``TorchDispatchMode`` (``StepCounter``), and attributes
every figure to the computing position that runs it, a grid index of
``Mesh.grid`` (row-major, "model" fastest), set by the step builders
around each computing unit (``at``):

- ``flops``: ``torch.utils.flop_counter``'s formulas for ``mm``,
  ``addmm``, ``bmm`` and ``baddbmm`` (the reference's dots), and those of
  the two attention operators ``repro_torch::flash_attention`` (B8) and
  ``repro_torch::decode_attention`` (B9), which count what their plain
  versions' matmuls count. A Python loop is run, not walked, so every
  trip counts (the reference's trip-count multiplication). A matrix
  product over a contraction of size 1 is an outer product, which XLA
  emits as a multiply and the reference's walker does not count, so
  neither does this counter (rwkv6's per-token bonus,
  ``models/rwkv6.py: _chunked``'s ``diag``, is a dot, and its backward
  two such products).
- ``dot_bytes``: the operand and result bytes of those ops (for
  ``addmm`` / ``baddbmm`` the two matrix operands, as the reference's
  dot leaves the bias add to another op; for B8 / B9 q, k, v and the
  output, where the reference's jnp oracle counts its two dots' scores).
- ``bytes_accessed``: the operand and result bytes of every op that is
  not a view (the reference's ``cost_analysis()["bytes accessed"]``).
- ``collective``: the bytes a step moves from one position to another,
  counted where the port moves them, by the category of the reference's
  program for the same movement:

  ===================================================  ==================
  the port                                             the reference
  ===================================================  ==================
  ``Sharded.gather``: weights, cache rows, batch rows  all-gather (GSPMD's
  onto a computing position (the blocks it does not    gather of an FSDP /
  hold)                                                TP-sharded operand)
  the gradient of each gathered remote block flowing   reduce-scatter
  back to its holder (the backward of that gather)
  the f32 sums of a replicated block's gradient        all-reduce
  copies (``launch/steps.py``, the mesh train step)
  ``Sharded.write`` of a unit's rows into the blocks   all-to-all (a
  that hold them (cache, logits)                       re-layout)
  ``_apply_moe_sharded``: the row's tokens to each     all-gather
  expert position                                      (x replicated
                                                       over "model")
  ``_apply_moe_sharded``: each expert position's       all-reduce (its
  output back to the row's                             ``psum``)
  the pipeline's hop to the next stage                 collective-permute
  ===================================================  ==================

  The count is logical, by position: a position holds one block of
  each sharded leaf (``Sharded``'s layout), and a byte moves when it
  leaves one position for another, whether or not the two share a card
  (a mesh of one card repeated) and on "meta", where nothing moves.
  The reference counts a collective's operand bytes on each device (an
  all-gather's local shard, a reduce-scatter's whole input); the port
  counts the bytes a position receives, or, for a gradient's return and
  an expert's output, sends.

What has no counterpart: the dtype resolution of the reference's
``Resolver`` (XLA:CPU widens bf16 dots to f32; here the tensors keep
their dtype), and the HLO text itself.

The hooks (``at``, ``on_gather``, ``on_write``, ``on_replica_sum``,
``moved``) return at once when no counter is active: the real steps pay
one list check a call."""
from __future__ import annotations

import weakref
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# the attention operators register with the dispatcher at import
import repro_torch.kernels.decode_attention  # noqa: F401
import repro_torch.kernels.flash_attention  # noqa: F401

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_aten = torch.ops.aten
# op -> (its tensor arguments the FLOP formula reads, the operands whose
# bytes are dot bytes)
DOT_OPS = {_aten.mm: (2, (0, 1)), _aten.bmm: (2, (0, 1)),
           _aten.addmm: (3, (1, 2)), _aten.baddbmm: (3, (1, 2)),
           torch.ops.repro_torch.flash_attention: (5, (0, 1, 2)),
           torch.ops.repro_torch.decode_attention: (4, (0, 1, 2))}
# matrix products: the operand whose last dim is the contraction
_CONTRACTED = {_aten.mm: 0, _aten.bmm: 0, _aten.addmm: 1, _aten.baddbmm: 1}
# shape queries, run uncounted (the names a torch version lacks skipped)
_QUERIES = {getattr(_aten, n) for n in (
    "size", "sym_size", "stride", "sym_stride", "numel", "sym_numel", "dim",
    "is_contiguous", "sym_is_contiguous", "storage_offset",
    "sym_storage_offset", "is_strides_like_format",
    "is_non_overlapping_and_dense") if hasattr(_aten, n)}


@dataclass
class Cost:
    """One position's (or a sum's) cost of one step: the reference's
    fields, and ``bytes_accessed``."""
    flops: float = 0.0
    dot_bytes: float = 0.0
    collective: Dict[str, float] = field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    bytes_accessed: float = 0.0

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += mult * other.flops
        self.dot_bytes += mult * other.dot_bytes
        self.bytes_accessed += mult * other.bytes_accessed
        for c in COLLECTIVES:
            self.collective[c] += mult * other.collective[c]

    @property
    def collective_bytes(self) -> float:
        return sum(self.collective.values())

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "dot_bytes": self.dot_bytes,
                "collective_bytes": self.collective_bytes,
                "collective": dict(self.collective),
                "bytes_accessed": self.bytes_accessed}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def grid_index(mesh, coords: Dict[str, int]) -> int:
    """The grid index (``Mesh.grid``'s row-major [R, M] order) of the
    position with mesh coordinates ``coords``."""
    r = 0
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            r = r * mesh.shape[a] + coords.get(a, 0)
    return r * mesh.shape["model"] + coords.get("model", 0)


def grid_coords(mesh, pos: int) -> Dict[str, int]:
    """``grid_index``'s inverse: {axis: i} of grid position ``pos``."""
    r, m = divmod(pos, mesh.shape["model"])
    coords = {"model": m}
    for a in ("data", "pod"):
        if a in mesh.axis_names:
            r, coords[a] = divmod(r, mesh.shape[a])
    return coords


def own_index(leaf, coords: Dict[str, int]) -> tuple:
    """The block index of ``leaf`` (a ``Sharded``) that the position with
    ``coords`` holds."""
    return leaf._index(leaf.spec, leaf.sharding.mesh, coords)


_ACTIVE: list = []


def active() -> Optional["StepCounter"]:
    """The innermost counter running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class at:
    """``with at(pos):`` attributes what runs inside to grid position
    ``pos`` (None: to no position) on the active counter; nothing
    without one."""
    __slots__ = ("pos", "prev", "c")

    def __init__(self, pos: Optional[int]):
        self.pos = pos

    def __enter__(self):
        self.c = _ACTIVE[-1] if _ACTIVE else None
        if self.c is not None:
            self.prev, self.c.pos = self.c.pos, self.pos
        return self

    def __exit__(self, *exc):
        if self.c is not None:
            self.c.pos = self.prev


def moved(category: str, nbytes: int) -> None:
    """``nbytes`` moved by the current position, in ``category``."""
    c = active()
    if c is not None and c.pos is not None and nbytes:
        c.costs[c.pos].collective[category] += nbytes


def on_gather(leaf, pieces: Dict[tuple, torch.Tensor]) -> None:
    """``Sharded.gather``: ``pieces`` ({block index: the part of that
    block the gather reads}) onto the current position: the pieces of
    blocks it does not hold are an all-gather, and, where they will get
    a gradient, its return a reduce-scatter."""
    c = active()
    if c is None or c.pos is None:
        return
    own = own_index(leaf, c.coords(leaf.sharding.mesh))
    remote = [p for i, p in pieces.items() if i != own]
    moved("all-gather", sum(_nbytes(p) for p in remote))
    if torch.is_grad_enabled():
        moved("reduce-scatter", sum(_nbytes(p) for p in remote
                                    if p.requires_grad))


def holders_of(leaf) -> Counter:
    """{block index: how many positions hold it} of ``leaf`` (a
    ``Sharded``)."""
    mesh = leaf.sharding.mesh
    return Counter(own_index(leaf, grid_coords(mesh, p))
                   for p in range(mesh.devices.size))


def moved_bytes(leaf, coords: Dict[str, int], ranges: Dict[int, tuple],
                write: bool, holders: Counter) -> int:
    """The bytes the position at ``coords`` moves of ``leaf``'s part
    inside ``ranges`` ({dim: (lo, hi)}; other dims whole): a read gets
    each covered block it does not hold; a write sends each covered
    block to every other holder (``holders``: ``holders_of(leaf)``)."""
    own = own_index(leaf, coords)
    item = torch.empty((), dtype=leaf.dtype).element_size()
    total = 0
    for idx, h in holders.items():
        n = 1
        for d, (lo, hi) in enumerate(leaf.block_range(idx)):
            a, b = ranges.get(d, (lo, hi))
            n *= max(0, min(b, hi) - max(a, lo))
        total += n * item * ((h - (idx == own)) if write else (idx != own))
    return total


def on_write(leaf, ranges: Dict[int, tuple]) -> None:
    """``Sharded.write`` of the global tensor's part inside ``ranges``
    from the current position into every position holding a block it
    covers, but its own: an all-to-all."""
    c = active()
    if c is None or c.pos is None:
        return
    mesh = leaf.sharding.mesh
    key = (id(mesh), tuple(leaf.spec), leaf.shape)
    if key not in c._holders:
        c._holders[key] = holders_of(leaf)
    moved("all-to-all", moved_bytes(leaf, c.coords(mesh), ranges, True,
                                    c._holders[key]))


def on_replica_sum(leaf) -> None:
    """The mesh train step's sum of a block's gradient copies (f32): for
    each block index held by k positions, the first (in grid order)
    receives the k - 1 other copies and each of those the sum back, an
    all-reduce, each position's bytes attributed to it."""
    c = active()
    if c is None:
        return
    mesh = leaf.sharding.mesh
    groups: Dict[tuple, list] = defaultdict(list)
    for p in range(mesh.devices.size):
        groups[own_index(leaf, grid_coords(mesh, p))].append(p)
    for idx, ps in groups.items():
        nb = 4                                   # f32
        for lo, hi in leaf.block_range(idx):
            nb *= hi - lo
        c.costs[ps[0]].collective["all-reduce"] += (len(ps) - 1) * nb
        for p in ps[1:]:
            c.costs[p].collective["all-reduce"] += nb


class StepCounter(TorchDispatchMode):
    """Counts, per grid position, what runs under it (``Cost``) and the
    peak of the transient bytes live at once (``peak``: each non-view
    output's bytes from its creation until the tensor is freed). Ops run
    with no position set (``at(None)``) are run and not counted."""

    def __init__(self):
        super().__init__()
        self.pos: Optional[int] = None
        self.costs: Dict[int, Cost] = defaultdict(Cost)
        self.live: Dict[int, int] = defaultdict(int)
        self.peak: Dict[int, int] = defaultdict(int)
        self._base: Dict[int, int] = {}
        self._coords: Dict[tuple, Dict[str, int]] = {}
        self._holders: dict = {}

    def coords(self, mesh) -> Dict[str, int]:
        key = (id(mesh), self.pos)
        hit = self._coords.get(key)
        if hit is None:
            hit = self._coords[key] = grid_coords(mesh, self.pos)
        return hit

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def reset(self) -> None:
        """Start new costs and peaks (the live bytes carry over)."""
        self.costs = defaultdict(Cost)
        self.peak = defaultdict(int)
        self._base = dict(self.live)

    def transient(self) -> Dict[int, int]:
        """{position: its peak live bytes since ``reset`` above those live
        at the reset}, for the positions that allocated since."""
        return {p: v - self._base.get(p, 0) for p, v in self.peak.items()}

    def _free(self, pos: int, nbytes: int) -> None:
        self.live[pos] -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet in _QUERIES:
            return func(*args, **kwargs)
        if packet not in flop_registry and packet not in DOT_OPS:
            # a composite op: count what it decomposes into, as
            # FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        pos = self.pos
        if pos is None or func.is_view:
            return out
        c = self.costs[pos]
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        c.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if packet in DOT_OPS and not (_CONTRACTED.get(packet) is not None
                                      and args[_CONTRACTED[packet]]
                                      .shape[-1] == 1):
            # the formula gets the operands only: a ``bmm`` with
            # ``out_dtype`` (the card's training attention) passes it
            # third, where torch's formula takes ``out_shape``
            n, operands = DOT_OPS[packet]
            c.flops += flop_registry[packet](*args[:n], out_val=out)
            c.dot_bytes += sum(_nbytes(args[i]) for i in operands) \
                + sum(map(_nbytes, outs))
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen:
                continue                  # in place: no new bytes
            nb = _nbytes(t)
            self.live[pos] += nb
            self.peak[pos] = max(self.peak[pos], self.live[pos])
            weakref.finalize(t, self._free, pos, nb)
        return out
