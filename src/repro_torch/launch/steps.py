"""Step builders (port of ``repro/launch/steps.py``): the train, prefill
and serve steps for an (arch config, shape, mesh), with the layouts of
their state (``specs``).

``mesh=None`` is the one-card path: the step runs eagerly on the
model's device. A ``core.distributed.Mesh`` (a grid of devices, which
may repeat one card) runs the same step over the grid's positions in
one process (``distributed/sharding.py`` says why this is not DTensor):

- State follows the reference's layouts: every parameter, AdamW ``m``
  and ``v`` and KV cache is a ``sharding.Sharded`` leaf laid out by
  ``param_specs`` / ``cache_shardings``.
- Batches follow ``batch_sharding``: each data block's rows are split
  over its "model" positions, so no device computes a row twice; a
  computing position gathers the weights onto its device and runs the
  family's own forward (and, training, its backward) on its rows,
  positions one after another.
- For an MoE arch whose experts divide the "model" axis, the model
  positions of a data row hold the experts instead: the row's tokens
  run on its first device, and each MoE layer dispatches expert-parallel
  (``models.moe._apply_moe_sharded``), one capacity pool a data row.
- An MoE arch that does not dispatch expert-parallel, and every MoE
  decode (the reference's serve step sets no mesh), is one capacity
  pool over the whole (micro)batch, as the reference's local dispatch:
  its rows are not split, and run whole on the grid's first device.

Each builder's ``specs["unit"]`` is the body it runs for one computing
unit, and each unit runs inside ``step_cost.at`` its grid position, so
that ``lower_step`` (below) counts a step's cost per position on the
"meta" device, each distinct unit once (``launch/step_cost.py``,
``launch/dryrun.py``)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding, P, Sharded
from repro_torch.launch import step_cost
from repro_torch.models import _reference_path, get_model
from repro_torch.models.moe import expert_parallel
from repro_torch.optim import AdamWConfig, adamw_update

# cache leaves [L, B, KV, T, X] with a sequence axis (dim 3)
_SEQ_LEAVES = ("k", "v", "k_low", "k_sc", "v_sc")


def _ns(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def _logits_sharding(cfg, mesh) -> NamedSharding:
    """Vocab-sharded logits unless the vocab doesn't divide the model
    axis (e.g. whisper's 51865)."""
    if cfg.vocab % shd.axis_size(mesh, "model") == 0:
        return _ns(mesh, None, "model")
    return _ns(mesh, None, None)


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


# --------------------------------------------------------------------------
# cache shardings (name-dispatched, the reference's rules)
# --------------------------------------------------------------------------

def cache_shardings(cfg, mesh, abstract_cache, batch: int):
    """A ``NamedSharding`` a leaf of the port's cache tree (``abstract_
    cache``: tensors, "meta" ones or not). The reference's rules, with
    its [L, B, T, KV, X] attention leaves in the port's [L, B, KV, T,
    X]: the batch over the batch axes, the sequence over "model" (and
    the batch axes too when the batch cannot use them); recurrent
    states' width over "model"."""
    b_ax = shd.batch_axes(mesh)
    b_size = shd.axes_size(mesh, b_ax)
    bspec = b_ax if batch % b_size == 0 and batch >= b_size else None
    seq_ax = "model" if bspec is not None else tuple(list(b_ax) + ["model"])
    msize = shd.axis_size(mesh, "model")

    def rule(path, leaf):
        name = path[-1]
        if name in _SEQ_LEAVES:                     # [L, B, KV, T, X]
            n_seq = shd.axes_size(mesh, shd.spec_axes(seq_ax))
            sax = seq_ax if leaf.shape[3] % n_seq == 0 else None
            return _ns(mesh, None, bspec, None, sax, None)
        if name == "S":                  # rwkv state [L, B, H, hd, hd]
            m = "model" if leaf.shape[2] % msize == 0 else None
            return _ns(mesh, None, bspec, m, None, None)
        if name == "x_prev":             # [L, B, 1, D]
            m = "model" if leaf.shape[3] % msize == 0 else None
            return _ns(mesh, None, bspec, None, m)
        if name == "h":                  # rg-lru state [R, B, W]
            m = "model" if leaf.shape[2] % msize == 0 else None
            return _ns(mesh, None, bspec, m)
        if name == "conv":               # [R, B, 3, W]
            m = "model" if leaf.shape[3] % msize == 0 else None
            return _ns(mesh, None, bspec, None, m)
        raise KeyError(f"no cache sharding rule for {'/'.join(path)}")

    return _tree_map(rule, abstract_cache)


# --------------------------------------------------------------------------
# the grid's computing positions
# --------------------------------------------------------------------------

def _check_mesh(mesh, what: str) -> None:
    from repro_torch.core.distributed import Mesh
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what}: mesh must be None or a repro_torch "
                        f"core.distributed.Mesh, not {type(mesh).__name__}")


def computing_units(cfg, mesh, rows: int, kind: str, offset: int = 0
                    ) -> List[Tuple[torch.device, int, int, int]]:
    """[(device, grid row, lo, hi)]: who computes global rows [lo, hi)
    of a batch of ``rows`` rows starting at row ``offset``. The rows
    split into data blocks as ``batch_sharding``'s batch axes (less
    "model") split them, each block computed by the first grid row that
    holds it; a block's rows split over its "model" positions
    (contiguous, the first ones a row more), or, where the MoE
    dispatches expert-parallel (``moe.expert_parallel``), stay whole on
    the row's first device. Where the MoE pools the whole batch
    (``_pooled``), every row is one unit on the grid's first device.
    Positions with no rows do not compute."""
    return [u[1:] for u in _units(cfg, mesh, rows, kind, offset)]


def _units(cfg, mesh, rows: int, kind: str, offset: int = 0
           ) -> List[Tuple[int, torch.device, int, int, int]]:
    """``computing_units`` with each unit's grid position first: [(grid
    index, device, grid row, lo, hi)]."""
    grid = mesh.grid()
    if _pooled(cfg, mesh, kind):
        return [(0, grid[0, 0], 0, offset, offset + rows)]
    R, M = grid.shape
    bspec = shd.batch_spec(cfg, mesh, rows, kind)
    n_blk = shd.axes_size(mesh, [a for a in (bspec or ()) if a != "model"])
    split = 1 if expert_parallel(cfg, mesh) else M
    out = []
    for b in range(n_blk):
        r = b * R // n_blk
        lo, hi = offset + b * rows // n_blk, offset + (b + 1) * rows // n_blk
        for m in range(split):
            a = lo + (hi - lo) * m // split
            e = lo + (hi - lo) * (m + 1) // split
            if e > a:
                out.append((r * M + m, grid[r, m], r, a, e))
    return out


def _pooled(cfg, mesh, kind: str) -> bool:
    """Whether all of a batch's rows form one MoE capacity pool: an MoE
    arch that does not dispatch expert-parallel on ``mesh`` (the
    reference's ``_apply_moe_local`` runs over every token of x), or any
    MoE decode (the reference's jitted serve step sets no mesh context,
    so its decode dispatches locally over the global batch). C, the
    dropped assignments and the aux loss then come from the same tokens
    as the reference's."""
    return cfg.moe is not None and (kind == "decode"
                                    or not expert_parallel(cfg, mesh))


def _take(v, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of a batch entry (a ``Sharded`` leaf, a tensor or an
    array) on ``device``."""
    if isinstance(v, Sharded):
        return v.gather(device, {0: (lo, hi)})
    return torch.as_tensor(v[lo:hi]).to(device)


class _Gatherer:
    """The values a computing position binds into the model on the
    "meta" device (``sharding.bound``): each parameter gathered onto the
    position's device, but the experts where the MoE dispatches
    expert-parallel, which stay ``Sharded`` for that dispatch; the
    buffers, made once a device."""

    def __init__(self, cfg, mesh, api, skeleton, kind: str):
        self.api = api
        self.keep = set()
        if cfg.moe is not None and not _pooled(cfg, mesh, kind):
            self.keep = {n for n, _ in skeleton.named_parameters()
                         if _reference_path(skeleton, n)[0][-1]
                         in ("e_gate", "e_up", "e_down")}
        self._buffers: Dict[Any, dict] = {}

    def __call__(self, params: Dict[str, Sharded], device) -> dict:
        if device not in self._buffers:
            self._buffers[device] = self.api.buffers(device)
        vals = {n: (leaf if n in self.keep else leaf.gather(device))
                for n, leaf in params.items()}
        vals.update(self._buffers[device])
        return vals


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------

def default_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                         mesh=None) -> int:
    """Gradient-accumulation depth: keep per-device live activations
    roughly constant across model widths (``max(4, d_model // 2048)``,
    doubled from 1 while it divides the global batch and leaves each
    microbatch a multiple of the batch axes' size), bounded by the
    per-device batch; 1 for the "fsdp" profile. ``mesh=None``: one
    card, batch axes of size 1."""
    if getattr(cfg, "shard_profile", "tp") == "fsdp":
        return 1   # the batch spreads over the whole mesh instead
    b_size = 1 if mesh is None else \
        shd.axes_size(mesh, shd.batch_axes(mesh, cfg))
    want = max(4, cfg.d_model // 2048)
    mb = 1
    while mb < want and shape.global_batch % (mb * 2) == 0 \
            and (shape.global_batch // (mb * 2)) % b_size == 0:
        mb *= 2
    return mb


def _rows(batch: Dict[str, Any], i: int, n: int) -> Dict[str, Any]:
    return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}


def shard_params(tensors, p_sh: Dict[str, NamedSharding],
                 requires_grad: bool = False) -> Dict[str, Sharded]:
    """A module's parameters (or any dict keyed by parameter name) laid
    out by ``p_sh``: {name: ``Sharded``}, each block a leaf tensor of
    its own (requiring grad when asked)."""
    if isinstance(tensors, torch.nn.Module):
        tensors = dict(tensors.named_parameters())
    out = {}
    for n, t in tensors.items():
        leaf = Sharded.place(t.detach(), p_sh[n])
        for b in leaf.blocks.values():
            b.requires_grad_(requires_grad)
        out[n] = leaf
    return out


def adamw_init_sharded(params: Dict[str, Sharded]) -> Dict[str, Any]:
    """``optim.adamw_init`` on a mesh: ``m`` and ``v`` f32 zeros in each
    parameter's layout, block for block; ``step`` int32 0 on the mesh's
    first device."""
    zeros = lambda: {n: leaf.like(lambda b: torch.zeros(
        b.shape, dtype=torch.float32, device=b.device))
        for n, leaf in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     microbatches: int = 0):
    """Returns (step, specs): ``step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` runs ``api.loss`` and its backward over the
    microbatches (0: ``default_microbatches``), then the AdamW update in
    place. Microbatch i is rows [i * B / mb, (i + 1) * B / mb) of every
    batch entry. The metrics are the means over the microbatches of
    ``api.loss``'s, with the update's "grad_norm" and "lr".

    ``mesh=None``: ``params`` is the model (an ``nn.Module``) and the
    state is ``optim.adamw_init``'s; each microbatch's gradients come in
    the parameters' dtype and are summed in f32 buffers, one a
    parameter, then divided by mb, as the reference's scan sums them;
    with mb == 1 they stay in the parameters' dtype. ``specs``: ``api``
    and ``microbatches``.

    A ``Mesh``: ``params`` is {name: ``Sharded``} laid out by ``p_sh``
    with blocks that require grad (``shard_params``), the state
    ``adamw_init_sharded``'s, and ``batch`` global tensors or
    ``Sharded`` leaves (``TokenPipeline(shardings=b_sh)``). Each
    computing position (``computing_units``) runs the loss on its rows,
    and each block's gradient is the f32 sum over the positions that
    used it, each weighted by its share of the microbatch's rows, in
    position order; copies of one block on several devices are then
    summed in storage order, so they stay equal. AdamW updates each
    stored block once and in place, clipped by the global norm over
    every block index once. ``specs`` holds ``api``, ``a_params``,
    ``p_sh``, ``a_opt``, ``o_sh``, ``b_sh``, ``microbatches`` and the
    model on the "meta" device (``skeleton``), as the reference's, and
    ``grads``: ``grads(params, batch) -> (grads, metrics)``, the step's
    gradients before the update, {name: ``Sharded`` f32} (the step is
    ``grads`` then AdamW)."""
    api = get_model(cfg)
    if mesh is not None:
        _check_mesh(mesh, "build_train_step")
    mb = microbatches or default_microbatches(cfg, shape, mesh)
    if shape.global_batch % mb:
        raise ValueError(f"build_train_step: {mb} microbatches do not "
                         f"divide the global batch {shape.global_batch}")
    rows = shape.global_batch // mb
    if mesh is not None:
        return _mesh_train_step(cfg, mesh, shape, opt_cfg, mb, api)

    def grads_of(params):
        out = {n: p.grad if p.grad is not None else torch.zeros_like(p)
               for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return out

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if mb == 1:
            loss, metrics = api.loss(model, batch)
            loss.backward()
            grads = grads_of(params)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()}
            ms = []
            for i in range(mb):
                loss, m = api.loss(model, _rows(batch, i, rows))
                loss.backward()
                for n, g in grads_of(params).items():
                    gsum[n] += g.to(torch.float32)
                ms.append({k: v.detach() for k, v in m.items()})
            grads = {n: g.div_(mb) for n, g in gsum.items()}
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        _, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return model, opt_state, {**metrics, **om}

    return train_step, dict(api=api, microbatches=mb)


def _mesh_specs(cfg, mesh, shape, kind: str, api):
    skeleton = api.init(None, "meta")
    a_params = dict(skeleton.named_parameters())
    p_sh = shd.param_shardings(cfg, skeleton, mesh)
    b_sh = shd.batch_sharding(cfg, mesh, shape, kind)
    return dict(api=api, skeleton=skeleton, a_params=a_params, p_sh=p_sh,
                b_sh=b_sh)


def _mesh_train_step(cfg, mesh, shape, opt_cfg, mb, api):
    specs = _mesh_specs(cfg, mesh, shape, "train", api)
    skeleton, p_sh = specs["skeleton"], specs["p_sh"]
    a_opt = {"m": {n: torch.empty(t.shape, dtype=torch.float32,
                                  device="meta")
                   for n, t in specs["a_params"].items()}}
    a_opt["v"] = dict(a_opt["m"])
    a_opt["step"] = torch.empty((), dtype=torch.int32, device="meta")
    o_sh = {"m": p_sh, "v": p_sh, "step": _ns(mesh)}
    rows = shape.global_batch // mb
    arules = shd.act_rules(cfg, mesh, rows)
    gather = _Gatherer(cfg, mesh, api, skeleton, "train")
    first = mesh.devices.flat[0]

    def unit(params, batch, dev, r: int, lo: int, hi: int) -> dict:
        """One computing unit: the loss of global rows [lo, hi) on
        ``dev`` (grid row ``r``) and its backward, the gradients left in
        each stored block's ``.grad``; returns the loss's metrics."""
        vals = gather(params, dev)
        rb = {k: _take(v, lo, hi, dev) for k, v in batch.items()}
        with shd.bound(skeleton, vals), \
                shd.activation_rules(arules, mesh, row=r):
            loss, m = api.loss(skeleton, rb)
            loss.backward()
        return m

    def grads_of(params, batch):
        """(grads, metrics): each parameter's gradient, the mean over the
        microbatches, as a ``Sharded`` f32 leaf in the parameter's layout
        (every stored copy of a block equal), and the metrics' means."""
        stored = [(n, key, b) for n, leaf in params.items()
                  for key, b in leaf.blocks.items()]
        gsum = {(n, key): torch.zeros(b.shape, dtype=torch.float32,
                                      device=b.device)
                for n, key, b in stored}
        msum: Dict[str, torch.Tensor] = {}
        for i in range(mb):
            for pos, dev, r, lo, hi in _units(cfg, mesh, rows, "train",
                                              i * rows):
                w = (hi - lo) / rows
                with step_cost.at(pos):
                    m = unit(params, batch, dev, r, lo, hi)
                for n, key, b in stored:
                    if b.grad is not None:
                        gsum[(n, key)].add_(b.grad.to(torch.float32),
                                            alpha=w)
                        b.grad = None
                for k, v in m.items():
                    v = v.detach().to(first) * w
                    msum[k] = v if k not in msum else msum[k] + v
        # copies of one block index on several devices: one sum, to each
        for leaf in params.values():
            step_cost.on_replica_sum(leaf)
        by_idx: Dict[tuple, list] = {}
        for n, key, _ in stored:
            by_idx.setdefault((n, key[0]), []).append(key)
        for (n, idx), keys in by_idx.items():
            g = gsum[(n, keys[0])].div_(mb)
            for key in keys[1:]:
                g = g + gsum[(n, key)].div(mb).to(g.device)
            for key in keys:
                gsum[(n, key)] = g.to(key[1])
        grads = {n: Sharded(leaf.sharding, leaf.shape, torch.float32,
                            {key: gsum[(n, key)] for key in leaf.blocks})
                 for n, leaf in params.items()}
        return grads, {k: v / mb for k, v in msum.items()}

    def train_step(params, opt_state, batch):
        grads, metrics = grads_of(params, batch)
        flat = lambda tree: {(n, key): b for n, leaf in tree.items()
                             for key, b in leaf.blocks.items()}
        # the global norm: each block index once, in storage order
        norm_of = {}
        for (n, key), g in flat(grads).items():
            norm_of.setdefault((n, key[0]), g)
        state = {"m": flat(opt_state["m"]), "v": flat(opt_state["v"]),
                 "step": opt_state["step"]}
        _, _, om = adamw_update(opt_cfg, flat(params), flat(grads), state,
                                norm_of=norm_of)
        return params, opt_state, {**metrics, **om}

    specs.update(a_opt=a_opt, o_sh=o_sh, microbatches=mb, grads=grads_of,
                 unit=unit)
    return train_step, specs


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig):
    """Returns (step, specs): ``step(params, batch, cache_len=None) ->
    (logits, cache)``, the prompt of ``shape`` run on ``mesh`` (the
    family's ``prefill`` on each computing position's rows, with
    ``cache_len`` as there): logits [B, V] f32 laid out by
    ``_logits_sharding`` and every cache leaf laid out by
    ``cache_shardings``, ``Sharded`` leaves. ``params``: {name:
    ``Sharded``} by ``p_sh``. ``specs``: ``api``, ``a_params``, ``p_sh``,
    ``b_sh``, ``a_cache`` and ``c_sh`` (at the shape's length), as the
    reference's."""
    _check_mesh(mesh, "build_prefill_step")
    api = get_model(cfg)
    specs = _mesh_specs(cfg, mesh, shape, "prefill", api)
    skeleton = specs["skeleton"]
    arules = shd.act_rules(cfg, mesh, shape.global_batch)
    a_cache = api.abstract_cache(shape.global_batch, shape.seq_len)
    c_sh = cache_shardings(cfg, mesh, a_cache, shape.global_batch)
    lg_sh = _logits_sharding(cfg, mesh)
    gather = _Gatherer(cfg, mesh, api, skeleton, "prefill")

    def unit(params, batch, dev, r: int, lo: int, hi: int, cache_len,
             out: dict) -> None:
        """One computing unit: the prompt's global rows [lo, hi) on
        ``dev`` (grid row ``r``), written into ``out``'s "logits" and
        "cache" (made, zeroed and laid out, by the first unit)."""
        B = next(iter(batch.values())).shape[0]
        rb = {k: _take(v, lo, hi, dev) for k, v in batch.items()}
        with shd.bound(skeleton, gather(params, dev)), \
                shd.activation_rules(arules, mesh, row=r):
            lg, c = api.prefill(skeleton, rb, cache_len)
        if "cache" not in out:
            with step_cost.at(None):      # the step's outputs, not its work
                glob = _tree_map(lambda _, t: torch.empty(
                    (t.shape[0], B) + tuple(t.shape[2:]), dtype=t.dtype,
                    device="meta"), c)
                sh = cache_shardings(cfg, mesh, glob, B)
                out["cache"] = _tree_map(lambda p, t: Sharded.zeros(
                    _at(sh, p), t.shape, t.dtype), glob)
                out["logits"] = Sharded.zeros(
                    lg_sh, (B,) + tuple(lg.shape[1:]), lg.dtype)
        _tree_map(lambda p, leaf: leaf.write(_at(c, p), {1: (lo, hi)}),
                  out["cache"])
        out["logits"].write(lg, {0: (lo, hi)})

    def prefill_step(params, batch, cache_len=None):
        B = next(iter(batch.values())).shape[0]
        out = {}
        for pos, dev, r, lo, hi in _units(cfg, mesh, B, "prefill"):
            with step_cost.at(pos):
                unit(params, batch, dev, r, lo, hi, cache_len, out)
        return out["logits"], out["cache"]

    specs.update(a_cache=a_cache, c_sh=c_sh, unit=unit)
    return prefill_step, specs


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ring(cfg) -> bool:
    """Whether the attention caches are ring buffers (a windowed arch's,
    or the hybrid's local attention)."""
    return cfg.family == "hybrid" or bool(cfg.window)


def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig):
    """One-token decode against a ``shape.seq_len`` cache: returns (step,
    specs), ``step(params, cache, token, pos) -> (logits, cache)``.
    ``cache``: ``Sharded`` leaves by ``cache_shardings`` (the prefill
    step's); ``token`` [B, 1] (a tensor or a ``Sharded`` leaf); ``pos``
    the position (an int or a scalar tensor, read once on the host).
    Each computing position gathers its rows of the cache, whole along
    the sequence (no flash-decoding merge), runs the family's
    ``decode_step`` on them, and the new token's k and v go into the
    block that owns their slot, in place; a recurrent state's rows are
    written back whole. Logits as ``build_prefill_step``'s. As the
    reference's jitted serve step, the decode runs under no mesh
    context: an MoE layer dispatches locally over the global batch, one
    capacity pool (``_pooled``: one computing unit), where the prefill
    dispatches expert-parallel a data row."""
    _check_mesh(mesh, "build_serve_step")
    api = get_model(cfg)
    specs = _mesh_specs(cfg, mesh, shape, "decode", api)
    skeleton = specs["skeleton"]
    a_cache = api.abstract_cache(shape.global_batch, shape.seq_len)
    c_sh = cache_shardings(cfg, mesh, a_cache, shape.global_batch)
    lg_sh = _logits_sharding(cfg, mesh)
    gather = _Gatherer(cfg, mesh, api, skeleton, "decode")

    def unit(params, cache, token, p: int, dev, lo: int, hi: int,
             out: dict) -> None:
        """One computing unit: rows [lo, hi) of the cache gathered onto
        ``dev``, one decode step, the new slot written back in place and
        the logits into ``out["logits"]`` (made by the first unit)."""
        B = token.shape[0]
        mine = _tree_map(lambda _, s: s.gather(dev, {1: (lo, hi)}), cache)
        tok = _take(token, lo, hi, dev)
        with shd.bound(skeleton, gather(params, dev)):
            lg, mine = api.decode_step(skeleton, mine, tok, p)

        def back(path, leaf):
            t = _at(mine, path)
            if path[-1] in _SEQ_LEAVES:
                T = leaf.shape[3]
                s = p % T if _ring(cfg) else min(p, T - 1)
                leaf.write(t[:, :, :, s:s + 1], {1: (lo, hi),
                                                 3: (s, s + 1)})
            else:
                leaf.write(t, {1: (lo, hi)})
        _tree_map(back, cache)
        if "logits" not in out:
            with step_cost.at(None):      # the step's output, not its work
                out["logits"] = Sharded.zeros(
                    lg_sh, (B,) + tuple(lg.shape[1:]), lg.dtype)
        out["logits"].write(lg, {0: (lo, hi)})

    def serve_step(params, cache, token, pos):
        p = int(pos)
        out = {}
        for g, dev, _, lo, hi in _units(cfg, mesh, token.shape[0],
                                        "decode"):
            with step_cost.at(g):
                unit(params, cache, token, p, dev, lo, hi, out)
        return out["logits"], cache

    specs.update(a_cache=a_cache, c_sh=c_sh, unit=unit)
    return serve_step, specs



# --------------------------------------------------------------------------
# lower_step: a step's cost and memory per position, counted on "meta"
# --------------------------------------------------------------------------

def _empty_sharded(sharding: NamedSharding, shape, dtype,
                   requires_grad: bool = False) -> Sharded:
    """A ``Sharded`` leaf of ``shape`` laid out by ``sharding`` whose
    blocks are "meta" tensors (nothing allocated)."""
    leaf = Sharded(sharding, shape, dtype, {})
    for key in leaf.keys():
        if key not in leaf.blocks:
            shp = [hi - lo for lo, hi in leaf.block_range(key[0])]
            leaf.blocks[key] = torch.empty(shp, dtype=dtype, device="meta"
                                           ).requires_grad_(requires_grad)
    return leaf


def _block_bytes(sharding: NamedSharding, shape, dtype) -> Tuple[int, int]:
    """(the bytes of one block, the (block, device) pairs stored) of a
    leaf of ``shape`` and ``dtype`` laid out by ``sharding``: every
    position holds one block of each leaf, all of one shape."""
    leaf = Sharded(sharding, shape, dtype, {})
    n = 1
    for lo, hi in leaf.block_range(leaf.keys()[0][0]):
        n *= hi - lo
    return n * torch.empty((), dtype=dtype).element_size(), \
        len(set(leaf.keys()))


class MemoryAnalysis:
    """The reference's ``memory_analysis()`` sizes of one position (the
    largest over positions), and ``stored_argument_bytes``: the
    arguments summed once per (block, device) of the mesh given to
    ``lower_step`` (what that mesh's cards store; on a mesh of one card
    repeated, one copy of a replicated block)."""

    def __init__(self, argument: int, output: int, alias: int, temp: int,
                 stored_argument: int, per_position: List[dict]):
        self.argument_size_in_bytes = argument
        self.output_size_in_bytes = output
        self.alias_size_in_bytes = alias
        self.temp_size_in_bytes = temp
        self.stored_argument_bytes = stored_argument
        self.per_position = per_position

    def __repr__(self):
        return (f"MemoryAnalysis(argument={self.argument_size_in_bytes}, "
                f"output={self.output_size_in_bytes}, alias="
                f"{self.alias_size_in_bytes}, temp={self.temp_size_in_bytes},"
                f" stored_argument={self.stored_argument_bytes})")


class StepCost:
    """``Lowered.cost()``: ``positions`` (a ``Cost`` a grid position),
    ``busiest`` (the position with the most FLOPs, then bytes; what the
    reference's per-device HLO gives), ``total`` (the sum over
    positions), ``multiplicity`` ([(count, Cost)]: the distinct
    per-position costs and how many positions have each) and ``units``
    ({unit key: how many computing units share it}; each key was run
    once unless ``lower_step(dedup=False)``)."""

    def __init__(self, positions: List[step_cost.Cost], units: dict):
        self.positions = positions
        self.units = units
        self.total = step_cost.Cost()
        for c in positions:
            self.total.add(c)
        self.busiest_position = max(
            range(len(positions)), key=lambda i: (
                positions[i].flops, positions[i].bytes_accessed,
                positions[i].collective_bytes, -i))
        self.busiest = positions[self.busiest_position]
        seen: Dict[str, list] = {}
        for c in positions:
            k = repr(c.as_dict())
            if k in seen:
                seen[k][0] += 1
            else:
                seen[k] = [1, c]
        self.multiplicity = [tuple(v) for v in seen.values()]


def _translate(pos: int, g_from: int, g_to: int, R: int, M: int) -> int:
    """Grid position ``pos`` of a unit run at ``g_from``, moved with the
    unit to ``g_to`` (rows and columns shifted, wrapping)."""
    a, b = divmod(pos, M)
    r1, m1 = divmod(g_from, M)
    r2, m2 = divmod(g_to, M)
    return ((a - r1 + r2) % R) * M + (b - m1 + m2) % M


class Lowered:
    """``lower_step``'s result: the step built on an abstract twin of the
    mesh (``launch.mesh.abstract_mesh``: the same shape and axes, every
    position a "meta" device of its own), its state as "meta" blocks,
    and two methods: ``cost()`` (traced at its first call, ``trace_s``)
    and ``memory_analysis()`` (from the layouts; its temp bytes 0 until
    ``cost()`` has run)."""

    def __init__(self, run, memory: MemoryAnalysis):
        self._run = run
        self._memory = memory
        self._cost: Optional[StepCost] = None
        self.trace_s: Optional[float] = None

    def cost(self) -> StepCost:
        if self._cost is None:
            import time
            t0 = time.perf_counter()
            self._cost = self._run()
            self.trace_s = time.perf_counter() - t0
        return self._cost

    def memory_analysis(self) -> MemoryAnalysis:
        if self._cost is not None:
            self._memory.temp_size_in_bytes = max(
                p["temp_size_in_bytes"] for p in self._memory.per_position)
        return self._memory


def lower_step(cfg: ModelConfig, mesh, shape: ShapeConfig, *,
               dedup: bool = True) -> Lowered:
    """The port of ``repro/launch/steps.py: lower_step``: the train,
    prefill or serve step of a (cfg, shape) cell on ``mesh`` (any
    ``Mesh``: cards, "cpu" devices, repeated or not, or an abstract
    one), built from ``abstract_params``, ``input_specs``,
    ``param_specs`` and ``cache_shardings`` on the mesh's abstract twin,
    so nothing is allocated and no kernel runs. ``cost()`` runs the
    step's computing units (``specs["unit"]``, the body each step runs a
    unit) under ``step_cost.StepCounter``, each at its grid position.
    Two units are the same when they compute the same number of rows of
    a (micro)batch of the same size in the same kind of step: their
    gathered blocks, shapes and movements are then the same shifted
    along the grid, so with ``dedup`` each distinct unit runs once and
    its per-position costs are shifted to every other unit of its key
    (``dedup=False`` runs every unit). The train step adds the
    replicated gradients' sums and AdamW's update on each position's
    blocks (one position's, shifted to all). ``memory_analysis()``:
    argument, output and alias bytes a position from the layouts (the
    train step's parameters and optimizer state, the serve step's cache,
    donated), temp bytes the peak of a position's transient bytes under
    the counter (an estimate: it moves by a few percent with when Python
    frees a unit's last tensors)."""
    kind = shape.kind
    api = get_model(cfg)
    from repro_torch.launch.mesh import abstract_mesh
    twin = abstract_mesh(tuple(mesh.devices.shape), mesh.axis_names)
    R, M = twin.grid().shape
    specs_in = api.input_specs(shape)
    B = shape.global_batch
    on = lambda ns, m: NamedSharding(m, ns.spec)   # a sharding on mesh m
    if kind == "train":
        _, specs = build_train_step(cfg, twin, shape)
        mb = specs["microbatches"]
        rows = B // mb
        units = [u for i in range(mb)
                 for u in _units(cfg, twin, rows, kind, i * rows)]
    else:
        build = build_prefill_step if kind == "prefill" else \
            build_serve_step
        _, specs = build(cfg, twin, shape)
        rows = B
        units = _units(cfg, twin, B, kind)
    p_sh, b_sh = specs["p_sh"], specs["b_sh"]
    a_params = specs["a_params"]

    # ---- memory, from the layouts
    leaves = []                       # (sharding, shape, dtype, roles)
    f32, i32 = torch.float32, torch.int32
    for n, t in a_params.items():
        leaves.append((p_sh[n], t.shape, t.dtype, "aio" if kind == "train"
                       else "i"))
    if kind == "train":
        for n, t in a_params.items():
            leaves += [(p_sh[n], t.shape, f32, "aio")] * 2     # m, v
        leaves.append((_ns(twin), (), i32, "aio"))             # step
    if kind == "decode":
        for path, t in _leaves(specs["a_cache"]):
            leaves.append((_at(specs["c_sh"], path), t.shape, t.dtype,
                           "aio"))
        leaves.append((b_sh["token"], specs_in["token"].shape, i32, "i"))
        leaves.append((_ns(twin), (), i32, "i"))               # pos
    else:
        for k, t in specs_in.items():
            leaves.append((b_sh[k], t.shape, t.dtype, "i"))
    if kind == "prefill":
        for path, t in _leaves(specs["a_cache"]):
            leaves.append((_at(specs["c_sh"], path), t.shape, t.dtype, "o"))
    if kind != "train":
        lg = _logits_sharding(cfg, twin)
        leaves.append((lg, (B, cfg.vocab), f32, "o"))
    size = {"i": 0, "o": 0, "a": 0}
    stored = 0
    for sh, shp, dt, roles in leaves:
        nb, _ = _block_bytes(sh, shp, dt)
        for r in roles:
            size[r] += nb
        if "i" in roles:
            stored += nb * _block_bytes(on(sh, mesh), shp, dt)[1]
    per_position = [{"argument_size_in_bytes": size["i"],
                     "output_size_in_bytes": size["o"],
                     "alias_size_in_bytes": size["a"],
                     "temp_size_in_bytes": 0}
                    for _ in range(R * M)]
    memory = MemoryAnalysis(size["i"], size["o"], size["a"], 0, stored,
                            per_position)

    # the data leaves a unit reads or writes rows of: (layout, the dim of
    # the rows, other ranges, write)
    data = [(Sharded(b_sh[k], t.shape, t.dtype, {}), 0, {}, False)
            for k, t in specs_in.items() if k != "pos"]
    if kind != "train":
        data.append((Sharded(_logits_sharding(cfg, twin), (B, cfg.vocab),
                             f32, {}), 0, {}, True))
        for path, t in _leaves(specs["a_cache"]):
            layout = Sharded(_at(specs["c_sh"], path), t.shape, t.dtype, {})
            if kind == "prefill":
                data.append((layout, 1, {}, True))
                continue
            data.append((layout, 1, {}, False))        # the gather
            rng = {}
            if path[-1] in _SEQ_LEAVES:                # the new slot
                T, slot = t.shape[3], shape.seq_len - 1
                s = slot % T if _ring(cfg) else min(slot, T - 1)
                rng = {3: (s, s + 1)}
            data.append((layout, 1, rng, True))
    holders = [step_cost.holders_of(layout) for layout, *_ in data]

    def moves(u) -> Dict[str, int]:
        coords = step_cost.grid_coords(twin, u[0])
        out = {"all-gather": 0, "all-to-all": 0}
        for (layout, d, rng, write), h in zip(data, holders):
            out["all-to-all" if write else "all-gather"] += \
                step_cost.moved_bytes(layout, coords, {d: (u[3], u[4]),
                                                       **rng}, write, h)
        return out

    def run() -> StepCost:
        counter = step_cost.StepCounter()
        totals = [step_cost.Cost() for _ in range(R * M)]
        temps = [0] * (R * M)
        seen: Dict[tuple, tuple] = {}
        counts: Dict[tuple, int] = {}

        def merge(rec, g_from, g_to):
            costs, peaks = rec
            for p, c in costs.items():
                totals[_translate(p, g_from, g_to, R, M)].add(c)
            for p, v in peaks.items():
                q = _translate(p, g_from, g_to, R, M)
                temps[q] = max(temps[q], v)

        def record(fn, pos):
            counter.reset()
            with step_cost.at(pos):
                fn()
            return dict(counter.costs), counter.transient()

        with counter:
            if kind == "train":
                params = {n: _empty_sharded(p_sh[n], t.shape, t.dtype, True)
                          for n, t in a_params.items()}
                batch = {k: _empty_sharded(b_sh[k], t.shape, t.dtype)
                         for k, t in specs_in.items()}
                unit = specs["unit"]

                def body(u):
                    _, dev, r, lo, hi = u
                    unit(params, batch, dev, r, lo, hi)
                    for leaf in params.values():
                        for b in leaf.blocks.values():
                            b.grad = None
            else:
                params = {n: _empty_sharded(p_sh[n], t.shape, t.dtype)
                          for n, t in a_params.items()}
                out: dict = {}
                unit = specs["unit"]
                if kind == "prefill":
                    batch = {k: _empty_sharded(b_sh[k], t.shape, t.dtype)
                             for k, t in specs_in.items()}

                    def body(u):
                        _, dev, r, lo, hi = u
                        unit(params, batch, dev, r, lo, hi, None, out)
                else:
                    cache = _tree_map(lambda p, t: _empty_sharded(
                        _at(specs["c_sh"], p), t.shape, t.dtype),
                        specs["a_cache"])
                    token = _empty_sharded(b_sh["token"],
                                           specs_in["token"].shape, i32)

                    def body(u):
                        _, dev, r, lo, hi = u
                        unit(params, cache, token, shape.seq_len - 1, dev,
                             lo, hi, out)
            for u in units:
                key = (kind, u[4] - u[3], rows)
                counts[key] = counts.get(key, 0) + 1
                if dedup and key in seen:
                    g0, rec, m0 = seen[key]
                    merge(rec, g0, u[0])
                    # the rows it reads and writes may lie elsewhere
                    # relative to it than the first unit's did
                    for cat, v in moves(u).items():
                        totals[u[0]].collective[cat] += v - m0[cat]
                    continue
                rec = record(lambda: body(u), u[0])
                seen[key] = (u[0], rec, moves(u))
                merge(rec, u[0], u[0])
            if kind == "train":
                counter.reset()
                for leaf in params.values():
                    step_cost.on_replica_sum(leaf)
                for p, c in counter.costs.items():
                    totals[p].add(c)
                # AdamW on position 0's blocks; every position holds one
                # block of each leaf, all of one shape
                blk = lambda t, dt: torch.empty(t.shape, dtype=dt,
                                                device="meta")
                own = {n: leaf.blocks[next(iter(leaf.blocks))]
                       for n, leaf in params.items()}
                grads = {n: blk(b, f32) for n, b in own.items()}
                state = {"m": {n: blk(b, f32) for n, b in own.items()},
                         "v": {n: blk(b, f32) for n, b in own.items()},
                         "step": torch.empty((), dtype=i32, device="meta")}
                opt = {n: blk(b, b.dtype) for n, b in own.items()}
                costs, peaks = record(lambda: adamw_update(
                    AdamWConfig(), opt, grads, state, norm_of=grads), 0)
                for q in range(R * M):
                    for c in costs.values():
                        totals[q].add(c)
                    temps[q] = max(temps[q], max(peaks.values(), default=0))
        for q, t in enumerate(temps):
            per_position[q]["temp_size_in_bytes"] = t
        return StepCost(totals, counts)

    return Lowered(run, memory)


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict's leaves, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree
