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

The layouts and the step builders are here; ``lower_step`` and the
dry-run tools that read them wait for ROADMAP.md A10e."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding, P, Sharded
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
    grid = mesh.grid()
    if _pooled(cfg, mesh, kind):
        return [(grid[0, 0], 0, offset, offset + rows)]
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
                out.append((grid[r, m], r, a, e))
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
            for dev, r, lo, hi in computing_units(cfg, mesh, rows, "train",
                                                  i * rows):
                w = (hi - lo) / rows
                vals = gather(params, dev)
                rb = {k: _take(v, lo, hi, dev) for k, v in batch.items()}
                with shd.bound(skeleton, vals), \
                        shd.activation_rules(arules, mesh, row=r):
                    loss, m = api.loss(skeleton, rb)
                    loss.backward()
                del vals, loss
                for n, key, b in stored:
                    if b.grad is not None:
                        gsum[(n, key)].add_(b.grad.to(torch.float32),
                                            alpha=w)
                        b.grad = None
                for k, v in m.items():
                    v = v.detach().to(first) * w
                    msum[k] = v if k not in msum else msum[k] + v
        # copies of one block index on several devices: one sum, to each
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

    specs.update(a_opt=a_opt, o_sh=o_sh, microbatches=mb, grads=grads_of)
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

    def prefill_step(params, batch, cache_len=None):
        B = next(iter(batch.values())).shape[0]
        logits, cache = None, None
        for dev, r, lo, hi in computing_units(cfg, mesh, B, "prefill"):
            rb = {k: _take(v, lo, hi, dev) for k, v in batch.items()}
            with shd.bound(skeleton, gather(params, dev)), \
                    shd.activation_rules(arules, mesh, row=r):
                lg, c = api.prefill(skeleton, rb, cache_len)
            if cache is None:
                glob = _tree_map(lambda _, t: torch.empty(
                    (t.shape[0], B) + tuple(t.shape[2:]), dtype=t.dtype,
                    device="meta"), c)
                sh = cache_shardings(cfg, mesh, glob, B)
                cache = _tree_map(lambda p, t: Sharded.zeros(
                    _at(sh, p), t.shape, t.dtype), glob)
                logits = Sharded.zeros(lg_sh, (B,) + tuple(lg.shape[1:]),
                                       lg.dtype)
            _tree_map(lambda p, leaf: leaf.write(_at(c, p), {1: (lo, hi)}),
                      cache)
            logits.write(lg, {0: (lo, hi)})
        return logits, cache

    specs.update(a_cache=a_cache, c_sh=c_sh)
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

    def serve_step(params, cache, token, pos):
        p = int(pos)
        B = token.shape[0]
        logits = None
        for dev, _, lo, hi in computing_units(cfg, mesh, B, "decode"):
            mine = _tree_map(lambda _, s: s.gather(dev, {1: (lo, hi)}),
                             cache)
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
            if logits is None:
                logits = Sharded.zeros(lg_sh, (B,) + tuple(lg.shape[1:]),
                                       lg.dtype)
            logits.write(lg, {0: (lo, hi)})
        return logits, cache

    specs.update(a_cache=a_cache, c_sh=c_sh)
    return serve_step, specs

