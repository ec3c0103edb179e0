"""Shared model plumbing (port of ``repro/models/common.py``): the dtype
policy, parameter init on an explicit ``torch.Generator``, and parameter
counts.

The reference keeps parameters as nested dicts of arrays, stacked along a
leading layer axis and run under ``lax.scan`` with a remat policy. The
port keeps them in ``nn.Module``s whose attribute names are the
reference's leaf names, one module a layer in an ``nn.ModuleList``, and
loops over the layers in Python (``scan_layers``), the reference's remat
policies mapped onto ``torch.utils.checkpoint``. ``models.from_reference``
and ``models.to_reference`` carry a parameter tree across.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)


def dtype_of(cfg) -> torch.dtype:
    """The model's parameter and activation dtype (``cfg.dtype``)."""
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None, *, fan_in: int = None, scale: float = 1.0):
    """Normal(0, scale / sqrt(fan_in)) init of a weight ``shape`` (fan_in
    ``shape[1]`` unless given: the ``d_in`` of an [d_out, d_in] matrix),
    drawn in f32 on ``device`` from ``gen`` (a generator on that device)
    and cast to ``dtype``. The numbers are not ``jax.random``'s: a test
    carries the reference's parameters across instead. ``gen`` None
    leaves the tensor uninitialised (``models.from_reference`` fills
    it)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[1] if fan_in is None else fan_in
    std = scale / math.sqrt(max(fan_in, 1))
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return x.normal_(0.0, std, generator=gen).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32,
               device=None):
    """Normal(0, 0.02) init, as ``dense_init``."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return x.normal_(0.0, 0.02, generator=gen).to(dtype)


def linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool, dtype,
           device) -> nn.Linear:
    """An ``nn.Linear`` (weight [d_out, d_in], the reference's [d_in,
    d_out] matrix transposed) with ``dense_init`` weights over fan_in
    ``d_in`` and zero bias, made on ``device`` without PyTorch's own
    init (``gen`` None: the weight left uninitialised)."""
    lin = nn.Linear(d_in, d_out, bias=bias, device="meta", dtype=dtype)
    lin.weight = nn.Parameter(dense_init(gen, (d_out, d_in), dtype=dtype,
                                         device=device))
    if bias:
        lin.bias = nn.Parameter(torch.zeros(d_out, dtype=dtype,
                                            device=device))
    return lin


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def param_bytes(model: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def cast_tree(tree: Any, dtype):
    """Cast every floating tensor of a nested dict / list / tuple of
    tensors to ``dtype``, leaving integer tensors as they are; an
    ``nn.Module`` is cast in place (``module.to(dtype)`` casts only its
    floating parameters and buffers) and returned."""
    if isinstance(tree, nn.Module):
        return tree.to(dtype)
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree


def pos_tensor(pos, device):
    """The current decode position as a [1] int64 tensor on ``device``: an
    int is filled there (no copy from the host), a tensor moved as it
    is."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.long)
    return torch.full((1,), int(pos), dtype=torch.long, device=device)


def stack_zeros(one: dict, n: int, device) -> dict:
    """Zeros of each template's shape and dtype (a layer's cache or state,
    made on the "meta" device) with a leading axis of ``n`` layers, on
    ``device``."""
    return {k: torch.zeros((n,) + v.shape, dtype=v.dtype, device=device)
            for k, v in one.items()}


# ------------------------------- remat --------------------------------------

# the products "dots" keeps (jax's checkpoint_dots_with_no_batch_dims: the
# matrix products without batch dimensions, the linear layers; the
# batched ones, attention's and the experts', are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _ckpt(fn, *args, **kw):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def maybe_remat(fn: Callable, cfg) -> Callable:
    """``fn`` under the config's remat policy: "full" recomputes all of
    its forward in backward (``torch.utils.checkpoint``), "dots" keeps
    the outputs of its plain matrix products and recomputes the rest (a
    selective checkpoint), "none" keeps everything. The values do not
    depend on the policy."""
    mode = getattr(cfg, "remat", "none")
    if mode == "full":
        return functools.partial(_ckpt, fn)
    if mode == "dots":
        return functools.partial(_ckpt, fn, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return fn


def _sqrt_block(L: int) -> int:
    """Largest divisor of L that is <= ceil(sqrt(L))."""
    best = 1
    d = 1
    while d * d <= L:
        if L % d == 0:
            best = d
        d += 1
    return best


def _loop(body, carry, blocks) -> Tuple[Any, List]:
    ys = []
    for b in blocks:
        carry, y = body(carry, b)
        ys.append(y)
    return carry, ys


def scan_layers(cfg, body: Callable, carry, blocks) -> Tuple[Any, List]:
    """``carry, y = body(carry, block)`` over ``blocks`` (a module list)
    in order, under the config's remat policy (``maybe_remat``, a
    checkpoint a block): (the last carry, [y a block]). Under "full",
    stacks of 16 blocks or more also checkpoint groups of
    ``_sqrt_block(L)`` blocks (two levels, as the reference's: O(sqrt L)
    block inputs kept, at about one more forward). Without grad mode the
    blocks just run."""
    mode = getattr(cfg, "remat", "none")
    if mode == "none" or not torch.is_grad_enabled():
        return _loop(body, carry, blocks)
    cbody = maybe_remat(body, cfg)
    L = len(blocks)
    bs = _sqrt_block(L)
    if mode != "full" or L < 16 or bs == 1:
        return _loop(cbody, carry, blocks)
    blocks = list(blocks)
    ys = []
    for g in range(0, L, bs):
        carry, yg = _ckpt(_loop, cbody, carry, blocks[g:g + bs])
        ys.extend(yg)
    return carry, ys
