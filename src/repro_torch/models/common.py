"""Shared model plumbing (port of ``repro/models/common.py``): the dtype
policy, parameter init on an explicit ``torch.Generator``, and parameter
counts.

The reference keeps parameters as nested dicts of arrays, stacked along a
leading layer axis and run under ``lax.scan`` with a remat policy. The
port keeps them in ``nn.Module``s whose attribute names are the
reference's leaf names, one module a layer in an ``nn.ModuleList``, and
loops over the layers in Python: ``scan_layers`` and remat do not carry
over (remat is training's business). ``models.from_reference`` carries a
reference parameter tree across.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn


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
