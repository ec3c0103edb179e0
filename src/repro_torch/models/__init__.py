"""LM models (port of ``repro/models``): every family (the decoder-only
transformer's dense, moe and vlm, whisper's encoder-decoder, the
recurrentgemma hybrid and rwkv6), and ``from_reference``, which carries
the JAX package's parameter tree (as numpy arrays) into the port's
module."""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.api import ModelApi, get_model

__all__ = ["ModelApi", "from_reference", "get_model"]

# the reference's bias leaves and the projection whose bias each is
_BIASES = {"bq": "wq", "bk": "wk", "bv": "wv", "b_up": "w_up",
           "b_down": "w_down"}


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _port_leaf(module: nn.Module, path: tuple) -> Tuple[str, bool]:
    """The port's parameter name for a reference leaf path below
    ``module``, and whether the reference's array is its transpose (an
    ``x @ W`` matrix [in, out] against ``nn.Linear``'s [out, in])."""
    *parents, name = path
    owner = module.get_submodule(".".join(parents)) if parents else module
    prefix = "".join(p + "." for p in parents)
    if name in _BIASES:
        return prefix + _BIASES[name] + ".bias", False
    if isinstance(getattr(owner, name, None), nn.Linear):
        return prefix + name + ".weight", True
    return prefix + name, False


def _tensor(a, transpose: bool) -> torch.Tensor:
    """A numpy leaf as a CPU tensor: bf16 (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) goes through f32, exactly."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    b = a.astype(np.float32) if bf16 else a
    t = torch.from_numpy(b if b.flags.writeable else b.copy())
    t = t.to(torch.bfloat16) if bf16 else t
    return t.T if transpose else t


def from_reference(cfg, params: Dict, device="cuda") -> nn.Module:
    """The port's module with the reference's parameters: ``params`` is
    ``repro.models.get_model(cfg).init(key)``'s tree with its leaves as
    numpy arrays (blocks stacked on axis 0 under ``layers``,
    ``enc_layers_p``, ``groups`` and ``trail``, whose port modules are
    ``nn.ModuleList``s; ``x @ W`` matrices [in, out], the port's
    ``nn.Linear`` weights their transposes; the other leaves, the MoE's
    router and experts among them, in the reference's layout). Every
    leaf must land on a port parameter of the same shape and dtype, and
    every port parameter must receive one; anything else raises
    ``ValueError``."""
    model = get_model(cfg).init(None, device)
    named = dict(model.named_parameters())
    filled = set()

    def put(name, a, transpose):
        if name not in named or name in filled:
            raise ValueError(f"from_reference: no port parameter for "
                             f"{name!r} (or it was given twice)")
        t = _tensor(a, transpose)
        p = named[name]
        if t.shape != p.shape or t.dtype != p.dtype:
            raise ValueError(f"from_reference: {name} is {tuple(p.shape)} "
                             f"{p.dtype}, the reference's leaf "
                             f"{tuple(t.shape)} {t.dtype}")
        p.copy_(t)
        filled.add(name)

    with torch.no_grad():
        for path, a in _leaves(params):
            stack = getattr(model, path[0], None)
            if isinstance(stack, nn.ModuleList):
                if np.shape(a)[0] != len(stack):
                    raise ValueError(f"from_reference: {'/'.join(path)} "
                                     f"stacks {np.shape(a)[0]} blocks, the "
                                     f"port's {path[0]} {len(stack)}")
                for i, block in enumerate(stack):
                    name, tr = _port_leaf(block, path[1:])
                    put(f"{path[0]}.{i}.{name}", np.asarray(a)[i], tr)
            else:
                name, tr = _port_leaf(model, path)
                put(name, a, tr)
    missing = sorted(set(named) - filled)
    if missing:
        raise ValueError(f"from_reference: no reference leaf for {missing}")
    return model
