"""LM models (port of ``repro/models``): every family (the decoder-only
transformer's dense, moe and vlm, whisper's encoder-decoder, the
recurrentgemma hybrid and rwkv6); ``from_reference``, which carries the
JAX package's parameter tree (as numpy arrays) into the port's module,
and ``to_reference``, its inverse for the parameters or any dict keyed
by parameter name (gradients, AdamW's moments)."""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.api import ModelApi, get_model

__all__ = ["ModelApi", "from_reference", "get_model", "to_reference"]

# each projection with a bias, and the reference's leaf for that bias
_BIAS_OF = {"wq": "bq", "wk": "bk", "wv": "bv", "w_up": "b_up",
            "w_down": "b_down"}


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _reference_path(model: nn.Module, name: str
                    ) -> Tuple[tuple, Optional[int], bool]:
    """The one map between the two layouts: the reference leaf of port
    parameter ``name``, as (its path, the block index along the stacked
    axis or None, whether the reference's array is the port's
    transpose: an ``x @ W`` matrix [in, out] against ``nn.Linear``'s
    [out, in]). A ``nn.Linear``'s bias is the reference's ``bq`` ...
    ``b_down`` leaf beside the matrix."""
    parts = name.split(".")
    index = None
    owner = model
    if isinstance(getattr(model, parts[0], None), nn.ModuleList):
        index = int(parts[1])
        owner = getattr(model, parts[0])[index]
        head, parts = (parts[0],), parts[2:]
    else:
        head = ()
    *mods, leaf = parts
    sub = owner.get_submodule(".".join(mods)) if mods else owner
    if isinstance(sub, nn.Linear):
        *above, lin = mods
        if leaf == "weight":
            return head + tuple(above) + (lin,), index, True
        return head + tuple(above) + (_BIAS_OF[lin],), index, False
    return head + tuple(parts), index, False


def named_from_reference(cfg, tree: Dict, model: nn.Module = None,
                         device=None, dtype: torch.dtype = None
                         ) -> Dict[str, torch.Tensor]:
    """A reference-layout tree (numpy, with bf16 as bits or
    ``ml_dtypes.bfloat16``, or tensors) -> {port parameter name: tensor
    on ``device``} in the port's layout: ``to_reference``'s inverse.
    ``model`` (default: ``cfg``'s on the meta device) gives the names,
    shapes and dtypes; ``dtype`` overrides the dtype asked of every
    leaf (AdamW's f32 moments). Every leaf must land on a parameter of
    its shape and dtype, a stacked leaf stack one block a module, and
    every parameter receive one; anything else raises ``ValueError``."""
    skeleton = model if model is not None else \
        get_model(cfg).init(None, "meta")
    given = dict(_leaves(tree))
    out, leaves = {}, {}
    for name, p in skeleton.named_parameters():
        path, index, transpose = _reference_path(skeleton, name)
        if path not in given:
            raise ValueError(f"{cfg.name}: no reference leaf "
                             f"{'/'.join(path)} for {name}")
        if path not in leaves:      # a stacked leaf converts once
            a = given[path]
            t = a if isinstance(a, torch.Tensor) else _from_numpy(a)
            if index is not None and t.shape[0] != len(
                    getattr(skeleton, path[0])):
                raise ValueError(f"{cfg.name}: {'/'.join(path)} stacks "
                                 f"{t.shape[0]} blocks, the port's "
                                 f"{path[0]} {len(getattr(skeleton, path[0]))}")
            leaves[path] = t
        t = leaves[path]
        t = t[index] if index is not None else t
        t = t.T if transpose else t
        want = dtype if dtype is not None else p.dtype
        if t.shape != p.shape or t.dtype != want:
            raise ValueError(f"{cfg.name}: {name} is {tuple(p.shape)} "
                             f"{want}, the reference's leaf "
                             f"{tuple(t.shape)} {t.dtype}")
        out[name] = t.contiguous().to(device)
    stray = sorted("/".join(p) for p in set(given) - set(leaves))
    if stray:
        raise ValueError(f"{cfg.name}: no port parameter for {stray}")
    return out


def from_reference(cfg, params: Dict, device="cuda") -> nn.Module:
    """The port's module with the reference's parameters: ``params`` is
    ``repro.models.get_model(cfg).init(key)``'s tree with its leaves as
    numpy arrays (blocks stacked on axis 0 under ``layers``,
    ``enc_layers_p``, ``groups`` and ``trail``, whose port modules are
    ``nn.ModuleList``s; ``x @ W`` matrices [in, out], the port's
    ``nn.Linear`` weights their transposes; the other leaves, the MoE's
    router and experts among them, in the reference's layout), through
    ``named_from_reference`` and its checks."""
    model = get_model(cfg).init(None, device)
    with torch.no_grad():
        for name, t in named_from_reference(cfg, params, model).items():
            model.get_parameter(name).copy_(t)
    return model


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor as numpy: its bits, numpy's void dtype 'V2' (what
    ``np.load`` returns for the reference's bf16 leaves, which are
    ``ml_dtypes.bfloat16``; a ``.view`` carries them across)."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy() \
        .view(np.dtype("V2"))


def bits_bf16(a: np.ndarray) -> torch.Tensor:
    """``bf16_bits``' inverse: bf16 bits (any 2-byte dtype) -> a CPU bf16
    tensor."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host: bf16 as its bits (``bf16_bits``),
    every other dtype as itself. A CPU tensor's array shares its
    memory."""
    if t.dtype == torch.bfloat16:
        return bf16_bits(t)
    return t.detach().cpu().numpy()


def _put(tree: Dict, path: tuple, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def to_reference(cfg, tensors) -> Dict:
    """The reference's numpy tree of the port's module's parameters, or
    of any dict keyed by its parameter names (the gradients, AdamW's
    ``m`` and ``v``): ``from_reference``'s inverse. Blocks are stacked
    on axis 0 under ``layers``, ``enc_layers_p``, ``groups`` and
    ``trail``; ``nn.Linear`` weights become the reference's [in, out]
    matrices, their biases its ``bq`` ... ``b_down`` leaves; bf16 leaves
    keep their bits exactly (``to_numpy``). Each leaf is a new
    C-contiguous array on the host that shares no memory with the
    tensors, and stacking happens there, so a card's tensors need no
    device memory beyond one transposed block. Every parameter must be
    given once; anything else raises ``ValueError``."""
    if isinstance(tensors, nn.Module):
        skeleton, tensors = tensors, dict(tensors.named_parameters())
    else:
        skeleton = get_model(cfg).init(None, "meta")
    named = dict(skeleton.named_parameters())
    unknown = sorted(set(tensors) - set(named))
    if unknown:
        raise ValueError(f"to_reference: {unknown} is no parameter of "
                         f"{cfg.name}")
    missing = sorted(set(named) - set(tensors))
    if missing:
        raise ValueError(f"to_reference: no tensor for {missing}")
    groups: Dict[tuple, Dict[Optional[int], torch.Tensor]] = {}
    for name, t in tensors.items():
        path, index, transpose = _reference_path(skeleton, name)
        t = t.detach()
        groups.setdefault(path, {})[index] = t.T if transpose else t
    tree: Dict = {}
    for path, blocks in groups.items():
        if None in blocks:
            t = blocks[None]
            host = torch.empty(t.shape, dtype=t.dtype)
            host.copy_(t)
        else:
            t = blocks[0]
            host = torch.empty((len(blocks),) + tuple(t.shape),
                               dtype=t.dtype)
            for i, b in blocks.items():
                host[i].copy_(b)
        _put(tree, path, to_numpy(host))
    return tree


def reference_shapes(cfg) -> Dict:
    """The reference tree of ``cfg``'s parameters with each leaf its
    shape, a tuple (from the module on the meta device: nothing is
    allocated)."""
    skeleton = get_model(cfg).init(None, "meta")
    tree: Dict = {}
    for name, p in skeleton.named_parameters():
        path, index, transpose = _reference_path(skeleton, name)
        shape = tuple(p.shape[::-1]) if transpose else tuple(p.shape)
        if index is not None:
            shape = (len(getattr(skeleton, path[0])),) + shape
        _put(tree, path, shape)
    return tree


def _from_numpy(a) -> torch.Tensor:
    """A numpy leaf as a CPU tensor: bf16, as ``ml_dtypes.bfloat16``
    (which ``torch.from_numpy`` refuses) or as its bits ('V2'), exactly
    through ``bits_bf16``; a read-only array copied."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return bits_bf16(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())
