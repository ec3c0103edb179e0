"""int8 block-quantized gradient compression (port of
``repro/optim/compression.py``): each leaf in blocks of 256 values, each
block's f32 scale its absmax / 127 (+ 1e-12), the values divided by it,
rounded half to even and clipped to +-127.

The reference's docstring says ``train/loop.py`` uses it for the
cross-pod all-reduce (``compress_dcn=True``); no such flag exists there
(ROADMAP.md C). The port's steps, on one card or on a mesh, do not use
it either: the reference's mesh step has no cross-pod all-reduce to
compress, and neither has the port's."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_BLOCK = 256


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.detach().to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale, shape, dtype) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:n].reshape(shape).to(dtype)


def compress_grads(grads: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """{name: tensor} -> {name: {"q": int8 [blocks, 256], "scale": f32
    [blocks, 1]}}."""
    return {k: dict(zip(("q", "scale"), _quantize(x)))
            for k, x in grads.items()}


def decompress_grads(comp: Dict[str, Dict], like: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """``compress_grads``' output back to ``like``'s shapes and dtypes."""
    return {k: _dequantize(comp[k]["q"], comp[k]["scale"], x.shape, x.dtype)
            for k, x in like.items()}
