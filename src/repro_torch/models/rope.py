"""Rotary position embeddings and whisper's sinusoidal positions (port
of ``repro/models/rope.py``)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    """theta ** (-i / half) for i < half = head_dim // 2, in f32."""
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, Hd] (or [..., 1, H, Hd] at decode); positions: [...,
    S] integer. The half-split convention of the reference: the first
    and second halves of each head rotate as (x1, x2) pairs (not
    interleaved lanes); angles in f32 from the integer positions, the
    rotation in f32, cast back to x's dtype. theta <= 0: no rotation."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs   # [..., S, hd/2]
    ang = ang[..., None, :]                   # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None):
    """Whisper's [n, d] f32 table: sin of pos / 10000 ** (2i / d) in the
    even columns, cos in the odd ones."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, :(d + 1) // 2])
    return pe
