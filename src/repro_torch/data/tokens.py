"""Synthetic LM tokens (port of ``repro/data/tokens.py``): seeded,
restart-deterministic, bit-equal to the reference (the same numpy
arithmetic). ``TokenPipeline`` waits for the training port (ROADMAP.md
A10)."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def synthetic_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                    *, extras: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """One global batch for ``step``. tokens/labels: [batch, seq] int32,
    Zipf-ish over the vocabulary; ``extras``: {name: (shape, dtype)} of
    standard-normal frontend inputs."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    u = rng.random((batch, seq + 1))
    toks = np.minimum((vocab * u ** 2.2).astype(np.int32), vocab - 1)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if extras:
        for name, (shape, dtype) in extras.items():
            out[name] = rng.standard_normal((batch,) + shape).astype(dtype)
    return out


def batch_extras_for(cfg) -> Dict:
    """Frontend-stub inputs per family: whisper's frames, a vlm's
    patch embeddings."""
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = ((cfg.enc_frames, cfg.d_model), np.float32)
    if cfg.vis_tokens:
        extras["patches"] = ((cfg.vis_tokens, cfg.d_model), np.float32)
    return extras
