"""Generation engine (port of ``repro/serve/engine.py``): batched prefill
then ``max_new`` decode steps, greedy or with temperature sampling, for
every LM family.

The reference's prefill returns a cache of exactly the prompt and pads
its sequence axis to ``prompt + max_new`` before stepping (bounded by a
windowed arch's window; whisper's self cache, not its cross cache; the
hybrid's and rwkv6's states are fixed in size and never padded). The
port's prefill writes into a cache of that length from the start
(``cache_len``; the same values: the padding is zeros either way). For
retrieval-attention archs the engine then fills the inline low-dim keys
of the whole cache (the layout-(3) index, built at prefill time as the
paper builds its database before the search phase); their cache is
rounded up to a length the filter can partition
(``retrieval_cache_len``), where the reference's reshape would fail.
Whisper's ``frames`` go to the prefill with the tokens."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.models.retrieval_attention import (project_low,
                                                     retrieval_cache_len)


@dataclass
class GenerationResult:
    tokens: np.ndarray        # [B, max_new]
    steps: int
    prefill_s: float
    decode_s: float
    last_logits: Optional[np.ndarray] = None   # [B, V] f32, last step

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.size / max(self.decode_s, 1e-9)


def cache_len(cfg: ModelConfig, prompt: int, max_new: int) -> int:
    """The decode cache's length: prompt (with the vlm's patch tokens)
    plus ``max_new``, rounded up for a retrieval arch, at most a windowed
    arch's window (the ring buffer). The hybrid and ssm families' states
    are fixed in size, and their prefill does not read it."""
    total = prompt + (cfg.vis_tokens or 0) + max_new
    if cfg.retrieval.enabled:
        total = retrieval_cache_len(cfg, total)
    return min(total, cfg.window) if cfg.window else total


def low_keys(model, cache: dict) -> dict:
    """Add ``k_low`` [L, B, KV, T, d_low]: every layer's keys through its
    projection (zeros past the prompt project to zeros)."""
    cache["k_low"] = torch.stack([project_low(lp.attn, cache["k"][l])
                                  for l, lp in enumerate(model.layers)])
    return cache


class GenerationEngine:
    """``generate(batch)`` over ``model`` (the port's module, on
    ``device``): ``batch`` holds ``tokens`` [B, S] (and ``patches`` for
    vlm, ``frames`` for encdec) as numpy arrays or tensors. Greedy is
    argmax; temperature sampling draws from a ``torch.Generator`` seeded
    with ``seed`` (not ``jax.random``'s numbers)."""

    def __init__(self, cfg: ModelConfig, model, *, max_new: int = 32,
                 temperature: float = 0.0, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.api = get_model(cfg)
        self.device = next(model.parameters()).device
        if self.device.type != torch.device(device).type:
            raise ValueError(f"GenerationEngine: the model is on "
                             f"{self.device}, not on {device}")
        self.model = model
        self.max_new = max_new
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits):
        if self.temperature <= 0:
            return logits.argmax(-1, keepdim=True).to(torch.int32)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen
                                 ).to(torch.int32)

    @torch.no_grad()
    def generate(self, batch: Dict[str, Any]) -> GenerationResult:
        """Prefill, then ``max_new`` decode steps, building no graph even
        where the model's parameters require grad (a training loop's
        model serves the same tokens)."""
        B, S = batch["tokens"].shape
        t0 = time.monotonic()
        logits, cache = self.api.prefill(
            self.model, batch, cache_len(self.cfg, S, self.max_new))
        self._sync()
        t1 = time.monotonic()
        if self.cfg.retrieval.enabled:
            cache = low_keys(self.model, cache)
        out = []
        tok = self._sample(logits)
        pos = S + (self.cfg.vis_tokens or 0)
        for i in range(self.max_new):
            out.append(tok)
            logits, cache = self.api.decode_step(self.model, cache, tok,
                                                 pos + i)
            tok = self._sample(logits)
        self._sync()
        t2 = time.monotonic()
        return GenerationResult(
            tokens=torch.cat(out, dim=1).cpu().numpy(), steps=self.max_new,
            prefill_s=t1 - t0, decode_s=t2 - t1,
            last_logits=logits.cpu().numpy())
