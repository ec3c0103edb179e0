"""Unified model API (port of ``repro/models/api.py``): a config bound to
its family's implementation. The port serves the dense and vlm families
(``models/transformer.py``); the others (moe, encdec, hybrid, ssm) raise
``NotImplementedError`` (ROADMAP.md A10)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


class ModelApi:
    """Thin namespace binding a config to its family implementation."""

    def __init__(self, cfg: ModelConfig):
        transformer.check_supported(cfg)
        self.cfg = cfg

    # --- parameters ---
    def init(self, gen: torch.Generator, device=None):
        """The model's module on ``device`` (default: ``gen``'s device),
        parameters drawn from ``gen``."""
        return transformer.init(self.cfg, gen,
                                gen.device if device is None else device)

    # --- steps ---
    def prefill(self, model, batch, cache_len=None):
        return transformer.prefill(self.cfg, model, batch, cache_len)

    def decode_step(self, model, cache, token, pos):
        return transformer.decode_step(self.cfg, model, cache, token, pos)

    def init_cache(self, batch: int, seq_len: int, device="cuda"):
        return transformer.init_cache(self.cfg, batch, seq_len, device)


def get_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg)
