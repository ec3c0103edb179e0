"""Unified model API (port of ``repro/models/api.py``): a config bound to
its family's implementation. Every family trains (``loss``) and serves
(``prefill``, ``decode_step``): dense, moe and vlm
(``models/transformer.py``), encdec (``encdec.py``, whisper), hybrid
(``hybrid.py``, recurrentgemma) and ssm (``ssm.py``, rwkv6). The
``input_specs`` of the reference's dry-run wait for ROADMAP.md A10d."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm, transformer

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "encdec": encdec,
    "hybrid": hybrid,
    "ssm": ssm,
}


class ModelApi:
    """Thin namespace binding a config to its family implementation."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.mod = _FAMILY_MODULES[cfg.family]

    # --- parameters ---
    def init(self, gen: torch.Generator, device=None):
        """The model's module on ``device`` (default: ``gen``'s device),
        parameters drawn from ``gen`` (None: left uninitialised)."""
        if device is None:
            device = gen.device
        return self.mod.init(self.cfg, gen, device)

    # --- steps ---
    def loss(self, model, batch):
        """(the loss to differentiate, a scalar f32 tensor; metrics
        {"loss": the mean NLL, and the MoE's "aux_loss" and
        "dropped_frac"}): ``batch`` holds ``tokens`` and ``labels`` [B,
        S] and the family's frontend inputs (``patches``, ``frames``)."""
        return self.mod.loss(self.cfg, model, batch)

    @torch.no_grad()
    def prefill(self, model, batch, cache_len=None):
        """(last-token logits [B, V] f32, cache); ``cache_len`` sizes the
        KV cache of the attention families (the recurrent states are
        fixed in size). Serving: no graph is built, whether or not the
        parameters require grad."""
        return self.mod.prefill(self.cfg, model, batch, cache_len)

    @torch.no_grad()
    def decode_step(self, model, cache, token, pos):
        return self.mod.decode_step(self.cfg, model, cache, token, pos)

    def init_cache(self, batch: int, seq_len: int, device="cuda"):
        return self.mod.init_cache(self.cfg, batch, seq_len, device)


def get_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg)
