"""Unified model API (port of ``repro/models/api.py``): a config bound to
its family's implementation. Every family trains (``loss``) and serves
(``prefill``, ``decode_step``): dense, moe and vlm
(``models/transformer.py``), encdec (``encdec.py``, whisper), hybrid
(``hybrid.py``, recurrentgemma) and ssm (``ssm.py``, rwkv6).
``abstract_params``, ``abstract_cache`` and ``input_specs`` describe a
cell without allocating: tensors on the "meta" device (the step
builders' layouts read them, and ``launch.steps.lower_step`` lowers a
step from them)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
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

    def abstract_params(self) -> dict:
        """{parameter name: a tensor on the "meta" device of its shape
        and dtype}: nothing is allocated."""
        return dict(self.init(None, "meta").named_parameters())

    def buffers(self, device) -> dict:
        """The module's buffers (constant tables) on ``device``, by name:
        what a model on the "meta" device lacks to run elsewhere."""
        fn = getattr(self.mod, "buffers", None)
        return fn(self.cfg, device) if fn is not None else {}

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

    def abstract_cache(self, batch: int, seq_len: int) -> dict:
        """``init_cache``'s tree on the "meta" device."""
        return self.init_cache(batch, seq_len, device="meta")

    # --- dry-run input specs ---
    def input_specs(self, shape: ShapeConfig) -> dict:
        """The reference's input keys at ``shape``, each a "meta" tensor of
        its shape and dtype: train {"tokens", "labels"} [B, S] int32,
        prefill {"tokens"}, decode {"token"} [B, 1] and {"pos"} [] int32;
        whisper's ``frames`` and a vlm's ``patches`` in the config's
        dtype, but at decode."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        sds = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
        dt = getattr(torch, cfg.dtype)
        i32 = torch.int32
        if shape.kind == "train":
            specs = {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
        elif shape.kind == "prefill":
            specs = {"tokens": sds((B, S), i32)}
        else:  # decode: one new token against a seq_len cache
            specs = {"token": sds((B, 1), i32), "pos": sds((), i32)}
        if cfg.family == "encdec" and shape.kind != "decode":
            specs["frames"] = sds((B, cfg.enc_frames, cfg.d_model), dt)
        if cfg.vis_tokens and shape.kind != "decode":
            specs["patches"] = sds((B, cfg.vis_tokens, cfg.d_model), dt)
        return specs


def get_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg)
