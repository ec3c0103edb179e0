"""The training step (port of the one-card part of
``repro/launch/steps.py``): ``default_microbatches`` and
``build_train_step``.

The reference jits the step with the mesh's shardings; the port runs it
eagerly on the model's device. A mesh (the reference's shardings, the
serving steps and ``lower_step``) waits for ROADMAP.md A10d."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig, adamw_update


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(f"{what}: a mesh waits for the mesh port "
                                  "(ROADMAP.md A10d); pass mesh=None")


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                         mesh=None) -> int:
    """Gradient-accumulation depth: keep the live activations roughly
    constant across model widths (``max(4, d_model // 2048)``, doubled
    from 1 while it divides the global batch), 1 for the "fsdp"
    profile. On one card the batch axes have size 1."""
    _no_mesh(mesh, "default_microbatches")
    if getattr(cfg, "shard_profile", "tp") == "fsdp":
        return 1
    want = max(4, cfg.d_model // 2048)
    mb = 1
    while mb < want and shape.global_batch % (mb * 2) == 0:
        mb *= 2
    return mb


def _rows(batch: Dict[str, Any], i: int, n: int) -> Dict[str, Any]:
    return {k: v[i * n:(i + 1) * n] for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     opt_cfg: AdamWConfig = AdamWConfig(),
                     microbatches: int = 0):
    """Returns (step, specs): ``step(model, opt_state, batch) -> (model,
    opt_state, metrics)`` runs ``api.loss`` and its backward over the
    microbatches, then ``adamw_update`` in place; ``specs`` holds the
    ``api`` and the ``microbatches`` (0: ``default_microbatches``).

    Microbatch i is rows [i * B / mb, (i + 1) * B / mb) of every batch
    entry. Each one's gradients come in the parameters' dtype and are
    summed in f32 buffers, one a parameter, then divided by mb, as the
    reference's scan sums them (bf16 ``.grad`` accumulation would round
    every partial sum); with mb == 1 they stay in the parameters'
    dtype. The metrics are the means over the microbatches of
    ``api.loss``'s, with ``adamw_update``'s "grad_norm" and "lr"."""
    _no_mesh(mesh, "build_train_step")
    api = get_model(cfg)
    mb = microbatches or default_microbatches(cfg, shape, mesh)
    if shape.global_batch % mb:
        raise ValueError(f"build_train_step: {mb} microbatches do not "
                         f"divide the global batch {shape.global_batch}")
    rows = shape.global_batch // mb

    def grads_of(params):
        out = {n: p.grad if p.grad is not None else torch.zeros_like(p)
               for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return out

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if mb == 1:
            loss, metrics = api.loss(model, batch)
            loss.backward()
            grads = grads_of(params)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()}
            ms = []
            for i in range(mb):
                loss, m = api.loss(model, _rows(batch, i, rows))
                loss.backward()
                for n, g in grads_of(params).items():
                    gsum[n] += g.to(torch.float32)
                ms.append({k: v.detach() for k, v in m.items()})
            grads = {n: g.div_(mb) for n, g in gsum.items()}
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        _, opt_state, om = adamw_update(opt_cfg, params, grads, opt_state)
        return model, opt_state, {**metrics, **om}

    return train_step, dict(api=api, microbatches=mb)
