"""Pipeline parallelism, GPipe-style, over a mesh axis (port of
``repro/distributed/pipeline.py``).

Contiguous layer blocks sit on pipeline stages, one a device along
``axis`` ("model"), and microbatches stream through them. Schedule: the
classic GPipe loop with S stages and M microbatches runs S + M - 1
ticks; at tick t stage s holds microbatch t - s (when 0 <= t - s < M),
runs its layers on it, and hands the activations to stage s + 1. The
reference rotates one buffer a stage with ``ppermute`` inside a
``shard_map`` and masks the invalid ticks; the port's hop is ``.to()``
the next stage's device, and a stage with no valid microbatch at a
tick does no work (the reference computes it and throws it away).
Bubble overhead is the usual (S - 1) / (S + M - 1). Each stage's layers
count at its grid position and each hop as the sender's
collective-permute (``launch/step_cost.py``).

Offered, as in the reference, as machinery for experiments
(``build_pipeline_forward``), not wired into the archs' steps."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.launch import step_cost


def stage_layers(n_layers: int, n_stages: int) -> Tuple[int, ...]:
    """Contiguous layer counts per stage (front-loaded remainder)."""
    base = n_layers // n_stages
    rem = n_layers % n_stages
    return tuple(base + (1 if s < rem else 0) for s in range(n_stages))


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages + n_microbatches - 1)


def stage_devices(mesh, axis: str = "model") -> list:
    """The device of each stage: the mesh's devices along ``axis``, the
    other axes at their first position."""
    i = mesh.axis_names.index(axis)
    idx = [0] * len(mesh.axis_names)
    out = []
    for s in range(mesh.devices.shape[i]):
        idx[i] = s
        out.append(mesh.devices[tuple(idx)])
    return out


def build_pipeline_forward(mesh, layer_fn: Callable, n_layers: int, *,
                           axis: str = "model"):
    """Returns pipelined_forward(stacked_params, x_microbatches).

    layer_fn(layer_params, x) -> x          (one layer, pure)
    stacked_params: {name: tensor with a leading layer axis [L, ...]}
    x_microbatches: [M, B_mb, S, D]

    Stages = the mesh's size along ``axis``; stage s's layers
    [s L / S, (s + 1) L / S) are moved to its device (``stage_devices``)
    and run in order on each microbatch it holds. Returns the last
    stage's outputs [M, B_mb, S, D] after all layers, on its device."""
    devs = stage_devices(mesh, axis)
    n_stages = len(devs)
    i = mesh.axis_names.index(axis)
    pos = [step_cost.grid_index(mesh, {axis: s})
           for s in range(mesh.devices.shape[i])]   # each stage's position
    assert n_layers % n_stages == 0, (n_layers, n_stages)
    per_stage = n_layers // n_stages

    def pipelined_forward(stacked_params: Dict[str, torch.Tensor],
                          x_microbatches: torch.Tensor) -> torch.Tensor:
        M = x_microbatches.shape[0]
        local = [{k: v[s * per_stage:(s + 1) * per_stage].to(devs[s])
                  for k, v in stacked_params.items()}
                 for s in range(n_stages)]
        buf = [None] * n_stages          # the microbatch each stage holds
        outs = [None] * M
        for t in range(M + n_stages - 1):
            if t < M:                    # stage 0 ingests microbatch t
                buf[0] = x_microbatches[t].to(devs[0])
            for s in range(n_stages):
                if buf[s] is None:
                    continue
                h = buf[s]
                with step_cost.at(pos[s]):
                    for l in range(per_stage):
                        h = layer_fn({k: v[l] for k, v in local[s].items()},
                                     h)
                buf[s] = h
            if buf[-1] is not None:      # the last stage emits t - (S - 1)
                outs[t - (n_stages - 1)] = buf[-1]
            # boundary activations hop one stage right
            for s, b in enumerate(buf[:-1]):
                if b is not None:
                    with step_cost.at(pos[s]):
                        step_cost.moved("collective-permute",
                                        b.numel() * b.element_size())
            buf = [None] + [None if b is None else b.to(devs[s + 1])
                            for s, b in enumerate(buf[:-1])]
        return torch.stack(outs)

    return pipelined_forward
