"""Training loop (port of ``repro/train/loop.py``): seeded init,
prefetched data, async checkpoints in the reference's format, restart,
straggler monitoring.

Restart contract: the data stream is a function of (seed, step) and the
optimizer state carries the step counter, so resuming is restoring the
latest checkpoint and starting the pipeline at its step. Kill the
process anywhere and relaunch it the same way: training continues bit
for bit (less what the last ``ckpt_every`` steps had not saved).

``mesh=None`` trains one model on ``device``; a
``core.distributed.Mesh`` trains the parameters and AdamW's moments as
``Sharded`` leaves laid out by the step's ``p_sh`` (drawn from the seed
exactly as on one card, then laid out), with each batch placed by
``b_sh``; a checkpoint is the same global tree either way, so a run
resumes on a mesh of any shape. The loop turns on gradients for its own
parameters only; serving's models stay without them."""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict

import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed.fault import StepMonitor
from repro_torch.distributed.sharding import Sharded
from repro_torch.launch.steps import (adamw_init_sharded, build_train_step,
                                      shard_params)
from repro_torch.models import (named_from_reference, reference_shapes,
                                to_numpy, to_reference)
from repro_torch.optim import AdamWConfig, adamw_init


@dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    seed: int = 0
    log_every: int = 10
    microbatches: int = 0          # 0 = auto
    resume: bool = True


@torch.no_grad()
def _global(tensors):
    """A module, a dict of tensors, or a dict of ``Sharded`` leaves (each
    gathered to the host as its global tensor)."""
    if isinstance(tensors, dict):
        return {n: t.gather(torch.device("cpu")) if isinstance(t, Sharded)
                else t for n, t in tensors.items()}
    return tensors


def state_tree(cfg, model, opt) -> Dict:
    """The checkpointed state in the reference's layout: {"params",
    "opt": {"m", "v", "step"}}, new numpy arrays on the host
    (``to_reference``: copied a block at a time, stacked on the host).
    ``model`` is the module or, on a mesh, {name: ``Sharded``}."""
    step = opt["step"].detach()
    return {"params": to_reference(cfg, _global(model)),
            "opt": {"m": to_reference(cfg, _global(opt["m"])),
                    "v": to_reference(cfg, _global(opt["v"])),
                    "step": to_numpy(step.to("cpu", copy=True))}}


def state_like(cfg) -> Dict:
    """``state_tree``'s keys and shapes, for ``restore_checkpoint``'s
    ``like``: a checkpoint of another config is refused before it is
    read."""
    shapes = reference_shapes(cfg)
    return {"params": shapes, "opt": {"m": shapes, "v": shapes,
                                      "step": ()}}


def load_state(cfg, model, tree) -> Dict:
    """``state_tree``'s inverse: copy the parameters into ``model`` and
    return the optimizer state on its device. Every leaf is checked
    (``named_from_reference``): the parameters in their dtypes, ``m``
    and ``v`` in f32."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        for name, t in named_from_reference(cfg, tree["params"],
                                            model).items():
            model.get_parameter(name).copy_(t)
    opt = tree["opt"]
    return {"m": named_from_reference(cfg, opt["m"], model, dev,
                                      torch.float32),
            "v": named_from_reference(cfg, opt["v"], model, dev,
                                      torch.float32),
            "step": opt["step"].to(device=dev, dtype=torch.int32)}


def load_state_sharded(cfg, tree, p_sh) -> tuple:
    """``load_state`` onto a mesh: (params, opt) as ``Sharded`` leaves
    laid out by ``p_sh`` (the parameters' blocks requiring grad), every
    leaf checked as there."""
    opt = tree["opt"]
    named = lambda t, dt=None: named_from_reference(cfg, t, None, "cpu", dt)
    params = shard_params(named(tree["params"]), p_sh, requires_grad=True)
    dev = next(iter(params.values())).device
    return params, {"m": shard_params(named(opt["m"], torch.float32), p_sh),
                    "v": shard_params(named(opt["v"], torch.float32), p_sh),
                    "step": opt["step"].to(device=dev, dtype=torch.int32)}


class TrainLoop:
    """``run()`` trains ``cfg`` at ``shape`` for ``loop_cfg.steps`` steps
    on ``device`` (``mesh=None``) or on ``mesh`` (whose first device
    draws the init), from the latest checkpoint in ``loop_cfg.ckpt_dir``
    when there is one (``resume``), else from the seeded init; returns
    {"final_step", "last_metrics", "straggler_events"}. ``metrics_log``
    keeps every step's metrics and wall time; ``model`` the trained
    module, or on a mesh its {name: ``Sharded``}."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                 loop_cfg: TrainLoopConfig = TrainLoopConfig(),
                 opt_cfg: AdamWConfig = AdamWConfig(), *, device="cuda"):
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.loop_cfg, self.opt_cfg = loop_cfg, opt_cfg
        self.device = torch.device(device) if mesh is None \
            else mesh.devices.flat[0]
        self.step_fn, self.specs = build_train_step(
            cfg, mesh, shape, opt_cfg, microbatches=loop_cfg.microbatches)
        self.monitor = StepMonitor()
        self.ckpt = CheckpointManager(Path(loop_cfg.ckpt_dir),
                                      keep=loop_cfg.keep)
        self.metrics_log: list = []
        self.model = None

    # ---- state ----
    def init_state(self):
        """(model, opt): the parameters drawn from a generator on the
        device seeded with ``loop_cfg.seed``, gradients on; on a mesh,
        the same draw on its first device, laid out by ``p_sh``."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.loop_cfg.seed)
        model = self.specs["api"].init(gen, self.device)
        if self.mesh is not None:
            params = shard_params(model, self.specs["p_sh"],
                                  requires_grad=True)
            return params, adamw_init_sharded(params)
        model.requires_grad_(True)
        return model, adamw_init(model)

    def try_restore(self):
        """(step, model, opt) from the latest checkpoint, or None."""
        step = latest_step(Path(self.loop_cfg.ckpt_dir))
        if step is None:
            return None
        tree = restore_checkpoint(Path(self.loop_cfg.ckpt_dir), step,
                                  like=state_like(self.cfg))
        if self.mesh is not None:
            return (step,) + load_state_sharded(self.cfg, tree,
                                                self.specs["p_sh"])
        model = self.specs["api"].init(None, self.device)
        opt = load_state(self.cfg, model, tree)
        return step, model.requires_grad_(True), opt

    # ---- main ----
    def run(self) -> Dict[str, Any]:
        lc = self.loop_cfg
        start = 0
        restored = self.try_restore() if lc.resume else None
        if restored is not None:
            start, model, opt = restored
            print(f"[train] resumed from step {start}", flush=True)
        else:
            model, opt = self.init_state()
        self.model = model
        pipe = TokenPipeline(self.cfg, self.shape, seed=lc.seed,
                             start_step=start, device=self.device,
                             shardings=self.specs.get("b_sh"))
        last_metrics: Dict[str, float] = {}
        try:
            for step, batch in pipe:
                if step >= lc.steps:
                    break
                t0 = time.monotonic()
                model, opt, metrics = self.step_fn(model, opt, batch)
                last_metrics = {k: float(v) for k, v in metrics.items()}
                wall = time.monotonic() - t0
                ev = self.monitor.heartbeat(step, wall)
                if ev.kind == "straggler":
                    print(f"[train] straggler step {step}: {ev.detail}",
                          flush=True)
                self.metrics_log.append({"step": step, "wall_s": wall,
                                         **last_metrics})
                if step % lc.log_every == 0:
                    print(f"[train] step {step} loss="
                          f"{last_metrics['loss']:.4f} gnorm="
                          f"{last_metrics.get('grad_norm', 0):.3f} "
                          f"{wall:.2f}s", flush=True)
                if (step + 1) % lc.ckpt_every == 0 or step + 1 == lc.steps:
                    self.ckpt.save_async(
                        step + 1, state_tree(self.cfg, model, opt),
                        extra={"arch": self.cfg.name})
        finally:
            pipe.close()
            self.ckpt.wait()
        return {"final_step": min(lc.steps, pipe.step),
                "last_metrics": last_metrics,
                "straggler_events": sum(
                    1 for e in self.monitor.events if e.kind == "straggler")}
