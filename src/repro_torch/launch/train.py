"""Training launcher (port of ``repro/launch/train.py``), on the card
unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
      --smoke --steps 20 --device cpu

``--smoke`` trains the arch's reduced config at sequence 64, batch 8
on ``make_host_mesh``, a (1, 1) mesh of ``--device``; without it, the
full config at ``--shape`` (``train_4k``: 4,096 tokens, batch 256) on
``make_production_mesh()``, the reference's (16, 16) mesh of cards,
which raises where there are fewer. Relaunching with the same arguments
resumes from the latest checkpoint in ``--ckpt-dir`` (``--no-resume``
starts over)."""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config, get_shape, \
    get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import TrainLoop, TrainLoopConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config at sequence 64, batch 8")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def train(args) -> dict:
    """Build the ``TrainLoop`` the arguments describe and run it."""
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        shape = ShapeConfig("smoke", seq_len=64, global_batch=8, kind="train")
        mesh = make_host_mesh([args.device])
    else:
        cfg = get_config(args.arch)
        shape = get_shape(args.shape)
        mesh = make_production_mesh()
    loop = TrainLoop(
        cfg, shape, mesh,
        TrainLoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir, seed=args.seed,
                        microbatches=args.microbatches,
                        resume=not args.no_resume),
        AdamWConfig(lr=args.lr, total_steps=max(args.steps, 10)))
    out = loop.run()
    print(f"[train] done: {out}", flush=True)
    return out


if __name__ == "__main__":
    train(parser().parse_args())
