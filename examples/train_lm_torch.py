"""End-to-end training with the kill-and-resume demo, on the PyTorch
port: train a reduced model, stop half way (a simulated failure),
restart from the checkpoint and check that the loss trajectory goes on
as one straight run's does.

    PYTHONPATH=src python examples/train_lm_torch.py [--arch starcoder2-3b]
        [--device cpu]
"""
import argparse
import shutil
import tempfile
from pathlib import Path

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import TrainLoop, TrainLoopConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    shape = ShapeConfig("smoke", seq_len=128, global_batch=8, kind="train")
    opt = AdamWConfig(lr=1e-3, total_steps=args.steps, warmup_steps=4)
    d = Path(tempfile.mkdtemp(prefix="repro_torch_train_"))
    run = lambda steps, ckpt: TrainLoop(
        cfg, shape, None, TrainLoopConfig(steps=steps, ckpt_every=10,
                                          ckpt_dir=str(ckpt), seed=1),
        opt, device=args.device)
    try:
        half = args.steps // 2
        print(f"=== phase 1: {half} steps, then a simulated failure ===")
        run(half, d / "resumed").run()
        print("=== phase 2: restart from the checkpoint, continue ===")
        resumed = run(args.steps, d / "resumed")
        out = resumed.run()
        print("=== the same steps in one straight run ===")
        straight = run(args.steps, d / "straight")
        straight.run()
        after = [m["loss"] for m in resumed.metrics_log]
        want = [m["loss"] for m in straight.metrics_log][half:]
        print(f"final loss {out['last_metrics']['loss']:.4f} at step "
              f"{out['final_step']}; the resumed steps' losses "
              f"{'equal' if after == want else 'DIFFER FROM'} the straight "
              "run's (the data pipeline is (seed, step)-deterministic)")
        if after != want:
            raise SystemExit(1)
    finally:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
