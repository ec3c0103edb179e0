"""The port's training step and loop (``launch.steps``, ``train.loop``,
``launch.train``, ``examples/train_lm_torch.py``) against the JAX
package on the CPU, and the serving path's refusal to build a graph.

The reference's ``TrainLoop`` cannot run on its own ``make_host_mesh()``
under jax 0.9.0 (Explicit axes against ``with_sharding_constraint``;
ROADMAP.md C), so the tests give it a (1, 1) mesh with Auto axes. Both
loops start from the same parameters: the port's seeded init, carried
into the reference's tree (``test_torch_lm.ref_params``).

Tolerance of the trajectory: AdamW's first updates are lr * m^ /
(sqrt(v^) + eps), about lr * sign(g) a parameter, so an element whose
gradient sits near 0 may step the other way in each package (the f32
gradients agree to ~1e-6 of each leaf, test_torch_train_loss.py): a
parameter then differs by up to 2 lr a step. Over 12 steps at lr <=
3.6e-5 that moves the loss by far less than 1e-5: rtol 1e-5 a step,
the same for the gradient norm (measured: LOSS_SEEN)."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as j_latest
from repro.checkpoint import restore_checkpoint as j_restore
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.launch.steps import default_microbatches as j_default_mb
from repro.optim import adamw_init as j_adamw_init
from repro.train.loop import TrainLoop as JTrainLoop
from repro.train.loop import TrainLoopConfig as JLoopConfig
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import build_train_step, default_microbatches
from repro_torch.models import get_model
from repro_torch.serve.engine import GenerationEngine
from repro_torch.train import TrainLoop, TrainLoopConfig
from test_torch_lm import ref_params

ROOT = Path(__file__).resolve().parents[1]
ARCH, SEQ, BATCH, SEED, STEPS = "starcoder2-3b", 32, 4, 5, 12
TRAJ_RTOL = 1e-5
# the largest relative differences seen on an x86 CPU: loss 1.6e-7,
# grad_norm 3.2e-7
LOSS_SEEN = (1.6e-7, 3.2e-7)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def auto_mesh():
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


class _SeededReferenceLoop(JTrainLoop):
    """The reference's loop from given parameters (numpy, the
    reference's tree) in place of its ``jax.random`` init."""

    def __init__(self, params, *args, **kw):
        super().__init__(*args, **kw)
        self._params = params

    def init_state(self):
        with self.mesh:
            params = jax.device_put(self._params, self.specs["p_sh"])
            opt = jax.jit(j_adamw_init,
                          out_shardings=self.specs["o_sh"])(params)
        return params, opt


def test_default_microbatches_match_reference():
    """The accumulation depth of every arch at every training shape and
    a few global batches, against the reference's on a one-device mesh
    (a "fsdp" arch takes 1), and on the port's (1, 1) host mesh too."""
    mesh = auto_mesh()
    for arch in ("starcoder2-3b", "llama3-405b", "qwen3-moe-235b-a22b",
                 "rwkv6-1.6b", "whisper-medium"):
        for gb in (1, 6, 8, 256):
            shape = dataclasses.replace(SHAPES["train_4k"], global_batch=gb)
            jshape = JShape(shape.name, shape.seq_len, gb, shape.kind)
            assert default_microbatches(get_config(arch), shape) == \
                j_default_mb(j_get_config(arch), jshape, mesh), (arch, gb)
    from repro_torch.launch.mesh import make_host_mesh
    assert default_microbatches(get_config(ARCH), SHAPES["train_4k"],
                                make_host_mesh(["cpu"])) == \
        j_default_mb(j_get_config(ARCH), JShape("train_4k", 4096, 256,
                                                "train"), mesh)


def test_train_loop_follows_reference(tmp_path):
    """12 steps of the port's ``TrainLoop`` against the reference's
    (starcoder2-3b smoke, seq 32, batch 4, seed 5, 4 microbatches of one
    row, a checkpoint at the last step): each step's loss and gradient
    norm within ``TRAJ_RTOL``, the learning rates equal to f32's
    rounding, and the reference restores the port's final checkpoint."""
    cfg, jcfg = get_smoke_config(ARCH), j_smoke(ARCH)
    shape = ShapeConfig("smoke", SEQ, BATCH, "train")
    mine = TrainLoop(cfg, shape, None,
                     TrainLoopConfig(steps=STEPS, seed=SEED, log_every=100,
                                     ckpt_dir=str(tmp_path / "port")),
                     device="cpu")
    out = mine.run()
    assert mine.specs["microbatches"] == 4
    theirs = _SeededReferenceLoop(
        ref_params(jcfg, cfg, seed=SEED), jcfg,
        JShape("smoke", SEQ, BATCH, "train"), auto_mesh(),
        JLoopConfig(steps=STEPS, seed=SEED, log_every=100,
                    ckpt_dir=str(tmp_path / "ref")))
    jout = theirs.run()
    assert out["final_step"] == jout["final_step"] == STEPS
    assert len(mine.metrics_log) == len(theirs.metrics_log) == STEPS
    seen = [0.0, 0.0]
    for a, b in zip(mine.metrics_log, theirs.metrics_log):
        assert a["step"] == b["step"]
        for i, k in enumerate(("loss", "grad_norm")):
            seen[i] = max(seen[i], abs(a[k] - b[k]) / abs(b[k]))
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=TRAJ_RTOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=TRAJ_RTOL)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    # the reference's restore reads the port's f32 checkpoint
    d = tmp_path / "port"
    assert j_latest(d) == STEPS
    got = j_restore(d, STEPS, {"params": theirs.specs["a_params"],
                               "opt": theirs.specs["a_opt"]})
    assert int(got["opt"]["step"]) == STEPS
    assert max(seen) <= TRAJ_RTOL, (seen, LOSS_SEEN)


def test_resume_is_bit_equal(tmp_path):
    """12 straight steps against 6, a new loop resuming from the
    checkpoint at step 6, and 6 more: every loss after the restart and
    every final parameter bit for bit."""
    cfg = get_smoke_config(ARCH)
    shape = ShapeConfig("smoke", SEQ, BATCH, "train")
    run = lambda steps, d: TrainLoop(
        cfg, shape, None, TrainLoopConfig(steps=steps, seed=SEED,
                                          ckpt_every=6, log_every=100,
                                          ckpt_dir=str(d)), device="cpu")
    straight = run(STEPS, tmp_path / "a")
    straight.run()
    run(6, tmp_path / "b").run()
    resumed = run(STEPS, tmp_path / "b")
    out = resumed.run()
    assert out["final_step"] == STEPS
    assert [m["step"] for m in resumed.metrics_log] == list(range(6, STEPS))
    assert [m["loss"] for m in resumed.metrics_log] == \
        [m["loss"] for m in straight.metrics_log[6:]]
    for (n, a), (_, b) in zip(resumed.model.named_parameters(),
                              straight.model.named_parameters()):
        assert torch.equal(a, b), n


def test_microbatched_step_sums_in_f32():
    """``build_train_step``: 2 microbatches give the mean of the two
    halves' losses, and the gradients their mean summed in f32 (checked
    against two single-microbatch backward passes); with mb = 1 the
    gradients stay in the parameters' dtype (bf16); a mesh that is not
    a ``core.distributed.Mesh`` is refused."""
    cfg = get_smoke_config(ARCH).replace(dtype="bfloat16")
    shape = ShapeConfig("t", 16, 4, "train")
    from repro_torch.data.tokens import synthetic_batch
    batch = synthetic_batch(1, 0, 4, 16, cfg.vocab)
    api = get_model(cfg)
    model = api.init(torch.Generator().manual_seed(0), "cpu") \
        .requires_grad_(True)
    want, losses = {}, []
    for i in range(2):
        half = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        loss, m = api.loss(model, half)
        loss.backward()
        for n, p in model.named_parameters():
            want[n] = want.get(n, 0) + p.grad.float()
            p.grad = None
        losses.append(float(m["loss"].detach()))
    seen = {}
    import repro_torch.launch.steps as steps_mod
    orig = steps_mod.adamw_update

    def spy(cfg_, params, grads, state):
        seen.update(grads)
        return orig(cfg_, params, grads, state)

    steps_mod.adamw_update = spy
    try:
        step, specs = build_train_step(cfg, None, shape, microbatches=2)
        from repro_torch.optim import adamw_init
        _, _, metrics = step(model, adamw_init(model), batch)
    finally:
        steps_mod.adamw_update = orig
    assert specs["microbatches"] == 2
    assert float(metrics["loss"]) == np.float32(np.mean(
        np.float32(losses)))
    for n, g in want.items():
        assert seen[n].dtype == torch.float32
        assert torch.equal(seen[n], g / 2), n
    assert all(p.grad is None for p in model.parameters())
    seen.clear()
    steps_mod.adamw_update = spy
    try:
        step, _ = build_train_step(cfg, None, shape, microbatches=1)
        step(model, adamw_init(model), batch)
    finally:
        steps_mod.adamw_update = orig
    assert all(g.dtype == torch.bfloat16 for n, g in seen.items()
               if model.get_parameter(n).dtype == torch.bfloat16)
    with pytest.raises(TypeError, match="Mesh"):
        build_train_step(cfg, object(), shape)


# ------------------------- serving a trained model --------------------------

def test_attention_ops_refuse_a_graph():
    """The attention kernels have no backward: both ops raise when grad
    mode is on and an input requires grad (on the card they would give
    an output with no ``grad_fn``), and run under ``torch.no_grad()``
    or on inputs that need none."""
    q = torch.randn(1, 4, 8, 16, requires_grad=True)
    k = torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q[:, :, 0], k, k, torch.tensor([8]))
    with torch.no_grad():
        ops.flash_attention(q, k, k)
        ops.decode_attention(q[:, :, 0], k, k, torch.tensor([8]))
    ops.flash_attention(q.detach(), k, k)


def test_train_loop_model_serves_the_same_tokens(tmp_path):
    """A ``TrainLoop``'s model (parameters requiring grad) served by
    ``GenerationEngine``: the same greedy tokens and logits as the same
    weights without grad, and the prefill builds no graph."""
    cfg = get_smoke_config(ARCH)
    loop = TrainLoop(cfg, ShapeConfig("smoke", SEQ, BATCH, "train"), None,
                     TrainLoopConfig(steps=2, log_every=100,
                                     ckpt_dir=str(tmp_path)), device="cpu")
    loop.run()
    model = loop.model
    assert all(p.requires_grad for p in model.parameters())
    frozen = get_model(cfg).init(None, "cpu")
    frozen.load_state_dict(model.state_dict())
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12),
                                     generator=torch.Generator()
                                     .manual_seed(0))}
    got = GenerationEngine(cfg, model, max_new=4, device="cpu") \
        .generate(batch)
    want = GenerationEngine(cfg, frozen, max_new=4, device="cpu") \
        .generate(batch)
    assert np.array_equal(got.tokens, want.tokens)
    assert np.array_equal(got.last_logits, want.last_logits)
    logits, _ = get_model(cfg).prefill(model, batch)
    assert logits.grad_fn is None and not logits.requires_grad


# ------------------------------ launcher, example ---------------------------

def test_launch_train_smoke_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch ... --smoke --device
    cpu``: 2 steps, then a relaunch to 3 resumes at step 2;
    ``--no-resume`` starts over."""
    argv = ["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    ap = launch_train.parser()
    out = launch_train.train(ap.parse_args(argv + ["--steps", "2"]))
    assert out["final_step"] == 2
    out = launch_train.train(ap.parse_args(argv + ["--steps", "3"]))
    assert out["final_step"] == 3
    assert "resumed from step 2" in capsys.readouterr().out
    out = launch_train.train(ap.parse_args(argv + ["--steps", "1",
                                                   "--no-resume"]))
    assert out["final_step"] == 1
    assert "resumed" not in capsys.readouterr().out


def test_example_kill_and_resume(tmp_path):
    """``examples/train_lm_torch.py --device cpu``: the resumed half's
    losses equal a straight run's (it exits 1 otherwise)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--steps", "4", "--device", "cpu"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "losses equal the straight run's" in out.stdout
