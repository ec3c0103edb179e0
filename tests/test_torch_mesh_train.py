"""Training on a mesh (``launch.steps.build_train_step`` with a
``core.distributed.Mesh``, ``train.TrainLoop``, ``checkpoint``,
``distributed.fault.remesh``, ``data.tokens.TokenPipeline``) on meshes
of "cpu" devices, against the JAX package's one-device step.

The parameters start equal in both packages (the port's seeded init,
carried into the reference's tree by ``test_torch_lm.ref_params``); the
reference's step runs jitted on a (1, 1) mesh with Auto axes (its
``make_host_mesh`` has Explicit ones, which its
``with_sharding_constraint`` refuses under jax 0.9; ROADMAP.md C).
Tolerances, the CPU tests' own (``test_torch_train_loss.py``): the loss
and the gradient norm to rtol 1e-5; each gradient leaf (the step's
``specs["grads"]``, against the reference step's microbatch body:
``value_and_grad`` of its ``api.loss`` summed in f32 over the
microbatches) within 1e-4 of the reference leaf's largest magnitude +
1e-7; each parameter after the step the same (AdamW's first step moves
an element by about lr x the sign of its gradient, so that check alone
cannot see a wrong gradient: the gradients are held directly).

A data row of the mesh is one capacity pool of the expert-parallel MoE
dispatch, as in the reference's ``shard_map``: on a (1, 4) mesh that is
the whole microbatch, as on one device, so the MoE arch is held to the
one-device step there; on (2, 2) it is held to the reference's own
(2, 2) step (``test_torch_mesh_lm.py``, its one subprocess). On a (2, 3)
mesh mixtral's 8 experts do not divide "model": the reference dispatches
locally over the whole microbatch, and so does the port (one computing
unit), so it is held to the one-device step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.distributed import sharding as j_shd
from repro.launch.steps import build_train_step as j_build_train_step
from repro.launch.steps import default_microbatches as j_microbatches
from repro.models import get_model as j_get_model
from repro.optim import adamw_init as j_adamw_init
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.distributed import make_mesh
from repro_torch.data.tokens import TokenPipeline, synthetic_batch
from repro_torch.distributed.fault import remesh
from repro_torch.distributed.sharding import (NamedSharding, P, Sharded,
                                              gather_tree, param_shardings,
                                              shard_tree, tree_nbytes)
from repro_torch.launch.steps import (adamw_init_sharded, build_train_step,
                                      computing_units, shard_params)
from repro_torch.models import get_model, to_reference
from repro_torch.train import TrainLoop, TrainLoopConfig
from repro_torch.train.loop import load_state_sharded, state_like, \
    state_tree
from test_torch_lm import ref_params

SEQ, BATCH, SEED = 16, 8, 3
LOSS_RTOL = NORM_RTOL = 1e-5
PARAM_REL, PARAM_ABS = GRAD_REL, GRAD_ABS = 1e-4, 1e-7


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape, distinct=False):
    """A mesh of "cpu" repeated or, ``distinct``, of "cpu:0", "cpu:1" ...:
    devices that compare unequal, so each position stores its own copy
    of a replicated block, as on separate cards, and the step sums the
    copies' gradients."""
    n = int(np.prod(shape))
    devs = [f"cpu:{i}" for i in range(n)] if distinct else ["cpu"] * n
    return make_mesh(shape, ("data", "model"), devices=devs)


def auto_mesh():
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _batch(cfg):
    return synthetic_batch(SEED, 0, BATCH, SEQ, cfg.vocab)


_REF = {}


def reference_grads(jcfg, mesh, p_sh, params, batch, mb):
    """The reference train step's gradients before its update, as numpy:
    its microbatch body (``value_and_grad`` of ``api.loss`` under its
    activation rules on ``mesh``), summed in f32 over ``mb`` microbatches
    of the batch's rows in order, then divided by ``mb``."""
    api = j_get_model(jcfg)
    n = next(iter(batch.values())).shape[0] // mb
    arules = j_shd.act_rules(jcfg, mesh, n)

    def one(p, b):
        with j_shd.activation_rules(arules, mesh):
            return jax.grad(lambda q: api.loss(q, b)[0])(p)
    f = jax.jit(one, in_shardings=(p_sh, None))
    acc = None
    for i in range(mb):
        g = jax.tree.map(lambda x: np.asarray(x, np.float32), f(
            params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()}))
        acc = g if acc is None else jax.tree.map(np.add, acc, g)
    return jax.tree.map(lambda a: a / np.float32(mb), acc)


def reference_step(arch, profile):
    """(loss, grad_norm, the reference's parameters after one step, its
    gradients; numpy) of the reference's one-device step, from
    ``ref_params``, once a case."""
    if (arch, profile) not in _REF:
        cfg = get_smoke_config(arch).replace(shard_profile=profile)
        jcfg = dataclasses.replace(j_smoke(arch), shard_profile=profile)
        params = ref_params(jcfg, cfg, seed=SEED)
        mesh = auto_mesh()
        shape = JShape("s", SEQ, BATCH, "train")
        step, specs = j_build_train_step(jcfg, mesh, shape)
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        with mesh:
            p = jax.device_put(params, specs["p_sh"])
            grads = reference_grads(jcfg, mesh, specs["p_sh"], p, batch,
                                    j_microbatches(jcfg, shape, mesh))
            o = jax.jit(j_adamw_init, out_shardings=specs["o_sh"])(p)
            p, _, m = step(p, o, batch)
        _REF[(arch, profile)] = (float(m["loss"]), float(m["grad_norm"]),
                                 jax.tree.map(np.asarray, p), grads)
    return _REF[(arch, profile)]


def port_mesh_step(arch, profile, mesh_shape, distinct=False):
    """(metrics, the parameters after one mesh step as the reference's
    numpy tree, specs, the parameters, the optimizer state, the step's
    gradients as the reference's numpy tree) from the same seeded
    init."""
    cfg = get_smoke_config(arch).replace(shard_profile=profile)
    mesh = cpu_mesh(mesh_shape, distinct)
    shape = ShapeConfig("s", SEQ, BATCH, "train")
    step, specs = build_train_step(cfg, mesh, shape)
    model = get_model(cfg).init(torch.Generator().manual_seed(SEED), "cpu")
    params = shard_params(model, specs["p_sh"], requires_grad=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    grads, _ = specs["grads"](params, batch)
    gtree = to_reference(cfg, {n: g.gather() for n, g in grads.items()})
    params, opt, m = step(params, adamw_init_sharded(params), batch)
    with torch.no_grad():
        tree = to_reference(cfg, {n: leaf.gather()
                                  for n, leaf in params.items()})
    return {k: float(v) for k, v in m.items()}, tree, specs, params, opt, \
        gtree


def close_grads(got, want):
    """Each gradient leaf within ``GRAD_REL`` of the reference leaf's
    largest + ``GRAD_ABS``, and not all zero where the reference's is
    not."""
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        g = np.asarray(got[path], np.float32)
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale + GRAD_ABS, (path, err, scale)


def close_params(got, want):
    """Each leaf within ``PARAM_REL`` of its largest + ``PARAM_ABS``."""
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        err = float(np.abs(np.asarray(got[path], np.float32) - w).max())
        assert err <= PARAM_REL * float(np.abs(w).max()) + PARAM_ABS, \
            (path, err)


@pytest.mark.parametrize("arch,mesh_shape,profile", [
    ("starcoder2-3b", (2, 2), "tp"), ("starcoder2-3b", (1, 4), "tp"),
    ("starcoder2-3b", (2, 2), "fsdp"), ("starcoder2-3b", (1, 4), "fsdp"),
    ("mixtral-8x7b", (1, 4), "tp"), ("mixtral-8x7b", (1, 4), "fsdp"),
    ("mixtral-8x7b", (2, 3), "tp")])
def test_mesh_train_step_matches_reference(arch, mesh_shape, profile):
    """One mesh step against the reference's one-device step: the loss
    and the gradient norm to rtol 1e-5, every gradient leaf and every
    parameter after the step within 1e-4 of its leaf's largest; the
    microbatches are the reference's ``default_microbatches`` on this
    mesh; the stored bytes are one copy of the parameters and of m and
    v."""
    m, tree, specs, params, opt, grads = port_mesh_step(arch, profile,
                                                        mesh_shape)
    loss, gnorm, want, jgrads = reference_step(arch, profile)
    np.testing.assert_allclose(m["loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], gnorm, rtol=NORM_RTOL)
    close_grads(grads, jgrads)
    close_params(tree, want)
    assert specs["microbatches"] == (1 if profile == "fsdp" else 4)
    one = sum(t.numel() * t.element_size()
              for t in specs["a_params"].values())
    f32 = sum(t.numel() * 4 for t in specs["a_params"].values())
    assert tree_nbytes(params) == one
    assert tree_nbytes(opt["m"]) == tree_nbytes(opt["v"]) == f32
    for n, leaf in params.items():
        assert tuple(leaf.sharding.spec) == tuple(specs["p_sh"][n].spec)
    assert np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0


@pytest.mark.parametrize("arch,mesh_shape,profile", [
    ("starcoder2-3b", (2, 2), "tp"), ("starcoder2-3b", (2, 2), "fsdp"),
    ("mixtral-8x7b", (1, 4), "tp")])
def test_mesh_train_step_on_distinct_devices_matches_reference(
        arch, mesh_shape, profile):
    """The same step on a mesh of four distinct devices ("cpu:0" ...),
    where a replicated block is stored once a position and its gradient
    is the sum over the copies: the loss and the gradient norm to rtol
    1e-5, every gradient leaf and parameter within 1e-4 of its leaf's
    largest, and every stored copy of a block equal after the step (the
    "tp" rules replicate some blocks; "fsdp" shards every leaf of this
    config four ways)."""
    m, tree, _, params, opt, grads = port_mesh_step(arch, profile,
                                                    mesh_shape, True)
    loss, gnorm, want, jgrads = reference_step(arch, profile)
    np.testing.assert_allclose(m["loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"], gnorm, rtol=NORM_RTOL)
    close_grads(grads, jgrads)
    close_params(tree, want)
    copies = 0
    for tree_ in (params, opt["m"], opt["v"]):
        for n, leaf in tree_.items():
            first = {}
            for (idx, _), b in leaf.blocks.items():
                if idx in first:
                    copies += 1
                    assert torch.equal(first[idx], b), n
                first.setdefault(idx, b)
    assert copies > 0 or profile == "fsdp"   # fsdp shards every leaf here


def test_mesh_step_on_one_position_equals_one_card():
    """A (1, 1) mesh runs the one-card step's arithmetic: after one step
    (4 microbatches, f32 sums) every parameter and the loss equal the
    one-card path's bit for bit."""
    cfg = get_smoke_config("starcoder2-3b")
    shape = ShapeConfig("s", SEQ, BATCH, "train")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    model = get_model(cfg).init(torch.Generator().manual_seed(SEED), "cpu")
    params = shard_params(model, param_shardings(cfg, model,
                                                 cpu_mesh((1, 1))), True)
    step, _ = build_train_step(cfg, cpu_mesh((1, 1)), shape)
    params, _, m = step(params, adamw_init_sharded(params), batch)
    from repro_torch.optim import adamw_init
    model.requires_grad_(True)
    one, _ = build_train_step(cfg, None, shape)
    model, _, m1 = one(model, adamw_init(model), batch)
    assert float(m["loss"]) == float(m1["loss"])
    for n, p in model.named_parameters():
        assert torch.equal(params[n].gather(), p.detach()), n


def test_computing_units_split_rows_once():
    """Each row of a batch is computed by exactly one grid position: the
    data blocks' rows split over "model" (the first positions a row
    more), whole on a data row's first device for an expert-parallel
    MoE, replicated rows computed by the first grid row only; all rows
    one unit on the first device where the MoE pools the whole batch."""
    dense = get_smoke_config("starcoder2-3b")
    moe = get_smoke_config("mixtral-8x7b")
    mesh = cpu_mesh((2, 4))
    u = computing_units(dense, mesh, 8, "train")
    assert [(r, lo, hi) for _, r, lo, hi in u] == \
        [(0, 0, 1), (0, 1, 2), (0, 2, 3), (0, 3, 4), (1, 4, 5), (1, 5, 6),
         (1, 6, 7), (1, 7, 8)]
    u = computing_units(dense, mesh, 6, "prefill", offset=10)
    assert [(r, lo, hi) for _, r, lo, hi in u] == \
        [(0, 10, 11), (0, 11, 12), (0, 12, 13), (1, 13, 14), (1, 14, 15),
         (1, 15, 16)]
    assert [(r, lo, hi) for _, r, lo, hi in
            computing_units(dense, mesh, 3, "decode")] == \
        [(0, 0, 1), (0, 1, 2), (0, 2, 3)]
    assert [(r, lo, hi) for _, r, lo, hi in
            computing_units(moe, mesh, 8, "train")] == [(0, 0, 4), (1, 4, 8)]
    # one capacity pool: the MoE decode (the reference's serve step sets
    # no mesh), and any step where the experts do not divide "model"
    assert [(r, lo, hi) for _, r, lo, hi in
            computing_units(moe, mesh, 8, "decode")] == [(0, 0, 8)]
    assert [(r, lo, hi) for _, r, lo, hi in computing_units(
        moe, cpu_mesh((2, 3)), 8, "train", offset=8)] == [(0, 8, 16)]


def test_checkpoint_restores_across_mesh_shapes(tmp_path):
    """A tree saved from a (2, 4) mesh restores straight onto a (1, 4)
    mesh (``restore_checkpoint(..., shardings=)``), and ``remesh`` of
    the live tree too, bit for bit; the files are the global leaves."""
    t = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"w": t, "b": {"v": torch.arange(8, dtype=torch.bfloat16)}}
    m8, m4 = cpu_mesh((2, 4)), cpu_mesh((1, 4))
    sh = lambda m: {"w": NamedSharding(m, P("data", "model")),
                    "b": {"v": NamedSharding(m, P("model"))}}
    t8 = shard_tree(tree, sh(m8))
    save_checkpoint(tmp_path, 1, gather_tree(t8))
    t4 = restore_checkpoint(tmp_path, 1, like=tree, shardings=sh(m4))
    assert isinstance(t4["w"], Sharded) and len(t4["w"].blocks) == 4
    assert torch.equal(t4["w"].gather(), t)
    assert torch.equal(t4["b"]["v"].gather(), tree["b"]["v"])
    live = remesh(t8, sh(m4))
    assert torch.equal(live["w"].gather(), t)
    assert live["w"].sharding.mesh is m4


def test_train_state_restores_onto_another_mesh(tmp_path):
    """A mesh step's state (parameters, m, v, step) saved from (2, 2) in
    the reference's format and restored onto (1, 4) with
    ``load_state_sharded``, and ``remesh``ed live: every leaf bit for
    bit, laid out by the new mesh's specs."""
    _, _, specs, params, opt, _ = port_mesh_step("starcoder2-3b", "tp",
                                                 (2, 2))
    cfg = get_smoke_config("starcoder2-3b")
    save_checkpoint(tmp_path, 1, state_tree(cfg, params, opt))
    p_sh14 = param_shardings(cfg, specs["skeleton"], cpu_mesh((1, 4)))
    p14, o14 = load_state_sharded(
        cfg, restore_checkpoint(tmp_path, 1, like=state_like(cfg)), p_sh14)
    live = remesh(params, p_sh14)
    assert int(o14["step"]) == int(opt["step"]) == 1
    for n, leaf in params.items():
        want = leaf.gather().detach()
        assert torch.equal(p14[n].gather(), want), n
        assert torch.equal(live[n].gather(), want), n
        assert tuple(p14[n].sharding.spec) == tuple(p_sh14[n].spec)
        assert all(b.requires_grad for b in p14[n].blocks.values())
        for k in ("m", "v"):
            assert torch.equal(o14[k][n].gather(), opt[k][n].gather())


def test_token_pipeline_places_batch_blocks():
    """``TokenPipeline(shardings=batch_sharding)``: each batch entry a
    ``Sharded`` leaf by its spec, the global batch bit for bit."""
    cfg = get_smoke_config("internvl2-76b")
    mesh = cpu_mesh((2, 2))
    shape = ShapeConfig("s", SEQ, BATCH, "train")
    _, specs = build_train_step(cfg, mesh, shape)
    pipe = TokenPipeline(cfg, shape, seed=SEED, shardings=specs["b_sh"])
    try:
        step, batch = next(pipe)
    finally:
        pipe.close()
    from repro_torch.data.tokens import batch_extras_for
    want = synthetic_batch(SEED, 0, BATCH, SEQ, cfg.vocab,
                           extras=batch_extras_for(cfg))
    assert step == 0 and set(batch) == set(want) == set(specs["b_sh"])
    for k, leaf in batch.items():
        assert tuple(leaf.sharding.spec) == tuple(specs["b_sh"][k].spec)
        assert len(leaf.blocks) == 2
        assert torch.equal(leaf.gather(), torch.from_numpy(want[k]))


def test_mesh_train_loop_resumes_bit_equal(tmp_path):
    """``TrainLoop`` on a (2, 2) mesh: 6 straight steps against 3, a new
    loop resuming from the checkpoint, and 3 more: the losses after the
    restart and every final parameter bit for bit; the losses follow the
    one-card loop's within rtol 1e-5."""
    cfg = get_smoke_config("starcoder2-3b")
    shape = ShapeConfig("smoke", 32, 4, "train")
    mesh = cpu_mesh((2, 2))
    run = lambda steps, d, m=mesh: TrainLoop(
        cfg, shape, m, TrainLoopConfig(steps=steps, seed=SEED, ckpt_every=3,
                                       log_every=100, ckpt_dir=str(d)),
        device="cpu")
    straight = run(6, tmp_path / "a")
    straight.run()
    run(3, tmp_path / "b").run()
    resumed = run(6, tmp_path / "b")
    out = resumed.run()
    assert out["final_step"] == 6
    assert [m["loss"] for m in resumed.metrics_log] == \
        [m["loss"] for m in straight.metrics_log[3:]]
    for n, leaf in straight.model.items():
        assert torch.equal(resumed.model[n].gather(), leaf.gather()), n
    one = run(6, tmp_path / "c", None)
    one.run()
    np.testing.assert_allclose([m["loss"] for m in straight.metrics_log],
                               [m["loss"] for m in one.metrics_log],
                               rtol=LOSS_RTOL)
