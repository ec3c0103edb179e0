"""Serving on a mesh (``launch.steps.build_prefill_step`` /
``build_serve_step``), the expert-parallel MoE dispatch
(``models.moe._apply_moe_sharded``) and the GPipe pipeline
(``distributed.pipeline``) on meshes of "cpu" devices, against the JAX
package.

Prefill and greedy decode on a (2, 2) mesh are held to the reference's
one-device prefill and decode (``test_torch_lm._reference_run``): the
tokens equal, the logits within 2e-3 (the reference's own decode
tolerance, ``tests/test_models.py:76``). The reference's mesh programs
need a device a position: ONE subprocess with
``--xla_force_host_platform_device_count=8`` runs its
``_apply_moe_sharded`` on a (2, 4) mesh at ``capacity_factor=1.25``
(where tokens drop), its ``build_pipeline_forward`` on (1, 4), its
train step for mixtral's smoke config on (2, 2) under "tp" and "fsdp"
(a data row is one capacity pool there, as in the port) with the
step's gradients before the update, and its ``build_prefill_step`` and
``build_serve_step`` for mixtral on (2, 4) (the prefill
expert-parallel a data row, the decode local over the global batch:
its serve step sets no mesh), and writes its outputs for the tests
below (~40 s)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.distributed import make_mesh
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.pipeline import build_pipeline_forward
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      shard_params)
from repro_torch.models import get_model, moe
from repro_torch.serve.engine import cache_len
from test_torch_lm import _batch, _reference_run, engine_run, ref_params
from test_torch_lm_recurrent import _frames
from test_torch_mesh_train import (LOSS_RTOL, NORM_RTOL, SEED,
                                   close_grads, close_params,
                                   port_mesh_step)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 2e-3
MOE_TOL = PIPE_TOL = 1e-5
B, S, STEPS = 4, 12, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape):
    n = int(np.prod(shape))
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * n)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------ prefill / decode ----------------------------

def mesh_generate(cfg, model, batch, steps, mesh_shape=(2, 2)):
    """The port's prefill and ``steps`` greedy decode steps through the
    mesh steps: (prefill logits, [step logits], [fed tokens], cache,
    the serve step's specs)."""
    mesh = cpu_mesh(mesh_shape)
    Bn, Sn = batch["tokens"].shape
    S_tot = Sn + cfg.vis_tokens
    T = cache_len(cfg, Sn, steps)
    pf, specs = build_prefill_step(cfg, mesh, ShapeConfig("p", Sn, Bn,
                                                          "prefill"))
    sv, sspecs = build_serve_step(cfg, mesh, ShapeConfig("d", T, Bn,
                                                          "decode"))
    params = shard_params(model, specs["p_sh"])
    lg, cache = pf(params, {k: torch.from_numpy(np.asarray(v))
                            for k, v in batch.items()}, T)
    first = lg.gather()
    tok = first.argmax(-1, keepdim=True)
    logits, toks = [], []
    for i in range(steps):
        toks.append(tok.numpy())
        lg, cache = sv(params, cache, tok, S_tot + i)
        logits.append(lg.gather())
        tok = logits[-1].argmax(-1, keepdim=True)
    return first, logits, toks, cache, sspecs


@pytest.mark.parametrize("arch", ["starcoder2-3b", "internvl2-76b",
                                  "whisper-medium", "recurrentgemma-9b",
                                  "rwkv6-1.6b"])
def test_mesh_prefill_and_decode_match_reference(arch):
    """Each non-MoE family on a (2, 2) mesh (one row a computing
    position) against the reference's one-device prefill and decode:
    greedy tokens equal, logits within 2e-3; every cache leaf laid out
    by ``cache_shardings`` at the decode shape."""
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    params = ref_params(jcfg, cfg, seed=SEED)
    model = get_model(cfg).init(torch.Generator().manual_seed(SEED), "cpu")
    batch = _frames(jcfg, _batch(jcfg, seed=31, b=B, s=S), 32)
    lg0, _, jlogits, _, jtoks = _reference_run(
        jcfg, params, batch, STEPS, S + cfg.vis_tokens + STEPS)
    first, logits, toks, cache, sspecs = mesh_generate(cfg, model, batch,
                                                       STEPS)
    np.testing.assert_allclose(_np(first), lg0, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for got, want, t, jt in zip(logits, jlogits, toks, jtoks):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_allclose(_np(got), want, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)

    def check(tree, sh):
        for k, v in tree.items():
            if isinstance(v, dict):
                check(v, sh[k])
            else:
                assert tuple(v.sharding.spec) == tuple(sh[k].spec), k
    check(cache, sspecs["c_sh"])


def _moe_probe():
    """Count the dispatches ``apply_moe`` takes until ``restore()``."""
    calls = {"sharded": 0, "local": 0}
    orig = moe._apply_moe_sharded, moe._apply_moe_local

    def wrap(kind, fn):
        def probe(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return probe
    moe._apply_moe_sharded = wrap("sharded", orig[0])
    moe._apply_moe_local = wrap("local", orig[1])
    calls["restore"] = lambda: (setattr(moe, "_apply_moe_sharded", orig[0]),
                                setattr(moe, "_apply_moe_local", orig[1]))
    return calls


def test_mesh_moe_serving_on_a_data_row_matches_reference():
    """mixtral's smoke config on a (1, 4) mesh (one data row: the
    expert-parallel prefill over the whole batch, the reference's
    one-device capacity pool; the decode local over the batch, as the
    reference's serve step) against the reference engine's run (its
    window's ring: the cache ``serve.engine.cache_len`` long): each
    prefill MoE layer takes ``_apply_moe_sharded``, each decode one
    ``_apply_moe_local``."""
    arch = "mixtral-8x7b"
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    params = ref_params(jcfg, cfg, seed=SEED)
    model = get_model(cfg).init(torch.Generator().manual_seed(SEED), "cpu")
    batch = _batch(jcfg, seed=33, b=B, s=S)
    _, lg0, _, jlogits, _, jtoks = engine_run(jcfg, params, batch, STEPS)
    calls = _moe_probe()
    try:
        first, logits, toks, _, _ = mesh_generate(cfg, model, batch, STEPS,
                                                  (1, 4))
    finally:
        calls["restore"]()
    assert calls["sharded"] == cfg.n_layers
    assert calls["local"] == cfg.n_layers * STEPS
    np.testing.assert_allclose(_np(first), lg0, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for got, want, t, jt in zip(logits, jlogits, toks, jtoks):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_allclose(_np(got), want, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_mesh_moe_serving_on_two_data_rows_matches_reference_mesh(
        reference):
    """mixtral's smoke config on a (2, 4) mesh against the reference's
    ``build_prefill_step`` and ``build_serve_step`` on its (2, 4) mesh:
    the prefill dispatches expert-parallel, one capacity pool a data
    row, in both (two ``_apply_moe_sharded`` calls a layer); each decode
    step dispatches locally over the whole batch in both (one
    ``_apply_moe_local`` a layer, on one computing unit). Greedy tokens
    equal, logits within 2e-3."""
    inp, out = reference
    cfg = get_smoke_config("mixtral-8x7b")
    model = get_model(cfg).init(torch.Generator().manual_seed(SEED), "cpu")
    calls = _moe_probe()
    try:
        first, logits, toks, _, _ = mesh_generate(
            cfg, model, {"tokens": inp["serve/tokens"]}, STEPS, (2, 4))
    finally:
        calls["restore"]()
    assert calls["sharded"] == cfg.n_layers * 2
    assert calls["local"] == cfg.n_layers * STEPS
    np.testing.assert_allclose(_np(first), out["serve/prefill"],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for i, (got, t) in enumerate(zip(logits, toks)):
        np.testing.assert_array_equal(t, out[f"serve/tok{i}"])
        np.testing.assert_allclose(_np(got), out[f"serve/step{i}"],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


# ----------------------- the reference's mesh programs -----------------------

REFERENCE = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeConfig
    from repro.distributed import sharding as shd
    from repro.distributed.pipeline import build_pipeline_forward
    from repro.launch.steps import (build_prefill_step, build_serve_step,
                                    build_train_step, default_microbatches)
    from repro.models import get_model, moe as moe_mod
    from repro.serve.engine import _pad_cache_seq
    from repro.optim import adamw_init

    d = sys.argv[1]
    inp = dict(np.load(os.path.join(d, "in.npz")))
    out = {}
    mesh = lambda shape: jax.make_mesh(
        shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
        devices=jax.devices()[:int(np.prod(shape))])

    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    m24 = mesh((2, 4))
    p = {k: jnp.asarray(inp["moe/" + k])
         for k in ("router", "e_gate", "e_up", "e_down")}
    with shd.activation_rules({}, m24), m24:
        y, m = jax.jit(lambda p, x: moe_mod.apply_moe(
            cfg, p, x, capacity_factor=1.25))(p, jnp.asarray(inp["moe_x"]))
    out["moe_y"] = np.asarray(y)
    out["moe_dropped"] = np.asarray(m["dropped_frac"])
    out["moe_aux"] = np.asarray(m["aux_loss"])

    L = inp["pipe_w"].shape[0]
    layer_fn = lambda lp, x: jnp.tanh(x @ lp["w"])
    m14 = mesh((1, 4))
    with m14:
        out["pipe"] = np.asarray(jax.jit(build_pipeline_forward(
            m14, layer_fn, L))({"w": jnp.asarray(inp["pipe_w"])},
                               jnp.asarray(inp["pipe_x"])))

    def nest(prefix):
        tree = {}
        for k, v in inp.items():
            if k.startswith(prefix):
                node = tree
                *up, last = k[len(prefix):].split("/")
                for u in up:
                    node = node.setdefault(u, {})
                node[last] = jnp.asarray(v)
        return tree
    batch = {k: jnp.asarray(inp["batch/" + k]) for k in ("tokens", "labels")}
    B, S = batch["tokens"].shape
    flat = lambda tree: {"/".join(e.key for e in path): np.asarray(v)
                         for path, v in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    for profile in ("tp", "fsdp"):
        jcfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                                   shard_profile=profile)
        m22 = mesh((2, 2))
        shape = ShapeConfig("s", S, B, "train")
        step, specs = build_train_step(jcfg, m22, shape)
        # the step's gradients before its update: its microbatch body,
        # summed in f32 over the microbatches, over their number
        mb = default_microbatches(jcfg, shape, m22)
        arules = shd.act_rules(jcfg, m22, B // mb)
        api = get_model(jcfg)

        def one(p, b):
            with shd.activation_rules(arules, m22):
                return jax.grad(lambda q: api.loss(q, b)[0])(p)
        with m22:
            params = jax.device_put(nest("params/"), specs["p_sh"])
            gfn = jax.jit(one, in_shardings=(specs["p_sh"], None))
            n, acc = B // mb, None
            for i in range(mb):
                g = jax.tree.map(lambda x: np.asarray(x, np.float32), gfn(
                    params, {k: v[i * n:(i + 1) * n]
                             for k, v in batch.items()}))
                acc = g if acc is None else jax.tree.map(np.add, acc, g)
            grads = jax.tree.map(lambda a: a / np.float32(mb), acc)
            opt = jax.jit(adamw_init, out_shardings=specs["o_sh"])(params)
            params, _, met = step(params, opt, batch)
        out[f"train_{profile}/loss"] = np.asarray(met["loss"])
        out[f"train_{profile}/grad_norm"] = np.asarray(met["grad_norm"])
        for key, v in flat(params).items():
            out[f"train_{profile}/params/" + key] = v
        for key, v in flat(grads).items():
            out[f"train_{profile}/grads/" + key] = v

    # mixtral served on (2, 4): the reference's prefill and serve steps
    jcfg = get_smoke_config("mixtral-8x7b")
    toks = inp["serve/tokens"]
    Bs, Ss = toks.shape
    T, steps = int(inp["serve/T"]), int(inp["serve/steps"])
    pf, pspecs = build_prefill_step(jcfg, m24,
                                    ShapeConfig("p", Ss, Bs, "prefill"))
    sv, sspecs = build_serve_step(jcfg, m24,
                                  ShapeConfig("d", T, Bs, "decode"))
    with m24:
        params = jax.device_put(nest("params/"), pspecs["p_sh"])
        lg, cache = pf(params, {"tokens": jnp.asarray(toks)})
        cache = jax.device_put(_pad_cache_seq(jcfg, params, cache, T),
                               sspecs["c_sh"])
        out["serve/prefill"] = np.asarray(lg)
        tok = np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)
        for i in range(steps):
            out[f"serve/tok{i}"] = tok
            lg, cache = sv(params, cache, jnp.asarray(tok),
                           jnp.int32(Ss + i))
            out[f"serve/step{i}"] = np.asarray(lg)
            tok = np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)
    np.savez(os.path.join(d, "out.npz"), **out)
    print("REFERENCE OK")
""")


def _moe_inputs():
    """qwen3-moe's smoke MoE (4 experts, top 2) at the port's seeded
    init, and x [4, 16, D] about one shared direction, so that the
    routing is skewed and tokens drop at 1.25."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    gen = torch.Generator().manual_seed(SEED)
    p = moe.MoE(cfg, gen, torch.float32, "cpu")
    rng = np.random.default_rng(41)
    x = (rng.standard_normal(cfg.d_model) * 4 + rng.standard_normal(
        (4, 16, cfg.d_model))).astype(np.float32)
    return cfg, p, x


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The one subprocess: its inputs (the MoE's, the pipeline's, and
    mixtral's smoke parameters and batch) and outputs."""
    d = tmp_path_factory.mktemp("reference_mesh")
    _, p, x = _moe_inputs()
    gen = np.random.default_rng(42)
    inp = {"moe_x": x, "pipe_w": (gen.standard_normal((8, 32, 32)) * 0.2)
           .astype(np.float32),
           "pipe_x": gen.standard_normal((6, 2, 4, 32)).astype(np.float32)}
    inp.update({f"moe/{n}": _np(t) for n, t in p.named_parameters()})
    cfg = get_smoke_config("mixtral-8x7b")
    inp.update(_flat(ref_params(j_smoke("mixtral-8x7b"), cfg, seed=SEED),
                     "params/"))
    from test_torch_mesh_train import _batch as train_batch
    inp.update({f"batch/{k}": v for k, v in train_batch(cfg).items()})
    inp["serve/tokens"] = _batch(j_smoke("mixtral-8x7b"), seed=35, b=B,
                                 s=S)["tokens"]
    inp["serve/T"] = np.int64(cache_len(cfg, S, STEPS))
    inp["serve/steps"] = np.int64(STEPS)
    np.savez(d / "in.npz", **inp)
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(d)],
                         capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "JAX_PLATFORMS": "cpu"}, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "REFERENCE OK" in res.stdout
    return inp, dict(np.load(d / "out.npz"))


def test_moe_sharded_dispatch_matches_reference(reference):
    """``apply_moe`` on a (2, 4) mesh at capacity 1.25 (tokens drop), a
    call a data row (``_apply_moe_sharded``, as the mesh steps run it),
    the global batch cut into its two data rows: y within 1e-5
    of the reference's ``shard_map`` dispatch, ``dropped_frac`` and the
    aux loss (the first row's, as the reference's replicated outputs
    read the first device's) exactly equal; gradients flow back
    through the dispatch, finite."""
    _, out = reference
    cfg, p, x = _moe_inputs()
    p.requires_grad_(True)
    xt = torch.from_numpy(x)
    mesh = cpu_mesh((2, 4))
    ys, ms = [], []
    for r in range(2):       # the reference's bspec: ("data",), 2 rows
        with shd.activation_rules({}, mesh, row=r):
            yr, mr = moe.apply_moe(cfg, p, xt[2 * r:2 * r + 2],
                                   capacity_factor=1.25)
        ys.append(yr)
        ms.append(mr)
    y, m = torch.cat(ys), ms[0]
    np.testing.assert_allclose(_np(y), out["moe_y"], atol=MOE_TOL,
                               rtol=MOE_TOL)
    assert float(m["dropped_frac"]) == float(out["moe_dropped"]) > 0
    assert float(m["aux_loss"].detach()) == float(out["moe_aux"])
    y.square().sum().backward()
    gn = sum(float(q.grad.square().sum()) for q in p.parameters())
    assert np.isfinite(gn) and gn > 0
    # each data row is the local dispatch over that row's tokens
    for r in range(2):
        with torch.no_grad():
            yl, ml = moe._apply_moe_local(cfg, p, xt[2 * r:2 * r + 2],
                                          capacity_factor=1.25)
        np.testing.assert_allclose(_np(yl), out["moe_y"][2 * r:2 * r + 2],
                                   atol=MOE_TOL, rtol=MOE_TOL)


def test_pipeline_matches_reference(reference):
    """``build_pipeline_forward`` on a (1, 4) mesh: the reference's
    pipelined output within 1e-5, and the sequential forward's."""
    inp, out = reference
    w, xs = torch.from_numpy(inp["pipe_w"]), torch.from_numpy(inp["pipe_x"])
    layer_fn = lambda lp, x: torch.tanh(x @ lp["w"])
    got = build_pipeline_forward(cpu_mesh((1, 4)), layer_fn, 8)({"w": w}, xs)
    np.testing.assert_allclose(_np(got), out["pipe"], atol=PIPE_TOL,
                               rtol=PIPE_TOL)
    h = xs
    for l in range(8):
        h = layer_fn({"w": w[l]}, h)
    np.testing.assert_allclose(_np(got), _np(h), atol=PIPE_TOL, rtol=0)
    with pytest.raises(AssertionError):
        build_pipeline_forward(cpu_mesh((1, 3)), layer_fn, 8)


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
def test_moe_mesh_train_step_matches_reference_mesh(reference, profile):
    """mixtral's smoke config, one train step on a (2, 2) mesh against
    the reference's step on its (2, 2) mesh (each data row its own
    capacity pool in both): the loss and the gradient norm to rtol
    1e-5, every gradient leaf (before the update) and every parameter
    after the step within 1e-4 of the reference leaf's largest."""
    _, out = reference
    m, tree, _, _, _, grads = port_mesh_step("mixtral-8x7b", profile,
                                             (2, 2))
    np.testing.assert_allclose(m["loss"], out[f"train_{profile}/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"],
                               out[f"train_{profile}/grad_norm"],
                               rtol=NORM_RTOL)

    def nested(prefix):
        want = {}
        for k, v in out.items():
            if k.startswith(prefix):
                node = want
                *up, last = k[len(prefix):].split("/")
                for u in up:
                    node = node.setdefault(u, {})
                node[last] = v
        return want
    close_grads(grads, nested(f"train_{profile}/grads/"))
    close_params(tree, nested(f"train_{profile}/params/"))


def test_long_context_example_on_cpu(tmp_path):
    """``examples/long_context_decode_torch.py --device cpu``: retrieval
    decode agrees with exact decode on every greedy token of the
    reference example's run (48 of 48 there too), and the long_500k
    arithmetic is the reference's."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" /
                             "long_context_decode_torch.py"),
         "--device", "cpu"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "agreement over 48 steps (topk=512/2048 cache): 48/48" in \
        out.stdout
    assert "-> 14.2x less HBM" in out.stdout
