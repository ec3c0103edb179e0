"""The port's optimizer, gradient compression, token pipeline and
checkpoints (``repro_torch.optim``, ``data.tokens.TokenPipeline``,
``checkpoint``) against the JAX package on the CPU.

AdamW runs the reference's formula element by element in f32, summed in
other orders by other libraries: f32 results to rtol 1e-6 plus 1e-6 of
the leaf's largest magnitude (the clip scale differs in its last bit,
and m = b1 m + (1 - b1) g cancels near 0); a bf16
parameter is the same f32 value rounded, so a 1-ulp difference in f32
may flip its rounding: bf16 parameters within one bf16 ulp (2^-8
relative), equal for all but a few elements (counted). Compression,
the pipeline and the checkpoint files are bit for bit."""
import json
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.data.tokens import TokenPipeline as JPipeline
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import compress_grads as j_compress
from repro.optim import cosine_lr as j_cosine_lr
from repro.optim import decompress_grads as j_decompress
from repro.optim.adamw import global_norm as j_global_norm
from repro_torch.checkpoint import (CheckpointManager, ckpt, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import get_model, to_reference
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_grads, cosine_lr, decompress_grads,
                               global_norm)
from repro_torch.train.loop import load_state, state_like, state_tree

SHAPES = {"a": (64, 48), "b": (300,), "c": (7, 5, 3), "d": (256,)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, dtype, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            .astype(dtype) for k, s in SHAPES.items()}


def _torch(a):
    """A numpy leaf (f32, or ml_dtypes bf16) as a CPU tensor."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_adamw_update_matches_reference(dtype):
    """Three steps of ``adamw_update`` (the first past warm-up's start,
    clipping on: the gradients' norm is above ``clip_norm``) on an f32
    and a bf16 tree: parameters, m, v, "grad_norm" and "lr" against the
    reference's; the update is in place and the step counter an int32
    scalar."""
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jp = _tree(rng, dtype)
    tp = {k: _torch(v) for k, v in jp.items()}
    jst = j_adamw_init(jp)
    tst = adamw_init(tp)
    ids = {k: id(v) for k, v in tp.items()}
    flips = 0
    for step in range(3):
        g = _tree(rng, dtype, scale=0.3)
        jp, jst, jm = j_adamw_update(JAdamWConfig(**cfg), jp, g, jst)
        _, tst, tm = adamw_update(AdamWConfig(**cfg), tp,
                                  {k: _torch(v) for k, v in g.items()}, tst)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for k in SHAPES:
            for name in ("m", "v"):
                _close(_np(tst[name][k]), _np(jst[name][k]))
            got, want = _np(tp[k]), _np(jp[k])
            if dtype == np.float32:
                _close(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
                flips += int((got != want).sum())
        assert int(tst["step"]) == int(jst["step"]) == step + 1
    assert tst["step"].dtype == torch.int32
    assert {k: id(v) for k, v in tp.items()} == ids
    assert flips <= 4, flips


def test_cosine_lr_and_global_norm_match_reference():
    """The schedule through warm-up, the cosine and past its end, and the
    global norm of an f32 and a bf16 tree."""
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    for step in (0, 1, 50, 99, 100, 101, 2_500, 9_999, 10_000, 20_000):
        np.testing.assert_allclose(
            float(cosine_lr(AdamWConfig(**cfg), step)),
            float(j_cosine_lr(JAdamWConfig(**cfg), jnp.int32(step))),
            rtol=1e-6, atol=1e-12)
    rng = np.random.default_rng(1)
    for dtype in (np.float32, ml_dtypes.bfloat16):
        t = _tree(rng, dtype)
        np.testing.assert_allclose(
            float(global_norm({k: _torch(v) for k, v in t.items()})),
            float(j_global_norm(t)), rtol=1e-6)


def test_compress_grads_bit_equal():
    """int8 codes and f32 block scales bit for bit the reference's (a
    padded last block, an all-zero block, ties rounded half to even, a
    bf16 leaf), and the decompressed leaves too."""
    rng = np.random.default_rng(2)
    g = _tree(rng, np.float32)
    g["d"][:] = 0.0
    g["a"][0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 127.0, -127.0,
                              63.5], np.float32)
    g["e"] = rng.standard_normal(513).astype(ml_dtypes.bfloat16)
    tg = {k: _torch(v) for k, v in g.items()}
    jc = j_compress(g)
    tc = compress_grads(tg)
    for k in g:
        assert np.array_equal(tc[k]["q"].numpy(), np.asarray(jc[k]["q"]))
        assert tc[k]["q"].dtype == torch.int8
        assert np.array_equal(tc[k]["scale"].numpy(),
                              np.asarray(jc[k]["scale"]))
    jd = j_decompress(jc, g)
    td = decompress_grads(tc, tg)
    for k in g:
        assert td[k].dtype == tg[k].dtype and td[k].shape == tg[k].shape
        assert np.array_equal(_np(td[k]), _np(jd[k]))


# ------------------------------- token pipeline -----------------------------

@pytest.mark.parametrize("arch,dtype,start", [
    ("starcoder2-3b", "float32", 0), ("whisper-medium", "float32", 3),
    ("internvl2-76b", "bfloat16", 5)])
def test_token_pipeline_bit_equal(arch, dtype, start):
    """Batches from step 0 and from a ``start_step``: the tokens, labels
    and frontend extras (cast to a bf16 config's dtype) bit for bit the
    reference pipeline's, at their steps."""
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    jcfg = j_smoke(arch).replace(dtype=dtype)
    mine = TokenPipeline(cfg, ShapeConfig("t", 16, 4, "train"), seed=9,
                         start_step=start, device="cpu")
    theirs = JPipeline(jcfg, JShape("t", 16, 4, "train"), seed=9,
                       start_step=start)
    try:
        for _ in range(3):
            (ts, tb), (js, jb) = next(mine), next(theirs)
            assert ts == js and mine.step == theirs.step
            assert set(tb) == set(jb)
            for k, want in jb.items():
                got = tb[k]
                assert got.device.type == "cpu"
                if dtype == "bfloat16" and k not in ("tokens", "labels"):
                    assert got.dtype == torch.bfloat16
                    assert np.array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
                else:
                    assert np.array_equal(got.numpy(), want)
    finally:
        mine.close()
        theirs.close()


# -------------------------------- checkpoints -------------------------------

def _state(cfg, seed=0):
    """A port model and an AdamW state after one made-up update."""
    model = get_model(cfg).init(torch.Generator().manual_seed(seed), "cpu")
    opt = adamw_init(model)
    grads = {n: torch.randn(p.shape, generator=torch.Generator()
                            .manual_seed(seed + 1)).to(p.dtype)
             for n, p in model.named_parameters()}
    adamw_update(AdamWConfig(lr=1e-2, warmup_steps=1), model, grads, opt)
    return model, opt


def _reference_tree(cfg, model, opt):
    """The same state as the reference holds it: numpy, bf16 leaves as
    ``ml_dtypes.bfloat16``."""
    as_ref = lambda t: jax.tree.map(
        lambda a: a.view(ml_dtypes.bfloat16) if a.dtype.kind == "V" else a,
        t)
    return {"params": as_ref(to_reference(cfg, model)),
            "opt": {"m": to_reference(cfg, opt["m"]),
                    "v": to_reference(cfg, opt["v"]),
                    "step": opt["step"].numpy()}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_files_equal_reference(tmp_path, dtype):
    """The port's checkpoint of a training state is file for file the
    reference's ``save_checkpoint`` of the same tree: the same names, the
    same manifest bytes, the same ``.npy`` bytes, bf16 leaves included
    ('<V2' and the raw bits)."""
    cfg = get_smoke_config("starcoder2-3b").replace(dtype=dtype)
    model, opt = _state(cfg)
    mine = save_checkpoint(tmp_path / "port", 7, state_tree(cfg, model, opt),
                           extra={"arch": cfg.name})
    theirs = j_save(tmp_path / "ref", 7, _reference_tree(cfg, model, opt),
                    extra={"arch": cfg.name})
    names = sorted(p.name for p in theirs.iterdir())
    assert sorted(p.name for p in mine.iterdir()) == names
    for n in names:
        assert (mine / n).read_bytes() == (theirs / n).read_bytes(), n
    man = json.loads((mine / "manifest.json").read_text())
    dtypes = {m["dtype"] for m in man["leaves"].values()}
    assert ("bfloat16" in dtypes) == (dtype == "bfloat16")
    assert man["leaves"]["opt/step"]["dtype"] == "int32"


def test_checkpoint_restores_across_packages(tmp_path):
    """f32 both ways (the reference restores the port's checkpoint, the
    port the reference's), the port restores the reference's bf16
    checkpoint bit for bit into a model and its AdamW state, and the
    reference's own bf16 restore fails (np.load gives void, which
    ``jnp.asarray`` refuses: a quirk of the reference, kept)."""
    cfg32 = get_smoke_config("rwkv6-1.6b")
    model, opt = _state(cfg32, seed=3)
    save_checkpoint(tmp_path / "p32", 2, state_tree(cfg32, model, opt))
    want = _reference_tree(cfg32, model, opt)
    got = j_restore(tmp_path / "p32", 2, want)
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                         jax.tree.leaves(want)):
        assert np.array_equal(np.asarray(a), b), p
    j_save(tmp_path / "r32", 2, want)
    back = get_model(cfg32).init(None, "cpu")
    opt2 = load_state(cfg32, back, restore_checkpoint(tmp_path / "r32", 2))
    for n, p in model.named_parameters():
        assert torch.equal(back.get_parameter(n), p), n
        assert torch.equal(opt2["m"][n], opt["m"][n])
        assert torch.equal(opt2["v"][n], opt["v"][n])
    assert int(opt2["step"]) == int(opt["step"]) == 1

    cfg16 = get_smoke_config("starcoder2-3b").replace(dtype="bfloat16")
    model, opt = _state(cfg16, seed=4)
    j_save(tmp_path / "r16", 5, _reference_tree(cfg16, model, opt))
    assert latest_step(tmp_path / "r16") == 5
    back = get_model(cfg16).init(None, "cpu")
    load_state(cfg16, back, restore_checkpoint(tmp_path / "r16", 5))
    for n, p in model.named_parameters():
        assert back.get_parameter(n).dtype == p.dtype
        assert torch.equal(back.get_parameter(n).view(torch.int16)
                           if p.dtype == torch.bfloat16 else
                           back.get_parameter(n),
                           p.view(torch.int16) if p.dtype == torch.bfloat16
                           else p), n
    with pytest.raises(TypeError, match="V2"):
        j_restore(tmp_path / "r16", 5, _reference_tree(cfg16, model, opt))


def test_checkpoint_manager_keeps_the_last(tmp_path):
    """Async saves with ``keep=2``: the last two steps stay, no temporary
    directory is left, and ``latest_step`` finds the newest."""
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3):
        mgr.save_async(step, {"w": torch.full((3,), float(step))},
                       extra={"s": step})
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002", "step_00000003"]
    assert latest_step(tmp_path) == 3
    assert torch.equal(restore_checkpoint(tmp_path, 3)["w"],
                       torch.full((3,), 3.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_async_checkpoint_holds_its_own_step(tmp_path, monkeypatch, dtype):
    """An async save is the state of the step it names, even when the
    next in-place ``adamw_update`` runs before the writer thread does
    (held here until then): the restored parameters, ``m``, ``v`` and
    ``step`` are step 1's, on the CPU, where a host array could share a
    tensor's memory. A tensor handed to ``save_async`` directly is
    copied too."""
    cfg = get_smoke_config("starcoder2-3b").replace(dtype=dtype)
    model, opt = _state(cfg)
    before = ({n: p.detach().clone() for n, p in model.named_parameters()},
              {n: t.clone() for n, t in opt["m"].items()},
              {n: t.clone() for n, t in opt["v"].items()})
    go = threading.Event()
    write = ckpt.save_checkpoint

    def held(*args, **kw):
        assert go.wait(60)
        return write(*args, **kw)
    monkeypatch.setattr(ckpt, "save_checkpoint", held)
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save_async(1, state_tree(cfg, model, opt))
    w = torch.zeros(4)
    mgr_w = CheckpointManager(tmp_path / "w")
    mgr_w.save_async(1, {"w": w})
    grads = {n: torch.ones(p.shape, dtype=p.dtype)
             for n, p in model.named_parameters()}
    adamw_update(AdamWConfig(lr=1e-2, warmup_steps=1), model, grads, opt)
    w.add_(1.0)
    go.set()
    mgr.wait()
    mgr_w.wait()
    assert int(opt["step"]) == 2
    back = get_model(cfg).init(None, "cpu")
    opt1 = load_state(cfg, back, restore_checkpoint(tmp_path, 1,
                                                    like=state_like(cfg)))
    assert int(opt1["step"]) == 1
    params, m, v = before
    moved = 0
    for n, p in back.named_parameters():
        assert torch.equal(p, params[n]), n
        assert torch.equal(opt1["m"][n], m[n]), n
        assert torch.equal(opt1["v"][n], v[n]), n
        moved += not torch.equal(model.get_parameter(n), params[n])
    assert moved > 0          # the step after the save did change them
    assert torch.equal(restore_checkpoint(tmp_path / "w", 1)["w"],
                       torch.zeros(4))


def test_restore_refuses_another_config(tmp_path):
    """``restore_checkpoint(..., like=state_like(cfg))`` refuses a
    checkpoint of another config (other shapes under the same keys)
    before reading a leaf, and ``load_state`` refuses a tree whose
    leaves do not fit the model (a shape, the moments' f32, a missing
    or a stray leaf)."""
    cfg = get_smoke_config("starcoder2-3b")
    model, opt = _state(cfg)
    save_checkpoint(tmp_path, 1, state_tree(cfg, model, opt))
    wider = cfg.replace(d_model=2 * cfg.d_model)
    with pytest.raises(ValueError, match="not \\["):
        restore_checkpoint(tmp_path, 1, like=state_like(wider))
    with pytest.raises(ValueError, match="keys"):
        restore_checkpoint(tmp_path, 1, like={"params": {}})
    tree = restore_checkpoint(tmp_path, 1, like=state_like(cfg))
    back = get_model(cfg).init(None, "cpu")
    load_state(cfg, back, tree)
    bad = dict(tree, opt=dict(tree["opt"], m=dict(
        tree["opt"]["m"], emb=tree["opt"]["m"]["emb"].double())))
    with pytest.raises(ValueError, match="float32"):
        load_state(cfg, back, bad)
    bad = dict(tree, params=dict(tree["params"], emb=tree["params"]["emb"][1:]))
    with pytest.raises(ValueError, match="emb"):
        load_state(cfg, back, bad)
    bad = dict(tree, params={k: v for k, v in tree["params"].items()
                             if k != "ln_f"})
    with pytest.raises(ValueError, match="no reference leaf"):
        load_state(cfg, back, bad)
    bad = dict(tree, params=dict(tree["params"], stray=torch.zeros(1)))
    with pytest.raises(ValueError, match="stray"):
        load_state(cfg, back, bad)
