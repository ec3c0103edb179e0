"""The port's sharding rules and mesh tools (``repro_torch.distributed
.sharding``, ``launch.steps.cache_shardings`` / ``default_microbatches``,
``launch.mesh``, ``distributed.fault``, ``distributed.pipeline``'s
arithmetic, ``configs.all_cells``, ``ModelApi``'s abstract values)
against the JAX package's, without devices: the rules read only a
mesh's axis names and sizes, so both packages get the reference's own
FakeMesh trick (``tests/test_distributed.py``) at the production
shapes, as a ``jax.sharding.AbstractMesh`` (a mesh of names and sizes,
which the reference's ``NamedSharding`` accepts).

A port parameter is not a reference leaf (``nn.Linear`` weights are the
transposes, the layers are not stacked), so each port spec is mapped
back through ``models._reference_path`` before it is held to the
reference's spec of that leaf: the stack axis put back as None, a
transposed matrix's entries reversed."""
import dataclasses

import jax
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_cells as j_all_cells
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.distributed import fault as j_fault
from repro.distributed import pipeline as j_pipeline
from repro.distributed import sharding as j_shd
from repro.launch import steps as j_steps
from repro.models import get_model as j_get_model
from repro_torch.configs import ARCH_IDS, SHAPES, all_cells, get_config, \
    get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.distributed import make_mesh
from repro_torch.distributed import fault, pipeline
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding, P, Sharded
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import steps
from repro_torch.models import _reference_path, get_model


def fake_mesh(shape):
    """The reference test's stand-in: axis names and sizes, no devices."""
    names = ("pod", "data", "model")[-len(shape):]
    return jax.sharding.AbstractMesh(tuple(shape), names)


_REF_PARAMS, _SKELETONS = {}, {}


def ref_abstract_params(arch):
    """The reference's ``abstract_params`` (``jax.eval_shape`` of its
    init, ~1 s an arch), once an arch."""
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = j_get_model(j_get_config(arch)).abstract_params()
    return _REF_PARAMS[arch]


def skeleton(arch):
    """The port's model on the meta device, once an arch."""
    if arch not in _SKELETONS:
        _SKELETONS[arch] = get_model(get_config(arch)).init(None, "meta")
    return _SKELETONS[arch]


MESHES = {"16x16": (16, 16), "2x4": (2, 4), "pod": (2, 16, 16)}


def _ref_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _ref_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _jspec(s):
    return tuple(s)


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh, profile):
    """Every leaf of every arch: the port's spec, mapped back to the
    reference's layout, equals ``repro.distributed.sharding.param_specs``
    on the same FakeMesh, under both profiles."""
    cfg = get_config(arch).replace(shard_profile=profile)
    jcfg = dataclasses.replace(j_get_config(arch), shard_profile=profile)
    fm = fake_mesh(MESHES[mesh])
    want = dict(_ref_leaves(j_shd.param_specs(
        jcfg, ref_abstract_params(arch), fm)))
    model = skeleton(arch)
    got = shd.param_specs(cfg, model, fm)
    seen = set()
    for name, spec in got.items():
        path, index, transpose = _reference_path(model, name)
        spec = tuple(spec)[::-1] if transpose else tuple(spec)
        if index is not None:
            spec = (None,) + spec
        assert spec == _jspec(want[path]), (name, spec, want[path])
        seen.add(path)
    assert seen == set(want)


def test_param_specs_take_the_abstract_dict():
    """``param_specs`` of ``ModelApi.abstract_params()`` (meta tensors,
    nothing allocated) equals that of the meta module."""
    cfg = get_smoke_config("mixtral-8x7b")
    api = get_model(cfg)
    a = api.abstract_params()
    assert all(t.device.type == "meta" for t in a.values())
    fm = fake_mesh((2, 2))
    assert shd.param_specs(cfg, a, fm) == \
        shd.param_specs(cfg, api.init(None, "meta"), fm)


@pytest.mark.parametrize("mesh", list(MESHES) + ["1x1"])
def test_batch_act_cache_state_rules_equal_reference(mesh):
    """``batch_sharding`` (train / prefill / decode, both profiles, the
    vlm and encdec extras), ``act_rules``, ``cache_spec`` and
    ``state_spec`` over batches that divide the batch axes and that do
    not, against the reference's."""
    fm = fake_mesh(MESHES.get(mesh, (1, 1)))
    for arch in ("starcoder2-3b", "internvl2-76b", "whisper-medium"):
        for profile in ("tp", "fsdp"):
            cfg = get_config(arch).replace(shard_profile=profile)
            jcfg = dataclasses.replace(j_get_config(arch),
                                       shard_profile=profile)
            for gb in (1, 2, 6, 8, 32, 256, 512):
                for kind in ("train", "prefill", "decode"):
                    got = shd.batch_sharding(
                        cfg, fm, ShapeConfig("s", 64, gb, kind), kind)
                    want = j_shd.batch_sharding(
                        jcfg, fm, JShape("s", 64, gb, kind), kind)
                    assert {k: tuple(v.spec) for k, v in got.items()} == \
                        {k: tuple(v.spec) for k, v in want.items()}, \
                        (arch, profile, gb, kind)
                got = shd.act_rules(cfg, fm, gb)["act_btd"].spec
                want = j_shd.act_rules(jcfg, fm, gb)["act_btd"].spec
                assert tuple(got) == tuple(want), (arch, gb)
                assert tuple(shd.cache_spec(cfg, fm, gb, 4096)) == \
                    tuple(j_shd.cache_spec(jcfg, fm, gb, 4096))
                assert shd.state_spec(cfg, fm, gb) == \
                    j_shd.state_spec(jcfg, fm, gb)


def _port_cache_as_reference(tree):
    """The port's cache specs in the reference's layout: its attention
    leaves [L, B, KV, T, X] are the reference's [L, B, T, KV, X]."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _port_cache_as_reference(v)
            continue
        spec = tuple(v.spec)
        if k in steps._SEQ_LEAVES:
            spec = spec[:2] + (spec[3], spec[2]) + spec[4:]
        out[k] = spec
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_reference(arch):
    """Every family's cache leaves (``ModelApi.abstract_cache``: meta
    tensors) on three meshes at batches the batch axes divide and not
    (sequence over "model", or over the batch axes too): the port's
    ``cache_shardings`` equals the reference's, its KV leaves'
    sequence and head entries swapped back."""
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    api, japi = get_model(cfg), j_get_model(jcfg)
    for mesh in ((2, 4), (4, 2), (2, 2, 2)):
        fm = fake_mesh(mesh)
        for batch, seq in ((8, 64), (1, 64), (3, 24)):
            a = api.abstract_cache(batch, seq)
            assert all(t.device.type == "meta" for _, t in
                       _ref_leaves(a))
            got = _port_cache_as_reference(
                steps.cache_shardings(cfg, fm, a, batch))
            want = jax.tree.map(
                lambda s: tuple(s.spec), j_steps.cache_shardings(
                    jcfg, fm, japi.abstract_cache(batch, seq), batch),
                is_leaf=lambda s: hasattr(s, "spec"))
            assert got == want, (arch, mesh, batch)


def test_logits_sharding_equal_reference():
    for arch in ("starcoder2-3b", "whisper-medium"):
        for mesh in ((2, 4), (16, 16)):
            fm = fake_mesh(mesh)
            assert tuple(steps._logits_sharding(get_config(arch),
                                                fm).spec) == \
                tuple(j_steps._logits_sharding(j_get_config(arch), fm).spec)


def test_default_microbatches_equal_reference_on_meshes():
    """Every arch at every training shape and several global batches, on
    five mesh shapes, under both profiles."""
    for arch in ARCH_IDS:
        for profile in ("tp", "fsdp"):
            cfg = get_config(arch).replace(shard_profile=profile)
            jcfg = dataclasses.replace(j_get_config(arch),
                                       shard_profile=profile)
            for mesh in ((1, 1), (2, 2), (2, 4), (16, 16), (2, 16, 16)):
                fm = fake_mesh(mesh)
                for gb in (1, 4, 6, 8, 64, 256, 512):
                    shape = dataclasses.replace(SHAPES["train_4k"],
                                                global_batch=gb)
                    jshape = JShape(shape.name, shape.seq_len, gb, "train")
                    assert steps.default_microbatches(cfg, shape, fm) == \
                        j_steps.default_microbatches(jcfg, jshape, fm), \
                        (arch, profile, mesh, gb)


def test_all_cells_equal_reference():
    got = [(a, s.name, s.seq_len, s.global_batch, s.kind)
           for a, s in all_cells()]
    want = [(a, s.name, s.seq_len, s.global_batch, s.kind)
            for a, s in j_all_cells()]
    assert got == want and len(got) == 40
    assert set(SHAPES) == set(J_SHAPES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_cache_and_input_specs(arch):
    """``abstract_params`` holds one meta tensor a parameter, the port's
    names, shapes and dtypes (the reference's leaves through the layout
    map); ``input_specs`` the reference's keys, shapes and dtypes at
    every shape kind."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    api = get_model(cfg)
    a = api.abstract_params()
    want = dict(_ref_leaves(ref_abstract_params(arch)))
    for name, t in a.items():
        assert t.device.type == "meta"
        path, index, transpose = _reference_path(skeleton(arch), name)
        shape = tuple(t.shape)[::-1] if transpose else tuple(t.shape)
        w = want[path]
        assert shape == (w.shape[1:] if index is not None else w.shape)
        assert str(t.dtype).split(".")[-1] == str(w.dtype)
    for shape in SHAPES.values():
        got = api.input_specs(shape)
        exp = j_get_model(jcfg).input_specs(
            JShape(shape.name, shape.seq_len, shape.global_batch,
                   shape.kind))
        assert set(got) == set(exp), shape.name
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(exp[k].shape)
            assert str(got[k].dtype).split(".")[-1] == str(exp[k].dtype)


def test_fault_tools_equal_reference():
    """``GradSkipPolicy`` and ``healthy_mesh_shape`` as the reference's
    tests check them, and step for step against the reference's."""
    for planned, done, elapsed in ((8, 6, 100.0), (8, 2, 100.0),
                                   (8, 6, 1.0), (3, 1, 50.0)):
        a = fault.GradSkipPolicy(planned=planned)
        b = j_fault.GradSkipPolicy(planned=planned)
        for _ in range(done):
            a.complete()
            b.complete()
        assert a.should_skip_rest(elapsed, 10.0) == \
            b.should_skip_rest(elapsed, 10.0)
        assert a.renorm() == b.renorm()
        assert a.skipped_total == b.skipped_total
    assert fault.GradSkipPolicy(planned=8, completed=6).should_skip_rest(
        100.0, 10.0)
    assert not fault.GradSkipPolicy(planned=8, completed=2) \
        .should_skip_rest(100, 10)
    for n in (16, 64, 255, 256, 512):
        assert fault.healthy_mesh_shape(n) == j_fault.healthy_mesh_shape(n)
    assert fault.healthy_mesh_shape(8, model_parallel=4) == (2, 4)
    with pytest.raises(RuntimeError):
        fault.healthy_mesh_shape(15)


def test_pipeline_arithmetic_equal_reference():
    for L in (1, 7, 8, 30, 126):
        for S in (1, 2, 4, 16):
            assert pipeline.stage_layers(L, S) == \
                j_pipeline.stage_layers(L, S)
            for M in (1, 8, 32):
                assert pipeline.bubble_fraction(S, M) == \
                    j_pipeline.bubble_fraction(S, M)


def test_meshes_refuse_missing_cards():
    """``make_production_mesh`` needs its 256 (512) cards and raises
    here, as the reference's without its flag; ``make_host_mesh`` is
    the first card, or the device the caller names."""
    with pytest.raises(RuntimeError, match="256"):
        launch_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512"):
        launch_mesh.make_production_mesh(multi_pod=True)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            launch_mesh.make_host_mesh()
    m = launch_mesh.make_host_mesh(["cpu"])
    assert m.shape == {"data": 1, "model": 1}
    assert m.devices.flat[0] == torch.device("cpu")


def test_sharded_blocks_gather_and_write():
    """A (2, 4) mesh of one device: a leaf sharded over both axes stores
    eight blocks, one replicated over "model" two, one replicated
    whole one; each gathers back bit for bit, in part too; ``write``
    reaches every block a range covers; bytes are one copy."""
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    t = torch.arange(8 * 16 * 3, dtype=torch.float32).reshape(8, 16, 3)
    for spec, n in ((P("data", "model"), 8), (P("data", None), 2),
                    (P(None, ("data", "model")), 8), (P(), 1),
                    (P(None, None, None), 1)):
        leaf = Sharded.place(t, NamedSharding(mesh, spec))
        assert len(leaf.blocks) == n
        assert leaf.nbytes == t.numel() * 4
        assert torch.equal(leaf.gather(), t)
        assert torch.equal(leaf.gather(ranges={0: (3, 7), 1: (5, 6)}),
                           t[3:7, 5:6])
        leaf.write(-t[2:5, :, 1:2], {0: (2, 5), 2: (1, 2)})
        want = t.clone()
        want[2:5, :, 1:2] *= -1
        assert torch.equal(leaf.gather(), want)
    with pytest.raises(ValueError):
        Sharded.place(torch.zeros(6, 4), NamedSharding(mesh, P("model")))


def test_sharded_copies_on_distinct_devices_prefer_the_local_one():
    """On a mesh of distinct devices a replicated block is stored once a
    device, and a gather takes the copy on its own device."""
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cpu", "meta"])
    leaf = Sharded.place(torch.ones(4, 2), NamedSharding(mesh, P()))
    assert [k[1].type for k in leaf.blocks] == ["cpu", "meta"]
    assert leaf.gather("meta").device.type == "meta"
    assert leaf.gather("cpu").data_ptr() == \
        leaf.blocks[((0, 0), torch.device("cpu"))].data_ptr()


def test_constrain_is_the_identity():
    x = torch.ones(2, 3)
    with shd.activation_rules({"act_btd": None}, "mesh", row=1):
        assert shd.constrain(x, "act_btd") is x
        assert shd.current_mesh() == "mesh" and shd.current_row() == 1
    assert shd.current_mesh() is None and shd.current_row() is None
