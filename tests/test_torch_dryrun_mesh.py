"""The dry-run tools on meshes and their own arithmetic, on the CPU:
``launch.steps.lower_step`` on (2, 2) and (2, 4) meshes of distinct
"cpu:N" devices (each position stores its own blocks, as on separate
cards) and of "cpu" repeated; ``launch.step_cost``'s counter against
torch's ``FlopCounterMode`` and against the bytes a real step moves;
``launch.roofline`` against the JAX package's; ``launch.dryrun``'s CLI;
the attention operators' FLOP formulas against their plain versions.

What the counter leaves out of torch's count: the matrix products over
a contraction of size 1, which XLA emits as multiplies and the
reference's walker does not count: rwkv6's per-token bonus's backward.
The bytes a real step moves are read from the storage (which device
holds the copy a gather or a write uses), not from the counter, with
the step's units driven as the step drives them."""
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import roofline as j_roofline
from repro_torch.configs import SHAPES, all_cells, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.distributed import make_mesh
from repro_torch.data.tokens import batch_extras_for, synthetic_batch
from repro_torch.distributed import pipeline
from repro_torch.distributed.sharding import Sharded, shard_tree, tree_nbytes
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, roofline, step_cost
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.steps import (adamw_init_sharded, build_prefill_step,
                                      build_serve_step, build_train_step,
                                      lower_step, shard_params)
from repro_torch.models import get_model
from repro_torch.models import moe as moe_mod

SEQ, BATCH = 16, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape, distinct=True):
    n = int(np.prod(shape))
    return make_mesh(shape, ("data", "model"),
                     devices=[f"cpu:{i}" if distinct else "cpu"
                              for i in range(n)])


def _batch(cfg, B, S):
    raw = synthetic_batch(0, 0, B, S, cfg.vocab,
                          extras=batch_extras_for(cfg))
    return {k: torch.as_tensor(v) for k, v in raw.items()}


def real_step(cfg, mesh, kind, B=BATCH, S=SEQ):
    """(run, state): the real step of ``kind`` on ``mesh`` with seeded
    weights and its batch laid out by ``b_sh``, ready to run once, and
    the state it reads ({name: tree})."""
    shape = ShapeConfig("s", S, B, kind)
    model = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg, B, S)
    if kind == "train":
        step, specs = build_train_step(cfg, mesh, shape)
        params = shard_params(model, specs["p_sh"], requires_grad=True)
        opt = adamw_init_sharded(params)
        sbatch = shard_tree(batch, specs["b_sh"])
        return (lambda: step(params, opt, sbatch)), {
            "params": params, "m": opt["m"], "v": opt["v"],
            "step": opt["step"], "batch": sbatch}
    pf, specs = build_prefill_step(cfg, mesh, ShapeConfig("p", S, B,
                                                          "prefill"))
    params = shard_params(model, specs["p_sh"])
    pbatch = shard_tree({k: v for k, v in batch.items() if k != "labels"},
                        {k: v for k, v in specs["b_sh"].items()})
    if kind == "prefill":
        return (lambda: pf(params, pbatch)), {"params": params,
                                             "batch": pbatch}
    lg, cache = pf(params, pbatch, S)
    serve, sspecs = build_serve_step(cfg, mesh, shape)
    token = shard_tree(lg.gather().argmax(-1, keepdim=True).to(torch.int32),
                       sspecs["b_sh"]["token"])
    return (lambda: serve(params, cache, token, S - 1)), {
        "params": params, "cache": cache, "token": token}


# --------------------------------------------------------------------------
# FLOPs against torch's FlopCounterMode
# --------------------------------------------------------------------------

def _contraction_one(a, b, *_, out_shape=None, **__):
    """torch's bmm formula, for the products over a contraction of 1
    only."""
    return 2 * a[0] * a[1] * b[2] if a[2] == 1 else 0


@pytest.mark.parametrize("arch,kind", [
    ("starcoder2-3b", "train"), ("starcoder2-3b", "prefill"),
    ("starcoder2-3b", "decode"), ("mixtral-8x7b", "train"),
    ("mixtral-8x7b", "prefill"), ("mixtral-8x7b", "decode"),
    ("whisper-medium", "train"), ("rwkv6-1.6b", "train"),
    ("recurrentgemma-9b", "decode")])
def test_meta_count_equals_flop_counter_on_cpu(arch, kind):
    """The count on "meta" equals ``FlopCounterMode`` around the same step
    on CPU tensors ((1, 1) mesh of "cpu"), less the products over a
    contraction of 1 (rwkv6 only)."""
    cfg = get_smoke_config(arch)
    mesh = cpu_mesh((1, 1), distinct=False)
    run, _ = real_step(cfg, mesh, kind, B=4)
    with FlopCounterMode(display=False) as fc:
        run()
    zero = lambda *a, **k: 0
    k1 = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.bmm: _contraction_one, torch.ops.aten.mm: zero,
        torch.ops.aten.addmm: zero, torch.ops.aten.baddbmm: zero,
        torch.ops.repro_torch.flash_attention: zero,
        torch.ops.repro_torch.decode_attention: zero})
    run, _ = real_step(cfg, mesh, kind, B=4)
    with k1:
        run()
    got = lower_step(cfg, mesh, ShapeConfig("s", SEQ, 4, kind)).cost()
    assert got.total.flops == fc.get_total_flops() - k1.get_total_flops()
    assert (k1.get_total_flops() > 0) == (arch == "rwkv6-1.6b")


# --------------------------------------------------------------------------
# each distinct unit once
# --------------------------------------------------------------------------

MESH_CASES = [("starcoder2-3b", (2, 2), "train", "tp"),
              ("starcoder2-3b", (2, 2), "train", "fsdp"),
              ("starcoder2-3b", (2, 2), "prefill", "tp"),
              ("starcoder2-3b", (2, 2), "decode", "tp"),
              ("mixtral-8x7b", (2, 4), "train", "tp"),
              ("mixtral-8x7b", (2, 4), "prefill", "tp"),
              ("mixtral-8x7b", (2, 4), "decode", "tp")]


def _cfg(arch, profile):
    cfg = get_smoke_config(arch)
    return cfg if profile == "tp" else cfg.replace(shard_profile=profile)


@pytest.mark.parametrize("arch,shape,kind,profile", MESH_CASES)
def test_each_distinct_unit_once_equals_every_unit(arch, shape, kind,
                                                   profile):
    """Deduplicated costs equal a run of every unit, position for
    position, field for field, the temp estimates too; mixtral trains
    and prefills expert-parallel on (2, 4) and pools its decode on one
    unit."""
    cfg, mesh = _cfg(arch, profile), cpu_mesh(shape)
    sh = ShapeConfig("s", SEQ, BATCH, kind)
    once, every = lower_step(cfg, mesh, sh), lower_step(cfg, mesh, sh,
                                                        dedup=False)
    a, b = once.cost(), every.cost()
    assert [c.as_dict() for c in a.positions] == \
        [c.as_dict() for c in b.positions]
    assert a.units == b.units
    sizes = lambda lw: [
        {k: v for k, v in p.items() if k != "temp_size_in_bytes"}
        for p in lw.memory_analysis().per_position]
    assert sizes(once) == sizes(every)
    if arch == "mixtral-8x7b" and kind == "decode":
        assert sum(a.units.values()) == 1            # pooled: one unit
    else:
        assert sum(a.units.values()) > len(a.units)  # something shared


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dense_sum_over_positions_equals_one_position(kind):
    cfg = get_smoke_config("starcoder2-3b")
    sh = ShapeConfig("s", SEQ, BATCH, kind)
    one = lower_step(cfg, abstract_mesh((1, 1), ("data", "model")),
                     sh).cost()
    four = lower_step(cfg, cpu_mesh((2, 2)), sh).cost()
    assert four.total.flops == one.total.flops
    assert len(four.positions) == 4 and len(one.positions) == 1


# --------------------------------------------------------------------------
# collective bytes against what a real step moves
# --------------------------------------------------------------------------

class Moves:
    """What a real step on a mesh of distinct devices moves between them,
    read from the storage: a gather's pieces whose copy lies on another
    device (and, where they will get a gradient, its return), a write's
    blocks on another device than the computing unit's, an
    expert-parallel MoE's tokens to each other expert position and its
    outputs back, and each replicated gradient's copies summed on the
    first and the sum sent back. Keyed by the receiving (or, for a
    gradient's return, an expert's output and a write, the computing)
    position's grid index."""

    def __init__(self, mesh, monkeypatch):
        self.pos = {d: i for i, d in enumerate(mesh.grid().flat)}
        self.grid = mesh.grid()
        self.by = defaultdict(lambda: defaultdict(int))
        self.unit_dev = None
        nb = lambda t: t.numel() * t.element_size()
        gather, write = Sharded.gather, Sharded.write
        apply_sharded, units = moe_mod._apply_moe_sharded, steps_mod._units

        def g(leaf, device=None, ranges=None):
            dev = leaf.device if device is None else torch.device(device)
            for idx, piece in leaf._pieces(dev, ranges or {}).items():
                if (idx, dev) in leaf.blocks:
                    continue
                self.by[self.pos[dev]]["all-gather"] += nb(piece)
                if torch.is_grad_enabled() and piece.requires_grad:
                    self.by[self.pos[dev]]["reduce-scatter"] += nb(piece)
            return gather(leaf, device, ranges)

        def w(leaf, value, ranges=None):
            for (idx, d), blk in leaf.blocks.items():
                if d == self.unit_dev:
                    continue
                n = value.element_size()
                for dim, (lo, hi) in enumerate(leaf.block_range(idx)):
                    a, b = (ranges or {}).get(dim, (lo, hi))
                    n *= max(0, min(b, hi) - max(a, lo))
                self.by[self.pos[self.unit_dev]]["all-to-all"] += n
            return write(leaf, value, ranges)

        def moe(cfg, p, x, mesh, *, row, **kw):
            for dev in self.grid[row, 1:]:
                if dev != self.grid[row, 0]:
                    self.by[self.pos[dev]]["all-gather"] += nb(x)
                    self.by[self.pos[dev]]["all-reduce"] += nb(x)
            return apply_sharded(cfg, p, x, mesh, row=row, **kw)

        def u(*a, **kw):
            for unit in units(*a, **kw):
                self.unit_dev = unit[1]
                yield unit

        monkeypatch.setattr(Sharded, "gather", g)
        monkeypatch.setattr(Sharded, "write", w)
        monkeypatch.setattr(moe_mod, "_apply_moe_sharded", moe)
        monkeypatch.setattr(steps_mod, "_units", u)

    def replica_sums(self, params):
        """The mesh train step's sums of gradient copies, f32: per block
        index stored on k devices, the first receives k - 1 copies and
        each other the sum."""
        for leaf in params.values():
            copies = defaultdict(list)
            for idx, d in leaf.blocks:
                copies[idx].append(d)
            for idx, devs in copies.items():
                n = 4
                for lo, hi in leaf.block_range(idx):
                    n *= hi - lo
                self.by[self.pos[devs[0]]]["all-reduce"] += \
                    (len(devs) - 1) * n
                for d in devs[1:]:
                    self.by[self.pos[d]]["all-reduce"] += n


@pytest.mark.parametrize("arch,shape,kind,profile", MESH_CASES)
def test_collective_bytes_equal_what_a_real_step_moves(
        arch, shape, kind, profile, monkeypatch):
    cfg, mesh = _cfg(arch, profile), cpu_mesh(shape)
    got = lower_step(cfg, mesh, ShapeConfig("s", SEQ, BATCH, kind)
                     ).cost().positions
    run, state = real_step(cfg, mesh, kind)
    moves = Moves(mesh, monkeypatch)
    run()
    if kind == "train":
        moves.replica_sums(state["params"])
    for p, c in enumerate(got):
        assert {k: v for k, v in c.collective.items() if v} == \
            {k: v for k, v in moves.by[p].items() if v}, f"position {p}"
    assert sum(c.collective_bytes for c in got) > 0


@pytest.mark.parametrize("arch,shape,kind,profile", MESH_CASES)
def test_argument_bytes_are_the_blocks_each_position_holds(
        arch, shape, kind, profile):
    cfg = _cfg(arch, profile)
    mesh = cpu_mesh(shape)
    mem = lower_step(cfg, mesh, ShapeConfig("s", SEQ, BATCH, kind)
                     ).memory_analysis()
    _, state = real_step(cfg, mesh, kind)
    held = defaultdict(int)
    for tree in state.values():
        for leaf in (tree.values() if isinstance(tree, dict) else [tree]):
            for sub in (leaf.values() if isinstance(leaf, dict) else [leaf]):
                if isinstance(sub, Sharded):
                    for (_, d), b in sub.blocks.items():
                        held[d] += b.numel() * b.element_size()
    # the optimizer step and decode's position: a scalar on each position
    # (the port keeps the step's on the first device alone), 4 bytes
    extra = 4 if kind in ("train", "decode") else 0
    for p, d in enumerate(mesh.grid().flat):
        assert mem.per_position[p]["argument_size_in_bytes"] == \
            held[d] + extra
    assert mem.argument_size_in_bytes == max(held.values()) + extra
    # on one device repeated: what its trees store, once
    rep = cpu_mesh(shape, distinct=False)
    mem = lower_step(cfg, rep, ShapeConfig("s", SEQ, BATCH, kind)
                     ).memory_analysis()
    _, state = real_step(cfg, rep, kind)
    plain = 4 if kind in ("train", "decode") else 0
    assert mem.stored_argument_bytes == tree_nbytes(state) + plain


def test_pipeline_hops_are_collective_permutes():
    mesh = cpu_mesh((1, 4))
    L, M, Bm, S, D = 8, 3, 2, 4, 16
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((L, D, D), generator=g) / D ** 0.5}
    xs = torch.randn((M, Bm, S, D), generator=g)
    fwd = pipeline.build_pipeline_forward(
        mesh, lambda lp, x: torch.tanh(x @ lp["w"]), L)
    counter = step_cost.StepCounter()
    with counter:
        fwd(params, xs)
    hop = Bm * S * D * 4
    for s in range(4):
        c = counter.costs[s]
        assert c.flops == M * (L // 4) * 2 * Bm * S * D * D
        assert c.collective["collective-permute"] == (M * hop if s < 3
                                                      else 0)


# --------------------------------------------------------------------------
# the attention operators' formulas
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,KV,S,T,d,causal,window", [
    (2, 4, 4, 16, 16, 8, True, 0), (2, 8, 2, 5, 33, 16, True, 0),
    (1, 6, 3, 40, 40, 8, True, 7), (3, 4, 1, 9, 20, 32, False, 0)])
def test_flash_formula_equals_plain_version(B, H, KV, S, T, d, causal,
                                            window):
    g = torch.Generator().manual_seed(S + T)
    q = torch.randn((B, H, S, d), generator=g)
    k, v = (torch.randn((B, KV, T, d), generator=g) for _ in range(2))
    with FlopCounterMode(display=False) as plain:
        ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    with FlopCounterMode(display=False) as op:
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                            causal=causal, window=window)
    assert op.get_total_flops() == plain.get_total_flops() \
        == 4 * B * H * S * T * d


@pytest.mark.parametrize("B,H,KV,T,d", [(2, 4, 4, 16, 8), (3, 8, 2, 33, 16),
                                        (1, 16, 1, 7, 64)])
def test_decode_formula_equals_plain_version(B, H, KV, T, d):
    g = torch.Generator().manual_seed(T)
    q = torch.randn((B, H, d), generator=g)
    k, v = (torch.randn((B, KV, T, d), generator=g) for _ in range(2))
    length = torch.arange(B, dtype=torch.int32) % (T + 1)
    with FlopCounterMode(display=False) as plain:
        ref.decode_attention_ref(q, k, v, length)
    with FlopCounterMode(display=False) as op:
        ops.decode_attention(q, k, v, length)      # CPU, watched
    assert op.get_total_flops() == plain.get_total_flops() \
        == 4 * B * H * T * d


# --------------------------------------------------------------------------
# the roofline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_chips", [256, 512])
def test_model_flops_per_chip_equals_reference(n_chips):
    cells = list(all_cells())
    assert len(cells) == 40
    for arch, shape in cells:
        assert roofline.model_flops_per_chip(arch, shape.name, n_chips) \
            == j_roofline.model_flops_per_chip(arch, shape.name, n_chips)


def test_analyze_uses_the_h100_figures():
    rec = {"ok": True, "arch": "starcoder2-3b", "shape": "train_4k",
           "mesh": "pod2x16x16", "walker_flops": 989e12,
           "walker_dot_bytes": 2 * 3.35e12,
           "collective_bytes_total": 0.5 * 450e9,
           "temp_size_in_bytes": 2e9, "argument_size_in_bytes": 3e9}
    row = roofline.analyze(rec)
    mf = roofline.model_flops_per_chip("starcoder2-3b", "train_4k", 512)
    assert (row["compute_s"], row["memory_s"], row["collective_s"]) == \
        (1.0, 2.0, 0.5)
    assert row["bottleneck"] == "memory"
    assert row["model_flops_per_chip"] == mf
    assert row["useful_flops_ratio"] == round(mf / 989e12, 3)
    assert row["roofline_fraction"] == round(mf / 989e12 / 2.0, 3)
    assert row["hw_mfu_bound"] == 0.5
    assert (row["temp_gb"], row["args_gb"]) == (2.0, 3.0)
    assert roofline.analyze({**rec, "n_chips": 256})["model_flops_per_chip"] \
        == 2 * mf
    assert roofline.analyze({**rec, "ok": False}) is None
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_what_would_help_takes_the_reference_branches():
    rows = [{"bottleneck": "compute", "useful_flops_ratio": 0.3},
            {"bottleneck": "compute", "useful_flops_ratio": 0.4},
            {"bottleneck": "memory", "useful_flops_ratio": 0.9},
            {"bottleneck": "collective", "useful_flops_ratio": 0.9}]
    port = [roofline.what_would_help(r) for r in rows]
    ref_ = [j_roofline.what_would_help(r) for r in rows]
    assert len(set(port)) == len(set(ref_)) == 4
    assert "tensor parallelism" in port[0] and "NVLink" in port[3]


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_dryrun_cli_writes_a_record_the_roofline_reads(tmp_path, monkeypatch,
                                                      capsys):
    for mod in (dryrun, roofline):
        monkeypatch.setattr(mod, "get_config", get_smoke_config)
        monkeypatch.setattr(mod, "RESULTS_DIR", tmp_path)
    args = ["--arch", "starcoder2-3b", "--shape", "train_4k"]
    assert dryrun.main(args) == 0
    import json
    rec = json.loads((tmp_path / "starcoder2-3b__train_4k__pod16x16.json")
                     .read_text())
    for key in ("ok", "lower_s", "trace_s", "temp_size_in_bytes",
                "argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes", "flops", "bytes_accessed",
                "walker_flops", "walker_dot_bytes", "walker_collectives",
                "collective_bytes_total", "n_chips", "total_flops"):
        assert key in rec, key
    assert rec["ok"] and rec["n_chips"] == 256
    assert set(rec["walker_collectives"]) == set(step_cost.COLLECTIVES)
    shape = SHAPES["train_4k"]
    # 4 of a data row's 16 positions compute one row each, 4 microbatches
    assert rec["units"] == [{"key": ["train", 1, 64], "count": 256}]
    assert rec["flops"] * rec["n_chips"] == 4 * rec["total_flops"]
    useful = roofline.model_flops_per_chip("starcoder2-3b", "train_4k", 256)
    assert useful * 256 <= rec["total_flops"]
    assert shape.global_batch == 256
    assert dryrun.main(args + ["--skip-done"]) == 0
    assert "skip done" in capsys.readouterr().out
    csv = tmp_path / "rows.csv"
    assert roofline.main(["--csv", str(csv)]) == 0
    lines = csv.read_text().splitlines()
    assert lines[0].startswith("arch,shape") and \
        lines[1].startswith("starcoder2-3b,train_4k")
