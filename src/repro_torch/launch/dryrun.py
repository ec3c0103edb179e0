"""The dry-run (port of ``repro/launch/dryrun.py``: ``run_cell`` and
``main``): each (arch x shape x mesh) cell's step lowered on the
production mesh, (16, 16) or (2, 16, 16), with no card, and one JSON
record a cell in ``experiments/dryrun_torch/``.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--variant auto|native|retrieval]
        [--profile tp|fsdp] [--skip-done]

Where the reference forces 512 host devices and compiles the step with
XLA, the port builds the step on ``launch.mesh
.make_abstract_production_mesh`` (each position a "meta" device of its
own) and counts it with ``steps.lower_step``: the step's computing
units run on "meta" under ``launch.step_cost.StepCounter``, each
distinct unit once; nothing is allocated on any device and no kernel
runs. The record keeps the reference's keys where they mean the same:
``ok``, ``lower_s`` (building the step and its layouts), the four
memory sizes (one position's, the largest), ``flops`` and
``walker_flops`` (the busiest position's FLOPs: the reference's
``cost_analysis()`` and its trip-count-aware walker, one count here),
``bytes_accessed`` (the operand and result bytes of every op on the
busiest position), ``walker_dot_bytes``, ``walker_collectives`` (its
bytes by category, ``step_cost``'s docstring maps them) and
``collective_bytes_total``, and ``error`` with ``traceback`` on
failure; ``trace_s`` (running the units) stands where ``compile_s``
stood. It adds ``n_chips``, the sums over positions (``total_flops``,
``total_dot_bytes``, ``total_collectives``), the busiest position's
index, the units and their multiplicities, and
``stored_argument_bytes``.

What has no counterpart: the legacy HLO collective parser
(``collectives``), ``hlo_bytes``, ``transcendentals``,
``generated_code_size_in_bytes`` and the ``.hlo.txt.gz``: there is no
HLO."""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import (ARCH_IDS, SHAPES, cell_supported,
                                 get_config, get_shape)
from repro_torch.launch.mesh import make_abstract_production_mesh
from repro_torch.launch.steps import lower_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"
_MEMORY = ("temp_size_in_bytes", "argument_size_in_bytes",
           "output_size_in_bytes", "alias_size_in_bytes")


def mesh_name(multi_pod: bool, profile: str = "tp") -> str:
    name = "pod2x16x16" if multi_pod else "pod16x16"
    return name if profile == "tp" else f"{name}-{profile}"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "auto", out_dir: Path = RESULTS_DIR,
             profile: str = "tp") -> dict:
    shape = get_shape(shape_name)
    cfg = get_config(arch)
    support = cell_supported(cfg, shape)
    if variant == "auto":
        variant = support
    if variant == "retrieval":
        from repro_torch.configs.base import RetrievalConfig
        # partitions = actual cache shards: (data x model) for batch=1
        # sequence sharding, model-only otherwise
        parts = 256 if shape.global_batch == 1 else 16
        cfg = cfg.replace(retrieval=RetrievalConfig(
            enabled=True, d_low=16, topk=2048, block=128, partitions=parts))
    if profile != "tp":
        cfg = cfg.replace(shard_profile=profile)
    name = mesh_name(multi_pod, profile)
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "variant": variant, "profile": profile, "ok": False}
    t0 = time.perf_counter()
    try:
        mesh = make_abstract_production_mesh(multi_pod=multi_pod)
        rec["n_chips"] = int(mesh.devices.size)
        lowered = lower_step(cfg, mesh, shape)
        rec["lower_s"] = time.perf_counter() - t0
        cost = lowered.cost()
        rec["trace_s"] = lowered.trace_s
        mem = lowered.memory_analysis()
        for attr in _MEMORY:
            rec[attr] = int(getattr(mem, attr))
        rec["stored_argument_bytes"] = int(mem.stored_argument_bytes)
        b, t = cost.busiest, cost.total
        rec["flops"] = rec["walker_flops"] = b.flops
        rec["bytes_accessed"] = b.bytes_accessed
        rec["walker_dot_bytes"] = b.dot_bytes
        rec["walker_collectives"] = dict(b.collective)
        rec["collective_bytes_total"] = int(b.collective_bytes)
        rec["busiest_position"] = cost.busiest_position
        rec["total_flops"] = t.flops
        rec["total_dot_bytes"] = t.dot_bytes
        rec["total_collectives"] = dict(t.collective)
        rec["units"] = [{"key": list(k), "count": n}
                        for k, n in cost.units.items()]
        rec["position_multiplicity"] = [
            {"positions": n, "flops": c.flops,
             "collective_bytes": c.collective_bytes}
            for n, c in cost.multiplicity]
        rec["ok"] = True
        print(mem)
    except Exception as e:  # record the failure; the sweep continues
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.perf_counter() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{arch}__{shape_name}__{name}.json"
    out.write_text(json.dumps(rec, indent=1))
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')[:120]})"
    print(f"[dryrun] {arch} x {shape_name} x {name} [{variant}]: "
          f"{status} ({rec['total_s']:.1f}s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--variant", default="auto",
                    choices=["auto", "native", "retrieval"])
    ap.add_argument("--profile", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells whose JSON already reports ok")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes[args.mesh]:
                f = RESULTS_DIR / (f"{arch}__{shape}__"
                                   f"{mesh_name(mp, args.profile)}.json")
                if args.skip_done and f.exists():
                    try:
                        if json.loads(f.read_text()).get("ok"):
                            print(f"[dryrun] skip done: {f.name}", flush=True)
                            continue
                    except (OSError, ValueError):
                        pass
                rec = run_cell(arch, shape, mp, args.variant, RESULTS_DIR,
                               profile=args.profile)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed", flush=True)
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
