"""Roofline analysis of the dry-run's records (port of
``repro/launch/roofline.py``), with an NVIDIA H100's figures.

Per (arch x shape x mesh) cell, from experiments/dryrun_torch/*.json
(``launch/dryrun.py``):

  compute term    = FLOPs_per_chip / PEAK_FLOPS             (989 TF bf16)
  memory term     = dot_bytes_per_chip / HBM_BW             (3.35 TB/s)
  collective term = collective_bytes_per_chip / LINK_BW     (450 GB/s)

The constants are NVIDIA's data sheet for the H100 80GB HBM3 (SXM) at
its 700 W power limit: 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s of HBM, and NVLink's 900 GB/s a card, 450 GB/s each way, to
the other cards of its host of 8. A card set below 700 W runs slower
under load. A mesh axis that spans more than one host of 8 cards
("data" and "model" of 16, "pod") crosses the hosts' network, slower
than NVLink, so there the collective term is a lower bound. The terms
are per-chip step times: the record's figures are the busiest
position's (``steps.lower_step``). No figure here was measured: each
is a count over a peak.

MODEL_FLOPS (the useful-work floor) is 6·N_active·tokens for training
and 2·N_active·tokens for inference; the ratio MODEL_FLOPS/FLOPs exposes
recompute, padding and, in the port, work a position repeats that
tensor parallelism would split (ROADMAP.md B, Held 11). The bottleneck
column names the term to attack. The arithmetic is the reference's; the
chip count comes from the record's mesh."""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.configs import SHAPES, get_config

PEAK_FLOPS = 989e12          # bf16 dense, per H100 SXM (700 W)
HBM_BW = 3.35e12             # bytes/s per H100 SXM
LINK_BW = 450e9              # bytes/s, NVLink, each way, per H100 SXM

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"


def model_flops_per_chip(arch: str, shape_name: str, n_chips: int) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_chips


def n_chips_of(rec: Dict) -> int:
    """The record's chip count: its ``n_chips``, else from its mesh's
    name (pod2x16x16: 512, pod16x16: 256)."""
    if rec.get("n_chips"):
        return int(rec["n_chips"])
    return 512 if rec["mesh"].startswith("pod2x16x16") else 256


def analyze(rec: Dict) -> Optional[Dict]:
    if not rec.get("ok"):
        return None
    n_chips = n_chips_of(rec)
    flops = rec.get("walker_flops") or rec["flops"]
    mem_bytes = rec.get("walker_dot_bytes") or rec["bytes_accessed"]
    t_comp = flops / PEAK_FLOPS
    t_mem = mem_bytes / HBM_BW
    t_coll = rec["collective_bytes_total"] / LINK_BW
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get).split("_")[0]
    mf = model_flops_per_chip(rec["arch"], rec["shape"], n_chips)
    step_s = max(terms.values())            # perfectly-overlapped bound
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "variant": rec.get("variant", "native"),
        **{k: round(v, 6) for k, v in terms.items()},
        "bottleneck": bottleneck,
        "model_flops_per_chip": mf,
        "useful_flops_ratio": round(mf / max(flops, 1.0), 3),
        "roofline_fraction": round(
            (mf / PEAK_FLOPS) / max(step_s, 1e-12), 3),
        "hw_mfu_bound": round(t_comp / max(step_s, 1e-12), 3),
        "temp_gb": round(rec.get("temp_size_in_bytes", 0) / 1e9, 2),
        "args_gb": round(rec.get("argument_size_in_bytes", 0) / 1e9, 2),
    }


def load_all(mesh: str = "pod16x16", results_dir: Path = RESULTS_DIR
             ) -> List[Dict]:
    rows = []
    for f in sorted(Path(results_dir).glob(f"*__{mesh}.json")):
        row = analyze(json.loads(f.read_text()))
        if row:
            rows.append(row)
    return rows


def what_would_help(row: Dict) -> str:
    b = row["bottleneck"]
    if b == "compute":
        if row["useful_flops_ratio"] < 0.4:
            return ("compute-bound but mostly recompute or repeated work: "
                    "relax the remat policy, split the matmuls over "
                    "'model' (tensor parallelism) or cut padded-expert "
                    "waste")
        return ("compute-bound near useful-flops: raise tensor-core "
                "utilization (wgmma, bf16 or fp8 tiles)")
    if b == "memory":
        return ("HBM-bound: shrink cache/param traffic (quantize KV, "
                "fuse ops, low-dim filter first)")
    return ("collective-bound: reshard to cut gathered bytes, keep the "
            "collective inside one NVLink host, or overlap it with "
            "compute")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows = load_all(args.mesh, RESULTS_DIR)
    cols = ["arch", "shape", "variant", "compute_s", "memory_s",
            "collective_s", "bottleneck", "useful_flops_ratio",
            "roofline_fraction", "temp_gb"]
    lines = [",".join(cols)]
    for r in rows:
        lines.append(",".join(str(r[c]) for c in cols))
    print("\n".join(lines))
    if args.csv:
        Path(args.csv).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
