"""The control of the comparison that decides ``correct``: the reference
put in the port's place, one precision below the configuration's float32
(``reference.knn.tf32_knn``), judged exactly as a run's answers are, on
the cell's own data, pool and width. It must come out not correct; its
readings set the upper end of each limit (PERF.md § 2).

    python3 -m perfbench.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed. The benchmark's own runs never run it."""
from __future__ import annotations

import argparse
import json
import sys

from perfbench import cell, run
from perfbench.reference import check
from perfbench.reference.knn import tf32_knn


def readings(bench: dict, wl: dict, seed: int, *, device: str = "cuda",
             scale: dict = None) -> dict:
    """The control's judgement on ``seed``: every ring batch answered by
    ``tf32_knn`` in the port's place."""
    conf, traffic = run.scaled(bench, wl, scale)
    x, pool, calls, _ = run.inputs(conf, traffic, seed)
    width = max(traffic["k"], conf["ef0"])
    d, i = tf32_knn(x, pool, width, device=device)
    d, i = d.cpu().numpy(), i.cpu().numpy()
    records = [(r, d[c], i[c]) for r, c in enumerate(calls)]
    verdict = check.judge(x, pool, calls, records, k=traffic["k"],
                          recall10_min=conf["recall10_min"], failed=0,
                          device=device)
    return {"seed": seed, "correct": verdict["correct"],
            "calls": len(records),
            "checks": verdict["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    bench = cell.benchmark()
    wl = cell.workload(bench, args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(bench, wl, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
