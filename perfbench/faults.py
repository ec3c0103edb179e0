"""Faults planted in the port's timed path when the measured window opens,
so that set-up (whose build probe shares the kernels) runs sound. The
comparison that decides ``correct`` has to fail each of them; the CPU
tests (``tests/test_perfbench_faults.py``) check that at a small size,
and this module reads them at a cell's own size on the card:

    python3 -m perfbench.faults --workload <cell> --faults <name> [...] --seeds <n> [...] [--seconds <s>]

prints one JSON line a fault and seed: ``correct`` and each number
judged. The runs share one build, since ``data_seed`` and
``build_seed`` fix the graph. The benchmark's own runs never plant a
fault."""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from perfbench import cell, generator, run


def _state_unchanged(real):
    """A trip that returns its state unchanged."""
    return lambda F_d, F_i, C_d, C_i, W, Cp, *a, **kw: (F_d, F_i, C_d, C_i,
                                                        Cp)


def _half_batch(real):
    """Half of the batch left out, its answers copied over the rest."""
    def search(db, q, qprep, **kw):
        h = len(q) // 2
        fd, fi = real(db, q[:h], qprep[:h], **kw)
        return torch.cat([fd, fd]), torch.cat([fi, fi])
    return search


def _altered(what):
    """One answer altered where the search returns it."""
    def wrap(real):
        def search(db, q, qprep, **kw):
            fd, fi = real(db, q, qprep, **kw)
            if what == "id":
                fi[7, 3] = (fi[7, 3] + 1) % db.high.shape[0]
            else:
                fd[7, 3] *= 1.01
            return fd, fi
        return search
    return wrap


def _wrong_rows(real):
    """Every 32nd row (one warp's in 32) answered with the next row's ids,
    at their true distances to its own query, re-sorted: every answer a
    true id at its true distance, a thirty-second of the rows the wrong
    neighbours."""
    def search(db, q, qprep, **kw):
        fd, fi = real(db, q, qprep, **kw)
        rows = torch.arange(0, len(fi) - 1, 32, device=fi.device)
        ids = fi[rows + 1]
        qr = torch.as_tensor(q, device=fi.device)[rows]
        d = ((db.high[ids.clamp(min=0)] - qr[:, None]) ** 2).sum(-1)
        d = torch.where(ids >= 0, d, torch.inf)
        d, order = d.sort(1)
        fd[rows], fi[rows] = d, ids.gather(1, order)
        return fd, fi
    return search


def _layer0_first_check(real):
    """The layer-0 loop leaving at its first check of done (8 trips)."""
    def layer_gen(db, layer, *a, **kw):
        if layer == 0:
            kw["max_steps"] = 8
        return real(db, layer, *a, **kw)
    return layer_gen


# a fault's name: the module and attribute it replaces, and its wrapper
FAULTS = {
    "state_unchanged": ("repro_torch.kernels.ops", "trip_fold",
                        _state_unchanged),
    "half_batch": ("repro_torch.serve.vector_service", "search_batched",
                   _half_batch),
    "id_altered": ("repro_torch.serve.vector_service", "search_batched",
                   _altered("id")),
    "distance_altered": ("repro_torch.serve.vector_service",
                         "search_batched", _altered("distance")),
    "wrong_rows": ("repro_torch.serve.vector_service", "search_batched",
                   _wrong_rows),
    "layer0_first_check": ("repro_torch.core.search_torch", "_layer_gen",
                           _layer0_first_check),
}


def in_window(setattr_, name: str) -> None:
    """Plant fault ``name`` by ``setattr_(obj, attr, value)`` (pytest's
    ``monkeypatch.setattr``, or a restoring one) each time the window
    opens."""
    drive = generator.drive

    def broken_drive(*a, **kw):
        path, attr, fault = FAULTS[name]
        target = importlib.import_module(path)
        setattr_(target, attr, fault(getattr(target, attr)))
        return drive(*a, **kw)
    setattr_(generator, "drive", broken_drive)


def readings(bench: dict, wl: dict, names, seeds, seconds: float, *,
             device: str = "cuda") -> list:
    """The judgement of a run with each fault of ``names`` on each of
    ``seeds``, in one process sharing one build."""
    from repro_torch.core import graph
    saved = []

    def setattr_(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    built = {}
    build = graph.build_hnsw

    def build_once(x, cfg, **kw):
        key = (len(x), cfg.builder, kw.get("seed"))
        if key not in built:
            built[key] = build(x, cfg, **kw)
        return built[key]
    def restore(mark):
        while len(saved) > mark:
            obj, attr, value = saved.pop()
            setattr(obj, attr, value)
    setattr_(graph, "build_hnsw", build_once)
    out = []
    try:
        for name in names:
            for seed in seeds:
                in_window(setattr_, name)
                res = run.run(bench, wl, seed, seconds, False, device=device)
                restore(1)
                out.append({"seed": seed, "fault": name,
                            "correct": res["correct"],
                            "queries": res["attempted"],
                            "checks": res["checks"]})
    finally:
        restore(0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--faults", nargs="+", required=True,
                    choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the faults are read on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cell.ROOT / "src"))
    bench = cell.benchmark()
    wl = cell.workload(bench, args.workload)
    for r in readings(bench, wl, args.faults, args.seeds, args.seconds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
