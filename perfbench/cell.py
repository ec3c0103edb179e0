"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, the configuration file it names, ``traffic/<mix>.json`` and one
reader a metric, ``metrics/<metric>.py`` (a module with ``read(run) ->
float or None``; ``run`` is the dict ``run.run`` fills)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have: {', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    with open(ROOT / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics(bench: dict, cell: str, kind: str) -> list:
    """The entries of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those listing it under ``workloads``, and those without the
    key (a per-layer one then where the cell reports what it moves)."""
    e2e = [m["name"] for m in metrics(bench, cell, "end_to_end")] \
        if kind == "per_layer" else None
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
