"""The port's build bench (``repro_torch.bench.build``, through the runner
``repro_torch.bench.run --build``) against the reference bench
(``benchmarks/bench_build.py``) on the CPU at 1,000 points and the same
seeds: the same row names and derived keys, levels, entry point,
invariants and mean layer-0 degree equal, recall@10 after each build
within 0.005 (the float-data parity bar), and the JSON the runner writes.

The sequential oracle (``build_hnsw_ref``) is the same numpy code in both
packages; it takes ~25 s a package at this size, so it runs once, in the
reference bench, and the port's bench receives that graph (the port's
wave build, search and checks are its own)."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N, NQ = 1_000, 64


def _derived(rows) -> dict:
    return {name: dict(kv.split("=", 1) for kv in d.split(";"))
            for name, _, d in rows}


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    import repro.core.build as rbuild
    import repro.core.graph as rgraph
    import repro_torch.core.graph as tgraph
    from benchmarks import bench_build
    from repro_torch.bench import run
    seen = {"wave": []}
    out = tmp_path_factory.mktemp("bench_build")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            ref_oracle, ref_wave = rgraph.build_hnsw_ref, \
                rbuild.build_hnsw_wave

            def oracle(x, cfg, **kw):
                seen["ref"] = ref_oracle(x, cfg, **kw)
                return seen["ref"]

            def wave(*a, **kw):
                seen["wave"].append(ref_wave(*a, **kw))
                return seen["wave"][-1]

            mp.setattr(rgraph, "build_hnsw_ref", oracle)
            mp.setattr(rbuild, "build_hnsw_wave", wave)
            ref_rows = bench_build.main(n_points=N, n_queries=NQ)

            def port_oracle(x, cfg, *, seed=0, verbose=False):
                g = seen["ref"]
                assert np.array_equal(np.asarray(g.x), x)
                return tgraph.HNSWGraph(
                    cfg=cfg, x=x, levels=np.asarray(g.levels),
                    layers=[np.asarray(a) for a in g.layers],
                    entry=int(g.entry))

            mp.setattr(tgraph, "build_hnsw_ref", port_oracle)
            run.main(["--build", "--n-points", str(N), "--fast",
                      "--device", "cpu", "--out", str(out)])
    finally:
        torch.set_num_threads(n_threads)
    doc = json.loads((out / "build.json").read_text())
    return {"ref_rows": ref_rows, "doc": doc, "ref_wave": seen["wave"][-1],
            "ref_oracle": seen["ref"]}


def test_rows_and_derived_keys_are_the_references(builds):
    ref = _derived(builds["ref_rows"])
    port = _derived([(r["name"], r["us"], r["derived"])
                     for r in builds["doc"]["rows"]])
    assert list(port) == list(ref) == ["build/ref", "build/wave"]
    for name in ref:
        assert list(port[name]) == list(ref[name])


@pytest.mark.parametrize("row", ["build/ref", "build/wave"])
def test_structure_equals_the_references(builds, row):
    ref = _derived(builds["ref_rows"])[row]
    port = _derived([(r["name"], r["us"], r["derived"])
                     for r in builds["doc"]["rows"]])[row]
    assert port["invariants"] == ref["invariants"] == "ok"
    assert port["mean_deg0"] == ref["mean_deg0"]
    if row == "build/wave":
        assert port["levels_match"] == ref["levels_match"] == "1"
        assert port["entry_match"] == ref["entry_match"] == "1"


def test_wave_graphs_share_levels_and_entry(builds):
    """Both wave builders draw ``sample_levels`` from the same seed: the
    port's levels and entry equal the reference's wave graph's."""
    from repro_torch.bench.build import bench_data
    from repro_torch.core.build import build_hnsw_wave, graph_invariants
    cfg, x, _, _, _ = bench_data(N, NQ)
    g = build_hnsw_wave(x, cfg, seed=0, device="cpu")
    rw = builds["ref_wave"]
    assert np.array_equal(g.levels, np.asarray(rw.levels))
    assert g.entry == int(rw.entry)
    inv = graph_invariants(g)
    assert inv["ok"]
    assert inv["mean_degree"][0] == pytest.approx(
        float(builds["doc"]["mean_deg0_wave"]))


@pytest.mark.parametrize("row", ["build/ref", "build/wave"])
def test_recall_after_build_within_parity_bar(builds, row):
    ref = float(_derived(builds["ref_rows"])[row]["recall@10"])
    key = "recall_at_10_ref" if row == "build/ref" else "recall_at_10_wave"
    assert abs(builds["doc"][key] - ref) <= 0.005


def test_json_has_the_reference_entrys_keys(builds):
    doc = builds["doc"]
    for k in ("wave_vps", "ref_vps", "speedup_vs_ref", "recall_at_10_wave",
              "recall_at_10_ref", "invariants_ok", "levels_match"):
        assert k in doc
    assert doc["invariants_ok"] and doc["levels_match"] and \
        doc["entry_match"]
    assert doc["n_points"] == N and doc["queries"] == NQ
    assert doc["device"] == "cpu" and doc["card"] is None
    assert doc["speedup_vs_ref"] == pytest.approx(
        doc["wave_vps"] / doc["ref_vps"])
