"""The port's filter-stage ablation (``repro_torch.bench.pq_ablation``)
against the reference's (``benchmarks/bench_pq_ablation.py``) on the CPU
at 1,000 points and 16 queries, both on the graph and queries the
reference caches in one temporary ``DATA_DIR``.

Bars, per mode (pca, pq, pq64, none, pca-deferred, cascade-deferred):
the row names and derived keys, ``bytes_per_vec``, the side-car bytes
and both multipliers equal; recall@10 within 0.02; ``dist_h_mean``
within 2%."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N, NQ = 1_000, 16
MODES = ["pca", "pq", "pq64", "none", "pca-deferred", "cascade-deferred"]


def _derived(rows) -> dict:
    return {name: dict(kv.split("=", 1) for kv in d.split(";"))
            for name, _, d in rows}


@pytest.fixture(scope="module")
def ablation(tmp_path_factory):
    import benchmarks.common as rcommon
    from benchmarks import bench_pq_ablation
    from repro_torch.bench import common, pq_ablation
    d = tmp_path_factory.mktemp("bench_ablation")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rcommon, "DATA_DIR", d / "data")
            mp.setattr(common, "DATA_DIR", d / "data")
            ref = bench_pq_ablation.main(n_points=N, n_queries=NQ)
            pq_ablation.main(N, NQ, device="cpu", out=str(d / "port.json"))
    finally:
        torch.set_num_threads(n_threads)
    return {"ref": _derived(ref),
            "port": json.loads((d / "port.json").read_text())}


def test_rows_and_keys_are_the_references(ablation):
    port = _derived([(r["name"], r["us"], r["derived"])
                     for r in ablation["port"]["rows"]])
    names = [f"pq_ablation/{m}" for m in MODES]
    assert list(port) == list(ablation["ref"]) == names
    for name in names:
        assert list(port[name]) == list(ablation["ref"][name])
    assert list(ablation["port"]["modes"]) == MODES


@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_the_references(ablation, mode):
    ref = ablation["ref"][f"pq_ablation/{mode}"]
    got = ablation["port"]["modes"][mode]
    for k in ("bytes_per_vec", "sidecar_bytes_per_vec", "rerank_mult",
              "promote_mult"):
        assert got[k] == int(ref[k]), k
    assert abs(got["recall"] - float(ref["recall@10"])) <= 0.02
    assert got["dist_h_mean"] == pytest.approx(float(ref["dist_h_mean"]),
                                               rel=0.02, abs=0.05)


def test_pq64_is_the_matched_byte_budget(ablation):
    modes = ablation["port"]["modes"]
    assert modes["pq64"]["bytes_per_vec"] == 64
    assert modes["pq"]["bytes_per_vec"] == 16
    assert modes["cascade-deferred"]["sidecar_bytes_per_vec"] == 60
    assert modes["pq64"]["bytes_layout3"] > modes["pq"]["bytes_layout3"]
