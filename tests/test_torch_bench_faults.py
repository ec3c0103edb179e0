"""The port's fault-tolerance bench (``repro_torch.bench.faults``, through
the runner ``repro_torch.bench.run --faults``) against the reference's
(``benchmarks/bench_faults.py``) on the CPU at 1,000 points over P = 4
shards, the same seeds and one batch of 64 queries (the runner's).

Bars: the same row names and derived keys; coverage per dead-shard count
equal (and the live share exactly); ``recall_full`` and
``recall_survivor`` within 0.02; ``zero_recompiles`` true in both; the
recovered coverage 1.0. (Split from ``test_torch_bench_service.py``,
the churn bench's, to keep each file under a minute here.)"""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N = 1_000


def _derived(rows) -> dict:
    return {name: dict(kv.split("=", 1) for kv in d.split(";"))
            for name, _, d in rows}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    import benchmarks.common as rcommon
    from repro_torch.bench import common
    d = tmp_path_factory.mktemp("bench_data")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rcommon, "DATA_DIR", d)
        mp.setattr(common, "DATA_DIR", d)
        yield d
    torch.set_num_threads(n_threads)


@pytest.fixture(scope="module")
def faults(data_dir, tmp_path_factory):
    from benchmarks import bench_faults
    from repro_torch.bench import run
    d = tmp_path_factory.mktemp("bench_faults")
    # the runner's --faults serves one batch of 64 queries
    rows = bench_faults.main(n_points=N, n_queries=64, n_shards=4,
                             json_path=str(d / "ref.json"))
    ref = json.loads((d / "ref.json").read_text())["faults"]
    run.main(["--faults", "--n-points", str(N), "--device", "cpu",
              "--out", str(d / "port")])
    port = json.loads((d / "port" / "faults.json").read_text())
    return {"rows": rows, "ref": ref, "port": port}


def test_faults_rows_and_keys_are_the_references(faults):
    ref = _derived(faults["rows"])
    port = _derived([(r["name"], r["us"], r["derived"])
                     for r in faults["port"]["rows"]])
    assert list(port) == list(ref) == [f"faults/dead{k}" for k in range(4)] \
        + ["faults/cycle"]
    for name in ref:
        assert list(port[name]) == list(ref[name])


@pytest.mark.parametrize("k_dead", range(4))
def test_faults_curve_matches_the_references(faults, k_dead):
    p = faults["port"]["curve"][k_dead]
    r = faults["ref"]["curve"][k_dead]
    assert p["dead_shards"] == r["dead_shards"] == k_dead
    assert p["coverage"] == r["coverage"] == p["live_share"]
    assert abs(p["recall_full"] - r["recall_full"]) <= 0.02
    assert abs(p["recall_survivor"] - r["recall_survivor"]) <= 0.02


def test_faults_cycle_matches_the_references(faults):
    p, r = faults["port"], faults["ref"]
    ref_cycle = _derived(faults["rows"])["faults/cycle"]
    assert p["zero_recompiles"] is True and r["zero_recompiles"] is True
    assert p["recovered_coverage"] == 1.0
    assert float(ref_cycle["recovered_coverage"]) == 1.0
    assert p["degraded_coverage"] == float(ref_cycle["degraded_coverage"])
    assert [e[0] for e in p["events"]][-1] == "recovered"
    assert p["n_shards"] == r["n_shards"] == 4
    assert p["batch"] == r["batch"] == 64
