"""The port's churn bench (``repro_torch.bench.churn``) against the
reference's (``benchmarks/bench_churn.py``) on the CPU at 1,000 points,
16 queries, 3 rounds and the same seeds, on one index and on two shards.
Both packages' ``DATA_DIR`` point at one temporary directory, so the
single-index churn of both runs on the graph the reference builds and
caches there. (The faults bench's test is
``test_torch_bench_faults.py``.)

Bars: the same row names and derived keys; upserts, deletes, live size
and tombstone fraction equal; recall@10 within 0.02; ``pca_drift`` to
rtol 1e-4."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N, NQ, ROUNDS = 1_000, 16, 3


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


@pytest.fixture(scope="module", params=[1, 2], ids=["single", "p2"])
def churn(request, data_dir):
    """Both benches' churn at ``n_shards``: the reference's rows and its
    service (its index read after the run), the port's figures."""
    from benchmarks import bench_churn
    from repro_torch.bench.churn import run_churn
    from repro_torch.bench.common import load_bench_db
    n_shards = request.param
    seen = {}

    class Recorded(bench_churn.VectorSearchService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["svc"] = self
            self.n_up = self.n_del = 0

        def upsert(self, xs, *a, **kw):
            self.n_up += len(xs)
            return super().upsert(xs, *a, **kw)

        def delete(self, ids, *a, **kw):
            self.n_del += len(ids)
            return super().delete(ids, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_churn, "VectorSearchService", Recorded)
        rows = bench_churn.main(n_points=N, n_queries=NQ, rounds=ROUNDS,
                                n_shards=n_shards)
    svc = seen["svc"]
    idx = svc.index if svc.index is not None else svc.sindex
    cfg, x, g, pca, _, q, _ = load_bench_db(N, NQ, device="cpu")
    port = run_churn(cfg, x, g, pca, q, rounds=ROUNDS, n_shards=n_shards,
                     device="cpu")
    return {"rows": rows, "svc": svc, "idx": idx, "port": port}


def test_churn_rows_and_keys_are_the_references(churn):
    ref = _derived(churn["rows"])
    port = _derived(churn["port"]["rows"])
    assert list(port) == list(ref) == ["churn/upsert", "churn/delete",
                                       "churn/query", "churn/final"]
    for name in ref:
        assert list(port[name]) == list(ref[name])


def test_churn_counts_equal_the_references(churn):
    e, svc, idx = churn["port"]["entry"], churn["svc"], churn["idx"]
    assert e["upserts"] == svc.n_up
    assert e["deletes"] == svc.n_del
    assert e["live"] == len(idx.live_ids()) == e["expected_live"]
    assert e["tombstone_frac"] == idx.tombstone_frac
    assert e["tombstone_frac"] == e["expected_tombstone_frac"]
    assert e["non_live_returned"] == 0


def test_churn_recall_and_drift_match_the_references(churn):
    e, idx = churn["port"]["entry"], churn["idx"]
    ref = _derived(churn["rows"])["churn/final"]
    assert abs(e["recall_at_10"] - float(ref["recall@10"])) <= 0.02
    assert e["pca_drift"] == pytest.approx(idx.pca_drift()["drift"],
                                           rel=1e-4)


def test_runner_churn_mode_prints_its_rows_and_holds_its_counts(
        data_dir, tmp_path):
    """``python -m repro_torch.bench.run --churn --fast``: the CSV header
    and the four rows, and its JSON under ``--out``, on the graph and 16
    queries the reference cached."""
    import contextlib
    import io
    import json
    from repro_torch.bench import run
    from repro_torch.bench.common import load_bench_db
    load_bench_db(N, NQ, device="cpu")        # the cached 16 queries
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run.main(["--churn", "--fast", "--n-points", str(N), "--device",
                  "cpu", "--out", str(tmp_path)])
    lines = buf.getvalue().splitlines()
    doc = json.loads((tmp_path / "churn.json").read_text())
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",", 1)[0] for ln in lines[1:]] == \
        [r["name"] for r in doc["rows"]] == ["churn/upsert", "churn/delete",
                                             "churn/query", "churn/final"]
    assert doc["rounds"] == 8 and doc["queries"] == NQ
    assert doc["live"] == doc["expected_live"]
    assert doc["tombstone_frac"] == doc["expected_tombstone_frac"]
    assert doc["non_live_returned"] == 0
