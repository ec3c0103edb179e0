"""The port's bench runner (``python -m repro_torch.bench.run``) on the CPU:
each mode prints the CSV header and its rows and writes its JSON under
``--out`` (``--perf-smoke`` here; ``--build``, ``--faults`` and
``--churn`` in the benches' own test files); the full suite runs the reference's order and re-raises a
failed bench; ``--load`` hands ``--prom-out`` on; without ``--device
cpu`` on a host with no card it raises; and after all of it
``BENCH_table3.json`` and ``benchmarks/`` are unchanged. Table III's new
options (``--filter``, ``--deferred``, ``--shards``) give the reference
bench's row names (``pHNSW-JAX-*`` there, ``pHNSW-torch-*`` here) and
its ``filters`` section's keys, against ``benchmarks/bench_table3_qps.py``
at the same size (1,000 points, 16 queries) on one cached fixture."""
import contextlib
import hashlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

N, NQ = 1_000, 16
HEADER = "name,us_per_call,derived"


def _tree_digest() -> str:
    """sha256 over BENCH_table3.json and every file under benchmarks/."""
    h = hashlib.sha256()
    files = [ROOT / "BENCH_table3.json"] + sorted(
        p for p in (ROOT / "benchmarks").rglob("*") if p.is_file()
        and "__pycache__" not in p.parts)
    for p in files:
        h.update(str(p.relative_to(ROOT)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _run(argv) -> list:
    from repro_torch.bench import run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run.main(argv)
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import benchmarks.common as rcommon
    from benchmarks import bench_table3_qps
    from repro_torch.bench import common
    d = tmp_path_factory.mktemp("bench_runner")
    before = _tree_digest()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(rcommon, "DATA_DIR", d / "data")
            mp.setattr(common, "DATA_DIR", d / "data")
            out["ref"] = bench_table3_qps.main(
                n_points=N, n_queries=NQ, json_path=str(d / "ref.json"))
            out["ref_doc"] = json.loads((d / "ref.json").read_text())
            out["ref_opt"] = bench_table3_qps.main(
                n_points=N, n_queries=NQ, filter_kind="cascade",
                deferred=True, n_shards=2)
            # the port on the reference's cached graph and queries
            for name, argv in (
                    ("canonical", ["--perf-smoke"]),
                    ("opt", ["--perf-smoke", "--filter", "cascade",
                             "--deferred", "--shards", "2"])):
                o = d / name
                lines = _run(argv + ["--n-points", str(N), "--device",
                                     "cpu", "--out", str(o)])
                out[name] = {"lines": lines, "json": {
                    f.stem: json.loads(f.read_text())
                    for f in sorted(o.glob("*.json"))}}
    finally:
        torch.set_num_threads(n_threads)
    out["digests"] = (before, _tree_digest())
    return out


def _names(rows) -> list:
    return [r[0].replace("pHNSW-JAX-", "pHNSW-torch-") for r in rows]


@pytest.mark.parametrize("mode", ["canonical", "opt"])
def test_each_mode_prints_its_rows_and_writes_its_json(runs, mode):
    """(The --build, --faults and --churn modes run through the runner in
    test_torch_bench_build.py, _faults.py and _service.py.)"""
    lines, docs = runs[mode]["lines"], runs[mode]["json"]
    stem = "table3_qps"
    assert list(docs) == [stem]
    assert lines[0] == HEADER
    rows = [ln for ln in lines[1:] if not ln.startswith("#")]
    assert [r.split(",", 1)[0] for r in rows] == \
        [r["name"] for r in docs[stem]["rows"]]
    assert docs[stem]["device"] == "cpu"


@pytest.mark.parametrize("which", ["canonical", "opt"])
def test_table3_rows_are_the_references(runs, which):
    """The port prints the reference's rows (its standard-HNSW batched row
    beside the measured one where that is another mode); the filter A/B
    rows appear only in the canonical configuration with a JSON."""
    ref = _names(runs["ref" if which == "canonical" else "ref_opt"])
    doc = runs[which]["json"]["table3_qps"]
    port = [r["name"] for r in doc["rows"]]
    extra = [n for n in port if n not in ref]
    assert [n for n in port if n in ref] == ref
    if which == "canonical":
        assert extra == ["table3/pHNSW-torch-batched/none"]
        assert "table3/filter_ab/cascade-deferred" in port
    else:
        assert extra == ["table3/pHNSW-torch-batched/none"]
        assert "table3/pHNSW-torch-sharded/p2-cascade-deferred" in port
        assert "filters" not in doc


def test_table3_filters_section_has_the_references_keys(runs):
    ref = runs["ref_doc"]["filters"]
    port = runs["canonical"]["json"]["table3_qps"]["filters"]
    assert list(port) == list(ref) == ["pca", "pq", "none", "pca-deferred",
                                       "cascade-deferred"]
    for mode in ref:
        assert list(port[mode]) == list(ref[mode])
        for k in ("bytes_per_vec", "sidecar_bytes_per_vec", "rerank_mult",
                  "promote_mult"):
            assert port[mode][k] == ref[mode][k], (mode, k)
        assert abs(port[mode]["recall"] - ref[mode]["recall"]) <= 0.02


def test_runner_leaves_the_tracked_files_alone(runs):
    before, after = runs["digests"]
    assert before == after


def test_runner_refuses_the_cpu_unless_asked(monkeypatch):
    from repro_torch.bench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run.main(["--perf-smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--build", "--device", "cuda"])


SUITE = ["table3_qps", "fig2_kselect", "fig5_energy", "pq_ablation",
         "churn"]


def _stub_suite(monkeypatch, calls, fail=None, roofline=()):
    from repro_torch.bench import (churn, fig2_kselect, fig5_energy,
                                   kernel_footprint, pq_ablation,
                                   table3_qps)
    from repro_torch.launch import roofline as rl
    monkeypatch.setattr(rl, "load_all", lambda mesh: list(roofline))
    for mod in (table3_qps, fig2_kselect, fig5_energy, kernel_footprint,
                pq_ablation, churn):
        name = mod.__name__.rsplit(".", 1)[1]

        def stub(*a, _name=name, **kw):
            calls.append((_name, a, kw))
            if _name == fail:
                raise ValueError(f"{_name} broke")
            print(f"{_name}/row,0.000,stub=1")
        monkeypatch.setattr(mod, "main", stub)


def test_full_suite_runs_in_the_references_order(monkeypatch, tmp_path):
    calls = []
    _stub_suite(monkeypatch, calls)
    lines = _run(["--fast", "--device", "cpu", "--out", str(tmp_path)])
    assert lines[0] == HEADER
    assert [c[0] for c in calls] == SUITE        # no footprint on the CPU
    assert lines[1:] == [f"{n}/row,0.000,stub=1" for n in SUITE]
    kw = {c[0]: (c[1], c[2]) for c in calls}
    assert kw["table3_qps"][0] == (8_000, 64)
    assert kw["fig2_kselect"][0] == (8_000, 64)
    assert kw["churn"][0] == (8_000, 64)
    assert kw["pq_ablation"][1]["out"] == str(tmp_path / "pq_ablation.json")
    assert kw["table3_qps"][1]["filter_kind"] == "pca"


def test_full_suite_reraises_a_failed_bench(monkeypatch, capsys):
    calls = []
    _stub_suite(monkeypatch, calls, fail="fig5_energy")
    from repro_torch.bench import run
    with pytest.raises(ValueError, match="fig5_energy broke"):
        run.main(["--fast", "--device", "cpu"])
    assert [c[0] for c in calls] == SUITE[:3]
    assert "# repro_torch.bench.fig5_energy FAILED" in capsys.readouterr().err


def test_load_mode_hands_on_its_flags(monkeypatch, tmp_path):
    from repro_torch.bench import load
    calls = []
    monkeypatch.setattr(load, "main",
                        lambda *a, **kw: calls.append((a, kw)))
    prom = tmp_path / "load.prom"
    lines = _run(["--load", "--n-points", "2000", "--device", "cpu",
                  "--prom-out", str(prom), "--out", str(tmp_path)])
    assert lines == [HEADER]
    assert calls == [((2_000,), {"device": "cpu",
                                 "out": str(tmp_path / "load.json"),
                                 "prom_path": str(prom)})]


def test_full_suite_prints_the_roofline_appendix(monkeypatch):
    row = {"arch": "starcoder2-3b", "shape": "train_4k", "compute_s": 0.5,
           "memory_s": 0.25, "collective_s": 0.125, "bottleneck": "compute",
           "roofline_fraction": 0.4, "useful_flops_ratio": 0.6}
    _stub_suite(monkeypatch, [], roofline=[row])
    lines = _run(["--fast", "--device", "cpu"])
    assert lines[-1] == ("roofline/starcoder2-3b/train_4k,500000.0,"
                         "bottleneck=compute;roofline_frac=0.4;"
                         "useful_flops=0.6")
