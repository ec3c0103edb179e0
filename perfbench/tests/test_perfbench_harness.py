"""CPU tests of the benchmark harness: cells found by name, seeded inputs,
the kernels' byte counts, the trace's reduction, the import guard and the
result line."""
import json
import re
import time

import numpy as np
import pytest

from perfbench import cell, generator, guard, run, trace
from perfbench.kernels import dist_h, peaks, trip_fold

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"config": {"n_points": 1000}, "traffic": {"batch": 256}}


def test_every_cell_finds_its_pieces_by_name():
    bench = cell.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["name"])
        conf, traffic = run.scaled(bench, w)
        assert conf["name"] == w["config"]
        assert traffic["loop"] == "closed" and traffic["k"] <= conf["ef0"]
        kinds = {k: cell.metrics(bench, w["name"], k)
                 for k in ("end_to_end", "per_layer")}
        assert "setup_s" in [m["name"] for m in kinds["end_to_end"]]
        assert len(kinds["end_to_end"]) >= 2 and kinds["per_layer"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert callable(cell.reader(m["name"]))
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert m["moves"] in [e["name"] for e in bench["end_to_end"]]
    for c in bench["configs"]:
        conf = cell.config(bench, c["name"])
        assert c["source"] == conf["source"]
        assert c["reduced"] == conf["reduced"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cell.workload(cell.benchmark(), "no-such-cell")


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 17])
def test_inputs_repeat_for_a_seed(seed):
    bench = cell.benchmark()
    conf, traffic = run.scaled(bench, bench["workloads"][0], SMALL)
    a = run.inputs(conf, traffic, seed)
    b = run.inputs(conf, traffic, seed)
    c = run.inputs(conf, traffic, seed + 1)
    for u, v in zip(a, b):
        for s, t in zip(u if isinstance(u, list) else [u],
                        v if isinstance(v, list) else [v]):
            np.testing.assert_array_equal(s, t)
    np.testing.assert_array_equal(a[0], c[0])      # one database
    assert not np.array_equal(a[1], c[1])          # the seed's queries
    x, pool, perms, batches = a
    assert x.shape == (1000, 128) and x.dtype == np.float32
    assert x.min() >= 0 and pool.shape == (256, 128)
    assert len(perms) == generator.RING
    for p, q in zip(perms, batches):
        assert sorted(p) == list(range(256))
        np.testing.assert_array_equal(q, pool[p])


def test_closed_loop_counts_every_call_and_stops_at_a_failure():
    batches = [np.zeros((4, 2), np.float32)] * 3
    n = {"calls": 0}

    def call(q):
        n["calls"] += 1
        if n["calls"] == 5:
            raise RuntimeError("lost")
        return np.zeros((4, 1)), np.zeros((4, 1), np.int64)

    w = generator.drive(call, batches, {"loop": "closed"}, 60.0)
    assert w["calls"] == 4 and w["queries"] == 16 and w["failed"] == 4
    assert [r for r, _, _ in w["records"]] == [0, 1, 2, 0]
    assert "lost" in w["error"]


def test_open_loop_serves_every_arrival_and_times_from_it():
    traffic = generator.checked({"loop": "open", "batch": 2, "rate": 200.0,
                                 "k": 10})
    due = generator.arrivals(traffic, 0.5, 11)
    np.testing.assert_array_equal(due, generator.arrivals(traffic, 0.5, 11))
    assert 40 < len(due) < 200 and due[-1] < 0.5
    assert np.all(np.diff(due) > 0)
    slow = {"n": 0}

    def call(q):
        slow["n"] += 1
        if slow["n"] == 3:
            time.sleep(0.05)        # the calls due meanwhile queue
        return np.zeros((2, 1)), np.zeros((2, 1), np.int64)

    w = generator.drive(call, [np.zeros((2, 2))] * 3, traffic, 0.5, 11)
    assert w["calls"] == len(due) and w["queries"] == 2 * len(due)
    assert max(w["lat_s"]) >= 0.05
    assert w["seconds"] >= due[-1]


def test_pool_of_several_calls_is_cut_into_the_ring():
    t = generator.checked({"loop": "closed", "batch": 4, "pool": 12,
                           "k": 10})
    ring = generator.ring(12, t, 5)
    assert len(ring) == 3 * generator.RING
    for r in range(generator.RING):
        assert sorted(np.concatenate(ring[3 * r:3 * r + 3])) == \
            list(range(12))


@pytest.mark.parametrize("traffic", [
    {"loop": "closed", "batch": 4, "k": 10, "burst": 3},
    {"loop": "poisson", "batch": 4, "k": 10},
    {"loop": "open", "batch": 4, "k": 10},
    {"loop": "closed", "batch": 4, "k": 10, "rate": 5.0},
    {"loop": "closed", "batch": 4, "pool": 6, "k": 10}])
def test_traffic_the_generator_does_not_apply_is_refused(traffic):
    with pytest.raises(ValueError):
        generator.checked(traffic)


@pytest.mark.parametrize("extra", [{"n_shards": 4}, {"insert_batch": 64}])
def test_configuration_keys_the_harness_does_not_apply_are_refused(extra):
    bench = cell.benchmark()
    conf = cell.config(bench, bench["configs"][0]["name"])
    run.phnsw_config(conf)
    with pytest.raises(ValueError, match=list(extra)[0]):
        run.phnsw_config({**conf, **extra})


def test_the_configuration_selects_the_filter(tmp_path, monkeypatch):
    """A configuration with ``filter_kind`` pq runs the PQ filter."""
    from repro_torch.core import search_torch
    from repro_torch.core.filters import PQFilter
    bench = cell.benchmark()
    conf = {**cell.config(bench, "sift-pca"), "name": "sift-pq",
            "filter_kind": "pq", "pq_train_iters": 2}
    (tmp_path / "sift-pq.json").write_text(json.dumps(conf))
    bench = {**bench, "configs": [{"name": "sift-pq",
                                   "file": str(tmp_path / "sift-pq.json")}]}
    wl = {"name": "sift-pq.bulk", "config": "sift-pq", "traffic": "bulk",
          "chips": 1}
    packed = []
    real = search_torch.build_packed

    def spy(g, filt=None, **kw):
        packed.append(filt)
        return real(g, filt=filt, **kw)
    monkeypatch.setattr(search_torch, "build_packed", spy)
    res = run.run(bench, wl, 4, 0.2, False, device="cpu", scale=SMALL)
    assert [type(f) for f in packed] == [PQFilter]
    assert res["correct"], res["checks"]


def test_dist_h_need_on_a_hand_worked_call():
    c = {"queries": 4, "dim": 128, "deferred": False, "expand_width": 1,
         "steps": [10, 2], "ef": [10, 1], "k": [16, 8], "dist_h_evals": 50}
    n_bytes, n_ops = dist_h.need(c)
    # 50 rows of 512 B plus their 4 B distance; 4 + 12 query rows of 512 B
    assert n_bytes == 50 * 516 + 16 * 512
    assert n_ops == 3 * 50 * 128
    assert dist_h.need({**c, "deferred": True})[0] == 50 * 516 + 4 * 512
    assert peaks.least_seconds(n_bytes, n_ops) == n_bytes / 3.35e12


def test_trip_fold_need_on_a_hand_worked_row():
    # layer 0 of sift-pca: ef 10, k 16, kk 16, cap 26, the kv row fed
    b, o = trip_fold.row_need(10, 16, 16, True)
    assert b == 2 * (80 + 208 + 64) + 4 * 3 * 16
    assert o == 2 * 256 + 26 + 42 + 32
    c = {"deferred": False, "expand_width": 1, "steps": [3, 5],
         "ef": [10, 1], "k": [16, 8]}
    b1, _ = trip_fold.row_need(1, 8, 8, True)
    assert trip_fold.need(c)[0] == 3 * b + 5 * b1


def test_roofline_share_from_a_trace():
    c = {"queries": 4, "dim": 128, "deferred": True, "expand_width": 1,
         "steps": [1], "ef": [30], "k": [16], "dist_h_evals": 1000}
    least = peaks.least_seconds(*dist_h.need(c))
    r = {"counts": c, "trace": {"calls": 2, "kernel_s": {
        "void (anonymous namespace)::dist_h_kernel(float const*)":
            8 * least, "other": 1.0}}}
    assert peaks.roofline_pct(r, dist_h) == pytest.approx(25.0)
    assert peaks.roofline_pct(r, trip_fold) is None
    assert peaks.roofline_pct({}, dist_h) is None


def test_trace_reduction_busy_share_and_gap_labels():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void k_a(int)", "ts": 10,
         "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "void k_a(int)", "ts": 25,
         "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60,
         "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::index_select",
         "ts": 38, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 40, "dur": 5},
    ]
    r = trace.reduce(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(35e-6)
    assert r["device_ops"][0] == ["k_a", pytest.approx(30e-6)]
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::index_select"] == pytest.approx(25e-6)
    assert gaps[trace.NO_OP] == pytest.approx(40e-6)
    assert trace.reduce([])["busy_s"] == 0.0


def test_import_guard_compares_whole_top_level_names():
    assert guard.forbidden(["repro_torch", "repro_torch.core.search_torch",
                            "numpy", "jaxtyping", "reprox"]) == []
    assert guard.forbidden(["repro.core.search_jax", "jaxlib.xla_client",
                            "jax", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


ARGS = ["--workload", "sift-pca.bulk", "--seed", "1", "--seconds", "1",
        "--trace", "0"]


def test_main_refuses_a_host_without_a_card(capsys, monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    # the test process may hold JAX (other tests load it): look past it
    monkeypatch.setattr(guard, "forbidden", lambda modules: [])
    assert run.main(ARGS) == 2
    assert capsys.readouterr().out == ""


def test_main_refuses_a_process_that_holds_jax(capsys, monkeypatch):
    monkeypatch.setattr(guard, "forbidden", lambda modules: ["jax"])
    assert run.main(ARGS) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


@pytest.mark.parametrize("trace_on", [0, 1])
def test_last_line_shape(trace_on):
    bench = cell.benchmark()
    wl = bench["workloads"][0]
    res = run.run(bench, wl, 7, 0.2, bool(trace_on), device="cpu",
                  scale=SMALL)
    json.dumps(res)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True
    assert res["attempted"] >= 256 and res["attempted"] % 256 == 0
    assert res["failed"] == 0
    kind = "per_layer" if trace_on else "end_to_end"
    names = {m["name"] for m in cell.metrics(bench, wl["name"], kind)}
    assert set(res["metrics"]) <= names
    if not trace_on:
        assert set(res["metrics"]) == names - {"peak_mem_gib"}
    for line in run.check_lines(res["checks"]):
        assert line.startswith("check ")
