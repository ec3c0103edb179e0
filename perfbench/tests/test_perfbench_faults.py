"""The comparison that decides ``correct`` must fail: the control (the
reference one precision down, in the port's place) and runs of the
harness at a CPU size with the port's timed path broken underneath, once
for each fault a cell can have. The exchange between chips has no fault
to plant: every cell runs on one card with one shard."""
import numpy as np
import pytest
import torch

from perfbench import cell, control, faults, run

SMALL = {"config": {"n_points": 1000}, "traffic": {"batch": 256}}


def small_run(wl, seed=3):
    return run.run(cell.benchmark(), wl, seed, 0.2, False, device="cpu",
                   scale=SMALL)


def cells():
    return cell.benchmark()["workloads"]


@pytest.mark.parametrize("wl", cells(), ids=lambda w: w["name"])
def test_a_sound_run_is_correct(wl):
    res = small_run(wl)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("wl", cells(), ids=lambda w: w["name"])
def test_the_control_is_not_correct(wl):
    r = control.readings(cell.benchmark(), wl, 5, device="cpu",
                         scale=SMALL)
    assert not r["correct"]
    assert r["checks"]["dist_gap"]["value"] > \
        r["checks"]["dist_gap"]["limit"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    faults.in_window(monkeypatch.setattr, "state_unchanged")
    assert not small_run(cells()[0])["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    faults.in_window(monkeypatch.setattr, "half_batch")
    res = small_run(cells()[0])
    assert not res["correct"]
    assert res["checks"]["recall10_min"]["value"] < 0.6


@pytest.mark.parametrize("what", ["id", "distance"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, what):
    faults.in_window(monkeypatch.setattr, f"{what}_altered")
    assert not small_run(cells()[1])["correct"]


def test_wrong_neighbours_at_their_true_distances(monkeypatch):
    """Every 32nd row answered with another query's ids at their true
    distances: only the recall limit can catch it."""
    faults.in_window(monkeypatch.setattr, "wrong_rows")
    res = small_run(cells()[0])
    assert not res["correct"]
    checks = res["checks"]
    assert checks["bad_rows"]["value"] == 0
    assert checks["dist_gap"]["value"] <= checks["dist_gap"]["limit"]
    assert checks["recall10_min"]["value"] < \
        checks["recall10_min"]["limit"]


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wl = cells()[0]
    r = control.readings(cell.benchmark(), wl, 9, device="cuda",
                         scale={"config": {"n_points": 20000},
                                "traffic": {"batch": 4096}})
    assert not r["correct"]
    assert r["checks"]["recall10_min"]["value"] >= 0.92
