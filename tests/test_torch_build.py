"""repro_torch's wave builder against the reference's ``build_hnsw``.

The port probes each wave with its own search (here on the CPU) and
links on the host with the reference's numpy arithmetic, so on an
exact-arithmetic fixture (small-integer vectors) the graph is
bit-identical to the reference wave build; on a float fixture its recall
stays within 0.01 of the reference build's (the bar of
tests/test_build.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core.graph import build_hnsw as ref_build_hnsw
from repro_torch.configs.base import PHNSWConfig
from repro_torch.core.build import graph_invariants
from repro_torch.core.graph import HNSWGraph, build_hnsw
from repro_torch.core.pca import fit_pca
from repro_torch.core.search_torch import build_packed, search_batched
from repro_torch.data.vectors import (brute_force_topk, make_queries,
                                      make_sift_like)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several workers on the host's cores: one torch
    thread each keeps the plain CPU kernels from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(cfg):
    return RefConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("efc,ef_upper", [(10, 4), (24, 8)])
def test_wave_build_bit_identical_on_integer_fixture(efc, ef_upper):
    rng = np.random.default_rng(77)
    x = rng.integers(0, 8, (700, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int700", n_points=700, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=efc, wave_size=160,
                      wave_ef_upper=ef_upper)
    g = build_hnsw(x, cfg, seed=4, device="cpu")
    gr = ref_build_hnsw(x, _ref(cfg), seed=4)
    np.testing.assert_array_equal(g.levels, gr.levels)
    assert g.entry == gr.entry
    assert len(g.layers) == len(gr.layers)
    assert int(g.levels.max()) >= 1          # the probe descends layers
    for a, b in zip(g.layers, gr.layers):
        np.testing.assert_array_equal(a, b)
    inv = graph_invariants(g)
    assert inv["ok"], inv["violations"]


def _recall(g, x, q, gt):
    pca = fit_pca(x, 15)
    db = build_packed(g, pca.transform(x).astype(np.float32), device="cpu")
    _, fi = search_batched(db, q, pca=pca, device="cpu")
    fi = fi.numpy()
    return float(np.mean([len(set(fi[i][:10].tolist()) & set(gt[i])) / 10
                          for i in range(len(q))]))


def test_wave_build_recall_and_invariants_on_float_fixture():
    x = make_sift_like(2000, seed=21)
    q = make_queries(x, 40, seed=22)
    gt = brute_force_topk(x, q, 10)
    cfg = PHNSWConfig(name="f2k", n_points=2000, ef_construction=32,
                      wave_size=512)
    g = build_hnsw(x, cfg, seed=6, device="cpu")
    gr = ref_build_hnsw(x, _ref(cfg), seed=6)
    np.testing.assert_array_equal(g.levels, gr.levels)
    assert g.entry == gr.entry
    inv = graph_invariants(g)
    assert inv["ok"], inv["violations"]
    assert all(f == 1.0 for f in inv["reachable_frac"])
    g_ref = HNSWGraph(cfg=cfg, x=x, levels=gr.levels, layers=gr.layers,
                      entry=gr.entry)
    r_port, r_ref = _recall(g, x, q, gt), _recall(g_ref, x, q, gt)
    assert r_port >= r_ref - 0.01, (r_port, r_ref)


@pytest.mark.parametrize("builder", ["ref", "bogus"])
def test_build_dispatch(builder):
    x = make_sift_like(60, seed=1)
    cfg = PHNSWConfig(name="tiny", n_points=60, ef_construction=8)
    if builder == "bogus":
        with pytest.raises(ValueError, match="unknown builder"):
            build_hnsw(x, cfg, builder=builder, device="cpu")
        return
    g = build_hnsw(x, cfg, builder="ref", seed=2)
    assert graph_invariants(g)["ok"]
