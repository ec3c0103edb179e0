"""CPU tests of the reference: exact neighbours against a numpy brute
force, and the TF32 rounding of the control."""
import numpy as np
import pytest
import torch

from perfbench.reference import data
from perfbench.reference.knn import exact_knn, round_tf32, tf32_knn

DATA = {"n_clusters": 8, "intrinsic": 16, "noise": 0.04, "scale": 20.0,
        "offset": 80.0}


def brute(x, q, k):
    d = ((q.astype(np.float64)[:, None] - x.astype(np.float64)[None]) ** 2
         ).sum(-1)
    i = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, i, 1), i


@pytest.mark.parametrize("k", [1, 10])
def test_exact_knn_matches_a_numpy_brute_force(k):
    x = data.make_vectors(700, 128, DATA, 3)
    q = data.make_queries(x, 50, 0.05, 4)
    d, i = exact_knn(x, q, k, device="cpu", block=16)
    bd, bi = brute(x, q, k)
    np.testing.assert_array_equal(i.numpy(), bi)
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12)


def test_the_tf32_control_differs_from_the_reference():
    x = data.make_vectors(700, 128, DATA, 3)
    q = data.make_queries(x, 50, 0.05, 4)
    d, _ = exact_knn(x, q, 10, device="cpu")
    c, _ = tf32_knn(x, q, 10, device="cpu")
    gap = (c.double() - d).abs() / (d + 1.0)
    assert gap.max() > 1e-3


def test_round_tf32_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 300.123,
                      -7.77e-3, 0.0])
    r = round_tf32(t)
    assert r.tolist()[:4] == [1.0, 1.0, 1.0 + 2 ** -9, 300.0]
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert (r - t).abs().max() <= 2 ** -11 * t.abs().max()
