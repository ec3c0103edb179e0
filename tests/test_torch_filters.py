"""repro_torch's product quantization and filter stage against
``repro.core.pq`` / ``repro.core.filters``.

Training and encoding keep the reference's numpy arithmetic and random
calls, so codebooks and codes are bit-equal; the device prep
(``prepare_torch``) matches the reference's ``prepare_jnp`` to rtol 1e-6
(f32 reduction order), exactly on integer centroids and queries."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.configs.base import PHNSWConfig as RefConfig
from repro.core import filters as rfilters
from repro.core import pq as rpq
from repro.core.pca import PCA as RefPCA
from repro_torch.configs.base import PHNSWConfig
from repro_torch.core import filters, pq


def _data(n, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)) \
        .astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_train_and_encode_bit_equal(weighted):
    x = _data(1000)
    w = np.random.default_rng(1).integers(1, 4, len(x)) if weighted \
        else None
    cb = pq.train_pq(x, 4, iters=2, seed=3, weights=w)
    cb0 = rpq.train_pq(x, 4, iters=2, seed=3, weights=w)
    np.testing.assert_array_equal(cb.centroids, cb0.centroids)
    np.testing.assert_array_equal(pq.encode_pq(cb, x),
                                  rpq.encode_pq(cb0, x))
    q = _data(5, seed=2)
    np.testing.assert_array_equal(pq.adc_table_batch(cb, q),
                                  rpq.adc_table_batch(cb0, q))
    np.testing.assert_array_equal(pq.adc_table(cb, q[0]),
                                  rpq.adc_table(cb0, q[0]))


def test_train_small_n_bit_equal():
    """Fewer points than codes: sampling with replacement plus jitter."""
    x = _data(100)
    np.testing.assert_array_equal(
        pq.train_pq(x, 4, iters=2, seed=0).centroids,
        rpq.train_pq(x, 4, iters=2, seed=0).centroids)


def test_make_filter_matches_reference_with_subsample():
    """Above 20k points both take the same seeded random subsample and
    weight it by ``levels + 1``; pq and cascade share one codebook."""
    x = _data(20_500, seed=5)
    levels = np.random.default_rng(6).integers(0, 3, len(x))
    cfg = PHNSWConfig(name="pq", n_points=len(x), dim=16, d_low=4,
                      pq_n_sub=4, pq_train_iters=1, filter_kind="pq")
    f_pq = filters.make_filter(cfg, x, seed=2, levels=levels)
    f_c = filters.make_filter(dataclasses.replace(cfg, filter_kind="cascade"),
                              x, seed=2, levels=levels)
    r_pq = rfilters.make_filter(RefConfig(**dataclasses.asdict(cfg)), x,
                                seed=2, levels=levels)
    np.testing.assert_array_equal(f_pq.cb.centroids, r_pq.cb.centroids)
    np.testing.assert_array_equal(f_c.cb.centroids, f_pq.cb.centroids)
    np.testing.assert_array_equal(f_pq.encode(x[:300]), r_pq.encode(x[:300]))
    assert f_c.pca.d_low == 4 and f_c.bytes_per_vec == 4
    assert f_c.mid_bytes_per_vec == 16 and f_c.mid_cost_dims == 4
    assert f_pq.cost_dims == 4 and f_pq.payload_dtype == np.uint8


def _ref_and_port(kind, integer):
    """A reference filter and the port's, carried across with
    ``filters.from_reference``. With ``integer`` the centroids are small
    integers and the PCA selects coordinates, so every table entry and
    projection is exact."""
    rng = np.random.default_rng(11)
    if integer:
        cents = rng.integers(0, 8, (4, 256, 4)).astype(np.float32)
        comps = np.eye(16, 4, dtype=np.float32)
        mean = np.zeros(16, np.float32)
    else:
        cents = rng.standard_normal((4, 256, 4)).astype(np.float32)
        comps = np.linalg.qr(rng.standard_normal((16, 4)))[0] \
            .astype(np.float32)
        mean = rng.standard_normal(16).astype(np.float32)
    expl = np.full(4, 0.25, np.float32)
    rcb, rp = rpq.PQCodebook(cents), RefPCA(mean, comps, expl)
    ref = {"pq": rfilters.PQFilter(rcb),
           "cascade": rfilters.CascadeFilter(rcb, rp),
           "pca": rfilters.PCAFilter(rp)}[kind]
    port = filters.from_reference(kind, {"centroids": cents, "mean": mean,
                                         "components": comps,
                                         "explained": expl})
    return ref, port


@pytest.mark.parametrize("kind", ["pq", "cascade", "pca"])
@pytest.mark.parametrize("integer", [False, True])
def test_prepare_torch_matches_prepare_jnp(kind, integer):
    ref, port = _ref_and_port(kind, integer)
    rng = np.random.default_rng(12)
    q = rng.integers(0, 8, (6, 16)).astype(np.float32) if integer \
        else rng.standard_normal((6, 16)).astype(np.float32)
    got = port.prepare_torch(torch.from_numpy(q)).numpy()
    want = np.asarray(ref.prepare_jnp(jnp.asarray(q)))
    assert got.shape == want.shape and got.dtype == np.float32
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(port.prepare(q), ref.prepare(q))
    # the device codebook is uploaded once and reused
    if kind != "pca":
        assert len(port._cents_dev) == 1
        port.prepare_torch(torch.from_numpy(q))
        assert len(port._cents_dev) == 1


def test_host_oracles_match_reference():
    """``dists`` / ``mid_dists`` (the host numpy oracles) and the
    payloads agree with the reference's."""
    x = _data(40, seed=8)
    q = _data(3, seed=9)
    for kind in ("pq", "cascade"):
        ref, port = _ref_and_port(kind, integer=False)
        pay = port.encode(x)
        np.testing.assert_array_equal(pay, ref.encode(x))
        qp = port.prepare(q)
        np.testing.assert_array_equal(port.dists(qp[0], pay),
                                      ref.dists(qp[0], pay))
    np.testing.assert_array_equal(port.encode_mid(x), ref.encode_mid(x))
    np.testing.assert_array_equal(port.mid_dists(qp[0], port.encode_mid(x)),
                                  ref.mid_dists(qp[0], ref.encode_mid(x)))
    ident = filters.from_reference("none", {"dim": 16})
    assert ident.kind == "none" and ident.cost_dims == 16
    assert ident.prepare_torch(torch.from_numpy(q)).shape == (3, 0)
