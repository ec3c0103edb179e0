"""repro_torch kernel ops against the JAX reference ops.

On the CPU each op in ``repro_torch.kernels.ops`` runs its plain PyTorch
version; it is held against ``repro.kernels.ops`` both on the jnp
oracles (``REPRO_KERNEL_IMPL=ref``) and on the Pallas kernels in
interpret mode (``REPRO_FORCE_PALLAS_INTERPRET=1``), over the shape
sweeps and edge cases of ``tests/test_kernels.py``. Inputs are made with
numpy from a seed. Distances are compared at rtol 1e-6 / atol 1e-3 (the
f32 reduction order differs between the frameworks); indices exactly.
The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.constants import INF, VALID_MAX
from repro_torch.kernels import ops, ref

RTOL, ATOL = 1e-6, 1e-3


@pytest.fixture(params=["ref", "interpret"])
def jax_impl(request, monkeypatch):
    """Route the JAX ops to the jnp oracles or to the Pallas kernels in
    interpret mode; the dispatch is read at trace time, so compiled
    programs are dropped around the switch."""
    if request.param == "ref":
        monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
        monkeypatch.delenv("REPRO_FORCE_PALLAS_INTERPRET", raising=False)
    else:
        monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


def _both(*arrays):
    """The same numpy inputs as (jax arrays, torch CPU tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _expand_inputs(rng, B, M, dl):
    x = rng.standard_normal((B, M, dl)).astype(np.float32)
    q = rng.standard_normal((B, dl)).astype(np.float32)
    valid = rng.integers(0, 2, (B, M)).astype(bool)
    th = np.where(rng.random(B) < 0.5, 2.0 * dl, INF).astype(np.float32)
    return x, q, valid, th


def _sorted_lists(rng, B, Na, Nb):
    """Ascending rows drawn from a small pool, so ties are plentiful."""
    a = np.sort(rng.choice(rng.standard_normal(16), (B, Na)), axis=1)
    b = np.sort(rng.choice(rng.standard_normal(16), (B, Nb)), axis=1)
    ia = rng.integers(0, 999, (B, Na)).astype(np.int32)
    ib = rng.integers(0, 999, (B, Nb)).astype(np.int32)
    return a.astype(np.float32), ia, b.astype(np.float32), ib


def _check(got_d, got_i, want_d, want_i):
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


# ------------------------- shape sweeps vs JAX -----------------------------

@pytest.mark.parametrize("B,K,D", [(8, 16, 128), (8, 3, 128), (16, 32, 64)])
def test_dist_h_sweep(B, K, D, jax_impl):
    rng = np.random.default_rng(B * 1000 + K * 10 + D)
    x = rng.standard_normal((B, K, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    (jx, jq), (tx, tq) = _both(x, q)
    np.testing.assert_allclose(ops.dist_h(tx, tq).numpy(),
                               np.asarray(jops.dist_h(jx, jq)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,M,dl,k", [(8, 32, 15, 16), (8, 16, 15, 3),
                                      (16, 64, 16, 8)])
def test_fused_expand_sweep(B, M, dl, k, jax_impl):
    rng = np.random.default_rng(M * 100 + k)
    (jx, jq, jv, jt), (tx, tq, tv, tt) = _both(*_expand_inputs(rng, B, M,
                                                               dl))
    _check(*ops.fused_expand(tx, tq, tv, tt, k),
           *jops.fused_expand(jx, jq, jv, jt, k))


@pytest.mark.parametrize("Na,Nb,k", [(36, 16, 36), (10, 16, 10),
                                     (16, 16, 16), (64, 3, 64),
                                     (32, 8, 20)])
def test_merge_sorted_sweep(Na, Nb, k, jax_impl):
    rng = np.random.default_rng(Na * 100 + Nb)
    (ja, jia, jb, jib), (ta, tia, tb, tib) = _both(
        *_sorted_lists(rng, 8, Na, Nb))
    _check(*ops.merge_topk_sorted(ta, tia, tb, tib, k),
           *jops.merge_topk_sorted(ja, jia, jb, jib, k))


@pytest.mark.parametrize("B,K,dl", [(8, 1, 15), (8, 60, 15), (16, 32, 4)])
def test_dist_l_sweep(B, K, dl, jax_impl):
    rng = np.random.default_rng(B * 1000 + K * 10 + dl)
    x = rng.standard_normal((B, K, dl)).astype(np.float32)
    q = rng.standard_normal((B, dl)).astype(np.float32)
    (jx, jq), (tx, tq) = _both(x, q)
    np.testing.assert_allclose(ops.dist_l(tx, tq).numpy(),
                               np.asarray(jops.dist_l(jx, jq)),
                               rtol=RTOL, atol=ATOL)


def _pq_inputs(rng, B, M, S, integer=False):
    """uint8 codes, non-negative tables (integer-valued when asked, so
    every sum is exact), a random mask and thresholds half at S."""
    codes = rng.integers(0, 256, (B, M, S)).astype(np.uint8)
    if integer:
        lut = rng.integers(0, 1 << 16, (B, S, 256)).astype(np.float32)
    else:
        lut = np.abs(rng.standard_normal((B, S, 256)) * 2.0) \
            .astype(np.float32)
    valid = rng.integers(0, 2, (B, M)).astype(bool)
    th = np.where(rng.random(B) < 0.5, float(S), INF).astype(np.float32)
    return codes, lut, valid, th


@pytest.mark.parametrize("B,M,S,k", [(8, 32, 16, 16), (8, 16, 8, 3),
                                     (16, 64, 4, 8)])
def test_pq_adc_expand_sweep(B, M, S, k, jax_impl):
    """The sweep of tests/test_kernels.py::test_pq_adc_expand_sweep; the
    reference takes int32 codes (its TPU kernel's dtype), the port
    uint8."""
    rng = np.random.default_rng(M * 100 + S + k)
    codes, lut, valid, th = _pq_inputs(rng, B, M, S)
    (jc, jl, jv, jt), (tc, tl, tv, tt) = _both(codes.astype(np.int32), lut,
                                               valid, th)
    _check(*ops.pq_adc_expand(torch.from_numpy(codes), tl, tv, tt, k),
           *jops.pq_adc_expand(jc, jl, jv, jt, k))


@pytest.mark.parametrize("op", ["fused_expand", "fused_filter",
                                "pq_adc_expand"])
@pytest.mark.parametrize("M", [160, 256])
def test_wide_expands_match_reference(M, op, jax_impl):
    """Rows past the warp tiers (M > 128: expand_width * M0 at W >= 5, or
    M0 = 160 at W = 1), which the card serves with a block per row,
    against the JAX op."""
    rng = np.random.default_rng(M + len(op))
    B, k = 4, 24
    if op == "pq_adc_expand":
        codes, lut, valid, th = _pq_inputs(rng, B, M, 16)
        (jc, jl, jv, jt), (tc, tl, tv, tt) = _both(codes.astype(np.int32),
                                                   lut, valid, th)
        _check(*ops.pq_adc_expand(torch.from_numpy(codes), tl, tv, tt, k),
               *jops.pq_adc_expand(jc, jl, jv, jt, k))
        return
    (jx, jq, jv, jt), (tx, tq, tv, tt) = _both(*_expand_inputs(rng, B, M,
                                                               15))
    if op == "fused_expand":
        _check(*ops.fused_expand(tx, tq, tv, tt, k),
               *jops.fused_expand(jx, jq, jv, jt, k))
    else:
        _check(*ops.fused_filter(tx, tq, k), *jops.fused_filter(jx, jq, k))


@pytest.mark.parametrize("Na,Nb,k", [(12800, 16, 16), (12300, 40, 300)])
def test_merge_past_12288_matches_reference(Na, Nb, k):
    """Merged rows longer than the default 48 KB of shared memory (the
    card opts into more, or merges in global memory) against the JAX
    op's jnp oracle, ties and all."""
    rng = np.random.default_rng(Na + Nb)
    (ja, jia, jb, jib), (ta, tia, tb, tib) = _both(
        *_sorted_lists(rng, 2, Na, Nb))
    _check(*ops.merge_topk_sorted(ta, tia, tb, tib, k),
           *jref.merge_topk_sorted_ref(ja, jia, jb, jib, k))


@pytest.mark.parametrize("M,k", [(13000, 10), (70000, 64)])
def test_ksort_past_12288_is_a_stable_sort(M, k):
    """kSort.L over rows longer than the default 48 KB of shared memory:
    the plain version against numpy's stable argsort (the reference's
    comparison matrix would be M x M), ties to the lower index, -0.0
    beside 0.0."""
    rng = np.random.default_rng(M)
    d = rng.choice(np.asarray([-0.0, 0.0, 1.0, 2.5, INF], np.float32),
                   (2, M))
    d[1, : M // 2] = rng.standard_normal(M // 2).astype(np.float32)
    v, i = ops.ksort_l(torch.from_numpy(d), k)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(i.numpy(), order)
    np.testing.assert_array_equal(v.numpy(),
                                  np.take_along_axis(d, order, 1))


@pytest.mark.parametrize("B,K,S", [(8, 1, 16), (4, 12, 8)])
def test_pq_adc_matches_reference(B, K, S, jax_impl):
    rng = np.random.default_rng(K + S)
    codes, lut, _, _ = _pq_inputs(rng, B, K, S)
    (jc, jl), (tc, tl) = _both(codes.astype(np.int32), lut)
    np.testing.assert_allclose(
        ops.pq_adc(torch.from_numpy(codes), tl).numpy(),
        np.asarray(jops.pq_adc(jc, jl)), rtol=RTOL, atol=ATOL)


def test_pq_adc_expand_exact_on_integer_tables(jax_impl):
    """Integer-valued tables make every f32 sum exact in any order:
    distances and indices are bit-equal to the reference (plenty of
    exact ties from repeated code rows), and the plain ADC equals
    ``repro.core.pq.adc_distances``."""
    from repro.core.pq import adc_distances
    rng = np.random.default_rng(41)
    codes, lut, valid, th = _pq_inputs(rng, 8, 32, 16, integer=True)
    codes[:, 16:] = codes[:, :16]                 # exact duplicate rows
    th[:] = INF
    (jc, jl, jv, jt), (tc, tl, tv, tt) = _both(codes.astype(np.int32), lut,
                                               valid, th)
    d, i = ops.pq_adc_expand(tc, tl, tv, tt, 32)
    d0, i0 = jops.pq_adc_expand(jc, jl, jv, jt, 32)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d0))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i0))
    plain = ref.pq_adc_ref(tc, tl).numpy()
    for b in range(8):
        np.testing.assert_array_equal(plain[b],
                                      adc_distances(lut[b], codes[b]))


def test_pq_adc_expand_reads_a_strided_table():
    """The cascade's tables are a strided view into its flat per-query
    row [S*256 + d_low]; the op gives the same result as on a copy."""
    rng = np.random.default_rng(7)
    codes, lut, valid, th = _pq_inputs(rng, 8, 32, 16)
    flat = np.concatenate([lut.reshape(8, -1),
                           rng.standard_normal((8, 15)).astype(np.float32)],
                          axis=1)
    view = torch.from_numpy(flat)[:, :16 * 256].reshape(8, 16, 256)
    assert not view.is_contiguous()
    tc, tl, tv, tt = (torch.from_numpy(a) for a in (codes, lut, valid, th))
    _check(*ops.pq_adc_expand(tc, view, tv, tt, 16),
           *ops.pq_adc_expand(tc, tl, tv, tt, 16))


def test_pq_adc_expand_k_above_m_raises():
    tc, tl, tv, tt = (torch.from_numpy(a) for a in _pq_inputs(
        np.random.default_rng(0), 8, 16, 8))
    with pytest.raises(ValueError, match="exceeds M"):
        ops.pq_adc_expand(tc, tl, tv, tt, 17)


# ------------------------------ edge cases ---------------------------------

def _edge_expand_inputs(B=8, M=32, dl=15):
    """Rows 0-1 all invalid, rows 2-3 all-equal distances (identical
    neighbor rows), rows 4-5 all above the threshold (every slot an INF
    pad), rows 6-7 random; integer-valued so every sum is exact."""
    rng = np.random.default_rng(88)
    x = rng.integers(0, 4, (B, M, dl)).astype(np.float32)
    q = rng.integers(0, 4, (B, dl)).astype(np.float32)
    x[2:4] = x[2:4, :1]
    valid = np.ones((B, M), bool)
    valid[0:2] = False
    valid[6:8] = rng.integers(0, 2, (2, M)).astype(bool)
    th = np.full(B, INF, np.float32)
    th[4:6] = 0.0
    return x, q, valid, th


@pytest.mark.parametrize("k", [1, 16, 32])
def test_pq_adc_expand_edge_rows(k, jax_impl):
    """All invalid, all-equal distances (identical code rows) and
    th = 0, on integer tables: bit-equal to the reference."""
    rng = np.random.default_rng(99)
    codes, lut, valid, th = _pq_inputs(rng, 8, 32, 16, integer=True)
    valid[:] = True
    valid[0:2] = False
    codes[2:4] = codes[2:4, :1]
    th[:] = INF
    th[4:6] = 0.0
    (jc, jl, jv, jt), (tc, tl, tv, tt) = _both(codes.astype(np.int32), lut,
                                               valid, th)
    d, i = ops.pq_adc_expand(torch.from_numpy(codes), tl, tv, tt, k)
    d0, i0 = jops.pq_adc_expand(jc, jl, jv, jt, k)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d0))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i0))
    assert (d[0:2] >= VALID_MAX).all() and (d[4:6] >= VALID_MAX).all()
    np.testing.assert_array_equal(i[2].numpy(), np.arange(k))


@pytest.mark.parametrize("k", [1, 16, 32])
def test_fused_expand_edge_rows(k, jax_impl):
    (jx, jq, jv, jt), (tx, tq, tv, tt) = _both(*_edge_expand_inputs())
    d, i = ops.fused_expand(tx, tq, tv, tt, k)
    _check(d, i, *jops.fused_expand(jx, jq, jv, jt, k))
    # non-survivors sort last as (INF, ascending index)
    assert (d[0:2] >= VALID_MAX).all() and (d[4:6] >= VALID_MAX).all()
    np.testing.assert_array_equal(i[0].numpy(), np.arange(k))
    np.testing.assert_array_equal(i[2].numpy(), np.arange(k))


def test_fused_expand_k_above_m_raises():
    """The reference's ksort_block leaves slots M..k-1 as (0.0, 0) for
    k > M; no configuration reaches it, and the port refuses it."""
    x, q, valid, th = (torch.from_numpy(a) for a in _expand_inputs(
        np.random.default_rng(0), 8, 16, 15))
    with pytest.raises(ValueError, match="exceeds M"):
        ops.fused_expand(x, q, valid, th, 17)


def test_merge_sorted_edge_cases(jax_impl):
    """Duplicate distances (a side wins ties, then lower slot), an
    all-INF b list (output == a), both all-INF, and k=1."""
    d_a = np.asarray([[1.0, 1.0, 2.0]], np.float32)
    i_a = np.asarray([[0, 1, 2]], np.int32)
    d_b = np.asarray([[1.0, 2.0]], np.float32)
    i_b = np.asarray([[10, 11]], np.int32)
    d_inf = np.full((1, 2), INF, np.float32)
    i_inf = np.full((1, 2), -1, np.int32)
    for args, k in [((d_a, i_a, d_b, i_b), 5), ((d_a, i_a, d_inf, i_inf), 3),
                    ((d_inf, i_inf, d_inf, i_inf), 2),
                    ((d_a, i_a, d_b, i_b), 1)]:
        j, t = _both(*args)
        _check(*ops.merge_topk_sorted(*t, k), *jops.merge_topk_sorted(*j, k))
    d, i = ops.merge_topk_sorted(*_both(d_a, i_a, d_b, i_b)[1], 5)
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 10, 2, 11]])


def test_merge_keeps_first_k_of_b():
    """The reference's quirk: only the first k rows of b can reach a
    k-wide output, so a wider b is cut before the merge."""
    rng = np.random.default_rng(5)
    (ja, jia, jb, jib), (ta, tia, tb, tib) = _both(
        *_sorted_lists(rng, 4, 4, 12))
    _check(*ops.merge_topk_sorted(ta, tia, tb, tib, 4),
           *jops.merge_topk_sorted(ja, jia, jb, jib, 4))


@pytest.mark.parametrize("B,M,k", [(8, 16, 3), (8, 32, 16), (16, 32, 8),
                                   (8, 64, 16), (8, 128, 32), (4, 8, 12)])
def test_plain_ksort_and_dist_l_match_reference(B, M, k):
    """The plain kSort.L (stable sort) gives the reference's comparison-
    matrix order, including its (0.0, 0) tail for k > M."""
    rng = np.random.default_rng(M + k)
    d = rng.choice(rng.standard_normal(8), (B, M)).astype(np.float32)
    v, i = ref.ksort_l_ref(torch.from_numpy(d), k)
    v0, i0 = jref.ksort_l_ref(jnp.asarray(d), k)
    _check(v, i, v0, i0)
    x = rng.standard_normal((B, M, 15)).astype(np.float32)
    q = rng.standard_normal((B, 15)).astype(np.float32)
    np.testing.assert_allclose(
        ref.dist_l_ref(torch.from_numpy(x), torch.from_numpy(q)).numpy(),
        np.asarray(jref.dist_l_ref(jnp.asarray(x), jnp.asarray(q))),
        rtol=RTOL, atol=ATOL)


def _ksort_rows(rng, B, M):
    """The reference sweep's draw (``rnd(scale=3.0)``: negative values
    included) with edge rows where B allows: a tie pool, all-INF, and
    -0.0 beside 0.0 (equal as floats, so they tie by index)."""
    d = (3.0 * rng.standard_normal((B, M))).astype(np.float32)
    if B >= 4:
        d[1] = rng.choice(np.asarray([0.0, 1.0, 1.0, 2.0], np.float32), M)
        d[2] = INF
        d[3] = rng.choice(np.asarray([-0.0, 0.0, 1.0], np.float32), M)
    return d


@pytest.mark.parametrize("B,M,k", [(8, 16, 3), (8, 32, 16), (16, 32, 8),
                                   (8, 64, 16), (8, 128, 32),
                                   (4, 40, 10), (4, 120, 30), (2, 240, 60),
                                   (4, 33, 5), (1, 40, 40)])
def test_ksort_l_sweep(B, M, k, jax_impl):
    """``ops.ksort_l`` against the JAX op and ``ksort_l_pallas`` in
    interpret mode: the reference's sweep plus the cross-shard merge
    shapes (M = P * E, k = E) and the edge rows; values and indices
    exact (no arithmetic touches a value)."""
    from repro.kernels.ksort_l import ksort_l_pallas
    import math
    d = _ksort_rows(np.random.default_rng(B * 1000 + M * 10 + k), B, M)
    v, i = ops.ksort_l(torch.from_numpy(d), k)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    v0, i0 = jops.ksort_l(jnp.asarray(d), k)
    v1, i1 = ksort_l_pallas(jnp.asarray(d), k, block_b=math.gcd(B, 8),
                            interpret=True)
    for vw, iw in ((v0, i0), (v1, i1)):
        np.testing.assert_array_equal(v.numpy(), np.asarray(vw))
        np.testing.assert_array_equal(i.numpy(), np.asarray(iw))
    if B >= 4:
        np.testing.assert_array_equal(i[2].numpy(), np.arange(k))
        assert (v[2] == INF).all()


def test_ksort_l_k_above_m_raises():
    """The plain version keeps the reference's (0.0, 0) tail for k > M;
    the op refuses it, as ``fused_expand`` does."""
    d = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="exceeds M"):
        ops.ksort_l(d, 9)
    v, i = ref.ksort_l_ref(d, 9)
    assert v[:, 8].tolist() == [0.0, 0.0] and i[:, 8].tolist() == [0, 0]


def test_mixed_devices_raise():
    x = torch.zeros(2, 3, 4)
    q = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="devices"):
        ops.dist_h(x, q)


# ------------------------- bf16 rows vs the Pallas kernels -------------------

# tests/test_kernels.py's shapes of the three Dist.L kernels
BF16_CASES = ([("dist_l", B, M, dl, 0) for B, M, dl in
               [(8, 16, 15), (8, 32, 15), (16, 32, 16), (8, 64, 8),
                (24, 128, 32)]]
              + [(op, B, M, dl, k) for op in ("fused_filter", "fused_expand")
                 for B, M, dl, k in [(8, 32, 15, 16), (8, 16, 15, 3),
                                     (16, 64, 16, 8)]])


@pytest.mark.parametrize("op,B,M,dl,k", BF16_CASES)
def test_bf16_rows_match_pallas_kernels(op, B, M, dl, k):
    """bf16 rows, f32 q: ``ops.dist_l``, ``ops.fused_filter`` and
    ``ops.fused_expand`` against ``dist_l_pallas``,
    ``fused_filter_pallas`` and ``fused_expand_pallas`` in interpret mode
    on the same bf16 values. Both widen every element to f32 before any
    arithmetic, so distances agree to rtol / atol 1e-5 and indices
    exactly."""
    from repro.kernels.dist_l import dist_l_pallas
    from repro.kernels.fused_filter import (fused_expand_pallas,
                                            fused_filter_pallas)
    rng = np.random.default_rng(B * 1000 + M * 10 + dl + k)
    x, q, valid, th = _expand_inputs(rng, B, M, dl)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(np.asarray(jx).view(np.int16),
                          tx.view(torch.int16).numpy())
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    if op == "dist_l":
        got = ops.dist_l(tx, tq)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(), np.asarray(dist_l_pallas(jx, jq, interpret=True)),
            rtol=1e-5, atol=1e-5)
        return
    if op == "fused_filter":
        got = ops.fused_filter(tx, tq, k)
        want = fused_filter_pallas(jx, jq, k, interpret=True)
    else:
        got = ops.fused_expand(tx, tq, torch.from_numpy(valid),
                               torch.from_numpy(th), k)
        want = fused_expand_pallas(jx, jq, jnp.asarray(valid, jnp.int32),
                                   jnp.asarray(th)[:, None], k,
                                   interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
@pytest.mark.parametrize("op", ["dist_l", "fused_filter", "fused_expand",
                                "fused_expand_rows"])
def test_payload_outside_f32_and_bf16_raises(op, dtype):
    """The Dist.L ops take f32 or bf16 rows only, on either device (a
    CUDA tensor would reach a kernel built for those two)."""
    x = torch.zeros(2, 8, 3, dtype=dtype)
    q, th = torch.zeros(2, 3), torch.zeros(2)
    valid = torch.ones(2, 8, dtype=torch.bool)
    call = {"dist_l": lambda: ops.dist_l(x, q),
            "fused_filter": lambda: ops.fused_filter(x, q, 4),
            "fused_expand": lambda: ops.fused_expand(x, q, valid, th, 4),
            "fused_expand_rows": lambda: ops.fused_expand_rows(
                torch.zeros(2, 8, dtype=torch.int32), x,
                torch.zeros(2, 1, dtype=torch.int32),
                torch.ones(2, 1, dtype=torch.bool), q, th, 4)}[op]
    with pytest.raises(TypeError, match="float32 or torch.bfloat16"):
        call()


# ------------------------ fused_filter and attention -------------------------

@pytest.mark.parametrize("B,M,dl,k", [(8, 32, 15, 16), (8, 16, 15, 3),
                                      (16, 64, 16, 8)])
def test_fused_filter_sweep(B, M, dl, k, jax_impl):
    """The sweep of tests/test_kernels.py::test_fused_filter_sweep:
    distances at rtol 1e-6 / atol 1e-3, indices exact."""
    rng = np.random.default_rng(B * 100 + M + k)
    x = rng.standard_normal((B, M, dl)).astype(np.float32)
    q = rng.standard_normal((B, dl)).astype(np.float32)
    (jx, jq), (tx, tq) = _both(x, q)
    _check(*ops.fused_filter(tx, tq, k), *jops.fused_filter(jx, jq, k))


def test_fused_filter_ties_and_k_equal_m(jax_impl):
    """Integer inputs (every sum exact) with all-equal rows: bit-equal to
    the reference, ties to the lower index, k = M."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 4, (8, 32, 15)).astype(np.float32)
    x[2:4] = x[2:4, :1]
    q = rng.integers(0, 4, (8, 15)).astype(np.float32)
    (jx, jq), (tx, tq) = _both(x, q)
    d, i = ops.fused_filter(tx, tq, 32)
    d0, i0 = jops.fused_filter(jx, jq, 32)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d0))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i0))
    np.testing.assert_array_equal(i[2].numpy(), np.arange(32))


def test_fused_filter_k_above_m_raises():
    """k > M would leave the reference's (0.0, 0) tail; the op refuses
    it, as fused_expand and ksort_l do."""
    x, q = torch.zeros(2, 8, 3), torch.zeros(2, 3)
    with pytest.raises(ValueError, match="exceeds M"):
        ops.fused_filter(x, q, 9)


def _attn(rng, dtype, *shapes):
    """Standard-normal f32 arrays, rounded to ``dtype`` the same way in
    both frameworks (f32 -> bf16 is round-to-nearest-even in each)."""
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=tol, atol=tol)


ATTN_TOL = {"f32": 2e-3, "bf16": 0.05}   # tests/test_kernels.py:256


@pytest.mark.parametrize("S,T,window", [(128, 128, 0), (128, 256, 0),
                                        (256, 256, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_sweep(S, T, window, dtype, jax_impl):
    """tests/test_kernels.py::test_flash_attention_sweep's grid, held
    against the JAX op (the Pallas kernel at bq = bk = 64 in interpret
    mode, or the jnp oracle) at the suite's tolerance."""
    rng = np.random.default_rng(S + T + window)
    (jq, jk, jv), (tq, tk, tv) = _attn(rng, dtype, (2, 2, S, 64),
                                       (2, 2, T, 64), (2, 2, T, 64))
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              bq=64, bk=64)
    assert got.dtype == tq.dtype
    _close(got, jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                     bq=64, bk=64), ATTN_TOL[dtype])


def test_flash_attention_noncausal(jax_impl):
    rng = np.random.default_rng(3)
    (jq, jk, jv), (tq, tk, tv) = _attn(rng, "f32", *[(1, 2, 128, 64)] * 3)
    _close(ops.flash_attention(tq, tk, tv, causal=False),
           jops.flash_attention(jq, jk, jv, causal=False, bq=64, bk=64),
           2e-3)


@pytest.mark.parametrize("T,bk", [(256, 64), (512, 128)])
def test_decode_attention_sweep(T, bk, jax_impl):
    """tests/test_kernels.py::test_decode_attention_sweep's (T, bk) grid
    and lengths, against the JAX op."""
    rng = np.random.default_rng(T + bk)
    (jq, jk, jv), (tq, tk, tv) = _attn(rng, "f32", (3, 4, 64),
                                       (3, 4, T, 64), (3, 4, T, 64))
    length = np.asarray([1, T // 2, T], np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(length), bk=bk)
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(length),
                                      bk=bk), 2e-3)


def test_flash_rows_without_keys_are_zero():
    """Causal with S > T: query rows at positions < 0 see no key. The
    Pallas kernel skips every kv block of such a query block and gives
    0; the jnp oracle's softmax over all-NEG_INF logits gives the mean of
    v. The port gives 0 there and equals both elsewhere."""
    from repro.kernels.flash_attention import flash_attention_pallas
    rng = np.random.default_rng(11)
    S, T = 128, 64
    for dtype in ("f32", "bf16"):
        (jq, jk, jv), (tq, tk, tv) = _attn(rng, dtype, (1, 2, S, 64),
                                           (1, 2, T, 64), (1, 2, T, 64))
        got = ops.flash_attention(tq, tk, tv, causal=True)
        pallas = flash_attention_pallas(jq, jk, jv, causal=True, bq=64,
                                        bk=64, interpret=True)
        oracle = jref.flash_attention_ref(jq, jk, jv, causal=True)
        tol = ATTN_TOL[dtype]
        _close(got, pallas, tol)
        assert (got[:, :, :S - T] == 0).all()
        assert np.abs(np.asarray(oracle[:, :, :S - T], np.float32)).max() \
            > 0.05
        _close(got[:, :, S - T:], oracle[:, :, S - T:], tol)


def test_decode_length_zero_is_zero():
    """length == 0: the Pallas kernel skips every block and gives 0, the
    jnp oracle gives the uniform mean of v; the port gives 0, and equals
    both on the rows with a valid prefix."""
    from repro.kernels.decode_attention import decode_attention_pallas
    rng = np.random.default_rng(12)
    T = 256
    (jq, jk, jv), (tq, tk, tv) = _attn(rng, "f32", (3, 4, 64),
                                       (3, 4, T, 64), (3, 4, T, 64))
    length = np.asarray([0, 100, T], np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(length))
    pallas = decode_attention_pallas(jq, jk, jv, jnp.asarray(length), bk=64,
                                     interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(length))
    _close(got, pallas, 2e-3)
    assert (got[0] == 0).all()
    assert np.abs(np.asarray(oracle[0])).max() > 0.05
    _close(got[1:], oracle[1:], 2e-3)


@pytest.mark.parametrize("S,T,causal,window", [
    (64, 64, True, 16), (100, 70, True, 0), (1, 200, True, 0),
    (90, 90, False, 20), (77, 300, True, 1000)])
def test_flash_ragged_shapes_match_reference(S, T, causal, window):
    """Shapes the Pallas kernel's tiling would refuse (S or T not a
    multiple of its blocks) are taken by the port's op: held against the
    jnp oracle on every row that sees a key, 0 on the others."""
    rng = np.random.default_rng(S * 7 + T)
    (jq, jk, jv), (tq, tk, tv) = _attn(rng, "f32", (2, 2, S, 32),
                                       (2, 2, T, 32), (2, 2, T, 32))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    blind = max(S - T, 0) if causal else 0
    assert (got[:, :, :blind] == 0).all()
    _close(got[:, :, blind:], want[:, :, blind:], 2e-3)


def test_attention_op_arguments():
    """A negative window is refused on both devices; bq and bk are the
    reference's TPU tile sizes and change nothing."""
    q = torch.randn(1, 1, 8, 16)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=-1)
    a = ops.flash_attention(q, q, q, bq=8, bk=8)
    b = ops.flash_attention(q, q, q)
    assert torch.equal(a, b)
