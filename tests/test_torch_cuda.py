"""repro_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one; on
the card run them with ``python -m pytest -m cuda tests/test_torch_cuda.py``
(this file imports no jax, so it runs where only PyTorch is installed).

Integer-valued inputs make every f32 sum exact in any order, so there
distances and indices must be identical; on float inputs distances agree
to rtol 1e-5 / atol 1e-3 (the summation order differs)."""
import numpy as np
import pytest
import torch

from repro_torch.bench import kernel_footprint as kf
from repro_torch.constants import INF
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the payload types of the Dist.L kernels
PAYLOADS = {"f32": torch.float32, "bf16": torch.bfloat16}


def _t(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.parametrize("B,M,dl,k", [(1024, 32, 15, 16), (1024, 16, 15, 8),
                                      (1024, 16, 15, 3), (64, 64, 15, 32),
                                      (8, 100, 4, 1)])
def test_fused_expand_matches_plain(cuda, B, M, dl, k):
    rng = np.random.default_rng(B + M + k)
    x = rng.integers(0, 8, (B, M, dl)).astype(np.float32)
    x[1] = x[1, :1]                       # all-equal distances
    q = rng.integers(0, 8, (B, dl)).astype(np.float32)
    valid = rng.random((B, M)) < 0.8
    valid[0] = False                      # all invalid
    th = np.where(rng.random(B) < 0.5, 64.0 * dl, INF).astype(np.float32)
    args = _t(cuda, x, q, valid, th)
    d, i = ops.fused_expand(*args, k)
    d0, i0 = ref.fused_expand_ref(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(d, d0) and torch.equal(i, i0)
    assert ops.launch_counts()["fused_expand"] > 0


@pytest.mark.parametrize("Na,Nb,k", [(10, 16, 10), (26, 16, 26),
                                     (100, 32, 100), (132, 32, 132),
                                     (8, 3, 8), (16, 16, 1), (3, 2, 5)])
def test_merge_sorted_matches_plain(cuda, Na, Nb, k):
    rng = np.random.default_rng(Na + Nb)
    B = 1024
    pool = rng.integers(0, 8, 16)
    a = np.sort(rng.choice(pool, (B, Na)), 1).astype(np.float32)
    b = np.sort(rng.choice(pool, (B, Nb)), 1).astype(np.float32)
    a[0, Na // 2:] = INF
    b[1] = INF
    ia = rng.integers(0, 999, (B, Na)).astype(np.int32)
    ib = rng.integers(0, 999, (B, Nb)).astype(np.int32)
    args = _t(cuda, a, ia, b, ib)
    d, i = ops.merge_topk_sorted(*args, k)
    d0, i0 = ref.merge_topk_sorted_ref(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(d, d0) and torch.equal(i, i0)


@pytest.mark.parametrize("B,K,D", [(1024, 16, 128), (2048, 32, 128),
                                   (8, 3, 130), (4, 1, 7)])
def test_dist_h_matches_plain(cuda, B, K, D):
    rng = np.random.default_rng(B + K + D)
    x = rng.standard_normal((B, K, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    tx, tq = _t(cuda, x, q)
    got = ops.dist_h(tx, tq)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.dist_h_ref(tx, tq).cpu().numpy(),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("B,K,dl", [(1024, 60, 15), (1024, 1, 15),
                                    (1024, 30, 15), (5, 7, 3)])
def test_dist_l_matches_plain(cuda, B, K, dl):
    rng = np.random.default_rng(B + K + dl)
    for integer in (True, False):
        if integer:
            x = rng.integers(-64, 64, (B, K, dl)).astype(np.float32)
            q = rng.integers(-64, 64, (B, dl)).astype(np.float32)
        else:
            x = rng.standard_normal((B, K, dl)).astype(np.float32)
            q = rng.standard_normal((B, dl)).astype(np.float32)
        tx, tq = _t(cuda, x, q)
        got = ops.dist_l(tx, tq)
        want = ref.dist_l_ref(tx, tq)
        torch.cuda.synchronize()
        if integer:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert ops.launch_counts()["dist_l"] > 0


@pytest.mark.parametrize("B,M,S,k", [(1024, 32, 16, 16), (1024, 16, 16, 8),
                                     (1024, 16, 16, 3), (1024, 32, 16, 32),
                                     (64, 64, 16, 64), (8, 100, 4, 1),
                                     (16, 32, 8, 5)])
def test_pq_adc_expand_matches_plain(cuda, B, M, S, k):
    """Integer-valued tables: bit-exact; rows 0-2 are all invalid,
    all-equal distances and th = 0. The table is read both contiguous
    and as the cascade's strided view of a flat row."""
    rng = np.random.default_rng(B + M + S + k)
    codes = rng.integers(0, 256, (B, M, S)).astype(np.uint8)
    codes[1] = codes[1, :1]
    flat = rng.integers(0, 1 << 16, (B, S * 256 + 15)).astype(np.float32)
    valid = rng.random((B, M)) < 0.8
    valid[0] = False
    th = np.where(rng.random(B) < 0.5, float(S << 15), INF) \
        .astype(np.float32)
    th[2] = 0.0
    tc, tf, tv, tt = _t(cuda, codes, flat, valid, th)
    view = tf[:, :S * 256].reshape(B, S, 256)
    d0, i0 = ref.pq_adc_expand_ref(tc, view, tv, tt, k)
    for lut in (view, view.contiguous()):
        d, i = ops.pq_adc_expand(tc, lut, tv, tt, k)
        torch.cuda.synchronize()
        assert torch.equal(d, d0) and torch.equal(i, i0)
    assert ops.launch_counts()["pq_adc_expand"] > 0


@pytest.mark.parametrize("kind,deferred,rm", [("pq", False, None),
                                              ("cascade", True, 2),
                                              ("pca", True, 3)])
def test_filtered_search_card_equals_cpu(cuda, kind, deferred, rm):
    """On integer data with integer centroids and a coordinate-selecting
    'PCA' every sum is exact: the pq, cascade-deferred and pca-deferred
    searches give bit-identical results on the card and on the CPU."""
    from repro_torch.configs.base import PHNSWConfig
    from repro_torch.core import filters
    from repro_torch.core.graph import build_hnsw
    from repro_torch.core.search_torch import build_packed, search_batched
    rng = np.random.default_rng(4)
    x = rng.integers(0, 8, (1500, 16)).astype(np.float32)
    q = rng.integers(0, 8, (64, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int1500", n_points=1500, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=256)
    g = build_hnsw(x, cfg, seed=2, device="cpu")
    filt = filters.from_reference(kind, {
        "centroids": rng.integers(0, 8, (4, 256, 4)).astype(np.float32),
        "mean": np.zeros(16, np.float32),
        "components": np.eye(16, 4, dtype=np.float32),
        "explained": np.full(4, 0.25, np.float32)})
    out = {}
    for d in ("cuda", "cpu"):
        db = build_packed(g, filt=filt, device=d)
        fd, fi, st = search_batched(db, q, filt=filt, deferred=deferred,
                                    rerank_mult=rm, return_stats=True,
                                    device=d)
        out[d] = [fd.cpu(), fi.cpu(), st["steps_per_layer"].cpu(),
                  st["dist_h_evals"].cpu()]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


def test_build_and_search_card_equals_cpu(cuda):
    """On integer data the whole slice is exact: the wave build and the
    PCA-filtered search give the same graph and bit-identical results on
    the card and on the CPU."""
    from repro_torch.configs.base import PHNSWConfig
    from repro_torch.core.graph import build_hnsw
    from repro_torch.core.search_torch import build_packed, search_batched
    rng = np.random.default_rng(3)
    x = rng.integers(0, 8, (1500, 16)).astype(np.float32)
    q = rng.integers(0, 8, (64, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int1500", n_points=1500, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=256)
    graphs = {d: build_hnsw(x, cfg, seed=2, device=d) for d in ("cuda",
                                                                "cpu")}
    for a, b in zip(graphs["cuda"].layers, graphs["cpu"].layers):
        np.testing.assert_array_equal(a, b)
    out = {}
    for d in ("cuda", "cpu"):
        db = build_packed(graphs["cpu"], x[:, :4], device=d)
        fd, fi, st = search_batched(db, q, q[:, :4], return_stats=True,
                                    device=d)
        out[d] = [fd.cpu(), fi.cpu(), st["steps_per_layer"].cpu(),
                  st["dist_h_evals"].cpu()]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,M,k", [(1024, 40, 10), (1024, 120, 30),
                                   (1024, 240, 60), (8, 33, 5), (1, 40, 40),
                                   (4, 2048, 7), (64, 256, 1), (64, 256, 256),
                                   (64, 257, 1), (64, 257, 257), (64, 512, 1),
                                   (64, 512, 512), (64, 513, 1),
                                   (64, 513, 513)])
def test_ksort_l_matches_plain(cuda, B, M, k):
    """Values and indices exact on every row: floats with negatives, a
    tie pool, all-INF rows and -0.0 beside 0.0 (they tie by index), the
    values' sign bits included; at the warp tier's edges (M = 256, 257,
    512, 513) with k = 1 and k = M."""
    rng = np.random.default_rng(B + M + k)
    d = (3.0 * rng.standard_normal((B, M))).astype(np.float32)
    if B >= 4:
        d[1] = rng.choice(np.asarray([0.0, 1.0, 1.0, 2.0], np.float32), M)
        d[2] = INF
        d[3] = rng.choice(np.asarray([-0.0, 0.0, 1.0], np.float32), M)
    (td,) = _t(cuda, d)
    before = ops.launch_counts()["ksort_l"]
    v, i = ops.ksort_l(td, k)
    v0, i0 = ref.ksort_l_ref(td, k)
    torch.cuda.synchronize()
    assert torch.equal(v, v0) and torch.equal(i, i0)
    assert torch.equal(torch.signbit(v), torch.signbit(v0))
    assert ops.launch_counts()["ksort_l"] == before + 1


@pytest.mark.parametrize("kind,deferred,rm,tombs", [
    ("pca", False, None, True), ("pq", False, None, False),
    ("cascade", True, 2, True), ("pca", True, 3, False)])
def test_sharded_search_card_equals_cpu(cuda, kind, deferred, rm, tombs):
    """On integer data the sharded search (three shards, a remainder
    split) gives bit-identical ids, dists and coverage on the card and
    on the CPU, with every shard live and with shard 0 dead."""
    from repro_torch.configs.base import PHNSWConfig
    from repro_torch.core import distributed, filters
    from repro_torch.core.graph import build_hnsw
    rng = np.random.default_rng(5)
    x = rng.integers(0, 8, (1501, 16)).astype(np.float32)
    q = rng.integers(0, 8, (64, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int1501", n_points=1501, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=256)
    graphs = [build_hnsw(x[a:b], cfg, seed=2 + s, device="cpu")
              for s, (a, b) in enumerate(distributed.shard_bounds(1501, 3))]
    filt = filters.from_reference(kind, {
        "centroids": rng.integers(0, 8, (4, 256, 4)).astype(np.float32),
        "mean": np.zeros(16, np.float32),
        "components": np.eye(16, 4, dtype=np.float32),
        "explained": np.full(4, 0.25, np.float32)})
    deleted = rng.random(1501) < 0.05 if tombs else None
    out = {}
    for d in ("cuda", "cpu"):
        sdb = distributed.build_sharded(x, cfg, filt, 3, graphs=graphs,
                                        deleted=deleted, device=d)
        out[d] = []
        for live in (None, [False, True, True]):
            fd, fi, st = distributed.shard_search_host(
                sdb, q, filt=filt, deferred=deferred, rerank_mult=rm,
                live=live, return_stats=True, device=d)
            out[d] += [fd.cpu(), fi.cpu(), st["coverage"]]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("kind,deferred,rm,tombs", [
    ("pca", False, None, True), ("pq", False, None, False),
    ("cascade", True, 2, True), ("pca", True, 3, False)])
def test_mesh_search_on_card_equals_shard_search_host(cuda, kind, deferred,
                                                      rm, tombs):
    """On integer data ``distributed_search`` over meshes (1, 4) and
    (2, 4) of the first four cards (of cuda:0 four times on a machine
    with fewer) gives ``shard_search_host``'s ids, dists and coverage on
    cuda:0, with every shard live and with shard 0 dead, and launches
    each kernel as often."""
    from repro_torch.configs.base import PHNSWConfig
    from repro_torch.core import distributed, filters
    from repro_torch.core.graph import build_hnsw
    rng = np.random.default_rng(6)
    x = rng.integers(0, 8, (1501, 16)).astype(np.float32)
    q = rng.integers(0, 8, (64, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int1501", n_points=1501, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=256)
    graphs = [build_hnsw(x[a:b], cfg, seed=2 + s, device="cpu")
              for s, (a, b) in enumerate(distributed.shard_bounds(1501, 4))]
    filt = filters.from_reference(kind, {
        "centroids": rng.integers(0, 8, (4, 256, 4)).astype(np.float32),
        "mean": np.zeros(16, np.float32),
        "components": np.eye(16, 4, dtype=np.float32),
        "explained": np.full(4, 0.25, np.float32)})
    deleted = rng.random(1501) < 0.05 if tombs else None
    sdb = distributed.build_sharded(x, cfg, filt, 4, graphs=graphs,
                                    deleted=deleted, device="cuda")
    kw = dict(filt=filt, deferred=deferred, rerank_mult=rm,
              return_stats=True)
    cards = [f"cuda:{i if torch.cuda.device_count() >= 4 else 0}"
             for i in range(4)]
    for live in (None, [False, True, True, True]):
        for R in (1, 2):
            mesh = distributed.make_mesh((R, 4), ("data", "model"),
                                         devices=cards * R)
            ops.reset_launch_counts()
            md, mi, ms = distributed.distributed_search(mesh, sdb, q,
                                                        live=live, **kw)
            torch.cuda.synchronize()
            got = ops.launch_counts()
            ops.reset_launch_counts()
            b = len(q) // R
            want = [distributed.shard_search_host(
                sdb, q[r * b:(r + 1) * b], live=live, device="cuda", **kw)
                for r in range(R)]
            torch.cuda.synchronize()
            assert got == ops.launch_counts()
            assert torch.equal(mi, torch.cat([w[1] for w in want]))
            assert torch.equal(md, torch.cat([w[0] for w in want]))
            assert ms["coverage"] == want[0][2]["coverage"]
            assert md.device == torch.device("cuda", 0)


@pytest.mark.parametrize("B,M,dl,k", [(64, 32, 15, 16), (1024, 32, 15, 16),
                                      (64, 32, 15, 32), (8, 100, 4, 1),
                                      (1, 33, 15, 33)])
def test_fused_filter_matches_plain(cuda, B, M, dl, k):
    """Exact on integer inputs, ties by index (row 1: all-equal
    distances)."""
    rng = np.random.default_rng(B + M + k)
    x = rng.integers(0, 8, (B, M, dl)).astype(np.float32)
    if B >= 2:
        x[1] = x[1, :1]
    q = rng.integers(0, 8, (B, dl)).astype(np.float32)
    tx, tq = _t(cuda, x, q)
    before = ops.launch_counts()["fused_filter"]
    d, i = ops.fused_filter(tx, tq, k)
    d0, i0 = ref.fused_filter_ref(tx, tq, k)
    torch.cuda.synchronize()
    assert torch.equal(d, d0) and torch.equal(i, i0)
    assert ops.launch_counts()["fused_filter"] == before + 1


def _attn_inputs(dev, dtype, *shapes, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype) for s in shapes]


# (S, T, d, dtype, causal, window): the JAX suite's sweep, the bench's
# shape, rows that see no key (S > T), ragged edges and head dims that
# are padded inside the kernel (30: scalar loads; 40: vector loads beside
# padding; 96: a multiple of 16 short of 128), and for the bf16
# tensor-core kernel a ragged chunk whose kv range is split over blocks,
# d=256 with a window that starts mid-tile, d=30 element by element and a
# non-causal window.
# Tolerance 2e-3 in f32 and 0.05 in bf16 (tests/test_kernels.py), and
# kernel_footprint.attention_excess <= 1, which scales with each row's
# RMS (one bf16 ulp plus 1/32 of the RMS; 1e-4 of each in f32).
@pytest.mark.parametrize("S,T,d,dtype,causal,window", [
    (128, 128, 64, torch.float32, True, 0),
    (128, 256, 64, torch.bfloat16, True, 0),
    (256, 256, 64, torch.float32, True, 64),
    (512, 512, 64, torch.bfloat16, True, 0),
    (200, 100, 64, torch.float32, True, 0),
    (1, 300, 128, torch.bfloat16, True, 0),
    (77, 1000, 128, torch.float32, True, 300),
    (128, 200, 64, torch.float32, False, 0),
    (70, 90, 30, torch.float32, True, 0),
    (96, 96, 40, torch.bfloat16, True, 0),
    (96, 96, 256, torch.bfloat16, True, 5000),
    (100, 1000, 128, torch.bfloat16, True, 0),
    (300, 300, 256, torch.bfloat16, True, 100),
    (128, 200, 96, torch.bfloat16, True, 0),
    (70, 90, 30, torch.bfloat16, True, 0),
    (260, 130, 64, torch.bfloat16, False, 70)])
def test_flash_attention_matches_plain(cuda, S, T, d, dtype, causal, window):
    q, k, v = _attn_inputs(cuda, dtype, (2, 3, S, d), (2, 3, T, d),
                           (2, 3, T, d), seed=S + T + d)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 0.05
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert kf.attention_excess(out, want) <= 1
    if causal and S > T:
        assert bool((out[:, :, :S - T] == 0).all())
    assert ops.launch_counts()["flash_attention"] == before + 1


@pytest.mark.parametrize("B,H,S,T,d,causal,window", [
    (1, 4, 100, 1000, 128, True, 0),
    (1, 4, 512, 512, 64, True, 0),
    (2, 2, 300, 100, 64, True, 0),
    (1, 2, 200, 700, 256, True, 150),
    (1, 3, 90, 500, 30, False, 0)])
def test_flash_attention_split_matches_unsplit(cuda, B, H, S, T, d, causal,
                                               window):
    """The bf16 kernel with its kv range split over blocks (partials
    merged by the second kernel) against the same kernel unsplit and the
    plain version: within attention_excess <= 1, blind rows exactly 0,
    one launch counted per call whatever the split."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _attn_inputs(cuda, torch.bfloat16, (B, H, S, d),
                           (B, H, T, d), (B, H, T, d), seed=S + T + d)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    one = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               n_split=1)
    for n_split in (2, 5, 16):
        before = ops.launch_counts()["flash_attention"]
        got = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   n_split=n_split)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == before + 1
        assert kf.attention_excess(got, one) <= 1
        assert kf.attention_excess(got, want) <= 1
        if causal and S > T:
            assert bool((got[:, :, :S - T] == 0).all())
    assert kf.attention_excess(one, want) <= 1


@pytest.mark.parametrize("T,d,dtype,lengths", [
    (256, 64, torch.float32, [1, 128, 256]),
    (512, 64, torch.float32, [0, 511, 700]),
    (4096, 64, torch.bfloat16, [4096, 0, 3000]),
    (1000, 128, torch.bfloat16, [999, 129, 1]),
    (300, 40, torch.float32, [300, 7, 0]),
    (4096, 64, torch.bfloat16, [4096]),
    (16384, 128, torch.bfloat16, [16384, 9000, 1])])
def test_decode_attention_matches_plain(cuda, T, d, dtype, lengths):
    """Against the plain version, then one call captured in a CUDA graph
    and replayed three times, each replay equal to the eager call (the
    bench's shape is [1, 4, 4096, 64]; T = 16384 streams through the
    tile ring)."""
    B, H = len(lengths), 4
    q, k, v = _attn_inputs(cuda, dtype, (B, H, d), (B, H, T, d),
                           (B, H, T, d), seed=T + d)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["decode_attention"]
    out = ops.decode_attention(q, k, v, ln)
    want = ref.decode_attention_ref(q, k, v, ln)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert kf.attention_excess(out, want) <= 1
    assert bool((out[ln <= 0] == 0).all())
    assert ops.launch_counts()["decode_attention"] == before + 1
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention(q, k, v, ln)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        got = ops.decode_attention(q, k, v, ln)
    for _ in range(3):
        got.fill_(1.0)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, out)


@pytest.mark.parametrize("d,dtype,offset,copy", [
    (64, torch.bfloat16, 0, "bulk"), (40, torch.float32, 0, "bulk"),
    (30, torch.bfloat16, 0, "cp.async"), (30, torch.float32, 0, "cp.async"),
    (33, torch.bfloat16, 0, "ld"), (64, torch.bfloat16, 1, "ld"),
    (64, torch.float32, 1, "cp.async")])
def test_decode_attention_copy_modes(cuda, d, dtype, offset, copy):
    """Each way a tile reaches shared memory: bulk copies (rows of 16-byte
    multiples), 4-byte cp.async (rows of 4-byte multiples, or caches
    offset by one f32) and plain loads (bf16 at odd d, or caches offset by
    one bf16 element)."""
    from repro_torch.kernels import decode_attention as da
    B, H, T = 2, 3, 700
    q, kk, vv = _attn_inputs(cuda, dtype, (B, H, d),
                             (B * H * T * d + offset,),
                             (B * H * T * d + offset,), seed=d + offset)
    k = kk[offset:].view(B, H, T, d)
    v = vv[offset:].view(B, H, T, d)
    assert da.split_plan(B * H, T, d, k.element_size(), align=da._align(
        k, v))["copy"] == copy
    ln = torch.tensor([T, 333], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, k, v, ln)
    want = ref.decode_attention_ref(q, k, v, ln)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert kf.attention_excess(out, want) <= 1


@pytest.mark.parametrize("B,H,T,d,lengths", [
    (1, 4, 4096, 64, [4096]), (8, 24, 2048, 128, [0, 1, 1000, 2048, 2048,
                                                 2055, 5, 1234])])
def test_decode_attention_is_one_device_kernel(cuda, B, H, T, d, lengths):
    """One call runs one device kernel (torch.profiler's device-side
    events): the chunks merge inside the launch."""
    q, k, v = _attn_inputs(cuda, torch.bfloat16, (B, H, d), (B, H, T, d),
                           (B, H, T, d), seed=T)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    assert kf.device_kernels(lambda: ops.decode_attention(q, k, v, ln)) == 1


# ------------- the trip fold, the fused PQ expand, the wide tiers ----------

def _bits(t):
    """A tensor's raw bits (f32 as int32): -0.0 and 0.0 differ."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _fold_case(rng, B, ef, cap, k, kk, integer, n_ids=5000):
    """Ascending frontiers with INF/-1 tails, a feed with INF/-1 slots,
    tombstone words; integer data from a small pool with -0.0 beside 0.0,
    or float data (3x standard normal, squared: distances); edge rows as
    in tests/test_torch_fold.py."""
    if integer:
        pool = np.asarray([-0.0, 0.0, 1.0, 2.0, 2.0, 3.0, 5.0], np.float32)
        draw = lambda shape: rng.choice(pool, shape)
    else:
        draw = lambda shape: (3 * rng.standard_normal(shape)) ** 2

    def frontier(n):
        d = np.sort(draw((B, n)), 1).astype(np.float32)
        pads = rng.integers(0, n + 1, B)
        d[np.arange(n)[None, :] >= n - pads[:, None]] = INF
        i = rng.integers(0, n_ids, (B, n)).astype(np.int32)
        i[d == INF] = -1
        return d, i

    F_d, F_i = frontier(ef)
    C_d, C_i = frontier(cap)
    Cp = frontier(max(k, 1))[0]
    dh = draw((B, kk)).astype(np.float32)
    dh[rng.random((B, kk)) < 0.2] = INF
    cand = rng.integers(0, n_ids, (B, kk)).astype(np.int32)
    cand[dh == INF] = -1
    kv = draw((B, kk)).astype(np.float32)
    if B >= 4:
        F_d[0], F_i[0] = INF, -1
        C_d[1], C_i[1] = INF, -1
        dh[2] = dh[2, :1]
    flags = rng.random(n_ids) < 0.3
    words = np.zeros(-(-n_ids // 32), np.uint32)
    ids = np.nonzero(flags)[0].astype(np.uint32)
    np.bitwise_or.at(words, ids // 32, np.uint32(1) << (ids % 32))
    return F_d, F_i, C_d, C_i, Cp, dh, cand, kv, words.view(np.int32)


# (B, ef, k, W, kk, heap, kv row, tombstones): the main path's folds (the
# merges of chip_smoke's mg_shapes: pca layers 0 / 1 / 2+, pca-deferred
# and cascade-deferred layer 0, the probe's layer 0 and upper layers),
# each with tombstones where the search filters them, then W = 4 and 8
# (the block tier from W * k > 64) and a frontier past shared memory
# (the global tier)
FOLD_SHAPES = [(1024, 10, 16, 1, 16, True, True, False),
               (1024, 10, 16, 1, 16, True, True, True),
               (1024, 1, 8, 1, 8, True, True, False),
               (1024, 1, 3, 1, 3, True, True, False),
               (1024, 30, 16, 1, 16, True, False, True),
               (1024, 60, 32, 1, 32, True, False, False),
               (2048, 100, 0, 1, 32, False, False, False),
               (2048, 100, 0, 1, 32, False, False, True),
               (2048, 16, 0, 1, 16, False, False, False),
               (1024, 10, 16, 4, 64, True, True, True),
               (256, 10, 16, 8, 128, True, True, True),
               (256, 100, 0, 8, 256, False, False, True),
               (2, 30000, 16, 1, 32, True, True, True)]


@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_trip_fold_matches_plain(cuda, shape):
    """The fold kernel against ref.trip_fold_ref, bit for bit (-0.0 and
    0.0 told apart) on integer and float data, in its warp, block and
    global tiers; one launch counted per call."""
    B, ef, k, W, kk, heap, kv_row, tombs = shape
    cap = max(ef + kk, 8)
    for integer in (True, False):
        rng = np.random.default_rng(ef + kk + k + integer)
        F_d, F_i, C_d, C_i, Cp, dh, cand, kv, words = _t(
            cuda, *_fold_case(rng, B, ef, cap, k, kk, integer))
        args = (F_d, F_i, C_d, C_i, W, Cp if heap else None, dh, cand,
                kv if kv_row else None, words if tombs else None)
        before = ops.launch_counts()["trip_fold"]
        got = ops.trip_fold(*args)
        want = ref.trip_fold_ref(*args)
        torch.cuda.synchronize()
        assert ops.launch_counts()["trip_fold"] == before + 1
        assert (got[4] is None) == (not heap)
        for g, w in zip(got, want):
            if w is not None:
                assert torch.equal(_bits(g), _bits(w))


def _rows_case(rng, B, W, N=3000, M0=32, S=16):
    adj = rng.integers(0, N, (N, M0)).astype(np.int32)
    tails = rng.integers(0, M0 // 2, N)
    adj[np.arange(M0)[None, :] >= M0 - tails[:, None]] = -1
    codes = rng.integers(0, 256, (N, M0, S)).astype(np.uint8)
    C_i = rng.integers(-1, N, (B, W + 7)).astype(np.int32)
    exp = rng.random((B, W)) < 0.8
    exp[0] = False
    flat = rng.integers(0, 1 << 16, (B, S * 256 + 15)).astype(np.float32)
    heap = np.sort(rng.integers(0, 1 << 20, (B, 4)), 1).astype(np.float32)
    heap[::2, -1] = INF
    heap[1, -1] = 0.0
    return adj, codes, C_i, exp, flat, heap


@pytest.mark.parametrize("cascade", [False, True], ids=["pq", "cascade"])
@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_pq_expand_rows_matches_unfused(cuda, W, cascade):
    """The fused-gather PQ expand against the path it replaces on the
    card (index_select of the popped rows, the pq_adc_expand kernel, the
    id gather) and against its plain version, bit for bit on integer
    tables; the popped ids are a view of a wider frontier, the threshold
    a column of the heap, the cascade's tables a strided view."""
    rng = np.random.default_rng(W + 10 * cascade)
    B, M0, S, k = 1024, 32, 16, 16
    adj, codes, C_i, exp, flat, heap = _t(cuda, *_rows_case(rng, B, W))
    lut = flat[:, :S * 256].reshape(B, S, 256)
    if not cascade:
        lut = lut.contiguous()
    c_w, th, kk = C_i[:, :W], heap[:, -1], W * k
    c_safe = torch.where(exp, c_w.clamp(min=0), 0).reshape(-1)
    nb_i = adj.index_select(0, c_safe).reshape(B, W * M0)
    nb_mask = (nb_i >= 0) & exp.repeat_interleave(M0, dim=1)
    nb_pay = codes.index_select(0, c_safe).reshape(B, W * M0, S)
    ud, ui = ops.pq_adc_expand(nb_pay, lut, nb_mask, th, kk)
    ucand = torch.gather(nb_i, 1, ui.long())
    pd, pc = ref.pq_expand_rows_ref(adj, codes, c_w, exp, lut, th, kk)
    before = ops.launch_counts()["pq_expand_rows"]
    d, c = ops.pq_expand_rows(adj, codes, c_w, exp, lut, th, kk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pq_expand_rows"] == before + 1
    assert torch.equal(_bits(d), _bits(ud)) and torch.equal(c, ucand)
    assert torch.equal(_bits(d), _bits(pd)) and torch.equal(c, pc)


# (dl, base offset in floats): the pca rows at dl = 15 on an aligned
# table (16-byte copies), the same table viewed one float in (a base off
# 16-byte alignment: 4-byte copies), dl = 16 (an even row: 4-byte copies
# at the odd stride 17) and dl = 128 (staged in opted-in shared memory
# at W = 1, 2 and 8; at W = 4 four warps' areas pass the card's limit
# and the rows are read in place)
ROWS_LAYOUTS = {"dl15": (15, 0), "dl15_misaligned": (15, 1), "dl16": (16, 0),
                "dl128": (128, 0)}


def _pca_rows_case(rng, B, W, dl, offset, integer, N=3000, M0=32):
    """A layer (adj with -1 tails, layout-(3) rows as a view ``offset``
    floats into a flat buffer), a frontier whose first W ids are popped
    (some -1; row 2 a -1 pop with its gate set), gates (row 0 all clear)
    and a heap whose last column is the threshold (row 1: 0). Integer
    rows make every sum exact; float rows are standard normal."""
    adj = rng.integers(0, N, (N, M0)).astype(np.int32)
    tails = rng.integers(0, M0 // 2, N)
    adj[np.arange(M0)[None, :] >= M0 - tails[:, None]] = -1
    n = N * M0 * dl + offset
    flat = rng.integers(0, 16, n) if integer else rng.standard_normal(n)
    q = rng.integers(0, 16, (B, dl)) if integer \
        else rng.standard_normal((B, dl))
    C_i = rng.integers(-1, N, (B, W + 7)).astype(np.int32)
    exp = rng.random((B, W)) < 0.8
    exp[0] = False
    C_i[2, 0], exp[2, 0] = -1, True
    scale = 64.0 * dl if integer else 1.5 * dl
    heap = np.sort(rng.random((B, 4)) * scale, 1).astype(np.float32)
    heap[::2, -1] = INF
    heap[1, -1] = 0.0
    return (adj, flat.astype(np.float32), C_i, exp, q.astype(np.float32),
            heap)


@pytest.mark.parametrize("layout", list(ROWS_LAYOUTS))
@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_fused_expand_rows_matches_unfused(cuda, W, layout):
    """The fused-gather pca expand against the path it replaces on the
    card (index_select of the popped rows, the fused_expand kernel, the
    id gather), bit for bit on integer and float rows (the same f32 sums
    in the same order), and against its plain version on integer rows;
    the popped ids are a view of a wider frontier, the threshold a column
    of the heap; one launch a call, staged as ``filter_plan`` says."""
    from repro_torch.kernels._launch import smem_optin
    from repro_torch.kernels.fused_filter import filter_plan
    dl, offset = ROWS_LAYOUTS[layout]
    B, M0, k = 1024, 32, 16
    for integer in (True, False):
        rng = np.random.default_rng(W + 10 * offset + dl + integer)
        adj, flat, C_i, exp, q, heap = _t(
            cuda, *_pca_rows_case(rng, B, W, dl, offset, integer))
        N = adj.shape[0]
        low = flat[offset:].view(N, M0, dl)
        assert (low.data_ptr() % 16 == 0) == (offset == 0)
        c_w, th, kk = C_i[:, :W], heap[:, -1], W * k
        c_safe = torch.where(exp, c_w.clamp(min=0), 0).reshape(-1)
        nb_i = adj.index_select(0, c_safe).reshape(B, W * M0)
        nb_mask = (nb_i >= 0) & exp.repeat_interleave(M0, dim=1)
        nb_pay = low.index_select(0, c_safe).reshape(B, W * M0, dl)
        ud, ui = ops.fused_expand(nb_pay, q, nb_mask, th, kk)
        ucand = torch.gather(nb_i, 1, ui.long())
        pd, pc = ref.fused_expand_rows_ref(adj, low, c_w, exp, q, th, kk)
        plan = filter_plan(W, M0, dl, offset == 0, smem_optin(adj.device))
        assert plan["staged"] == (layout != "dl128" or W != 4)
        before = ops.launch_counts()["fused_expand_rows"]
        d, c = ops.fused_expand_rows(adj, low, c_w, exp, q, th, kk)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_expand_rows"] == before + 1
        assert torch.equal(_bits(d), _bits(ud)) and torch.equal(c, ucand)
        if integer:
            assert torch.equal(_bits(d), _bits(pd)) and torch.equal(c, pc)
        assert bool((d[0] == INF).all())
        assert bool((d[1] == INF).all())
        assert bool((d[2] < INF).any())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,M,dl,k", [(1024, 32, 15, 16), (64, 32, 15, 16),
                                      (1024, 64, 15, 32), (512, 160, 15, 40),
                                      (256, 96, 16, 7)])
def test_filter_bodies_match_plain(cuda, B, M, dl, k, dtype):
    """fused_expand (its gathered block read in place) and fused_filter
    equal to their plain versions on integer rows in the warp and block
    tiers, at an odd and an even dl, on f32 rows and on the same values
    in bf16 (equal to the f32 results too)."""
    from repro_torch.kernels.fused_filter import (fused_expand_cuda,
                                                  fused_filter_cuda)
    rng = np.random.default_rng(B + M + dl)
    x = rng.integers(0, 8, (B, M, dl)).astype(np.float32)
    q = rng.integers(0, 8, (B, dl)).astype(np.float32)
    valid = rng.random((B, M)) < 0.8
    th = np.where(rng.random(B) < 0.5, 2.0 * dl, INF).astype(np.float32)
    tx, tq, tv, tt = _t(cuda, x, q, valid, th)
    tb = tx.to(PAYLOADS[dtype])
    for got, plain, f32 in (
            (fused_expand_cuda(tb, tq, tv, tt, k),
             ref.fused_expand_ref(tb, tq, tv, tt, k),
             ref.fused_expand_ref(tx, tq, tv, tt, k)),
            (fused_filter_cuda(tb, tq, k), ref.fused_filter_ref(tb, tq, k),
             ref.fused_filter_ref(tx, tq, k))):
        torch.cuda.synchronize()
        for want in (plain, f32):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("M", [160, 256])
def test_wide_expand_tiers_match_plain(cuda, M):
    """M > 128 (a block per row): fused_expand, fused_filter and
    pq_adc_expand against their plain versions, exact on integer
    inputs."""
    rng = np.random.default_rng(M)
    B, dl, S, k = 512, 15, 16, 40
    x = rng.integers(0, 8, (B, M, dl)).astype(np.float32)
    x[1] = x[1, :1]
    q = rng.integers(0, 8, (B, dl)).astype(np.float32)
    valid = rng.random((B, M)) < 0.8
    valid[0] = False
    th = np.where(rng.random(B) < 0.5, 64.0 * dl, INF).astype(np.float32)
    tx, tq, tv, tt = _t(cuda, x, q, valid, th)
    for got, want in (
            (ops.fused_expand(tx, tq, tv, tt, k),
             ref.fused_expand_ref(tx, tq, tv, tt, k)),
            (ops.fused_filter(tx, tq, k), ref.fused_filter_ref(tx, tq, k))):
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    codes = rng.integers(0, 256, (B, M, S)).astype(np.uint8)
    flat = rng.integers(0, 1 << 16, (B, S * 256 + 15)).astype(np.float32)
    tc, tf_ = _t(cuda, codes, flat)
    lut = tf_[:, :S * 256].reshape(B, S, 256)
    th2 = torch.where(tt < INF, float(S << 15), INF)
    got = ops.pq_adc_expand(tc, lut, tv, th2, k)
    want = ref.pq_adc_expand_ref(tc, lut, tv, th2, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_expand_global_tier_matches_plain(cuda):
    """A row past the card's opt-in shared memory (60,000 slots): the
    block ranks it in a global scratch row."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 8, (2, 60000, 2)).astype(np.float32)
    q = rng.integers(0, 8, (2, 2)).astype(np.float32)
    tx, tq = _t(cuda, x, q)
    got = ops.fused_filter(tx, tq, 9)
    want = ref.fused_filter_ref(tx, tq, 9)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("Na,Nb,k", [(12800, 16, 300), (60000, 100, 64)])
def test_merge_sorted_past_12288_matches_plain(cuda, Na, Nb, k):
    """Opted-in shared memory (12,816 elements) and the global tier
    (60,100) against the plain version, ties and INF pads included."""
    rng = np.random.default_rng(Na)
    pool = rng.integers(0, 8, 16)
    a = np.sort(rng.choice(pool, (4, Na)), 1).astype(np.float32)
    b = np.sort(rng.choice(pool, (4, Nb)), 1).astype(np.float32)
    a[0, Na // 2:] = INF
    b[1] = INF
    ia = rng.integers(0, 1 << 20, (4, Na)).astype(np.int32)
    ib = rng.integers(0, 1 << 20, (4, Nb)).astype(np.int32)
    args = _t(cuda, a, ia, b, ib)
    d, i = ops.merge_topk_sorted(*args, k)
    d0, i0 = ref.merge_topk_sorted_ref(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(d, d0) and torch.equal(i, i0)


@pytest.mark.parametrize("M,k", [(13000, 20), (60000, 7)])
def test_ksort_l_past_12288_matches_plain(cuda, M, k):
    rng = np.random.default_rng(M)
    d = (3.0 * rng.standard_normal((3, M))).astype(np.float32)
    d[1] = rng.choice(np.asarray([-0.0, 0.0, 1.0], np.float32), M)
    d[2] = INF
    (td,) = _t(cuda, d)
    v, i = ops.ksort_l(td, k)
    v0, i0 = ref.ksort_l_ref(td, k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(v), _bits(v0)) and torch.equal(i, i0)


@pytest.mark.parametrize("mode", ["pca", "pq", "cascade-deferred",
                                  "pca-tombstones"])
@pytest.mark.parametrize("W", [2, 4, 8])
def test_wide_search_and_build_card_equals_cpu(cuda, W, mode):
    """expand_width W in {2, 4, 8} (W * M0 up to 128 expand slots, W * k
    fold feeds, the probe's W * M0): the wave build gives the same graph
    and the search (and, with tombstones, the probe) bit-identical
    results on the card and on the CPU, on integer data."""
    import dataclasses
    from repro_torch.configs.base import PHNSWConfig
    from repro_torch.core import filters, search_torch
    from repro_torch.core.graph import build_hnsw
    kind = mode.split("-")[0]
    deferred = mode == "cascade-deferred"
    rng = np.random.default_rng(6)
    x = rng.integers(0, 8, (1500, 16)).astype(np.float32)
    q = rng.integers(0, 8, (64, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int1500", n_points=1500, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=256,
                      expand_width=W)
    graphs = {d: build_hnsw(x, cfg, seed=2, device=d) for d in ("cuda",
                                                                "cpu")}
    for a, b in zip(graphs["cuda"].layers, graphs["cpu"].layers):
        np.testing.assert_array_equal(a, b)
    filt = filters.from_reference(kind, {
        "centroids": rng.integers(0, 8, (4, 256, 4)).astype(np.float32),
        "mean": np.zeros(16, np.float32),
        "components": np.eye(16, 4, dtype=np.float32),
        "explained": np.full(4, 0.25, np.float32)})
    flags = rng.random(1500) < 0.05
    out = {}
    for d in ("cuda", "cpu"):
        db = search_torch.build_packed(graphs["cpu"], filt=filt, device=d)
        if mode.endswith("tombstones"):
            db = dataclasses.replace(db, deleted=torch.as_tensor(
                search_torch.pack_bitmap(flags), device=d))
        fd, fi, st = search_torch.search_batched(
            db, q, filt=filt, deferred=deferred, rerank_mult=2 if deferred
            else None, return_stats=True, device=d)
        out[d] = [fd.cpu(), fi.cpu(), st["steps_per_layer"].cpu(),
                  st["dist_h_evals"].cpu()]
        if db.deleted is not None:
            pd, pi = search_torch.probe_neighborhoods(
                db, q, filt.prepare_torch(torch.as_tensor(q, device=d)), 24,
                8, ef_upper=8, device=d)
            out[d] += [pd.cpu(), pi.cpu()]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


# ------------- the Dist.L kernels on f32 and bf16 rows ----------------------

def _int_rows(rng, shape, lo=-64, hi=64):
    """Integer rows, exact in bf16 (|v| <= 256) and in every f32 sum."""
    return rng.integers(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("dtype", list(PAYLOADS))
@pytest.mark.parametrize("K", [1, 60, 128])
@pytest.mark.parametrize("dl", [8, 15, 16, 32])
def test_dist_l_payloads_match_plain(cuda, dtype, K, dl):
    """dist_l on f32 and bf16 rows: an odd B (rows that are no multiple of
    a warp's or a block's), exact on integer rows, for the widths with a
    compile-time loop (15, 16) and the runtime one (8, 32); a bf16 call
    is one device kernel (no cast before it); a table viewed one element
    in (rows off 16-byte alignment) gives the same bits; float rows to
    rtol 1e-5 / atol 1e-3."""
    rng = np.random.default_rng(K * 100 + dl)
    B, dt = 1023, PAYLOADS[dtype]
    x = _int_rows(rng, (B * K * dl + 1,))
    q = _int_rows(rng, (B, dl))
    tflat, tq = _t(cuda, x, q)
    tflat = tflat.to(dt)
    for off in (0, 1):
        tx = tflat[off:off + B * K * dl].view(B, K, dl)
        before = ops.launch_counts()["dist_l"]
        got = ops.dist_l(tx, tq)
        want = ref.dist_l_ref(tx, tq)
        torch.cuda.synchronize()
        assert ops.launch_counts()["dist_l"] == before + 1
        assert torch.equal(got, want)
    assert kf.device_kernels(lambda: ops.dist_l(tx, tq)) == 1
    xf = torch.randn(B, K, dl, device=cuda).to(dt)
    qf = torch.randn(B, dl, device=cuda)
    torch.testing.assert_close(ops.dist_l(xf, qf), ref.dist_l_ref(xf, qf),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", list(PAYLOADS))
@pytest.mark.parametrize("B,M,dl,k", [(64, 32, 15, 16), (1023, 32, 15, 16),
                                      (63, 60, 8, 7), (65, 128, 16, 128),
                                      (7, 100, 32, 1), (33, 33, 15, 33),
                                      (5, 128, 120, 16),
                                      (512, 160, 15, 40)])
def test_fused_filter_payloads_match_plain(cuda, dtype, B, M, dl, k):
    """fused_filter on f32 and bf16 rows in every launch its plan takes
    for real inputs: the staged warp tier with chunk loads (an aligned
    table, M * dl a multiple of 4) or element loads (M * dl odd, or the
    table viewed one element in), the in-place warp body where the
    slices do not fit (128 slots of 120) and the in-place block tier (160
    slots); values and indices exact on integer rows (row 1: all-equal
    distances, ties by index); a bf16 call is one device kernel."""
    from repro_torch.kernels._launch import smem_optin
    from repro_torch.kernels.fused_filter import fused_filter_plan
    rng = np.random.default_rng(B + M + dl + k)
    x = _int_rows(rng, (B * M * dl + 1,), 0, 8)
    x[M * dl:2 * M * dl] = np.tile(x[:dl], M)
    q = _int_rows(rng, (B, dl), 0, 8)
    tflat, tq = _t(cuda, x, q)
    tflat = tflat.to(PAYLOADS[dtype])
    fits = 16 * ((dl + 3) // 4 * 4 + (M * (dl | 1) + 3) // 4 * 4) \
        <= smem_optin(cuda)
    for off in (0, 1):
        tx = tflat[off:off + B * M * dl].view(B, M, dl)
        plan = fused_filter_plan(
            M, dl, tx.data_ptr() % (4 * tx.element_size()) == 0,
            smem_optin(cuda))
        assert plan["staged"] == (M <= 128 and fits)
        assert plan["vec"] == int(plan["staged"] and off == 0
                                  and (M * dl) % 4 == 0)
        want = ref.fused_filter_ref(tx, tq, k)
        before = ops.launch_counts()["fused_filter"]
        got = ops.fused_filter(tx, tq, k)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_filter"] == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kf.device_kernels(lambda: ops.fused_filter(tx, tq, k)) == 1


# (dl, base offset in elements) of the bf16 pca rows: dl = 15 on an
# aligned table (16-byte copies of the dense 960-byte blocks, at most
# two-way bank conflicts), the same table one element in (rows 2 bytes
# into a word: no cp.async copy, read in place), dl = 16 (4-byte copies
# at the stride 18, an odd number of words), dl = 18 (dense 16-byte
# copies, 9 words a row)
BF16_ROWS_LAYOUTS = {"dl15": (15, 0), "dl15_misaligned": (15, 1),
                     "dl16": (16, 0), "dl18": (18, 0)}


@pytest.mark.parametrize("layout", list(BF16_ROWS_LAYOUTS))
@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_fused_expand_rows_bf16_matches_unfused(cuda, W, layout):
    """The pca expand on a bf16 layer: bit for bit against the unfused
    path on the same bf16 rows (index_select, fused_expand, id gather),
    against its plain version on integer rows, and against itself on the
    rows widened to f32; staged as ``filter_plan`` says; one launch and
    one device kernel a call (no cast)."""
    from repro_torch.kernels._launch import smem_optin
    from repro_torch.kernels.fused_filter import filter_plan
    dl, offset = BF16_ROWS_LAYOUTS[layout]
    B, M0, k = 1024, 32, 16
    for integer in (True, False):
        rng = np.random.default_rng(W + 10 * offset + dl + integer + 7)
        adj, flat, C_i, exp, q, heap = _t(
            cuda, *_pca_rows_case(rng, B, W, dl, offset, integer))
        N = adj.shape[0]
        low = flat.to(torch.bfloat16)[offset:].view(N, M0, dl)
        c_w, th, kk = C_i[:, :W], heap[:, -1], W * k
        c_safe = torch.where(exp, c_w.clamp(min=0), 0).reshape(-1)
        nb_i = adj.index_select(0, c_safe).reshape(B, W * M0)
        nb_mask = (nb_i >= 0) & exp.repeat_interleave(M0, dim=1)
        nb_pay = low.index_select(0, c_safe).reshape(B, W * M0, dl)
        ud, ui = ops.fused_expand(nb_pay, q, nb_mask, th, kk)
        ucand = torch.gather(nb_i, 1, ui.long())
        plan = filter_plan(W, M0, dl, low.data_ptr() % 16 == 0,
                           smem_optin(adj.device), 2,
                           low.data_ptr() % 4 == 0)
        assert plan["staged"] == (layout != "dl15_misaligned")
        before = ops.launch_counts()["fused_expand_rows"]
        d, c = ops.fused_expand_rows(adj, low, c_w, exp, q, th, kk)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_expand_rows"] == before + 1
        assert torch.equal(_bits(d), _bits(ud)) and torch.equal(c, ucand)
        wd, wc = ops.fused_expand_rows(adj, low.float(), c_w, exp, q, th,
                                       kk)
        assert torch.equal(_bits(d), _bits(wd)) and torch.equal(c, wc)
        if integer:
            pd, pc = ref.fused_expand_rows_ref(adj, low, c_w, exp, q, th,
                                               kk)
            assert torch.equal(_bits(d), _bits(pd)) and torch.equal(c, pc)
    assert kf.device_kernels(lambda: ops.fused_expand_rows(
        adj, low, c_w, exp, q, th, kk)) == 1


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("shards", [1, 3])
def test_bf16_search_card_equals_cpu(cuda, deferred, shards):
    """The pca search with bf16 layout-(3) rows, single-shard and
    sharded (three shards, a remainder split, shard 0 dead too): on
    integer data ids, dists, steps, Dist.H counts and coverage are
    bit-identical on the card and on the CPU; bf16 holds those integers
    exactly, so they also equal the f32 search's; on float data (PCA
    rows rounded to bf16) the card and the CPU agree as the f32 arms
    do."""
    import dataclasses
    from repro_torch.configs.base import PHNSWConfig
    from repro_torch.core import distributed, filters, search_torch
    from repro_torch.core.graph import build_hnsw
    from repro_torch.core.pca import fit_pca
    rng = np.random.default_rng(8)
    n = 1501
    x = rng.integers(0, 8, (n, 16)).astype(np.float32)
    q = rng.integers(0, 8, (64, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="int1501", n_points=n, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=256,
                      low_dtype="bfloat16")
    bounds = distributed.shard_bounds(n, shards)
    graphs = [build_hnsw(x[a:b], cfg, seed=2 + s, device="cpu")
              for s, (a, b) in enumerate(bounds)]
    filt = filters.from_reference("pca", {
        "mean": np.zeros(16, np.float32),
        "components": np.eye(16, 4, dtype=np.float32),
        "explained": np.full(4, 0.25, np.float32)})
    fpca = filters.PCAFilter(fit_pca(x + rng.random(x.shape, np.float32),
                                     4))
    kw = dict(deferred=deferred, rerank_mult=3 if deferred else None,
              return_stats=True)

    def run(d, c, f, xx):
        gs = [dataclasses.replace(g, cfg=c, x=xx[a:b])
              for g, (a, b) in zip(graphs, bounds)]
        if shards == 1:
            db = search_torch.build_packed(gs[0], filt=f, device=d)
            assert db.low.dtype == search_torch._TORCH_DTYPE[c.low_dtype]
            fd, fi, st = search_torch.search_batched(db, q, filt=f,
                                                     device=d, **kw)
            return [fd.cpu(), fi.cpu(), st["steps_per_layer"].cpu(),
                    st["dist_h_evals"].cpu()]
        sdb = distributed.build_sharded(xx, c, f, shards, graphs=gs,
                                        device=d)
        out = []
        for live in (None, [False, True, True]):
            fd, fi, st = distributed.shard_search_host(
                sdb, q, filt=f, live=live, device=d, **kw)
            out += [fd.cpu(), fi.cpu(), st["coverage"]]
        return out

    f32 = dataclasses.replace(cfg, low_dtype="float32")
    got = {d: run(d, cfg, filt, x) for d in ("cuda", "cpu")}
    for a, b, c in zip(got["cuda"], got["cpu"], run("cuda", f32, filt, x)):
        for y in (b, c):
            assert torch.equal(a, y) if isinstance(a, torch.Tensor) \
                else a == y
    xf = x + rng.random(x.shape).astype(np.float32)
    fl = {d: run(d, cfg, fpca, xf) for d in ("cuda", "cpu")}
    ids_c, ids_h = fl["cuda"][1].numpy(), fl["cpu"][1].numpy()
    assert float((ids_c == ids_h).all(1).mean()) >= 0.95


def _int_mutable_setup(n, shards, low_dtype="float32"):
    """The integer fixture of the mutable tests: integer points, shard
    graphs built on the CPU, and a coordinate-selecting 'PCA'."""
    from repro_torch.configs.base import PHNSWConfig
    from repro_torch.core import distributed, filters
    from repro_torch.core.graph import build_hnsw
    rng = np.random.default_rng(12)
    x = rng.integers(0, 8, (n, 16)).astype(np.float32)
    cfg = PHNSWConfig(name="intmut", n_points=n, dim=16, d_low=4, M=8,
                      M0=16, ef_construction=32, wave_size=256,
                      ef_construction_k=8, min_capacity=32,
                      low_dtype=low_dtype)
    graphs = [build_hnsw(x[a:b], cfg, seed=2 + s, device="cpu")
              for s, (a, b) in enumerate(distributed.shard_bounds(n,
                                                                  shards))]
    filt = filters.from_reference("pca", {
        "mean": np.zeros(16, np.float32),
        "components": np.eye(16, 4, dtype=np.float32),
        "explained": np.full(4, 0.25, np.float32),
        "low_dtype": low_dtype})
    return cfg, graphs, filt


def _mutate(idx, rng):
    """One upsert past the capacity (a growth), deletes, a
    replace-upsert and a second upsert, through any index kind."""
    q = rng.integers(0, 8, (64, 16)).astype(np.float32)
    g1 = idx.upsert(rng.integers(0, 8, (300, 16)).astype(np.float32))
    idx.delete(g1[::7])
    idx.upsert(rng.integers(0, 8, (20, 16)).astype(np.float32),
               ids=g1[1:21])
    idx.upsert(rng.integers(0, 8, (90, 16)).astype(np.float32))
    fd, fi = idx.search(q)
    return [fd.cpu(), fi.cpu()]


@pytest.mark.parametrize("low_dtype", ["float32", "bfloat16"])
def test_mutable_index_card_equals_cpu(cuda, low_dtype):
    """On integer data the mutable index is exact: the same graph, the
    same upserts (the probe on the card), deletes and a growth give the
    same adjacency, levels, entry and tombstones, and bit-identical
    search results, on the card and on the CPU; the upserts launch the
    probe's kernels."""
    from repro_torch.index import MutableIndex
    cfg, graphs, filt = _int_mutable_setup(1000, 1, low_dtype)
    out = {}
    for d in ("cuda", "cpu"):
        idx = MutableIndex.from_graph(graphs[0], filt, seed=3, device=d)
        ops.reset_launch_counts()
        res = _mutate(idx, np.random.default_rng(5))
        if d == "cuda":
            counts = ops.launch_counts()
        out[d] = (res, idx)
    (rc, ic), (rh, ih) = out["cuda"], out["cpu"]
    for a, b in zip(rc, rh):
        assert torch.equal(a, b)
    assert (ic.n, ic.cap, ic.entry, ic.epoch) == (ih.n, ih.cap, ih.entry,
                                                  ih.epoch)
    np.testing.assert_array_equal(ic.levels, ih.levels)
    np.testing.assert_array_equal(ic.deleted, ih.deleted)
    for a, b in zip(ic.adj, ih.adj):
        np.testing.assert_array_equal(a, b)
    for la, lb in zip(ic.db.layers, ih.db.layers):
        assert torch.equal(la.packed_low.cpu(), lb.packed_low)
    assert torch.equal(ic.db.deleted.cpu(), ih.db.deleted)
    for name in ("trip_fold", "fused_expand_rows", "dist_h"):
        assert counts[name] > 0, name


def test_sharded_mutable_index_card_equals_cpu(cuda):
    """The sharded mutable index at P = 4 on integer data: the same
    global ids and bit-identical search results on the card and on the
    CPU."""
    from repro_torch.index import MutableIndex, ShardedMutableIndex
    cfg, graphs, filt = _int_mutable_setup(1001, 4)
    out = {}
    for d in ("cuda", "cpu"):
        idx = ShardedMutableIndex(
            [MutableIndex.from_graph(g, filt, seed=10 + s, device=d)
             for s, g in enumerate(graphs)], filt, cfg)
        out[d] = _mutate(idx, np.random.default_rng(6)) \
            + [idx.live_global_ids()]
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(out["cuda"][2], out["cpu"][2])


def test_earlier_epoch_stays_frozen_on_card(cuda):
    """A PackedDB and a ShardedDB held from before an upsert and a delete
    keep every tensor unchanged on the card: publication is out of
    place."""
    from repro_torch.index import MutableIndex, ShardedMutableIndex
    cfg, graphs, filt = _int_mutable_setup(1001, 4)
    idx = MutableIndex.from_graph(graphs[0], filt, seed=3, device="cuda")
    sidx = ShardedMutableIndex(
        [MutableIndex.from_graph(g, filt, seed=10 + s, device="cuda")
         for s, g in enumerate(graphs)], filt, cfg)
    db0, sdb0 = idx.db, sidx.sdb
    held = [db0.low, db0.high, db0.deleted] \
        + [t for lay in db0.layers for t in (lay.adj, lay.packed_low)] \
        + [sdb0.low, sdb0.high, sdb0.deleted] + sdb0.adj + sdb0.packed_low
    before = [t.clone() for t in held]
    rng = np.random.default_rng(9)
    for index in (idx, sidx):
        ids = index.upsert(rng.integers(0, 8, (40, 16)).astype(np.float32))
        index.delete(ids[:5])
    torch.cuda.synchronize()
    assert idx.db is not db0 and sidx.sdb is not sdb0
    assert all(torch.equal(a, b) for a, b in zip(before, held))


@pytest.mark.parametrize("shards", [1, 2])
def test_replica_set_failover_and_recovery_on_card(cuda, shards, tmp_path):
    """A 3-replica set on the card at N = 600: the replicas answer bit
    for bit alike and equal to the CPU's same set, ``rs.query`` equals a
    single replica's answer, a killed primary fails over, a stale
    checkpoint recovers it with exactly the gap replayed, and the set
    converges; the queries and upserts launch the search's kernels."""
    from repro_torch.distributed import faults
    from repro_torch.distributed.faults import (AllReplicasDeadError,
                                                FaultPlan)
    from repro_torch.index import MutableIndex, ShardedMutableIndex
    from repro_torch.serve import ReplicaSet, VectorSearchService
    cfg, graphs, filt = _int_mutable_setup(600, shards)
    rng = np.random.default_rng(21)
    q = rng.integers(0, 8, (16, 16)).astype(np.float32)
    new = rng.integers(0, 8, (8, 16)).astype(np.float32)
    out = {}
    for d in ("cuda", "cpu"):
        if shards == 1:
            idx = MutableIndex.from_graph(graphs[0], filt, seed=3,
                                          device=d)
        else:
            idx = ShardedMutableIndex(
                [MutableIndex.from_graph(g, filt, seed=10 + s, device=d)
                 for s, g in enumerate(graphs)], filt, cfg)
        svc = VectorSearchService(idx, batch_size=16, device=d)
        rs = ReplicaSet.replicate(svc, 3, snapshot_dir=tmp_path / d)
        assert all(r.svc.device.type == d for r in rs.replicas)
        ops.reset_launch_counts()
        answers = [r.svc.query(q) for r in rs.replicas]
        via = rs.query(q)
        for a in answers[1:] + [via]:
            assert all(np.array_equal(u, v) for u, v in zip(a, answers[0]))
        gids = rs.upsert(new[:4])
        assert rs.delete(gids[:1]) == 1
        counts = ops.launch_counts()
        ckpt, seq = rs.checkpoint()
        with faults.inject(FaultPlan()) as plan:
            plan.add("kill_replica", 0)
            rs.query(q)
            assert ("failover", 1, "primary -> 1") in rs.events
            rs.upsert(new[4:])
            with pytest.raises(AllReplicasDeadError):
                plan.add("kill_replica", -1)
                rs.query(q)
        rs.replicas[1].alive = rs.replicas[2].alive = True
        assert rs.recover(0, snapshot=ckpt, snapshot_seq=seq) == 1
        assert rs.republish(0) == 0
        rep = rs.assert_converged()
        assert rep["n_healthy"] == 3 and rep["applied_seq"] == 3
        live = rs.replicas[1].svc._mut.live_ids()
        assert np.isin(rs.replicas[0].svc.query(q)[1], live).all()
        out[d] = [r.svc.query(q) for r in rs.replicas]
        if d == "cuda":
            for name in ("trip_fold", "fused_expand_rows", "dist_h"):
                assert counts[name] > 0, name
    for a, b in zip(out["cuda"], out["cpu"]):
        assert all(np.array_equal(u, v) for u, v in zip(a, b))


def test_record_search_stats_on_card_batch(cuda):
    """The bridge folds a card batch's telemetry (CUDA tensors) exactly
    as the same batch's on the CPU."""
    from repro_torch.core.search_torch import build_packed, search_batched
    from repro_torch.obs import Registry, record_search_stats
    cfg, graphs, filt = _int_mutable_setup(600, 1)
    q = np.random.default_rng(4).integers(0, 8, (32, 16)).astype(np.float32)
    outs = {}
    for d in ("cuda", "cpu"):
        db = build_packed(graphs[0], filt=filt, device=d)
        _, _, st = search_batched(db, q, filt=filt, return_stats=True,
                                  device=d)
        reg = Registry()
        outs[d] = record_search_stats(st, wall_s=0.002, registry=reg,
                                      cfg=cfg, filt=filt)
        assert reg.histogram("phnsw_search_steps").count == 32
        assert st["steps_total"].device.type == d
    assert outs["cuda"] == outs["cpu"]


# the fold gated per row (the slotted search), in each tier: the pca
# scheduler's bank of 64 slots (ef 10, the mutable index's tombstones),
# the pca-deferred bank (ef 30, no kv row), the block tier (W = 8) and
# the global tier (a frontier past shared memory)
GATED_FOLD_SHAPES = [(64, 10, 16, 1, 16, True, True, True),
                     (64, 30, 16, 1, 16, True, False, True),
                     (64, 100, 0, 1, 32, False, False, False),
                     (64, 10, 16, 8, 128, True, True, True),
                     (2, 30000, 16, 1, 32, True, True, True)]


@pytest.mark.parametrize("shape", GATED_FOLD_SHAPES)
def test_trip_fold_gated_matches_plain(cuda, shape):
    """The fold kernel with per-row ``ef_eff`` and ``pop`` against
    ref.trip_fold_ref, bit for bit on integer and float data, in the
    warp, block and global tiers (one launch, counted as gated); with
    every row popped at the compiled bound it equals the ungated kernel,
    and without gates it counts no gated launch."""
    B, ef, k, W, kk, heap, kv_row, tombs = shape
    cap = max(ef + kk, 8)
    for integer in (True, False):
        rng = np.random.default_rng(3 * ef + kk + integer)
        F_d, F_i, C_d, C_i, Cp, dh, cand, kv, words = _t(
            cuda, *_fold_case(rng, B, ef, cap, k, kk, integer))
        args = (F_d, F_i, C_d, C_i, W, Cp if heap else None, dh, cand,
                kv if kv_row else None, words if tombs else None)
        ef_eff, pop = _t(cuda, rng.integers(1, ef + 1, B).astype(np.int32),
                         rng.random(B) < 0.6)
        ef_eff[0], pop[0] = ef, False
        for gates in ({"ef_eff": ef_eff, "pop": pop}, {"pop": pop},
                      {"ef_eff": ef_eff}, {"pop": pop.to(torch.uint8)}):
            before = ops.launch_counts()
            got = ops.trip_fold(*args, **gates)
            want = ref.trip_fold_ref(*args, **gates)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            assert after["trip_fold"] == before["trip_fold"] + 1
            assert after["trip_fold_gated"] == before["trip_fold_gated"] + 1
            for g, w in zip(got, want):
                if w is not None:
                    assert torch.equal(_bits(g), _bits(w))
        full = {"ef_eff": torch.full_like(ef_eff, ef),
                "pop": torch.ones_like(pop)}
        before = ops.launch_counts()["trip_fold_gated"]
        plain = ops.trip_fold(*args)
        assert ops.launch_counts()["trip_fold_gated"] == before
        for g, w in zip(ops.trip_fold(*args, **full), plain):
            if w is not None:
                assert torch.equal(_bits(g), _bits(w))


def test_trip_fold_gated_argument_checks(cuda):
    """A gate of the wrong dtype, shape or device raises."""
    rng = np.random.default_rng(1)
    F_d, F_i, C_d, C_i, Cp, dh, cand, kv, _ = _t(
        cuda, *_fold_case(rng, 8, 10, 26, 16, 16, True))
    args = (F_d, F_i, C_d, C_i, 1, Cp, dh, cand, kv, None)
    from repro_torch.kernels.trip_fold import trip_fold_cuda
    with pytest.raises(TypeError):
        trip_fold_cuda(*args, pop=torch.ones(8, dtype=torch.float32,
                                             device=cuda))
    with pytest.raises(ValueError):
        trip_fold_cuda(*args, ef_eff=torch.ones(7, dtype=torch.int32,
                                                device=cuda))
    with pytest.raises(ValueError):
        ops.trip_fold(*args, ef_eff=torch.ones(8, dtype=torch.int32))


@pytest.mark.parametrize("mode", ["pca", "pca-deferred", "sharded"])
def test_scheduler_card_equals_cpu(cuda, mode):
    """The continuous-batching scheduler on the integer fixture: the
    same submit/tick script on the card and on the CPU gives the same
    completions tick by tick (rid, ids, dists, steps, forced) and the
    same escalations; ``run_stream()`` is bit-equal to the card's
    ``run_stream_sync()`` and to the CPU's; the sharded service (three
    shards, shard 1 dead) degrades identically."""
    import dataclasses
    from repro_torch.core import distributed
    from repro_torch.core.search_torch import build_packed
    from repro_torch.serve.vector_service import VectorSearchService
    cfg, graphs, filt = _int_mutable_setup(
        900, 3 if mode == "sharded" else 1)
    cfg = dataclasses.replace(cfg, deferred_rerank=mode == "pca-deferred")
    x = np.concatenate([g.x for g in graphs])
    rng = np.random.default_rng(21)
    q = rng.integers(0, 8, (96, 16)).astype(np.float32)
    ks = rng.choice([4, 10, 24], 96)
    out = {}
    for d in ("cuda", "cpu"):
        if mode == "sharded":
            db = distributed.build_sharded(x, cfg, filt, 3, graphs=graphs,
                                           device=d)
        else:
            db = build_packed(dataclasses.replace(graphs[0], cfg=cfg),
                              filt=filt, device=d)
        svc = VectorSearchService(db, filt=filt, batch_size=32, device=d)
        ids, st = svc.run_stream(q)
        assert st["path"] == "scheduler"
        assert np.array_equal(ids, svc.run_stream_sync(q)[0])
        sched = svc.scheduler(ef=24, n_slots=32, quantum=8)
        if mode == "sharded":
            sched.set_live([True, False, True])
        ticks = []
        for i in range(96):
            sched.submit(q[i], k=int(ks[i]), rid=i)
            if i % 16 == 15:
                ticks.append([(c.rid, c.ids.tolist(), c.dists.tolist(),
                               c.steps, c.forced, c.coverage)
                              for c in sched.tick()])
        while sched.in_flight or sched.queue_depth:
            ticks.append([(c.rid, c.ids.tolist(), c.dists.tolist(),
                           c.steps, c.forced, c.coverage)
                          for c in sched.tick()])
        esc = svc.stats.registry.get("phnsw_sched_escalations_total").value
        out[d] = (ids, ticks, esc)
    assert np.array_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][2] == out["cpu"][2]
    assert sorted(c[0] for t in out["cuda"][1] for c in t) == list(range(96))


# ------------------- grouped-query attention and LM serving ------------------

@pytest.mark.parametrize("G", [1, 4, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,window", [(200, 200, 0), (1024, 1024, 0),
                                        (150, 100, 40), (64, 640, 0)])
def test_gqa_flash_attention_matches_plain(cuda, G, dtype, S, T, window):
    """B8 with q heads = G kv heads (query head h reads kv head h // G)
    against its plain version: causal, ragged, S > T with blind rows,
    a window, a chunk; the bf16 kernel also split over blocks."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    KV, d = 2, 128
    q, k, v = _attn_inputs(cuda, dtype, (2, KV * G, S, d), (2, KV, T, d),
                           (2, KV, T, d), seed=G * S + T)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    splits = (None, 3) if dtype == torch.bfloat16 else (None,)
    for n_split in splits:
        before = ops.launch_counts()["flash_attention"]
        out = flash_attention_cuda(q, k, v, causal=True, window=window,
                                   n_split=n_split)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == before + 1
        tol = 2e-3 if dtype == torch.float32 else 0.05
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert kf.attention_excess(out, want) <= 1
        if S > T:
            assert bool((out[:, :, :S - T] == 0).all())


@pytest.mark.parametrize("G", [1, 4, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,lengths", [(1056, [1056, 0, 1, 700]),
                                       (5000, [0, 4999, 5000, 5007])])
def test_gqa_decode_attention_matches_plain(cuda, G, dtype, T, lengths):
    """B9 with q heads = G kv heads against its plain version, rows with
    length 0 exactly 0, one device kernel a call."""
    KV, d = 2, 128
    B = len(lengths)
    q, k, v = _attn_inputs(cuda, dtype, (B, KV * G, d), (B, KV, T, d),
                           (B, KV, T, d), seed=G + T)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, k, v, ln)
    want = ref.decode_attention_ref(q, k, v, ln)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert kf.attention_excess(out, want) <= 1
    assert bool((out[ln <= 0] == 0).all())
    assert kf.device_kernels(lambda: ops.decode_attention(q, k, v, ln)) == 1


def test_gqa_kernels_refuse_ragged_groups(cuda):
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.zeros(1, 3, 8, 64, device=cuda)
    kv = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q, kv, kv, causal=True, window=0)
    with pytest.raises(ValueError, match="multiple"):
        decode_attention_cuda(q[:, :, 0], kv, kv,
                              torch.ones(1, dtype=torch.int32, device=cuda))


# LM serving card against CPU: f32 smoke configs, the same parameters on
# both; logits to 2e-3 (tests/test_models.py:76's decode tolerance; the
# kernels and the plain versions sum in other orders), tokens equal.
@pytest.mark.parametrize("arch", ["starcoder2-3b", "llama3-405b",
                                  "internvl2-76b"])
def test_generation_engine_card_equals_cpu(cuda, arch):
    """``GenerationEngine`` on the card launches B8 once a layer at
    prefill and B9 once a layer a step, and gives the CPU's greedy
    tokens and logits; the retrieval decode likewise at the smoke
    ``RetrievalConfig``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RetrievalConfig
    from repro_torch.data.tokens import batch_extras_for, synthetic_batch
    from repro_torch.models import get_model
    from repro_torch.serve.engine import GenerationEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    batch = synthetic_batch(0, 0, 2, 24, cfg.vocab,
                            extras=batch_extras_for(cfg))
    batch.pop("labels")
    for c in (cfg, cfg.replace(retrieval=RetrievalConfig(
            enabled=True, d_low=4, topk=8, block=8, partitions=2))):
        card = get_model(c).init(torch.Generator(device=cuda).manual_seed(0),
                                 cuda)
        host = get_model(c).init(None, "cpu")
        host.load_state_dict(card.state_dict())
        ops.reset_launch_counts()
        got = GenerationEngine(c, card, max_new=4).generate(
            {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
        counts = ops.launch_counts()
        assert counts["flash_attention"] == c.n_layers
        assert counts["decode_attention"] == (
            0 if c.retrieval.enabled else 4 * c.n_layers)
        want = GenerationEngine(c, host, max_new=4, device="cpu").generate(
            batch)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_allclose(got.last_logits, want.last_logits,
                                   rtol=2e-3, atol=2e-3)


# The moe, encdec, hybrid and ssm families' attention shapes (reduced in
# length where the plain version's logits would be large): recurrentgemma's
# local MQA (16 heads over 1, d=256, window 2048 at S past it), whisper's
# non-causal encoder and cross-attention (d=64, T = 1,500 frames), qwen3's
# G = 16 (64 heads over 4), mixtral's window 4096.
FAMILY_FLASH = [(1, 16, 1, 2100, 2100, 256, True, 2048),
                (2, 16, 16, 1500, 1500, 64, False, 0),
                (2, 16, 16, 64, 1500, 64, False, 0),
                (2, 64, 4, 300, 300, 128, True, 0),
                (1, 8, 2, 4200, 4200, 128, True, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,T,d,causal,window", FAMILY_FLASH)
def test_family_flash_attention_matches_plain(cuda, dtype, B, H, KV, S, T, d,
                                              causal, window):
    """B8 at the families' prefill and encoder shapes against its plain
    version (non-causal rows see every key: none is blind)."""
    q, k, v = _attn_inputs(cuda, dtype, (B, H, S, d), (B, KV, T, d),
                           (B, KV, T, d), seed=H * S + T)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert kf.attention_excess(out, want) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,T,d,lengths", [
    (16, 1, 2048, 256, [2048, 1, 1000, 2048]),      # the ring: min(pos+1, T)
    (16, 16, 1500, 64, [1500, 1500]),              # whisper's cross cache
    (64, 4, 1040, 128, [1040, 7]),                 # qwen3, G = 16
])
def test_family_decode_attention_matches_plain(cuda, dtype, H, KV, T, d,
                                               lengths):
    """B9 at the families' decode shapes against its plain version, one
    device kernel a call."""
    B = len(lengths)
    q, k, v = _attn_inputs(cuda, dtype, (B, H, d), (B, KV, T, d),
                           (B, KV, T, d), seed=H + T)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, k, v, ln)
    want = ref.decode_attention_ref(q, k, v, ln)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert kf.attention_excess(out, want) <= 1
    assert kf.device_kernels(lambda: ops.decode_attention(q, k, v, ln)) == 1


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "whisper-medium", "recurrentgemma-9b",
                                  "rwkv6-1.6b", "llama3-405b int8"])
def test_family_generation_card_equals_cpu(cuda, arch):
    """``GenerationEngine`` on the card for each family (the smoke
    configs, f32; mixtral's 16-token prompt twice its window, so the ring
    wraps; recurrentgemma's past its local window) gives the CPU's greedy
    tokens and logits (2e-3), launching B8 once an attention layer at
    prefill and B9 once an attention layer a step (rwkv6 neither); and,
    for ``kv_quant``, decode from the int8 cache of ``init_cache``, card
    against CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import batch_extras_for, synthetic_batch
    from repro_torch.models import get_model
    from repro_torch.serve.engine import GenerationEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    name, _, quant = arch.partition(" ")
    cfg = get_smoke_config(name).replace(kv_quant=bool(quant))
    batch = synthetic_batch(0, 0, 2, 16, cfg.vocab,
                            extras=batch_extras_for(cfg))
    batch.pop("labels")
    card = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                               cuda)
    host = get_model(cfg).init(None, "cpu")
    host.load_state_dict(card.state_dict())
    ops.reset_launch_counts()
    got = GenerationEngine(cfg, card, max_new=4).generate(
        {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
    counts = ops.launch_counts()
    attn_layers = {"encdec": 2 * cfg.n_layers, "ssm": 0,
                   "hybrid": cfg.n_layers // max(len(cfg.pattern), 1)}.get(
        cfg.family, cfg.n_layers)
    assert counts["flash_attention"] == attn_layers + cfg.enc_layers
    assert counts["decode_attention"] == 4 * attn_layers
    want = GenerationEngine(cfg, host, max_new=4, device="cpu").generate(
        batch)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.last_logits, want.last_logits,
                               rtol=2e-3, atol=2e-3)
    if quant:
        api = get_model(cfg)
        caches = {d: api.init_cache(2, 12, d) for d in (cuda, "cpu")}
        for t in range(10):
            tok = torch.from_numpy(batch["tokens"][:, t:t + 1])
            lg = {d: api.decode_step(m, caches[d], tok.to(d), t)[0].cpu()
                  for d, m in ((cuda, card), ("cpu", host))}
            torch.testing.assert_close(lg[cuda], lg["cpu"], rtol=2e-3,
                                       atol=2e-3)
        assert caches[cuda]["k"].dtype == torch.int8


# ------------------------------- training ----------------------------------

TRAIN_ARCHS = ["starcoder2-3b", "mixtral-8x7b", "internvl2-76b",
               "whisper-medium", "recurrentgemma-9b", "rwkv6-1.6b"]


def _train_grads(api, model, batch):
    loss, metrics = api.loss(model, batch)
    loss.backward()
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), \
        {k: float(v.detach()) for k, v in metrics.items()}, \
        grads


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_loss_card_equals_cpu(cuda, arch):
    """``ModelApi.loss`` and its backward at each family's smoke config
    in f32, card against CPU on the same parameters and batch: the loss
    to rtol 1e-5, each gradient within 1e-4 of its leaf's largest
    magnitude + 1e-7 (the CPU tests' bars against the reference), the
    MoE's dropped fraction exactly; no attention kernel launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import batch_extras_for, synthetic_batch
    from repro_torch.models import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    card = api.init(torch.Generator(device=cuda).manual_seed(1), cuda) \
        .requires_grad_(True)
    host = api.init(None, "cpu")
    host.load_state_dict(card.state_dict())
    host.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        2, 0, 2, 32, cfg.vocab, extras=batch_extras_for(cfg)).items()}
    ops.reset_launch_counts()
    cl, cm, cg = _train_grads(api, card,
                              {k: v.to(cuda) for k, v in batch.items()})
    assert not any(ops.launch_counts().values())
    hl, hm, hg = _train_grads(api, host, batch)
    assert abs(cl - hl) <= 1e-5 * abs(hl)
    assert cm.get("dropped_frac") == hm.get("dropped_frac")
    for n, want in hg.items():
        err = float((cg[n] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-7, n


@pytest.mark.parametrize("S,window,q_chunk", [(512, 0, 256), (512, 64, 128)])
def test_blocked_attention_bf16_card_equals_cpu(cuda, S, window, q_chunk):
    """``blocked_attention`` in bf16 (on the card the scores come from a
    bf16 product with an f32 output, on the CPU from the widened
    inputs: the same exact products, summed in other orders), grouped,
    causal, plain and banded: the output and the gradients of q, k and
    v within 2 bf16 ulps of each tensor's largest magnitude."""
    from repro_torch.models.attention import blocked_attention
    g = torch.Generator().manual_seed(S + window)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16)
               for shape in ((2, S, 8, 64), (2, S, 2, 64), (2, S, 2, 64)))
    w = torch.randn((2, S, 8, 64), generator=g).to(torch.bfloat16)
    pos = torch.arange(S)

    def run(dev):
        ts = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        o = blocked_attention(*ts, pos.to(dev), pos.to(dev), causal=True,
                              window=window, q_chunk=q_chunk)
        (o.float() * w.to(dev).float()).sum().backward()
        return [o.detach().float().cpu()] + \
            [t.grad.float().cpu() for t in ts]

    for got, want in zip(run(cuda), run("cpu")):
        tol = 2 * 2 ** -8 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol


def test_train_resume_bit_equal_on_card(cuda, tmp_path):
    """``TrainLoop`` on the card (starcoder2-3b smoke, seq 64, batch 8):
    4 straight steps against 2, a new loop resuming from the checkpoint,
    and 2 more: the losses after the restart and the final parameters
    bit for bit (the backward passes are deterministic run to run)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import TrainLoop, TrainLoopConfig
    cfg = get_smoke_config("starcoder2-3b")
    shape = ShapeConfig("smoke", 64, 8, "train")
    run = lambda n, d: TrainLoop(
        cfg, shape, None, TrainLoopConfig(steps=n, seed=3, ckpt_every=2,
                                          ckpt_dir=str(tmp_path / d)),
        device=cuda)
    straight = run(4, "a")
    straight.run()
    run(2, "b").run()
    resumed = run(4, "b")
    resumed.run()
    assert [m["loss"] for m in resumed.metrics_log] == \
        [m["loss"] for m in straight.metrics_log][2:]
    for a, b in zip(resumed.model.parameters(),
                    straight.model.parameters()):
        assert torch.equal(a, b)


def test_attention_kernels_refuse_a_graph_on_card(cuda):
    """On the card the kernels' outputs would carry no ``grad_fn``: both
    ops raise under autograd, and a model whose parameters require grad
    serves through ``GenerationEngine`` (``torch.no_grad()``) the same
    tokens as the same weights without grad."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve.engine import GenerationEngine
    q = torch.randn(1, 4, 8, 16, device=cuda, requires_grad=True)
    k = torch.randn(1, 2, 8, 16, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention(q[:, :, 0], k, k,
                             torch.tensor([8], device=cuda))
    cfg = get_smoke_config("starcoder2-3b")
    model = get_model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                                cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), device=cuda)}
    want = GenerationEngine(cfg, model, max_new=4, device=cuda) \
        .generate(batch)
    model.requires_grad_(True)
    got = GenerationEngine(cfg, model, max_new=4, device=cuda).generate(batch)
    assert np.array_equal(got.tokens, want.tokens)
    assert np.array_equal(got.last_logits, want.last_logits)


# ---- B8 and B9 as dispatcher operators (the dry-run counts them) ----

@pytest.mark.parametrize("H,KV,S,T,d,causal,window", [
    (4, 4, 64, 64, 64, True, 0), (8, 2, 33, 70, 128, True, 16),
    (4, 1, 16, 40, 32, False, 0)])
def test_flash_attention_counts_like_cpu_and_launches_once(
        cuda, H, KV, S, T, d, causal, window):
    """B8 through ``ops``: a ``FlopCounterMode`` counts its formula on
    CUDA tensors exactly as on CPU ones (and as on "meta"), and each call
    launches the kernel once."""
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(H + S)
    q, k, v = (torch.randn(shape, generator=g, dtype=torch.bfloat16)
               for shape in ((2, H, S, d), (2, KV, T, d), (2, KV, T, d)))
    counts = {}
    for dev in ("cpu", cuda, "meta"):
        with FlopCounterMode(display=False) as fc:
            before = ops.launch_counts()["flash_attention"]
            ops.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                                causal=causal, window=window)
            counts[str(dev)] = (fc.get_total_flops(),
                                ops.launch_counts()["flash_attention"]
                                - before)
    torch.cuda.synchronize()
    want = 4 * 2 * H * S * T * d
    assert counts == {"cpu": (want, 0), "cuda": (want, 1),
                      "meta": (want, 0)}


@pytest.mark.parametrize("H,KV,T,d", [(4, 4, 4096, 64), (24, 2, 1056, 128),
                                      (16, 1, 300, 256)])
def test_decode_attention_counts_like_cpu_and_launches_once(cuda, H, KV, T,
                                                            d):
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(H + T)
    q = torch.randn((3, H, d), generator=g, dtype=torch.bfloat16)
    k, v = (torch.randn((3, KV, T, d), generator=g, dtype=torch.bfloat16)
            for _ in range(2))
    length = torch.tensor([0, T // 2, T], dtype=torch.int32)
    counts = {}
    for dev in ("cpu", cuda, "meta"):
        with FlopCounterMode(display=False) as fc:
            before = ops.launch_counts()["decode_attention"]
            ops.decode_attention(q.to(dev), k.to(dev), v.to(dev),
                                 length.to(dev))
            counts[str(dev)] = (fc.get_total_flops(),
                                ops.launch_counts()["decode_attention"]
                                - before)
    torch.cuda.synchronize()
    want = 4 * 3 * H * T * d
    assert counts == {"cpu": (want, 0), "cuda": (want, 1),
                      "meta": (want, 0)}


# --------------- the stacked kernels (the sharded slotted pass) --------------

STACKED_P, STACKED_ROWS = 4, 64      # the stream phase's bank: P x S rows


def _stacked_rows_case(rng, P, R, W, N, M0, width, kind):
    """A stacked layer (adj [P, N, M0] with -1 tails; integer layout-(3)
    rows or uint8 codes [P, N, M0, width]), P * R shard-major rows of
    popped ids (a view of a wider frontier, some -1; row 2 a -1 pop with
    its gate set), gates (row 0 all clear), integer queries, a flat
    integer table row (the cascade's layout) and a heap whose last column
    is the threshold."""
    B = P * R
    adj = rng.integers(0, N, (P, N, M0)).astype(np.int32)
    tails = rng.integers(0, M0 // 2, (P, N))
    adj[np.arange(M0)[None, None, :] >= M0 - tails[..., None]] = -1
    if kind == "pq":
        pay = rng.integers(0, 256, (P, N, M0, width)).astype(np.uint8)
    else:
        pay = rng.integers(0, 16, (P, N, M0, width)).astype(np.float32)
    C_i = rng.integers(-1, N, (B, W + 7)).astype(np.int32)
    exp = rng.random((B, W)) < 0.8
    exp[0] = False
    C_i[2, 0], exp[2, 0] = -1, True
    q = rng.integers(0, 16, (B, width)).astype(np.float32)
    flat = rng.integers(0, 1 << 16, (B, width * 256 + 15)).astype(np.float32)
    scale = float(width << 15) if kind == "pq" else 64.0 * width
    heap = np.sort(rng.random((B, 4)) * scale, 1).astype(np.float32)
    heap[::2, -1] = INF
    heap[1, -1] = 0.0
    return adj, pay, C_i, exp, q, flat, heap


def _stacked_expand(kind, adj, pay, c_w, exp, q, lut, th, kk, op):
    """``op`` (ops or ref) of the expand of ``kind`` on these leaves."""
    if kind == "pq":
        return op.pq_expand_rows(adj, pay, c_w, exp, lut, th, kk) \
            if op is ops else ref.pq_expand_rows_ref(adj, pay, c_w, exp, lut,
                                                     th, kk)
    if op is ops:
        return ops.fused_expand_rows(adj, pay, c_w, exp, q, th, kk)
    return ref.fused_expand_rows_ref(adj, pay, c_w, exp, q, th, kk)


def _check_stacked_expand(dev, kind, P, R, W, N, M0, width, k, seed):
    """The stacked expand of ``kind`` ("f32", "bf16" or "pq") against its
    plain version and against P per-shard launches, bit for bit; one
    launch counted for the stacked call."""
    rng = np.random.default_rng(seed)
    adj, pay, C_i, exp, q, flat, heap = _t(dev, *_stacked_rows_case(
        rng, P, R, W, N, M0, width, kind))
    if kind == "bf16":
        pay = pay.to(torch.bfloat16)
    B = P * R
    lut = flat[:, :width * 256].reshape(B, width, 256)
    c_w, th, kk = C_i[:, :W], heap[:, -1], W * k
    name = "pq_expand_rows" if kind == "pq" else "fused_expand_rows"
    before = ops.launch_counts()[name]
    got = _stacked_expand(kind, adj, pay, c_w, exp, q, lut, th, kk, ops)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    want = _stacked_expand(kind, adj, pay, c_w, exp, q, lut, th, kk, ref)
    rows = lambda p: slice(p * R, (p + 1) * R)
    per = [_stacked_expand(kind, adj[p], pay[p], c_w[rows(p)], exp[rows(p)],
                           q[rows(p)], lut[rows(p)], th[rows(p)], kk, ops)
           for p in range(P)]
    torch.cuda.synchronize()
    for w in (want, tuple(map(torch.cat, zip(*per)))):
        assert torch.equal(_bits(got[0]), _bits(w[0]))
        assert torch.equal(got[1], w[1])
    assert bool((got[0][0] == INF).all())


@pytest.mark.parametrize("kind", ["f32", "bf16", "pq"])
@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_stacked_expand_rows_match_plain_and_per_shard(cuda, W, kind):
    """The expands on a stacked layer (P = 4 shards, 64 rows each: the
    stream phase's sharded bank): one launch for every shard, equal to
    the plain version and to the per-shard launches, in the warp tier
    (W = 1, 2, 4: 32, 64, 128 slots) and the block tier (W = 8)."""
    width = 16 if kind == "pq" else 15
    _check_stacked_expand(cuda, kind, STACKED_P, STACKED_ROWS, W, 3000, 32,
                          width, 16, 100 * W + len(kind))


@pytest.mark.parametrize("kind", ["f32", "pq"])
def test_stacked_expand_rows_global_tier(cuda, kind):
    """A stacked row past the card's opt-in shared memory (W = 4 popped
    nodes of M0 = 16,384 slots): the global tier, equal the same way."""
    from repro_torch.kernels._launch import smem_optin
    from repro_torch.kernels.fused_filter import expand_plan
    assert expand_plan(4 * 16384, smem_optin(cuda))["tier"] == "global"
    _check_stacked_expand(cuda, kind, 2, 2, 4, 64, 16384, 4, 20, 7)


# (B, ef, k, W, kk, heap, kv row): the pca bank's fold (warp tier), the
# pca-deferred bank's (no kv row), the bypass, W = 8 (block tier) and a
# frontier past shared memory (global tier), each over P = 4 shards'
# tombstone words
STACKED_FOLD_SHAPES = [(256, 10, 16, 1, 16, True, True),
                       (256, 30, 16, 1, 16, True, False),
                       (256, 100, 0, 1, 32, False, False),
                       (256, 10, 16, 8, 128, True, True),
                       (8, 30000, 16, 1, 32, True, True)]


@pytest.mark.parametrize("shape", STACKED_FOLD_SHAPES)
def test_stacked_trip_fold_matches_plain_and_per_shard(cuda, shape):
    """The fold with stacked tombstone words [P, nw] (row r masked with
    shard r // (B / P)'s): one launch, gated and ungated, equal bit for
    bit to the plain version and to the per-shard launches, on integer
    and float data."""
    B, ef, k, W, kk, heap, kv_row = shape
    P, cap = STACKED_P, max(ef + kk, 8)
    for integer in (True, False):
        rng = np.random.default_rng(5 * ef + kk + integer)
        F_d, F_i, C_d, C_i, Cp, dh, cand, kv, _ = _t(
            cuda, *_fold_case(rng, B, ef, cap, k, kk, integer))
        words, = _t(cuda, np.stack([_fold_case(rng, 1, 1, 8, 1, 1, True)[-1]
                                    for _ in range(P)]))
        ef_eff, pop = _t(cuda, rng.integers(1, ef + 1, B).astype(np.int32),
                         rng.random(B) < 0.6)
        rows = lambda p: slice(p * (B // P), (p + 1) * (B // P))
        for gates in ({}, {"ef_eff": ef_eff, "pop": pop}):
            args = (F_d, F_i, C_d, C_i, W, Cp if heap else None, dh, cand,
                    kv if kv_row else None, words)
            before = ops.launch_counts()
            got = ops.trip_fold(*args, **gates)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            assert after["trip_fold"] == before["trip_fold"] + 1
            assert after["trip_fold_gated"] == \
                before["trip_fold_gated"] + bool(gates)
            want = ref.trip_fold_ref(*args, **gates)
            cut = lambda t, p: None if t is None else t[rows(p)]
            per = [ops.trip_fold(*(cut(t, p) for t in args[:4]), W,
                                 *(cut(t, p) for t in args[5:9]), words[p],
                                 **{n: t[rows(p)] for n, t in gates.items()})
                   for p in range(P)]
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(got, want)):
                if w is None:
                    assert g is None
                    continue
                assert torch.equal(_bits(g), _bits(w))
                assert torch.equal(_bits(g),
                                   _bits(torch.cat([o[i] for o in per])))


def test_stacked_kernels_refuse_a_ragged_batch(cuda):
    """B not a multiple of the P shards raises, on the card as on the
    CPU, before any launch."""
    rng = np.random.default_rng(3)
    adj, low, C_i, exp, q, flat, heap = _t(cuda, *_stacked_rows_case(
        rng, 4, 8, 1, 100, 16, 4, "f32"))
    _, codes, *_ = _t(cuda, *_stacked_rows_case(rng, 4, 8, 1, 100, 16, 4,
                                                "pq"))
    cut = slice(0, 31)
    lut = flat[cut, :4 * 256].reshape(31, 4, 256)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="shards"):
        ops.fused_expand_rows(adj, low, C_i[cut, :1], exp[cut], q[cut],
                              heap[cut, -1], 8)
    with pytest.raises(ValueError, match="shards"):
        ops.pq_expand_rows(adj, codes, C_i[cut, :1], exp[cut], lut,
                           heap[cut, -1], 8)
    F_d, F_i, C_d, C_i2, Cp, dh, cand, kv, w = _t(
        cuda, *_fold_case(rng, 31, 10, 26, 16, 16, True))
    with pytest.raises(ValueError, match="shards"):
        ops.trip_fold(F_d, F_i, C_d, C_i2, 1, Cp, dh, cand, kv,
                      torch.stack([w] * 4))
    assert ops.launch_counts() == before


def test_sharded_scheduler_launches_once_a_trip(cuda):
    """The sharded stream on the card (P = 3) steps every shard in one
    pass: each layer-body trip, counted on the host, launches the pca
    expand and the fold once, the gated fold once a slotted trip, and
    not once a shard; bit-equal to the synchronous shard loop."""
    from repro_torch.core import distributed
    from repro_torch.core import search_torch as st
    from repro_torch.serve.vector_service import VectorSearchService
    cfg, graphs, filt = _int_mutable_setup(900, 3)
    x = np.concatenate([g.x for g in graphs])
    q = np.random.default_rng(4).integers(0, 8, (64, 16)).astype(np.float32)
    sdb = distributed.build_sharded(x, cfg, filt, 3, graphs=graphs,
                                    device=cuda)
    svc = VectorSearchService(sdb, filt=filt, batch_size=32, device=cuda)
    svc.scheduler()
    ops.reset_launch_counts()
    st.reset_trip_counts()
    ids, stats = svc.run_stream(q)
    torch.cuda.synchronize()
    counts, trips = ops.launch_counts(), st.trip_counts()
    assert stats["path"] == "scheduler" and trips["slotted"] > 0
    assert counts["trip_fold_gated"] == trips["slotted"]
    assert counts["trip_fold"] == trips["slotted"] + trips["layer"]
    assert counts["fused_expand_rows"] == trips["slotted"] + trips["layer"]
    assert np.array_equal(ids, svc.run_stream_sync(q)[0])


# ---- the paper's benches (repro_torch.bench.*) card against CPU ----------

@pytest.fixture
def bench_fixture(cuda, tmp_path, monkeypatch):
    """The benches' cached fixture in ``tmp_path`` at 1,000 points, built
    on the card; the CPU runs load the same graph."""
    from repro_torch.bench import common
    monkeypatch.setattr(common, "DATA_DIR", tmp_path / "data")
    return common.load_bench_db(1_000, 32, device="cuda")


def test_build_bench_card_equals_cpu(cuda):
    from repro_torch.bench import build
    cfg, x, pca, q, gt = build.bench_data(500, 32)
    got = {dev: build.run_build(cfg, x, pca, q, gt, device=dev)["entry"]
           for dev in ("cuda", "cpu")}
    for k in ("levels_match", "entry_match", "invariants_ok",
              "mean_deg0_ref"):
        assert got["cuda"][k] == got["cpu"][k]
    assert got["cuda"]["levels_match"] and got["cuda"]["entry_match"]
    for k in ("recall_at_10_ref", "recall_at_10_wave"):
        assert abs(got["cuda"][k] - got["cpu"][k]) <= 0.005


@pytest.mark.parametrize("n_shards", [1, 2])
def test_churn_bench_card_equals_cpu(cuda, bench_fixture, n_shards):
    from repro_torch.bench.churn import run_churn
    cfg, x, g, pca, _, q, _ = bench_fixture
    got = {dev: run_churn(cfg, x, g, pca, q, rounds=3, n_shards=n_shards,
                          device=dev)["entry"] for dev in ("cuda", "cpu")}
    c, h = got["cuda"], got["cpu"]
    for k in ("upserts", "deletes", "live", "expected_live",
              "tombstone_frac", "non_live_returned"):
        assert c[k] == h[k], k
    assert c["live"] == c["expected_live"] and c["non_live_returned"] == 0
    assert abs(c["recall_at_10"] - h["recall_at_10"]) <= 0.02
    assert c["pca_drift"] == pytest.approx(h["pca_drift"], rel=1e-4)
    assert ops.launch_counts()["trip_fold"] > 0


def test_faults_bench_card_equals_cpu(cuda):
    from repro_torch.bench.faults import faults_index, run_faults
    got = {}
    for dev in ("cuda", "cpu"):
        idx, qb = faults_index(1_000, 16, 4, device=dev)
        got[dev] = run_faults(idx, qb, reps=1, device=dev)["entry"]
    c, h = got["cuda"], got["cpu"]
    for pc, ph in zip(c["curve"], h["curve"]):
        assert pc["coverage"] == ph["coverage"] == pc["live_share"]
        assert abs(pc["recall_full"] - ph["recall_full"]) <= 0.02
        assert abs(pc["recall_survivor"] - ph["recall_survivor"]) <= 0.02
    assert c["zero_recompiles"] and h["zero_recompiles"]
    assert c["recovered_coverage"] == h["recovered_coverage"] == 1.0


def test_pq_ablation_bench_card_equals_cpu(cuda, bench_fixture):
    from repro_torch.bench.pq_ablation import run_pq_ablation
    cfg, x, g, pca, _, q, gt = bench_fixture
    got = {dev: run_pq_ablation(cfg, x, g, pca, q, gt, device=dev)["modes"]
           for dev in ("cuda", "cpu")}
    assert list(got["cuda"]) == list(got["cpu"])
    for mode, c in got["cuda"].items():
        h = got["cpu"][mode]
        for k in ("bytes_per_vec", "sidecar_bytes_per_vec", "rerank_mult",
                  "promote_mult", "bytes_layout3"):
            assert c[k] == h[k], (mode, k)
        assert abs(c["recall"] - h["recall"]) <= 0.02, mode
        assert c["dist_h_mean"] == pytest.approx(h["dist_h_mean"], rel=0.02)
    assert ops.launch_counts()["pq_expand_rows"] > 0


@pytest.mark.parametrize("argv", [["--filter", "cascade", "--deferred"],
                                  ["--shards", "2"]])
def test_runner_perf_smoke_card_equals_cpu(cuda, bench_fixture, tmp_path,
                                           argv):
    import json
    from repro_torch.bench import run
    docs = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        run.main(["--perf-smoke", "--n-points", "1000", "--device", dev,
                  "--out", str(d)] + argv)
        docs[dev] = json.loads((d / "table3_qps.json").read_text())
    names = [[r["name"] for r in docs[dev]["rows"]] for dev in docs]
    assert names[0] == names[1]
    for row_c, row_h in zip(docs["cuda"]["rows"], docs["cpu"]["rows"]):
        if "torch" in row_c["name"]:
            rc = float(row_c["derived"].split("recall@10=")[1][:5])
            rh = float(row_h["derived"].split("recall@10=")[1][:5])
            assert abs(rc - rh) <= 0.02, row_c["name"]
    assert docs["cuda"]["card"] == torch.cuda.get_device_name(0)
