"""The port's kernel-footprint bench (``repro_torch.bench.kernel_footprint``)
without a card: its row names and shapes are the reference bench's
(``benchmarks/bench_kernel_footprint.py``), its derived byte and
operation counts follow from the shapes, the calls run the plain versions
on the CPU at those shapes, and ``main`` refuses to time without CUDA.
This file imports no jax."""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro_torch.bench import kernel_footprint as kf
from repro_torch.kernels import ref

NAMES = ["kernels/dist_l", "kernels/ksort_l", "kernels/dist_h",
         "kernels/fused_filter", "kernels/flash_attention",
         "kernels/decode_attention"]


def test_rows_are_the_reference_benchs():
    rows = kf.plan()
    assert [r["name"] for r in rows] == NAMES
    assert [r["shape"] for r in rows] == [
        [64, 32, 15], [64, 32, 16], [64, 16, 128], [64, 32, 15, 16],
        [1, 4, 512, 512, 64], [1, 4, 4096, 64]]


def test_derived_counts_follow_from_the_shapes():
    rows = {r["name"]: r for r in kf.plan()}
    assert rows["kernels/dist_l"]["bytes"] == 4 * (64 * 32 * 15 + 64 * 15
                                                  + 64 * 32)
    assert rows["kernels/dist_h"]["ops"] == 3 * 64 * 16 * 128
    assert rows["kernels/fused_filter"]["bytes"] == \
        4 * (64 * 32 * 15 + 64 * 15) + 8 * 64 * 16
    # the bench passes one bf16 [1, 4, 512, 64] tensor as q, k and v: it
    # is read once, the output written once; 4*d operations per visible
    # pair, S(S+1)/2 pairs per head when causal
    fl = rows["kernels/flash_attention"]
    assert fl["bytes"] == 2 * 4 * 512 * 64 * 2
    assert kf.flash_cost(1, 4, 512, 512, 64, 2, True, 0)["bytes"] == \
        4 * 4 * 512 * 64 * 2
    assert fl["ops"] == 4 * 64 * 4 * (512 * 513 // 2)
    assert fl["bound_by"] == "bytes"
    # one cache passed as k and v, read once, plus q, the output and
    # length (distinct k and v: the reference's cache_bytes_read)
    de = rows["kernels/decode_attention"]
    assert de["bytes"] == 4 * 4096 * 64 * 2 + 2 * 4 * 64 * 2 + 4
    assert kf.decode_cost(4, 64, 2, [4096], 4096)["bytes"] == \
        2 * 4 * 4096 * 64 * 2 + 2 * 4 * 64 * 2 + 4
    assert de["bound_by"] == "bytes"
    for r in rows.values():
        ms, by = kf.bound_ms(r["bytes"], r["ops"], r["peak_ops_per_s"])
        assert r["bound_us"] == pytest.approx(ms * 1e3)
        assert r["bound_by"] == by


def test_smem_figures_follow_the_kernels_plans():
    """kSort.L's [64, 32] rows are sorted a warp each, in registers (no
    shared memory); the decode row's figure is its plan's at the bench's
    shape: four stages of 128 K and V rows, barriers and softmax
    states."""
    from repro_torch.kernels.decode_attention import split_plan
    from repro_torch.kernels.ksort_l import ksort_plan
    rows = {r["name"]: r for r in kf.plan()}
    assert rows["kernels/ksort_l"]["smem_per_block_bytes"] == \
        ksort_plan(32, kf.SMEM_OPTIN)["smem"] == 0
    plan = split_plan(4, 4096, 64, 2)
    assert rows["kernels/decode_attention"]["smem_per_block_bytes"] == \
        plan["smem"] > plan["stages"] * 2 * plan["tile"] * 64 * 2


@pytest.mark.parametrize("S,T,causal,window", [
    (512, 512, True, 0), (64, 256, True, 0), (200, 100, True, 0),
    (300, 300, True, 64), (130, 130, False, 30), (50, 70, False, 0),
    (96, 96, True, 5000)])
def test_attention_pairs_count_the_mask(S, T, causal, window):
    mask = ref.attention_mask(S, T, causal, window)
    assert kf.attention_pairs(S, T, causal, window) == int(mask.sum())


def test_model_width_costs():
    """The figures the bring-up is checked against: starcoder2-3b
    prefill ~103.1 GFLOP bound by operations; mixtral-8x7b's window
    ~412 GFLOP; starcoder2-3b decode 1.61 GB of K/V bound by bytes."""
    c = kf.flash_cost(1, 24, 4096, 4096, 128, 2, True, 0)
    assert c["ops"] == 4 * 128 * 24 * (4096 * 4097 // 2)
    ms, by = kf.bound_ms(c["bytes"], c["ops"], kf.PEAK_BF16_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(0.10425, rel=1e-3)
    c = kf.flash_cost(1, 32, 8192, 8192, 128, 2, True, 4096)
    assert c["ops"] == pytest.approx(412.35e9, rel=1e-4)
    c = kf.decode_cost(24, 128, 2, [16384] * 8, 16384)
    assert 2 * 24 * 8 * 16384 * 128 * 2 == 1610612736
    ms, by = kf.bound_ms(c["bytes"], c["ops"], kf.PEAK_BF16_OPS_PER_S)
    assert by == "bytes" and ms == pytest.approx(0.4808, rel=1e-3)
    # lengths past the cache count as the cache, length 0 as nothing
    assert kf.decode_cost(1, 8, 2, [0, 9], 4)["ops"] == 4 * 8 * 4


def test_calls_run_the_plain_versions_on_the_cpu():
    """The rows' inputs at the reference's shapes from default_rng(0),
    through the port's ops on the CPU (plain versions; no timing), each
    beside its plain call on the same tensors."""
    calls = kf.make_calls(torch.device("cpu"))
    assert list(calls) == NAMES
    outs = {n: (fn(), plain()) for n, (fn, plain) in calls.items()}
    for got, want in outs.values():
        for g, w in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (got, want))):
            assert torch.equal(g, w)
    shapes = {n: [tuple(t.shape) for t in (o if isinstance(o, tuple)
                                            else (o,))]
              for n, (o, _) in outs.items()}
    assert shapes == {"kernels/dist_l": [(64, 32)],
                      "kernels/ksort_l": [(64, 16), (64, 16)],
                      "kernels/dist_h": [(64, 16)],
                      "kernels/fused_filter": [(64, 16), (64, 16)],
                      "kernels/flash_attention": [(1, 4, 512, 64)],
                      "kernels/decode_attention": [(1, 4, 64)]}
    out = calls["kernels/flash_attention"][0]()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_emit_prints_three_fields():
    rows = kf.plan()
    for r in rows:
        r["us"] = 1.5
    buf = io.StringIO()
    with redirect_stdout(buf):
        kf.emit(rows)
    lines = buf.getvalue().splitlines()
    assert [ln.split(",")[0] for ln in lines] == NAMES
    for ln in lines:
        name, us, derived = ln.split(",")
        assert us == "1.500"
        assert "bound_by=" in derived and "smem_per_block_bytes=" in derived


def test_main_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main would time on it")
    out = tmp_path / "fp.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        kf.main(["--out", str(out)])
    assert not out.exists()


def test_bound_takes_the_larger_time():
    ms, by = kf.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = kf.bound_ms(1.0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = kf.bound_ms(1.0, 989e9, kf.PEAK_BF16_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(1.0)
    assert np.isclose(kf.bound_ms(0.0, 0.0)[0], 0.0)


def _exact_attention(q, k, v, mask):
    """f64 softmax attention rounded once to q's dtype: a kernel that
    keeps f32 inside, without the plain version's bf16 weights."""
    lg = (q.double() @ k.double().transpose(-1, -2)) * q.shape[-1] ** -0.5
    lg = lg.masked_fill(~mask, float("-inf"))
    p = torch.exp(lg - lg.amax(-1, keepdim=True).clamp(min=-1e300))
    return ((p @ v.double()) / p.sum(-1, keepdim=True).clamp(min=1e-30)
            ).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_excess_passes_rounding_and_fails_a_dropped_tile(dtype):
    """A long decode row (T = 8192: outputs ~0.01): the exact result
    rounded once passes; the same with the last 32-key tile dropped
    fails, though it is inside the JAX suite's flat 0.05 in bf16."""
    g = torch.Generator().manual_seed(0)
    B, H, T, d = 2, 2, 8192, 128
    q, k, v = (torch.randn(s, generator=g).to(dtype)
               for s in ((B, H, 1, d), (B, H, T, d), (B, H, T, d)))
    ln = torch.tensor([T, 5000])
    want = ref.decode_attention_ref(q[:, :, 0], k, v, ln)
    seen = torch.arange(T)[None, None, None, :] < ln[:, None, None, None]
    assert kf.attention_excess(_exact_attention(q, k, v, seen)[:, :, 0],
                               want) <= 1
    dropped = seen & (torch.arange(T) < (ln - 32)[:, None, None, None])
    bad = _exact_attention(q, k, v, dropped)[:, :, 0]
    assert kf.attention_excess(bad, want) > 1
    if dtype == torch.bfloat16:
        assert float((bad.float() - want.float()).abs().max()) < 0.05


def test_attention_excess_rows_without_keys_must_be_exact():
    want = torch.zeros((1, 2, 4, 8), dtype=torch.bfloat16)
    want[0, 0] = 1.0
    got = want.clone()
    assert kf.attention_excess(got, want) == 0.0
    got[0, 1, 2, 3] = 1e-3
    assert kf.attention_excess(got, want) == float("inf")
