"""The host plans of kSort.L's warp tier and of the one-launch decode, and
the invariants their kernels rest on, checked without a card (this file
imports no jax).

* kSort.L's warp tier sorts 64-bit keys (``ksort_l.sort_keys`` renders
  ``csrc/warp_sort.cuh``'s key in plain PyTorch): their order must be the
  stable sort's on negatives, -0.0 beside 0.0, INF (3.4e38), tie pools
  and rows of one value. ``ksort_plan`` picks the warp tier up to 512
  values a row and the block tiers past it.
* ``decode_attention.split_plan``: every key of [0, T) in exactly one
  chunk, at most ``MAX_SPLIT`` chunks per (b, h), the shared
  memory within an H100's 227 KB and equal to ``smem_bytes``, a copy
  mode each address and row width allows; merging the chunks' softmax
  states in rank order gives the plain version's result.
* ``dist_l.dist_l_plan``: a thread a row, blocks of whole warps that
  cover every row once, narrower where that gives more SMs a block.
* The pca expand's staging (``fused_filter.stage_layout``) and
  ``fused_filter_plan``: the shared-memory row stride each picks keeps
  the 32 lanes' reads of a column in distinct banks wherever the row is
  a whole number of words (at most two-way conflicts for a bf16 row of
  odd width), and the copies need only the alignment they are given."""
import numpy as np
import pytest
import torch

from repro_torch.constants import INF
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import dist_l as dlk
from repro_torch.kernels import fused_filter as ff
from repro_torch.kernels import ksort_l as ks
from repro_torch.kernels import ref
from repro_torch.kernels.merge_sorted import staged_plan

OPTIN = 232_448           # an H100's opt-in shared memory a block


def _row(case, M, rng):
    if case == "normal":
        return 3.0 * rng.standard_normal(M)
    if case == "negatives":
        return -np.abs(rng.standard_normal(M)) * 1e3
    if case == "signed zeros":
        return rng.choice(np.asarray([-0.0, 0.0, 1.0, -1.0]), M)
    if case == "inf":
        return np.full(M, INF)
    if case == "tie pool":
        return rng.choice(np.asarray([0.0, 1.0, 1.0, 2.0]), M)
    if case == "one value":
        return np.full(M, -2.5)
    if case == "negative zero":
        return np.full(M, -0.0)
    # extremes: the largest and smallest magnitudes of both signs, INF
    return rng.choice(np.asarray([-INF, INF, -1e-45, 1e-45, -0.0, 0.0,
                                  -1.0, 1.0]), M)


@pytest.mark.parametrize("M", [1, 7, 32, 40, 240, 513])
@pytest.mark.parametrize("case", ["normal", "negatives", "signed zeros",
                                  "inf", "tie pool", "one value",
                                  "negative zero", "extremes"])
def test_sort_keys_order_is_the_stable_sort(case, M):
    rng = np.random.default_rng(M)
    d = torch.tensor(np.stack([_row(case, M, rng) for _ in range(3)]),
                     dtype=torch.float32)
    keys = ks.sort_keys(d)
    assert keys.dtype == torch.int64
    assert all(len(set(r.tolist())) == M for r in keys)  # unique
    order = torch.argsort(keys, dim=1)
    vals, idx = torch.sort(d, dim=1, stable=True)
    assert torch.equal(order, idx)
    # the index sits in the low word; the value is read back by index,
    # so a -0.0 keeps its sign bit
    assert torch.equal(keys & 0xFFFFFFFF,
                       torch.arange(M).expand(3, M).to(torch.int64))
    back = torch.gather(d, 1, order)
    assert torch.equal(back.view(torch.int32), vals.view(torch.int32))


def test_sort_keys_fold_negative_zero():
    """-0.0 and 0.0 get one orderable word, so they tie and fall to the
    index, as the float compare does."""
    keys = ks.sort_keys(torch.tensor([[-0.0, 0.0, -0.0, 1.0, -1.0]]))
    hi = keys >> 32
    assert hi[0, 0] == hi[0, 1] == hi[0, 2]
    assert hi[0, 4] < hi[0, 0] < hi[0, 3]


@pytest.mark.parametrize("M,run", [(1, 1), (32, 1), (40, 2), (120, 4),
                                   (240, 8), (256, 8), (257, 16),
                                   (512, 16)])
def test_ksort_plan_warp_tier(M, run):
    plan = ks.ksort_plan(M, OPTIN)
    assert plan["tier"] == "warp" and not plan["staged"]
    assert plan["run"] == run and 32 * run >= M
    assert run == 1 or 16 * run < M       # the smallest power of two
    assert plan["smem"] == 0
    assert plan["rows_per_block"] == ks.ROWS_PER_BLOCK
    assert plan["threads"] == 32 * ks.ROWS_PER_BLOCK <= 1024


@pytest.mark.parametrize("M,tier", [(513, "shared"), (12288, "shared"),
                                    (12289, "shared_optin")])
def test_ksort_plan_block_tiers_past_512(M, tier):
    plan = ks.ksort_plan(M, OPTIN)
    assert plan["tier"] == tier
    assert {k: plan[k] for k in staged_plan(M, OPTIN)} == \
        staged_plan(M, OPTIN)
    assert plan["rows_per_block"] == 1


# (b*h, T, d, itemsize): the bench, starcoder2-3b's decode, the smoke's
# and the CUDA tests' edge shapes
SHAPES = [(4, 4096, 64, 2), (192, 16384, 128, 2)] + [
    (bh, T, d, size) for bh in (1, 12) for T in (1, 100, 257, 4096 + 7)
    for d in (30, 40, 64, 128, 256) for size in (2, 4)]


@pytest.mark.parametrize("bh,T,d,itemsize", SHAPES)
def test_decode_split_plan_invariants(bh, T, d, itemsize):
    p = da.split_plan(bh, T, d, itemsize)
    chunk, n, tile, stages = (p["chunk"], p["n_split"], p["tile"],
                              p["stages"])
    # every key of [0, T) in exactly one chunk, and no chunk empty
    owner = np.full(T, -1)
    for s in range(n):
        span = slice(s * chunk, min((s + 1) * chunk, T))
        assert (owner[span] == -1).all() and span.start < T
        owner[span] = s
    assert (owner >= 0).all()
    assert 1 <= n <= da.MAX_SPLIT
    # each warp takes a whole number of steps of 32 / G keys
    E, G = da.lanes(d, itemsize)
    assert (E, G) == (p["per_lane"], p["lanes_per_key"])
    assert G * E >= d and 4 <= G <= 32 and E * itemsize >= 16
    assert tile == da.WARPS * da.STEPS * (32 // G) and chunk % tile == 0
    # every tile of a short chunk in flight at once, else a ring that
    # fits the budget
    assert 1 <= stages <= min(-(-chunk // tile), da.MAX_STAGES)
    assert stages == 1 or stages * 2 * tile * d * itemsize <= da.STAGE_BUDGET
    assert p["smem"] == da.smem_bytes(d, itemsize, tile, stages) <= OPTIN
    assert p["copy"] == da.copy_mode(d, itemsize, 16)


def test_decode_plan_at_the_bench_and_starcoder2_3b():
    """The bench's 4 (b, h) rows split 32 ways, one 128-key tile a block;
    starcoder2-3b's 192 rows split 6 ways, each chunk streaming through
    the ring."""
    p = da.split_plan(4, 4096, 64, 2, sms=132)
    assert (p["chunk"], p["n_split"], p["tile"], p["stages"], p["copy"]) \
        == (128, 32, 128, 1, "bulk")
    states = 4 * (da.WARPS + 1) * 66                 # m, l, acc[64]
    assert p["smem"] == 2 * 128 * 64 * 2 + 16 + -(-states // 16) * 16
    p = da.split_plan(192, 16384, 128, 2, sms=132)
    assert (p["n_split"], p["tile"], p["stages"]) == (6, 64,
                                                      da.RING_STAGES)
    assert p["chunk"] // p["tile"] > p["stages"]


@pytest.mark.parametrize("d,itemsize,align,mode", [
    (64, 2, 16, "bulk"), (128, 2, 16, "bulk"), (40, 4, 16, "bulk"),
    (64, 2, 8, "cp.async"), (64, 4, 4, "cp.async"), (30, 2, 16, "cp.async"),
    (30, 4, 16, "cp.async"), (40, 2, 16, "bulk"), (33, 2, 16, "ld"),
    (64, 2, 2, "ld"), (1, 4, 16, "cp.async"), (1, 2, 16, "ld")])
def test_decode_copy_mode(d, itemsize, align, mode):
    """A TMA bulk copy needs 16-byte aligned addresses and sizes: rows of
    a multiple of 16 bytes on caches aligned to 16. Else 4-byte cp.async
    where rows and caches allow 4 bytes, else plain loads."""
    assert da.copy_mode(d, itemsize, align) == mode


def test_decode_align_reads_both_caches():
    k = torch.zeros(64, dtype=torch.bfloat16)
    v = torch.zeros(64, dtype=torch.bfloat16)
    a = da._align(k, v)
    assert a in (1, 2, 4, 8, 16) and (k.data_ptr() | v.data_ptr()) % a == 0
    assert da._align(k[1:], v) <= 2


def _chunked_decode(q, k, v, length, plan):
    """The kernel's arithmetic in plain PyTorch on the plan's chunks: a
    softmax state (m, l, acc) per chunk of each (b, h), merged in rank
    order (the kernel merges in a fixed order of its own)."""
    B, H, T, d = k.shape
    out = torch.zeros(B, H, d)
    for b in range(B):
        n_valid = min(max(int(length[b]), 0), T)
        for h in range(H):
            states = []
            for s in range(plan["n_split"]):
                t0 = s * plan["chunk"]
                t1 = min(t0 + plan["chunk"], n_valid)
                if t1 <= t0:
                    states.append((-1e30, 0.0, torch.zeros(d)))
                    continue
                lg = (k[b, h, t0:t1] @ q[b, h]) * d ** -0.5
                m = float(lg.max())
                p = torch.exp(lg - m)
                states.append((m, float(p.sum()), p @ v[b, h, t0:t1]))
            gm = max(m for m, _, _ in states)
            gl = sum(l * np.exp(m - gm) for m, l, _ in states)
            acc = sum(a * float(np.exp(m - gm)) for m, _, a in states)
            out[b, h] = acc / max(gl, 1e-30)
    return out


@pytest.mark.parametrize("T,d,lengths", [(300, 64, [0, 150, 300]),
                                         (1000, 40, [999, 1, 1007]),
                                         (5000, 32, [5000, 4096])])
def test_decode_chunks_merge_to_the_plain_version(T, d, lengths):
    rng = np.random.default_rng(T)
    B, H = len(lengths), 2
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
               for s in ((B, H, d), (B, H, T, d), (B, H, T, d)))
    ln = torch.tensor(lengths, dtype=torch.int32)
    plan = da.split_plan(B * H, T, d, 4)
    assert plan["n_split"] > 1
    got = _chunked_decode(q, k, v, ln, plan)
    want = ref.decode_attention_ref(q, k, v, ln)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bool((got[ln <= 0] == 0).all())


# ------------------------- dist_l's launch -----------------------------------

SMS = 132                  # an H100 SXM's SMs


@pytest.mark.parametrize("rows", [1, 31, 1024, 2048, 4223, 16896, 61440,
                                  1023 * 128, 10 ** 7])
def test_dist_l_plan_covers_the_rows(rows):
    """A thread a row: the grid covers every row once, blocks of whole
    warps, 64 to 128 threads, narrower than 128 only while that gives
    more SMs a block."""
    lo, hi = dlk.THREADS
    plan = dlk.dist_l_plan(rows, SMS)
    t = plan["threads"]
    assert t % 32 == 0 and lo <= t <= hi
    assert plan["grid"] == -(-rows // t) and (plan["grid"] - 1) * t < rows
    if t < hi:
        assert -(-rows // (t + 32)) < SMS


def test_dist_l_plan_at_the_main_path():
    """The cascade's promote pool [1024, 60, 15]: 480 blocks of 128; the
    deferred entry score [1024, 1, 15] and the footprint's [64, 32, 15]:
    two warps a block, 16 and 32 blocks."""
    assert dlk.dist_l_plan(1024 * 60, SMS) == {"threads": 128, "grid": 480}
    assert dlk.dist_l_plan(1024, SMS) == {"threads": 64, "grid": 16}
    assert dlk.dist_l_plan(64 * 32, SMS) == {"threads": 64, "grid": 32}


# --------------------- the pca expand's staging, fused_filter ----------------

def _bank_ways(rw: int, itemsize: int, dl: int) -> int:
    """The most distinct 4-byte words one bank serves when lanes l =
    0..31 read element c of rows l at a stride of rw elements, over c."""
    worst = 1
    for c in range(dl):
        words = {(l * rw + c) * itemsize // 4 for l in range(32)}
        per_bank = {}
        for w in words:
            per_bank.setdefault(w % 32, set()).add(w)
        worst = max(worst, max(len(v) for v in per_bank.values()))
    return worst


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("dl", [1, 2, 3, 4, 8, 15, 16, 18, 30, 32, 128])
def test_stage_layout_keeps_the_lanes_apart(dl, itemsize):
    """16-byte copies of the dense block where every block is aligned,
    4-byte copies of word rows at a padded stride, or none; whatever is
    picked, a row that is a whole number of words is read by the 32 lanes
    from 32 distinct banks, a bf16 row of odd width with at most two-way
    conflicts."""
    M0 = 32
    for aligned, word_aligned in ((True, True), (False, True),
                                  (False, False)):
        copy, rw = ff.stage_layout(M0, dl, itemsize, aligned, word_aligned)
        rb = dl * itemsize
        if copy == 0:
            assert rb % 4 != 0 or not word_aligned
            assert not aligned or (M0 * rb) % 16 != 0
            continue
        assert rw >= dl
        if copy == 16:
            assert aligned and rw == dl and (M0 * rb) % 16 == 0
        else:
            assert copy == 4 and rb % 4 == 0 and word_aligned
            assert (rw * itemsize) % 4 == 0
        assert _bank_ways(rw, itemsize, dl) <= (1 if rb % 4 == 0 else 2)
    # f32 keeps the rule it had: 16-byte copies at odd dl, else dl | 1
    if itemsize == 4:
        assert ff.stage_layout(M0, dl, 4, True) == \
            ((16, dl) if dl % 2 else (4, dl | 1))


def test_filter_plan_bf16_at_the_main_path():
    """The bf16 pca expand at W = 1, M0 = 32, dl = 15: the 960-byte
    blocks by 16-byte copies, dense, a warp's area half the f32 one's; a
    table off 16-byte alignment is read in place; dl = 16 takes 4-byte
    copies at the stride 18 (nine words)."""
    plan = ff.filter_plan(1, 32, 15, True, OPTIN, 2)
    assert plan["staged"] and (plan["copy"], plan["rw"]) == (16, 15)
    assert ff.stage_words(1, 32, 15, 15, 2) == 16 + 240
    assert plan["smem"] == 4 * 4 * (16 + 240)
    off = ff.filter_plan(1, 32, 15, False, OPTIN, 2, False)
    assert not off["staged"] and off["smem"] == 0
    even = ff.filter_plan(1, 32, 16, True, OPTIN, 2)
    assert (even["copy"], even["rw"]) == (4, 18)


@pytest.mark.parametrize("M,dl,aligned,vec", [
    (32, 15, True, 1), (32, 15, False, 0), (33, 15, True, 0),
    (33, 16, True, 1), (100, 7, True, 1), (128, 32, True, 1)])
def test_fused_filter_plan_stages_the_warp_tier(M, dl, aligned, vec):
    """Up to 128 slots the staged warp tier: f32 rows at the odd stride dl
    | 1 in four warps' slices; chunk loads (``vec``) where every row's
    block starts on a four-element boundary; past 128 slots, or where the
    slices pass the card's limit, the tiers read in place."""
    plan = ff.fused_filter_plan(M, dl, aligned, OPTIN)
    assert plan["staged"] and plan["tier"] == "warp"
    assert plan["rw"] == dl | 1 and plan["vec"] == vec
    assert plan["smem"] == 4 * ff.WARPS_PER_BLOCK * (
        -(-dl // 4) * 4 + -(-M * (dl | 1) // 4) * 4)
    assert plan["per_lane"] == ff.expand_plan(M, OPTIN)["per_lane"]
    assert _bank_ways(plan["rw"], 4, dl) == 1
    wide = ff.fused_filter_plan(160, dl, aligned, OPTIN)
    assert wide["tier"] == "block" and not wide["staged"]
    big = ff.fused_filter_plan(128, 512, aligned, OPTIN)
    assert big["tier"] == "warp" and not big["staged"]
