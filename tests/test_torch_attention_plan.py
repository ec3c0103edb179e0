"""The host-side plan of the bf16 flash attention kernel
(``repro_torch.kernels.flash_attention``), without a card: the split
count at the timed shapes of ``chip_smoke.py``, the kv range each query
tile runs and its split into chunks against the mask of the plain
version, and the shared memory a block asks for. This file imports no
jax."""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

# the six timed rows of chip_smoke.FLASH_CASES: (B, H, S, T, d, causal,
# window) -> whether the kernel splits the kv range
TIMED = [((1, 4, 512, 512, 64, True, 0), True),            # bench
         ((1, 24, 4096, 4096, 128, True, 0), False),       # starcoder2-3b
         ((1, 24, 512, 4096, 128, True, 0), True),         # its chunk
         ((8, 24, 1024, 1024, 128, True, 0), False),       # its LM prefill
         ((1, 32, 8192, 8192, 128, True, 4096), False),    # mixtral-8x7b
         ((1, 16, 8192, 8192, 256, True, 2048), False)]    # recurrentgemma


@pytest.mark.parametrize("shape,splits", TIMED)
def test_split_at_the_timed_shapes(shape, splits):
    n = fa.split_plan(*shape)
    assert (n > 1) == splits
    assert 1 <= n <= fa.MAX_SPLIT
    B, H, S, T, d, causal, window = shape
    most = max(fa.kv_tiles(i, S, T, causal, window, fa.BQ)[1]
               for i in range(-(-S // fa.BQ)))
    assert n <= most or n == 1


def test_split_plan_on_fewer_sms_splits_no_more():
    """A card with fewer SMs (a MIG slice) needs fewer blocks to fill:
    the plan is a pure function of the shape and the SM count."""
    shape = (1, 24, 512, 4096, 128, True, 0)
    assert fa.split_plan(*shape, sms=16) <= fa.split_plan(*shape)
    assert fa.split_plan(*shape) == fa.split_plan(*shape, sms=fa.SMS)


SHAPES = [(1, 1), (1, 300), (64, 64), (128, 128), (129, 200), (200, 100),
          (300, 70), (512, 512), (100, 1000), (77, 1000), (1000, 77)]


@pytest.mark.parametrize("bq", [fa.BQ_F32, fa.BQ])
@pytest.mark.parametrize("S,T", SHAPES)
def test_chunks_cover_each_tiles_kv_range_once(S, T, bq):
    """Every key a row of a query tile can see lies in the tile's kv range
    (``kv_tiles``), the range's tiles overlap T, and for every split count
    the chunks cover the range's tiles exactly once; causal or not, over
    windows that start mid-tile, on a tile edge or past T, at both
    kernels' block heights."""
    for causal in (True, False):
        for window in (0, 1, 30, 64, 100, 5000):
            mask = ref.attention_mask(S, T, causal, window)
            for qt in range(-(-S // bq)):
                begin, n = fa.kv_tiles(qt, S, T, causal, window, bq)
                seen = mask[qt * bq:(qt + 1) * bq].any(0).nonzero().flatten()
                if n == 0:
                    assert seen.numel() == 0
                    continue
                assert begin % fa.BK == 0 and 0 <= begin < T
                assert begin + (n - 1) * fa.BK < T
                if seen.numel():
                    assert int(seen.min()) >= begin
                    assert int(seen.max()) < begin + n * fa.BK
                for n_split in (1, 2, 3, 7, fa.MAX_SPLIT):
                    covered = []
                    for c in range(n_split):
                        lo, hi = fa.chunk_tiles(n, n_split, c)
                        assert 0 <= lo <= hi <= n
                        covered += range(lo, hi)
                    assert covered == list(range(n))


def test_blind_tiles_have_no_kv_range():
    """Causal with S > T: a query tile whose rows all sit before position
    0 runs no kv tile, so each of its chunks leaves an empty partial."""
    S, T = 600, 100
    for bq in (64, 128):
        assert fa.kv_tiles(0, S, T, True, 0, bq) == (0, 0)
        assert fa.kv_tiles(-(-S // bq) - 1, S, T, True, 0, bq)[1] > 0


def test_shared_memory_fits_a_block():
    """Both kernels stay within the 227 KB (232,448 B) a block may ask
    for, at every head dim 1..256; the bf16 ring holds at least two
    stages of K and V, and the bf16 blocks an SM is meant to hold fit
    together."""
    for d in range(1, 257):
        assert fa.stages(d) >= 2
        for dtype in (torch.bfloat16, torch.float32):
            assert 0 < fa.smem_bytes(d, dtype) <= 232_448
        dp = fa.padded_dim(d)
        assert dp >= d and dp % 16 == 0
        assert fa.smem_bytes(d, torch.bfloat16) == \
            2 * dp * (fa.BQ + 2 * fa.stages(d) * fa.BK) \
            + 16 * fa.stages(d)
        # the blocks an SM holds fit its 228 KB, 1 KB reserved a block
        assert fa.blocks_per_sm(d) * (fa.smem_bytes(d, torch.bfloat16)
                                      + 1024) <= 233_472
