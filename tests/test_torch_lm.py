"""The port's LM serving path (``repro_torch.models``, ``serve.engine``,
``data.tokens``, ``launch.serve``) against the JAX package on the CPU.

Each case carries the reference's parameters across with
``from_reference`` and feeds both packages the same numpy inputs. On CPU
tensors the port's attention runs the plain versions of the flash and
decode kernels (B8, B9), which take grouped-query attention as the
kernels do. Tolerances: f32 logits and caches to rtol = atol = 1e-4 (the
same arithmetic, summed in another order: measured ~3e-6); bf16 as
stated at its case. Greedy tokens must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import cell_supported as j_cell_supported
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import RetrievalConfig as JRetrieval
from repro.configs.base import SHAPES as J_SHAPES
from repro.data.tokens import batch_extras_for as j_extras
from repro.data.tokens import synthetic_batch as j_synthetic_batch
from repro.kernels import ref as jref
from repro.models import get_model as j_get_model
from repro.models.common import count_params as j_count_params
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.engine import _pad_cache_seq as j_pad_cache_seq
from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RetrievalConfig
from repro_torch.data.tokens import batch_extras_for, synthetic_batch
from repro_torch.kernels import ops, ref
from repro_torch.models import (attention, from_reference, get_model,
                                to_reference)
from repro_torch.models.common import count_params
from repro_torch.models.retrieval_attention import (
    retrieval_cache_len, retrieval_decode_attention)
from repro_torch.serve.engine import GenerationEngine, cache_len, low_keys

TOL = 1e-4
KEY = jax.random.key(0)
B, S, STEPS = 2, 16, 3
ARCHS = ["starcoder2-3b", "llama3-405b", "internvl2-76b"]
# the smoke RetrievalConfig (configs/base.py smoke_config): partial
# coverage, 1 of 2 blocks kept in each of 2 partitions at T = 32
SMOKE_RETRIEVAL = dict(enabled=True, d_low=4, topk=8, block=8, partitions=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 run puts several workers on the host's cores: one torch
    thread each keeps the plain CPU kernels from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.vis_tokens:
        batch["patches"] = rng.standard_normal(
            (b, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _jcache(c):
    """The reference's cache [L, B, T, KV, Hd] in the port's layout [L,
    B, KV, T, Hd]."""
    return np.asarray(c, np.float32).transpose(0, 1, 3, 2, 4)


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _reference_run(jcfg, params, batch, steps=STEPS, cache_len=None):
    """The reference's prefill, then ``steps`` greedy decode steps in a
    cache padded as its engine pads it: (prefill logits, prefill cache,
    [step logits], final cache, [fed tokens])."""
    api = j_get_model(jcfg)
    lg, cache0 = jax.jit(api.prefill)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    S_tot = batch["tokens"].shape[1] + jcfg.vis_tokens
    cache = j_pad_cache_seq(jcfg, params, cache0,
                            cache_len or S_tot + steps)
    step = jax.jit(api.decode_step)
    tok = np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)
    logits, toks = [], []
    for i in range(steps):
        toks.append(tok)
        out, cache = step(params, cache, jnp.asarray(tok),
                          jnp.int32(S_tot + i))
        logits.append(np.asarray(out))
        tok = np.asarray(jnp.argmax(out, -1))[:, None].astype(np.int32)
    return np.asarray(lg), _np(cache0), logits, _np(cache), toks


# cache leaves whose sequence axis the port moves: the reference's [..., B,
# T, KV, X] is the port's [..., B, KV, T, X]
_SEQ_LEAVES = ("k", "v", "k_sc", "v_sc", "k_low")


def cache_as_reference(tree):
    """A port cache (nested dicts of tensors) as numpy in the reference's
    layout."""
    return {k: cache_as_reference(v) if isinstance(v, dict) else
            (v.float().numpy().swapaxes(-3, -2) if k in _SEQ_LEAVES
             else v.float().numpy())
            for k, v in tree.items()}


def close_trees(got, want, tol=TOL):
    """Every leaf of the port's cache (``cache_as_reference``) within
    ``tol`` of the reference's, the same keys."""
    assert set(got) == set(want)
    for k in got:
        if isinstance(got[k], dict):
            close_trees(got[k], want[k], tol)
        else:
            _close(got[k], want[k], tol)


def engine_run(jcfg, params, batch, steps=4):
    """The reference engine's greedy ``generate`` of ``steps`` tokens,
    then its own jitted prefill and decode step replayed (no new
    compile): (its tokens, prefill logits, prefill cache, each step's
    logits, the final cache, the tokens fed), the cache padded as the
    engine pads it."""
    eng = JEngine(jcfg, params, max_new=steps)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tokens = eng.generate(jb).tokens
    lg, cache0 = eng._prefill(params, jb)
    S_tot = batch["tokens"].shape[1] + jcfg.vis_tokens
    cache = cache0
    if jcfg.family in ("dense", "moe", "vlm", "encdec"):
        total = S_tot + steps
        cache = j_pad_cache_seq(jcfg, params, cache0, min(
            total, jcfg.window) if jcfg.window else total)
    tok = np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)
    logits, toks = [], []
    for i in range(steps):
        toks.append(tok)
        out, cache = eng._step(params, cache, jnp.asarray(tok),
                               jnp.int32(S_tot + i))
        logits.append(np.asarray(out))
        tok = np.asarray(jnp.argmax(out, -1))[:, None].astype(np.int32)
    return tokens, np.asarray(lg), _np(cache0), logits, _np(cache), toks


def check_family_against_reference(jcfg, tcfg, params, batch, run,
                                   steps=4):
    """``from_reference``, then the port's prefill logits and cache, each
    decode step's logits and the final cache within ``TOL`` of the
    reference's engine-padded run (``engine_run``), and
    ``GenerationEngine``'s greedy tokens equal to the reference
    engine's. Returns the port's model."""
    tokens, lg, cache0, logits, cache, toks = run
    model = from_reference(tcfg, _np(params), "cpu")
    api = get_model(tcfg)
    S_tot = batch["tokens"].shape[1] + tcfg.vis_tokens
    got, tc = api.prefill(model, batch)
    assert got.dtype == torch.float32 and got.shape == lg.shape
    _close(got, lg)
    close_trees(cache_as_reference(tc), cache0)
    _, tc = api.prefill(model, batch, cache_len(tcfg, S_tot - tcfg.vis_tokens,
                                                steps))
    for i, tok in enumerate(toks):
        got, tc = api.decode_step(model, tc, torch.from_numpy(tok),
                                  S_tot + i)
        _close(got, logits[i])
    close_trees(cache_as_reference(tc), cache)
    res = GenerationEngine(tcfg, model, max_new=steps,
                           device="cpu").generate(batch)
    np.testing.assert_array_equal(res.tokens, tokens)
    np.testing.assert_array_equal(res.tokens, np.concatenate(toks, 1))
    return model


@pytest.fixture(scope="module", params=ARCHS)
def arch_case(request):
    """One smoke config (f32) in both packages, the reference's
    parameters and its prefill and decode results."""
    arch = request.param
    jcfg = j_smoke(arch)
    params = j_get_model(jcfg).init(KEY)
    batch = _batch(jcfg)
    return (arch, jcfg, get_smoke_config(arch), params, batch,
            _reference_run(jcfg, params, batch))


# ------------------------------- configs -----------------------------------

def test_configs_equal_reference():
    """Every arch's full and smoke config holds the reference's fields,
    parameter counts and cell classes."""
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for arch in ARCH_IDS:
        for mine, theirs in ((get_config(arch), j_get_config(arch)),
                             (get_smoke_config(arch), j_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            assert mine.n_params() == theirs.n_params()
            assert mine.n_active_params() == theirs.n_active_params()
            assert mine.resolved_head_dim == theirs.resolved_head_dim
            for shape in SHAPES.values():
                assert cell_supported(mine, shape) == j_cell_supported(
                    theirs, J_SHAPES[shape.name])
    assert get_config("starcoder2-3b").n_params() == 3_180_331_008


# --------------------------- carrying weights ------------------------------

def _expected_leaf(mod, path):
    """The port tensor below module ``mod`` that should hold reference
    leaf ``path``, as the reference's array."""
    names = {"bq": ("wq", "bias"), "bk": ("wk", "bias"), "bv": ("wv", "bias"),
             "b_up": ("w_up", "bias"), "b_down": ("w_down", "bias")}
    for p in path[:-1]:
        mod = getattr(mod, p)
    leaf = path[-1]
    if leaf in names:
        return getattr(getattr(mod, names[leaf][0]), names[leaf][1])
    t = getattr(mod, leaf)
    return t.weight.T if isinstance(t, torch.nn.Linear) else t


# the reference's stacked blocks (axis 0), one port module each
STACKS = ("layers", "enc_layers_p", "groups", "trail")


def check_carries_every_leaf(model, params) -> None:
    """Every leaf of the reference's tree (numpy) is bit for bit the port
    parameter it names (block i of a stacked leaf in the port's module
    list), with its dtype, and every port parameter holds one."""
    assert count_params(model) == j_count_params(params)
    n = 0
    for path, a in _leaves(params):
        stacked = path[0] in STACKS
        for i in (range(a.shape[0]) if stacked else [None]):
            got = _expected_leaf(getattr(model, path[0])[i], path[1:]) \
                if stacked else _expected_leaf(model, path)
            want = a[i] if stacked else a
            assert str(got.dtype).endswith(str(want.dtype)), path
            assert np.array_equal(got.float().numpy(),
                                  want.astype(np.float32)), path
            n += 1
    assert n == len(list(model.parameters()))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


@pytest.mark.parametrize("arch,dtype", [("starcoder2-3b", "float32"),
                                        ("internvl2-76b", "float32"),
                                        ("starcoder2-3b", "bfloat16")])
def test_from_reference_carries_every_leaf(arch, dtype):
    """Every leaf of the reference's tree lands bit for bit on the port
    parameter it names (matrices transposed to ``nn.Linear``'s layout,
    bf16 exactly, norms f32), the counts agree, and a tree with a leaf
    missing or one too many is refused."""
    jcfg = j_smoke(arch).replace(
        dtype=dtype, retrieval=JRetrieval(**SMOKE_RETRIEVAL))
    tcfg = get_smoke_config(arch).replace(
        dtype=dtype, retrieval=RetrievalConfig(**SMOKE_RETRIEVAL))
    params = _np(j_get_model(jcfg).init(KEY))
    model = from_reference(tcfg, params, "cpu")
    check_carries_every_leaf(model, params)
    if dtype == "bfloat16":
        assert model.layers[0].ln_attn.scale.dtype == torch.float32
        assert model.layers[0].attn.wq.weight.dtype == torch.bfloat16
    short = dict(params)
    del short["ln_f"]
    with pytest.raises(ValueError, match="no reference leaf"):
        from_reference(tcfg, short, "cpu")
    extra = dict(params, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stray"):
        from_reference(tcfg, extra, "cpu")


def ref_params(jcfg, tcfg, seed=0):
    """Parameters for both packages without the reference's init, whose
    eager ops take seconds to compile: the port's seeded init laid out
    as the reference's tree by ``models.to_reference``, checked leaf by
    leaf against the tree's paths, shapes and dtypes from
    ``jax.eval_shape`` of the reference's ``init`` (which compiles
    nothing), as numpy arrays (bf16 as ``ml_dtypes.bfloat16``)."""
    model = get_model(tcfg).init(torch.Generator().manual_seed(seed), "cpu")
    tree = jax.eval_shape(j_get_model(jcfg).init, KEY)

    def walk(node, mine, path=()):
        assert set(node) == set(mine), path
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, mine[k], path + (k,))
                continue
            a = mine[k]
            assert a.shape == v.shape, path + (k,)
            if a.dtype.kind == "V":          # bf16 bits
                a = a.view(ml_dtypes.bfloat16)
            assert a.dtype == v.dtype, path + (k,)
            out[k] = a
        return out
    return walk(tree, to_reference(tcfg, model))


# ---------------------------- prefill / decode -----------------------------

def test_prefill_matches_reference(arch_case):
    """Last-token logits and the cache of exactly the prompt (vlm: after
    the patch tokens): gelu / layernorm / qkv bias (starcoder2),
    swiglu / rmsnorm (llama3), vlm (internvl2)."""
    arch, jcfg, tcfg, params, batch, (lg, cache, *_) = arch_case
    model = from_reference(tcfg, _np(params), "cpu")
    got, tc = get_model(tcfg).prefill(model, batch)
    assert got.dtype == torch.float32 and got.shape == (B, tcfg.vocab)
    _close(got, lg)
    assert set(tc) == {"k", "v"}
    assert tc["k"].shape[3] == S + tcfg.vis_tokens
    _close(tc["k"], _jcache(cache["k"]))
    _close(tc["v"], _jcache(cache["v"]))


def test_decode_steps_match_reference(arch_case):
    """Greedy decode steps in a preallocated cache: each step's logits
    and the final cache equal the reference's ``decode_step`` in its
    padded cache."""
    arch, jcfg, tcfg, params, batch, (_, _, logits, cache, toks) = arch_case
    model = from_reference(tcfg, _np(params), "cpu")
    api = get_model(tcfg)
    S_tot = S + tcfg.vis_tokens
    _, tc = api.prefill(model, batch, S_tot + STEPS)
    for i, tok in enumerate(toks):
        got, tc = api.decode_step(model, tc, torch.from_numpy(tok),
                                  S_tot + i)
        _close(got, logits[i])
    _close(tc["k"], _jcache(cache["k"]))
    _close(tc["v"], _jcache(cache["v"]))


def test_decode_position_as_tensor_and_past_the_cache():
    """``pos`` as a tensor gives the int's result; past the cache's end
    the reference writes slot T - 1 and attends to every slot, as the
    port does (length pos + 1 clamps to T)."""
    jcfg, tcfg = j_smoke("llama3-405b"), get_smoke_config("llama3-405b")
    params = j_get_model(jcfg).init(KEY)
    model = from_reference(tcfg, _np(params), "cpu")
    api, japi = get_model(tcfg), j_get_model(jcfg)
    tok = _batch(jcfg, seed=4, s=1)["tokens"]
    T = 6
    jc, tc = japi.init_cache(B, T), api.init_cache(B, T, "cpu")
    step = jax.jit(japi.decode_step)
    for pos in (0, 1, T + 2):
        want, jc = step(params, jc, jnp.asarray(tok), jnp.int32(pos))
        got, tc = api.decode_step(model, tc, torch.from_numpy(tok),
                                  torch.tensor(pos))
        _close(got, want)
    _close(tc["k"], _jcache(jc["k"]))


def test_engine_greedy_tokens_equal_reference():
    """``GenerationEngine`` (B=2, S=16, max_new 4) gives the reference
    engine's greedy tokens."""
    jcfg, tcfg = j_smoke("starcoder2-3b"), get_smoke_config("starcoder2-3b")
    params = j_get_model(jcfg).init(KEY)
    batch = _batch(jcfg, seed=5)
    want = JEngine(jcfg, params, max_new=4).generate(
        {k: jnp.asarray(v) for k, v in batch.items()})
    eng = GenerationEngine(tcfg, from_reference(tcfg, _np(params), "cpu"),
                           max_new=4, device="cpu")
    got = eng.generate(batch)
    assert got.tokens.dtype == np.int32 and got.steps == 4
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert np.isfinite(got.last_logits).all()
    # temperature sampling: seeded, reproducible, in the vocabulary
    hot = [GenerationEngine(tcfg, eng.model, max_new=4, temperature=1.0,
                            seed=3, device="cpu").generate(batch).tokens
           for _ in range(2)]
    np.testing.assert_array_equal(hot[0], hot[1])
    assert ((hot[0] >= 0) & (hot[0] < tcfg.vocab)).all()
    with pytest.raises(ValueError, match="not on cuda"):
        GenerationEngine(tcfg, eng.model)


# bf16: both packages round every matrix product, norm output and
# activation to bf16 (8 significant bits, ulp 2^-8 relative), but at other
# places (XLA's CPU dot against ATen's, gelu's internal precision), so
# the logits (RMS ~1 here) differ by a few bf16 ulps after two layers
# (measured: at most 0.026).
BF16_TOL = 0.06


def test_bf16_prefill_and_decode_match_reference():
    """starcoder2's smoke config in bf16 (norms f32): the prefill and
    two decode steps' logits at ``BF16_TOL``, and the greedy tokens."""
    jcfg = j_smoke("starcoder2-3b").replace(dtype="bfloat16")
    tcfg = get_smoke_config("starcoder2-3b").replace(dtype="bfloat16")
    params = j_get_model(jcfg).init(KEY)
    batch = _batch(jcfg, seed=6)
    lg, _, logits, cache, toks = _reference_run(jcfg, params, batch,
                                                steps=2)
    model = from_reference(tcfg, _np(params), "cpu")
    api = get_model(tcfg)
    got, tc = api.prefill(model, batch, S + 2)
    assert tc["k"].dtype == torch.bfloat16
    _close(got, lg, BF16_TOL)
    np.testing.assert_array_equal(got.argmax(-1)[:, None].numpy(), toks[0])
    for i, tok in enumerate(toks):
        got, tc = api.decode_step(model, tc, torch.from_numpy(tok), S + i)
        _close(got, logits[i], BF16_TOL)


# ------------------------------- retrieval ---------------------------------

def test_retrieval_decode_matches_reference():
    """The pHNSW retrieval decode at the smoke ``RetrievalConfig``
    (partial coverage: 1 block of 8 kept of 2 in each of 2 partitions at
    T = 32): the engine's low-dim keys, four steps' logits and the greedy
    tokens equal the reference's. Only outputs are compared: blocks past
    ``pos`` tie, and ``torch.topk`` may keep other tied blocks than
    ``lax.top_k``."""
    jcfg = j_smoke("llama3-405b").replace(
        retrieval=JRetrieval(**SMOKE_RETRIEVAL))
    tcfg = get_smoke_config("llama3-405b").replace(
        retrieval=RetrievalConfig(**SMOKE_RETRIEVAL))
    params = j_get_model(jcfg).init(KEY)
    batch = _batch(jcfg, seed=7, s=28)
    T = 32
    assert retrieval_cache_len(tcfg, T) == T
    _, _, logits, cache, toks = _reference_run(jcfg, params, batch, steps=4,
                                               cache_len=T)
    model = from_reference(tcfg, _np(params), "cpu")
    api = get_model(tcfg)
    _, tc = api.prefill(model, batch, T)
    tc = low_keys(model, tc)
    for i, tok in enumerate(toks):
        if i == 0:
            _close(tc["k_low"], _jcache(j_pad_cache_seq(
                jcfg, params, j_get_model(jcfg).prefill(
                    params, {"tokens": jnp.asarray(batch["tokens"])})[1],
                T)["k_low"]))
        got, tc = api.decode_step(model, tc, torch.from_numpy(tok), 28 + i)
        _close(got, logits[i])
    _close(tc["k_low"], _jcache(cache["k_low"]))
    want = JEngine(jcfg, params, max_new=4).generate(
        {"tokens": jnp.asarray(batch["tokens"])})
    got = GenerationEngine(tcfg, model, max_new=4, device="cpu").generate(
        batch)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_retrieval_full_coverage_equals_dense():
    """tests/test_models.py::test_retrieval_attention_full_coverage_exact
    in the port: with every block kept and d_low == head_dim, retrieval
    decode equals dense decode (B9's plain version)."""
    base = get_smoke_config("llama3-405b")
    T = 64
    full = base.replace(retrieval=RetrievalConfig(
        enabled=True, d_low=base.resolved_head_dim, topk=T, block=4))
    model = get_model(full).init(torch.Generator().manual_seed(0), "cpu")
    api_d, api_f = get_model(base), get_model(full)
    cd, cf = api_d.init_cache(2, T, "cpu"), api_f.init_cache(2, T, "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, base.vocab, (2, 24)))
    for t in range(24):
        lg_d, cd = api_d.decode_step(model, cd, toks[:, t:t + 1], t)
        lg_f, cf = api_f.decode_step(model, cf, toks[:, t:t + 1], t)
    _close(lg_f, lg_d.numpy(), 2e-4)


def test_retrieval_cache_len_and_refusal():
    """The engine rounds a retrieval arch's cache up to a length the
    filter can partition; any other length is refused, as the
    reference's reshape fails on it."""
    cfg = get_smoke_config("llama3-405b").replace(
        retrieval=RetrievalConfig(**SMOKE_RETRIEVAL))
    assert [retrieval_cache_len(cfg, t) for t in (1, 8, 9, 16, 17, 20, 33)] \
        == [8, 8, 16, 16, 32, 32, 48]
    big = RetrievalConfig(enabled=True, d_low=16, topk=2048, block=128,
                          partitions=16)
    assert retrieval_cache_len(cfg.replace(retrieval=big), 8208) == 10240
    p = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu") \
        .layers[0].attn
    kv = torch.zeros(1, 1, 20, 16)
    with pytest.raises(ValueError, match="32 positions"):
        retrieval_decode_attention(cfg, p, torch.zeros(1, 4, 16), kv, kv,
                                   torch.zeros(1, 1, 20, 4),
                                   torch.tensor([3]))


# ----------------------- every family and cache kind -----------------------

def _shapes(tree):
    """{path: (shape, dtype name)} of a cache, the port's in the
    reference's layout."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({(k,) + p: x for p, x in _shapes(v).items()})
        elif isinstance(v, torch.Tensor):
            shape = list(v.shape)
            if k in _SEQ_LEAVES:
                shape[-3], shape[-2] = shape[-2], shape[-3]
            out[(k,)] = (tuple(shape), str(v.dtype).replace("torch.", ""))
        else:
            out[(k,)] = (tuple(v.shape), str(v.dtype))
    return out


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "whisper-medium", "recurrentgemma-9b",
                                  "rwkv6-1.6b"])
def test_unported_families_refuse(arch):
    """Every family serves: ``get_model`` binds the smoke config, and
    its ``init_cache`` holds the reference's leaves with their shapes
    (the port's layout moves the sequence axis) and dtypes, zeros, below
    the window (W = 8) and past it."""
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    api = get_model(cfg)
    for T in (5, 12):
        cache = api.init_cache(2, T, "cpu")
        assert _shapes(cache) == _shapes(_np(j_get_model(jcfg).init_cache(
            2, T)))
        assert not any(t.any() for t in _leaf_tensors(cache))


def _leaf_tensors(tree):
    for v in tree.values():
        yield from (_leaf_tensors(v) if isinstance(v, dict) else (v,))


def test_unported_cache_kinds_refuse():
    """The windowed ring buffer and the int8 cache serve: their caches
    hold the reference's shapes and dtypes (T bounded by the window; int8
    values and scales in the model's dtype, bf16 too), and
    ``attn_forward`` runs its bidirectional and cross-attention forms."""
    cfg, jcfg = get_smoke_config("llama3-405b"), j_smoke("llama3-405b")
    for kw in (dict(kv_quant=True), dict(window=8),
               dict(kv_quant=True, window=8, dtype="bfloat16")):
        for T in (6, 20):
            got = get_model(cfg.replace(**kw)).init_cache(1, T, "cpu")
            want = j_get_model(jcfg.replace(**kw)).init_cache(1, T)
            assert _shapes(got) == _shapes(_np(want))
            assert attention.init_cache(cfg.replace(**kw), 1, T,
                                        torch.float32)["k"].shape[2] == \
                (min(T, 8) if "window" in kw else T)
    p = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu") \
        .layers[0].attn
    x = torch.randn(2, 5, cfg.d_model)
    pos = torch.arange(5)
    assert attention.attn_forward(cfg, p, x, pos, causal=False).shape == \
        x.shape
    y = attention.attn_forward(cfg, p, x, pos, kv_src=torch.randn(
        2, 9, cfg.d_model), causal=False)
    assert y.shape == x.shape and torch.isfinite(y).all()
    with pytest.raises(ValueError, match="window"):
        attention.attn_forward(cfg, p, x, pos, kv_src=x, window=4)


# ------------------------------ GQA kernels --------------------------------

@pytest.mark.parametrize("G", [1, 4, 12])
def test_gqa_attention_refs_match_jax_with_heads_expanded(G):
    """The plain versions of B8 and B9 take kv heads = q heads / G; each
    equals the JAX oracle fed the kv heads repeated G times (query head h
    reads kv head h // G), through ``ops`` as well. Decode rows with
    length 0 give 0 (the oracle's mean of v is not compared)."""
    rng = np.random.default_rng(G)
    KV, d, S, T = 2, 32, 40, 40
    H = KV * G
    q = rng.standard_normal((2, H, S, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, KV, T, d)).astype(np.float32)
            for _ in range(2))
    rep = lambda a: jnp.repeat(jnp.asarray(a), G, axis=1)
    want = jref.flash_attention_ref(jnp.asarray(q), rep(k), rep(v),
                                    causal=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(ref.flash_attention_ref(tq, tk, tv, causal=True), want, 2e-5)
    _close(ops.flash_attention(tq, tk, tv, causal=True), want, 2e-5)
    length = np.asarray([0, 23], np.int32)
    qd = np.ascontiguousarray(q[:, :, 0])
    want = jref.decode_attention_ref(jnp.asarray(qd), rep(k), rep(v),
                                     jnp.asarray(length))
    got = ops.decode_attention(torch.from_numpy(qd), tk, tv,
                               torch.from_numpy(length))
    assert got.shape == (2, H, d) and (got[0] == 0).all()
    _close(got[1:], np.asarray(want)[1:], 2e-5)
    with pytest.raises(ValueError, match="multiple"):
        ref.decode_attention_ref(torch.zeros(1, 3, d), tk[:1], tv[:1],
                                 torch.tensor([1]))


# ------------------------------ data / launch ------------------------------

def test_synthetic_batch_bit_equal():
    cfg = get_smoke_config("internvl2-76b")
    for step in (0, 7):
        mine = synthetic_batch(3, step, 4, 33, cfg.vocab,
                               extras=batch_extras_for(cfg))
        theirs = j_synthetic_batch(3, step, 4, 33, cfg.vocab,
                                   extras=j_extras(j_smoke("internvl2-76b")))
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(mine[k], theirs[k])


def test_serve_lm_smoke_on_cpu():
    """``python -m repro_torch.launch.serve --smoke --device cpu`` at the
    launcher's defaults (batch 4, prompt 32, 16 new), for every arch
    (whisper's frames cast to the model's dtype as the patches are)."""
    from repro_torch.launch.serve import parser, serve_lm
    for arch in ARCH_IDS:
        res = serve_lm(parser().parse_args(["--arch", arch, "--smoke",
                                            "--device", "cpu"]))
        vocab = get_smoke_config(arch).vocab
        assert res.tokens.shape == (4, 16)
        assert ((res.tokens >= 0) & (res.tokens < vocab)).all()
        assert np.isfinite(res.last_logits).all()


def test_serve_vectors_on_cpu(tmp_path):
    """``--vector`` over a few thousand points, the graph cached under
    ``--cache-dir``."""
    from repro_torch.launch.serve import parser, serve_vectors
    args = parser().parse_args(["--vector", "--n-points", "2000",
                                "--n-queries", "64", "--batch", "32",
                                "--cache-dir", str(tmp_path),
                                "--device", "cpu"])
    idx, stats = serve_vectors(args)
    assert idx.shape[0] == 64 and (idx >= 0).all() and (idx < 2000).all()
    assert stats["qps"] > 0
    assert list(tmp_path.iterdir())


def test_param_bytes_and_cast_tree():
    """``param_bytes`` counts what the reference's counts for the same
    tree (bf16 matrices, f32 norms); ``cast_tree`` casts the floating
    leaves of a nested dict (integers kept) and a module in place."""
    from repro.models.common import param_bytes as j_param_bytes
    from repro_torch.models.common import cast_tree, param_bytes
    jcfg = j_smoke("starcoder2-3b").replace(dtype="bfloat16")
    tcfg = get_smoke_config("starcoder2-3b").replace(dtype="bfloat16")
    params = _np(j_get_model(jcfg).init(KEY))
    model = from_reference(tcfg, params, "cpu")
    assert param_bytes(model) == j_param_bytes(params)
    tree = {"a": torch.ones(2), "b": [torch.arange(3), (torch.zeros(1),)]}
    out = cast_tree(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16
    assert out["b"][0].dtype == torch.int64
    assert out["b"][1][0].dtype == torch.bfloat16
    assert cast_tree(model, torch.float32) is model
    assert {p.dtype for p in model.parameters()} == {torch.float32}
