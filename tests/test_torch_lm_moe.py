"""The port's attention extensions (the sliding-window ring buffer, the
int8 cache, ``attn_forward``) and the moe family (``models/moe.py``;
mixtral-8x7b and qwen3-moe-235b-a22b) against the JAX package on the
CPU, at the smoke configs in f32 (one torch thread, each reference
program compiled once a module). Tolerances as in
tests/test_torch_lm.py: 1e-4 on f32 logits and caches, greedy tokens
equal, the MoE's ``dropped_frac`` and the int8 cache exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as j_attention
from repro.models import get_model as j_get_model
from repro.models.moe import _apply_moe_local as j_apply_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, from_reference, get_model, moe
from test_torch_lm import (KEY, TOL, _batch, _close,  # noqa: F401
                           _np, _one_torch_thread, cache_as_reference,
                           check_carries_every_leaf,
                           check_family_against_reference, close_trees,
                           engine_run, ref_params)

MOE_ARCHS = ["mixtral-8x7b", "qwen3-moe-235b-a22b"]


@functools.lru_cache(maxsize=None)
def _case(arch):
    """A moe smoke config in both packages, the reference's parameters,
    a batch (B=2, S=16) and the reference engine's run of 4 tokens
    (compiled once: the cases below share it)."""
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    params = ref_params(jcfg, tcfg)
    batch = _batch(jcfg, seed=11)
    return (arch, jcfg, tcfg, params, batch, engine_run(jcfg, params, batch))


@pytest.fixture(params=MOE_ARCHS)
def moe_case(request):
    return _case(request.param)


@pytest.fixture
def mixtral_case():
    """mixtral's case: the moe arch with a window (8 in the smoke)."""
    return _case("mixtral-8x7b")


def test_moe_families_match_reference(moe_case):
    """mixtral (window 8: the 16-token prompt fills the ring twice over)
    and qwen3: prefill logits and the cache, four decode steps (capacity
    2.0 against prefill's 1.25) and the final cache within 1e-4 of the
    reference engine's run; the engines' greedy tokens equal; every leaf
    carried (the router and experts untransposed)."""
    arch, jcfg, tcfg, params, batch, run = moe_case
    model = check_family_against_reference(jcfg, tcfg, params, batch, run)
    check_carries_every_leaf(model, _np(params))
    assert model.layers[0].moe.e_gate.shape == (
        tcfg.moe.n_experts, tcfg.d_model, tcfg.d_ff)
    assert not hasattr(model.layers[0], "mlp")


# ------------------------------- apply_moe ----------------------------------

@functools.lru_cache(maxsize=None)
def _j_moe(cf):
    cfg = j_smoke("mixtral-8x7b")
    return jax.jit(lambda p, x: j_apply_moe(cfg, p, x, capacity_factor=cf))


def _moe_inputs(seed, tie=False):
    jcfg, tcfg = j_smoke("mixtral-8x7b"), get_smoke_config("mixtral-8x7b")
    params = ref_params(jcfg, tcfg)["layers"]["moe"]
    params = {k: v[0] for k, v in params.items()}
    if tie:     # experts 1 and 2 route identically: every gate ties
        params["router"] = params["router"].copy()
        params["router"][:, 2] = params["router"][:, 1]
    x = np.random.default_rng(seed).standard_normal(
        (3, 8, tcfg.d_model)).astype(np.float32)
    p = moe.MoE(tcfg, None, torch.float32, "cpu").requires_grad_(False)
    with torch.no_grad():
        for k, v in params.items():
            getattr(p, k).copy_(torch.from_numpy(v.copy()))
    return tcfg, params, p, x


@pytest.mark.parametrize("cf", [100.0, 1.25, 0.5])
def test_apply_moe_matches_reference(cf):
    """``apply_moe`` against ``_apply_moe_local`` at capacity factors
    past every expert's load (nothing drops), the prefill's 1.25, and
    0.5 (a quarter and more dropped): ``dropped_frac`` equal exactly
    (the same tokens drop), ``y`` and ``aux_loss`` within 1e-5."""
    tcfg, params, p, x = _moe_inputs(3)
    want_y, want = _j_moe(cf)(params, jnp.asarray(x))
    got_y, got = moe.apply_moe(tcfg, p, torch.from_numpy(x),
                               capacity_factor=cf)
    assert got["dropped_frac"].item() == float(want["dropped_frac"])
    if cf == 100.0:
        assert got["dropped_frac"].item() == 0
    if cf == 0.5:
        assert got["dropped_frac"].item() > 0.25
    _close(got_y, want_y, 1e-5)
    _close(got["aux_loss"], want["aux_loss"], 1e-5)


def test_apply_moe_gate_ties_go_to_the_lower_expert():
    """With two experts' router columns equal every token's gates tie;
    ``lax.top_k`` keeps the lower expert, and so does the port (a
    stable descending sort, where ``torch.topk`` may not): the same
    tokens drop and the outputs agree."""
    tcfg, params, p, x = _moe_inputs(4, tie=True)
    for cf in (1.25, 0.5):
        want_y, want = _j_moe(cf)(params, jnp.asarray(x))
        got_y, got = moe.apply_moe(tcfg, p, torch.from_numpy(x),
                                   capacity_factor=cf)
        assert got["dropped_frac"].item() == float(want["dropped_frac"])
        _close(got_y, want_y, 1e-5)
    gates = torch.softmax(torch.from_numpy(x).reshape(-1, tcfg.d_model)
                          @ p.router, -1)
    assert torch.equal(gates[:, 1], gates[:, 2])
    top = torch.sort(gates, dim=-1, descending=True, stable=True).indices[:, :2]
    has1, has2 = (top == 1).any(-1), (top == 2).any(-1)
    assert (has1 | ~has2).all() and (has1 & has2).any()
    assert [moe.capacity(T, 2, 4, 1.25) for T in (1, 2, 10, 24)] == \
        [1, 2, 6, 15]
    # Python's round is half to even: 2 * 2 / 4 * 2.5 = 2.5 -> 2
    assert moe.capacity(2, 2, 4, 2.5) == 2


# ------------------------------- int8 cache ---------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal(dtype):
    """``_quantize_kv``: the int8 values and the scales (in the input's
    dtype) bit-equal to the reference's, ties of .5 included (round half
    to even); ``_dequantize_kv`` too."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 7, 3, 16)) * 3).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]      # scale 1: ties at .5
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    wq, ws = j_attention._quantize_kv(jx)
    gq, gs = attention._quantize_kv(tx)
    assert gq.dtype == torch.int8 and gs.dtype == tx.dtype
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.float().numpy(),
                                  np.asarray(ws.astype(jnp.float32)))
    np.testing.assert_array_equal(
        attention._dequantize_kv(gq, gs).float().numpy(),
        np.asarray(j_attention._dequantize_kv(wq, ws).astype(jnp.float32)))
    assert gq[0, 0, 0, :4].tolist() == [127, 0, 2, -2]


def test_int8_cache_decode_matches_reference():
    """A dense smoke config with ``kv_quant``, decoding 10 tokens from
    ``init_cache`` (the int8 cache: each step quantises its k and v,
    dequantises the cache, and B9 attends): logits within 1e-4, the int8
    values exactly and the scales within 1e-4 (``_quantize_kv`` is
    bit-equal on equal inputs; here the projections' last bits differ).
    Then the engine: the reference's
    prefill returns k and v unquantised and its decode quantises only a
    cache with scales, so a served ``kv_quant`` arch decodes in the
    model's dtype; the port's engine gives its tokens and logits."""
    jcfg = j_smoke("llama3-405b").replace(kv_quant=True)
    tcfg = get_smoke_config("llama3-405b").replace(kv_quant=True)
    params = ref_params(jcfg, tcfg)
    model = from_reference(tcfg, _np(params), "cpu")
    api, japi = get_model(tcfg), j_get_model(jcfg)
    toks = _batch(jcfg, seed=6, s=10)["tokens"]
    jc, tc = japi.init_cache(2, 12), api.init_cache(2, 12, "cpu")
    assert tc["k"].dtype == torch.int8 and set(tc) == {"k", "v", "k_sc",
                                                       "v_sc"}
    step = jax.jit(japi.decode_step)
    for t in range(10):
        tok = toks[:, t:t + 1]
        want, jc = step(params, jc, jnp.asarray(tok), jnp.int32(t))
        got, tc = api.decode_step(model, tc, torch.from_numpy(tok), t)
        _close(got, want)
    got = cache_as_reference(tc)
    for k in ("k", "v"):
        np.testing.assert_array_equal(got[k], np.asarray(jc[k]))
        _close(got[k + "_sc"], jc[k + "_sc"])
    batch = _batch(jcfg, seed=7)
    run = engine_run(jcfg, params, batch)
    assert set(run[4]) == {"k", "v"}
    check_family_against_reference(jcfg, tcfg, params, batch, run)


# ------------------------------ ring buffer ---------------------------------

def test_ring_decode_across_the_wrap(mixtral_case):
    """mixtral's ring of W = 8 slots from ``init_cache``: 20 decode steps
    from position 0 (the ring fills at 7 and wraps twice) against the
    reference's ``decode_step`` on its ``init_cache``: logits within
    1e-4 every step, the ring's slots equal after it; B9's length is
    min(pos + 1, 8)."""
    _, jcfg, tcfg, params, *_ = mixtral_case
    model = from_reference(tcfg, _np(params), "cpu")
    api, japi = get_model(tcfg), j_get_model(jcfg)
    jc, tc = japi.init_cache(2, 64), api.init_cache(2, 64, "cpu")
    assert tc["k"].shape[3] == 8
    toks = _batch(jcfg, seed=8, s=20)["tokens"]
    step = jax.jit(japi.decode_step)
    for t in range(20):
        tok = toks[:, t:t + 1]
        want, jc = step(params, jc, jnp.asarray(tok), jnp.int32(t))
        got, tc = api.decode_step(model, tc, torch.from_numpy(tok),
                                  torch.tensor(t))
        _close(got, want)
    close_trees(cache_as_reference(tc), _np(jc))


# --------------------------- attn_forward -----------------------------------

def test_attn_forward_noncausal_and_cross_match_reference():
    """``attn_forward`` (B8's plain version) against the reference's
    ``blocked_attention`` path: the encoder's bidirectional
    self-attention and cross-attention to other states (no rope, no
    mask), with qkv biases, GQA (4 heads over 2) and a windowed causal
    case."""
    jcfg = j_smoke("qwen2-72b").replace(kv_heads=2)
    tcfg = get_smoke_config("qwen2-72b").replace(kv_heads=2)
    assert tcfg.qkv_bias
    params = ref_params(jcfg, tcfg)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    model = from_reference(tcfg, _np(params), "cpu")
    p = model.layers[0].attn
    with torch.no_grad():      # non-zero biases (the init's are zero)
        for name in ("bq", "bk", "bv"):
            b = np.random.default_rng(len(name)).standard_normal(
                jp[name].shape).astype(np.float32)
            jp = dict(jp, **{name: jnp.asarray(b)})
            getattr(p, "w" + name[1]).bias.copy_(torch.from_numpy(b))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 20, tcfg.d_model)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)
    for kw in (dict(causal=False), dict(causal=True, window=5)):
        want = j_attention.attn_forward(jcfg, jp, jnp.asarray(x),
                                        jnp.asarray(pos), **kw)
        got = attention.attn_forward(tcfg, p, torch.from_numpy(x),
                                     torch.from_numpy(pos).long(), **kw)
        _close(got, want)
    want = j_attention.attn_forward(
        jcfg, jp, jnp.asarray(x), jnp.asarray(pos), causal=False,
        kv_src=jnp.asarray(src), kv_positions=jnp.arange(20))
    got = attention.attn_forward(tcfg, p, torch.from_numpy(x),
                                 torch.from_numpy(pos).long(), causal=False,
                                 kv_src=torch.from_numpy(src))
    _close(got, want)


# ------------------------ the windowed-cache fault --------------------------

def _dense_mixtral():
    """mixtral's smoke config with the dense MLP in place of the MoE, to
    isolate the window (prefill and decode use other MoE capacities)."""
    return get_smoke_config("mixtral-8x7b").replace(family="dense",
                                                    moe=None)


def _decode_vs_prefill(cfg, model, toks, S):
    """max |logits| difference between decoding token S after a prefill
    of S and a prefill of S + 1 tokens (the engine's cache length)."""
    from repro_torch.serve.engine import cache_len
    api = get_model(cfg)
    full, _ = api.prefill(model, {"tokens": toks[:, :S + 1]})
    _, cache = api.prefill(model, {"tokens": toks[:, :S]},
                           cache_len(cfg, S, 1))
    step, _ = api.decode_step(model, cache, toks[:, S:S + 1], S)
    return float((step - full).abs().max())


def test_window_fault_kept_and_exact_at_the_window(mixtral_case):
    """The reference's windowed prefill keeps the prompt's last W
    positions in slots 0..W-1, where decode expects position p in slot p
    % W: past the window and not a multiple of it (S = 12, W = 8) the
    ring is out of order and decode evicts the wrong position. The port
    keeps that: equal to the reference there (the moe arch's engine run,
    4 steps at 1e-4); with the dense MLP, decode after a prefill of W or
    2W tokens equals the prefill of one more (1e-4), and at S = 12 it
    does not (the fault shows)."""
    _, jcfg, tcfg, params, *_ = mixtral_case
    batch = _batch(jcfg, seed=12, s=12)
    check_family_against_reference(jcfg, tcfg, params, batch,
                                   engine_run(jcfg, params, batch))
    cfg = _dense_mixtral()
    model = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_batch(cfg, seed=13, s=17)["tokens"])
    for S in (8, 16):
        assert _decode_vs_prefill(cfg, model, toks, S) < TOL
    assert _decode_vs_prefill(cfg, model, toks, 12) > 0.1
