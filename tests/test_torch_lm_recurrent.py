"""The port's whisper (``models/encdec.py``), recurrentgemma
(``models/hybrid.py``, ``rglru.py``) and rwkv6 (``models/ssm.py``,
``rwkv6.py``) against the JAX package on the CPU, at the smoke configs
in f32 (one torch thread, each reference program compiled once a
module). Tolerances as in tests/test_torch_lm.py: 1e-4 on f32 logits,
caches and states, greedy tokens equal; bf16 as stated at its case."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import get_model as j_get_model
from repro.models import hybrid as j_hybrid
from repro.models import rglru as j_rglru
from repro.models import rwkv6 as j_rwkv6
from repro_torch.configs import get_smoke_config
from repro_torch.models import from_reference, get_model, rglru, rwkv6
from repro_torch.models.rope import sinusoidal_positions
from repro_torch.serve.engine import cache_len
from test_torch_lm import (BF16_TOL, KEY, TOL, _batch,  # noqa: F401
                           _close, _np, _one_torch_thread,
                           check_carries_every_leaf,
                           check_family_against_reference, engine_run,
                           ref_params)

ARCHS = ["whisper-medium", "recurrentgemma-9b", "rwkv6-1.6b"]


def _frames(cfg, batch, seed, dtype=np.float32):
    """Whisper's stub frames [B, enc_frames, D], standard normal."""
    if cfg.family == "encdec":
        batch["frames"] = np.random.default_rng(seed).standard_normal(
            (batch["tokens"].shape[0], cfg.enc_frames, cfg.d_model)
        ).astype(dtype)
    return batch


@functools.lru_cache(maxsize=None)
def _case(arch, S=16):
    """A smoke config in both packages, the reference's parameters, a
    batch (B=2, S tokens, whisper's 8 frames) and the reference engine's
    run of 4 tokens (compiled once: the cases below share it)."""
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    params = ref_params(jcfg, tcfg)
    batch = _frames(jcfg, _batch(jcfg, seed=21, s=S), 22)
    return jcfg, tcfg, params, batch, engine_run(jcfg, params, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_families_match_reference(arch):
    """whisper (the encoder, causal self-attention and cross-attention
    with its cached k / v), recurrentgemma (two RG-LRU blocks and local
    MQA attention with window 8: the 16-token prompt fills the ring) and
    rwkv6 (the chunked time mix): prefill logits and the cache, four
    decode steps and the final cache (or state) within 1e-4 of the
    reference engine's run; the engines' greedy tokens equal; every leaf
    carried."""
    jcfg, tcfg, params, batch, run = _case(arch)
    model = check_family_against_reference(jcfg, tcfg, params, batch, run)
    check_carries_every_leaf(model, _np(params))


# ------------------------------- RG-LRU -------------------------------------

def _rec_params(case):
    jcfg, tcfg, params, *_ = case
    jp = jax.tree.map(lambda a: a[0], params["groups"]["rec0"]["rec"])
    model = from_reference(tcfg, _np(params), "cpu")
    return jcfg, tcfg, jp, model.groups[0].rec0.rec


@pytest.mark.parametrize("S", [12, 32, 1])
def test_rglru_matches_reference(S):
    """``apply_rglru`` and the final state (the reference's
    ``hybrid._final_state``, a second scan) from one log-depth scan,
    then ``decode_rglru`` from that state, against the reference's
    (``associative_scan``): outputs and states within 1e-4."""
    jcfg, tcfg, jp, p = _rec_params(_case("recurrentgemma-9b"))
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)

    @jax.jit
    def reference(jp, x, x1):
        st = j_hybrid._final_state(jcfg, jp, x)
        return (j_rglru.apply_rglru(jcfg, jp, x), st,
                *j_rglru.decode_rglru(jcfg, jp, x1, st))

    want_y, want, want_y1, want1 = reference(jp, jnp.asarray(x),
                                             jnp.asarray(x1))
    y, st = rglru.rglru_scan(tcfg, p, torch.from_numpy(x))
    _close(y, want_y)
    _close(rglru.apply_rglru(tcfg, p, torch.from_numpy(x)), y.numpy(), 0)
    y1, st1 = rglru.decode_rglru(tcfg, p, torch.from_numpy(x1), st)
    _close(y1, want_y1)
    for k in ("h", "conv"):
        _close(st[k], want[k])
        _close(st1[k], want1[k])


def test_linear_scan_equals_the_loop():
    """The doubling scan against h_t = a_t h_{t-1} + b_t step by step, at
    lengths around the powers of two."""
    g = torch.Generator().manual_seed(0)
    for S in (1, 2, 3, 7, 8, 9, 33):
        a = torch.rand((2, S, 5), generator=g)
        b = torch.randn((2, S, 5), generator=g)
        h, want = torch.zeros(2, 5), []
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        _close(rglru.linear_scan(a, b), torch.stack(want, 1).numpy(), 1e-5)


# -------------------------------- RWKV6 -------------------------------------

@pytest.mark.parametrize("S", [12, 32, 1])
def test_tmix_and_cmix_match_reference(S):
    """``tmix_forward`` (the chunked form: one chunk of 12, two of 16;
    S = 1 the recurrence) and ``cmix_forward`` against the reference's,
    from zero state and from a carried one: outputs and states within
    1e-4."""
    jcfg, tcfg, params, *_ = _case("rwkv6-1.6b")
    jl = jax.tree.map(lambda a: a[0], params["layers"])
    lp = from_reference(tcfg, _np(params), "cpu").layers[0]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    H, hd, D = tcfg.n_heads, tcfg.resolved_head_dim, tcfg.d_model
    carried = {"x_prev": rng.standard_normal((2, 1, D)).astype(np.float32),
               "S": rng.standard_normal((2, H, hd, hd)).astype(np.float32)}

    @jax.jit
    def reference(jl, x, st):
        return [(j_rwkv6.tmix_forward(jcfg, jl["tmix"], x, s),
                 j_rwkv6.cmix_forward(jcfg, jl["cmix"], x, s and {
                     "x_prev": s["x_prev"]}))
                for s in (None, st)]

    wants = reference(jl, jnp.asarray(x), {k: jnp.asarray(v)
                                           for k, v in carried.items()})
    tst = {k: torch.from_numpy(v) for k, v in carried.items()}
    for st, ((want_y, want), (want_cy, want_c)) in zip((None, tst), wants):
        got_y, got = rwkv6.tmix_forward(tcfg, lp.tmix, torch.from_numpy(x),
                                        st)
        _close(got_y, want_y)
        for k in ("x_prev", "S"):
            _close(got[k], want[k])
        got_y, got = rwkv6.cmix_forward(
            tcfg, lp.cmix, torch.from_numpy(x),
            st and {"x_prev": st["x_prev"]})
        _close(got_y, want_cy)
        _close(got["x_prev"], want_c["x_prev"])


# --------------------------- the hybrid's ring -------------------------------

def _decode_vs_prefill(cfg, model, toks, S, frames=None):
    """max |logits| difference between decoding token S after a prefill
    of S and a prefill of S + 1 tokens (the engine's cache length)."""
    api = get_model(cfg)
    extra = {} if frames is None else {"frames": frames}
    full, _ = api.prefill(model, {"tokens": toks[:, :S + 1], **extra})
    _, cache = api.prefill(model, {"tokens": toks[:, :S], **extra},
                           cache_len(cfg, S, 1))
    step, _ = api.decode_step(model, cache, toks[:, S:S + 1], S)
    return float((step - full).abs().max())


def test_hybrid_short_prompt_fault_kept_and_exact_at_the_window():
    """The reference sizes the hybrid's ring at min(S, local_window) and
    never pads it, so under a prompt shorter than the window decode's
    first step evicts position 0. The port keeps that: at S = 4 (window
    8) equal to the reference's engine run (4 steps, 1e-4); decode after
    a prefill of 8 or 16 tokens equals the prefill of one more (1e-4),
    and at S = 4 it does not (the fault shows)."""
    jcfg, tcfg, params, batch, run = _case("recurrentgemma-9b", S=4)
    model = check_family_against_reference(jcfg, tcfg, params, batch, run)
    toks = torch.from_numpy(_batch(tcfg, seed=23, s=17)["tokens"])
    for S in (8, 16):
        assert _decode_vs_prefill(tcfg, model, toks, S) < TOL
    assert _decode_vs_prefill(tcfg, model, toks, 4) > 0.1


def test_decode_equals_prefill_whisper_and_rwkv6():
    """Decode after a prefill of S tokens against a prefill of S + 1
    (whisper with its frames; rwkv6 at S = 16 and 17: the chunked form
    against the recurrence), 1e-4."""
    for arch, lengths in (("whisper-medium", (5, 16)),
                          ("rwkv6-1.6b", (16, 17))):
        cfg = get_smoke_config(arch)
        model = get_model(cfg).init(torch.Generator().manual_seed(1), "cpu")
        batch = _frames(cfg, _batch(cfg, seed=24, s=18), 25)
        frames = batch.get("frames")
        for S in lengths:
            assert _decode_vs_prefill(cfg, model, torch.from_numpy(
                batch["tokens"]), S, frames) < TOL, (arch, S)


# -------------------------------- whisper -----------------------------------

def test_whisper_bf16_with_bf16_frames_matches_reference():
    """whisper's smoke config in bf16, both packages fed the same bf16
    frames (the launcher casts them, as patches): prefill and two decode
    steps' logits at ``BF16_TOL``; the table is the reference's
    ``sinusoidal_positions``."""
    from repro.models.rope import sinusoidal_positions as j_sin
    np.testing.assert_allclose(sinusoidal_positions(300, 64).numpy(),
                               np.asarray(j_sin(300, 64)), atol=1e-6)
    jcfg = j_smoke("whisper-medium").replace(dtype="bfloat16")
    tcfg = get_smoke_config("whisper-medium").replace(dtype="bfloat16")
    params = ref_params(jcfg, tcfg)
    batch = _frames(jcfg, _batch(jcfg, seed=26), 27)
    batch["frames"] = np.asarray(jnp.asarray(batch["frames"]).astype(
        jnp.bfloat16))
    _, lg, _, logits, _, toks = engine_run(jcfg, params, batch, steps=2)
    model = from_reference(tcfg, _np(params), "cpu")
    api = get_model(tcfg)
    tb = {"tokens": batch["tokens"],
          "frames": torch.from_numpy(batch["frames"].astype(np.float32))
          .to(torch.bfloat16)}
    got, tc = api.prefill(model, tb, 16 + 2)
    assert tc["self"]["k"].dtype == torch.bfloat16
    _close(got, lg, BF16_TOL)
    for i, tok in enumerate(toks):
        got, tc = api.decode_step(model, tc, torch.from_numpy(tok), 16 + i)
        _close(got, logits[i], BF16_TOL)
