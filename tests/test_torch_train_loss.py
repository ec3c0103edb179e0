"""The port's training loss (``repro_torch.models``: ``blocked_attention``,
``chunked_xent``, each family's ``loss`` and ``ModelApi.loss``) and its
gradients against the JAX package on the CPU, in f32.

Both packages get the same parameters (the port's seeded init laid out
as the reference's tree, ``test_torch_lm.ref_params``) and the same
numpy batch. The reference's gradients come from one jitted
``jax.value_and_grad(api.loss)`` a family; the port's from autograd,
carried into the reference's layout by ``models.to_reference``.
Tolerances: the loss to rtol 1e-5 (measured 8.0e-8 at most); each
gradient leaf to 1e-4 times the leaf's largest magnitude plus 1e-7: the
same f32 arithmetic summed in other orders, measured at most 4.7e-6 of
the leaf's largest (rwkv6). The absolute term holds the key biases
(``bk``), whose gradient is 0 but for rounding (the softmax ignores a
shift of every key by one vector): ~1e-9 in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.data.tokens import batch_extras_for as j_extras
from repro.data.tokens import synthetic_batch as j_synthetic_batch
from repro.models import get_model as j_get_model
from repro.models.attention import blocked_attention as j_blocked
from repro.models.layers import chunked_xent as j_xent
from repro_torch.configs import get_smoke_config
from repro_torch.models import from_reference, get_model, to_reference
from repro_torch.models.attention import blocked_attention
from repro_torch.models.layers import chunked_xent
from test_torch_lm import ref_params

LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-7
B, S = 2, 32
# one arch a family (dense, moe, vlm, encdec, hybrid, ssm)
FAMILY_ARCHS = ["starcoder2-3b", "mixtral-8x7b", "internvl2-76b",
                "whisper-medium", "recurrentgemma-9b", "rwkv6-1.6b"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _f32(a):
    """A numpy leaf as f32, bf16 bits ('V2') included."""
    a = np.asarray(a)
    if a.dtype.kind == "V":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).float().numpy()
    return a.astype(np.float32)


def _tree_f32(tree):
    return {k: _tree_f32(v) if isinstance(v, dict) else _f32(v)
            for k, v in tree.items()}


def close_grads(got, want, rel=GRAD_REL, abs_=GRAD_ABS):
    """Every leaf of the port's gradient tree (``to_reference``) within
    rel x the reference leaf's largest magnitude + abs_, the same
    paths. Returns the worst error over that scale."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    worst = 0.0
    for path in w:
        a = np.asarray(w[path], np.float32)
        b = np.asarray(g[path], np.float32)
        assert a.shape == b.shape, path
        scale = float(np.abs(a).max())
        err = float(np.abs(a - b).max())
        assert err <= rel * scale + abs_, (path, err, scale)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def train_batch(cfg, seed=3, b=B, s=S):
    return j_synthetic_batch(seed, 0, b, s, cfg.vocab, extras=j_extras(cfg))


def reference_loss_and_grads(jcfg, params, batch):
    api = j_get_model(jcfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        api.loss, has_aux=True))(params, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def port_loss_and_grads(tcfg, params, batch):
    model = from_reference(tcfg, params, "cpu").requires_grad_(True)
    loss, metrics = get_model(tcfg).loss(model, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            to_reference(tcfg, grads))


# ------------------------------ blocked attention ---------------------------

ATTN_CASES = {
    # name: (B, S, T, N, KV, Hd, causal, window, q_chunk, cross)
    "gqa_causal": (2, 32, 32, 4, 2, 16, True, 0, 256, False),
    "mha_chunked": (1, 64, 64, 4, 4, 8, True, 0, 16, False),
    "cross_T_ne_S": (2, 24, 40, 4, 1, 16, False, 0, 8, True),
    "non_causal": (2, 32, 32, 6, 2, 8, False, 0, 256, False),
    "banded": (2, 64, 64, 4, 2, 16, True, 8, 16, False),
    "window_unbanded": (1, 32, 32, 4, 2, 16, True, 8, 256, False),
    "odd_length": (1, 30, 30, 4, 2, 8, True, 0, 8, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blocked_attention_matches_reference(case):
    """The q-chunked attention, forward and the gradients of q, k and v
    (of a fixed random projection of the output), against the
    reference's on random f32 inputs: grouped-query, cross-attention
    with T != S, non-causal, and the banded path (S = 64, chunks of 16,
    window 8: every chunk reads only its band); chunk sizes that do not
    divide S shrink as the reference's."""
    Bb, Sq, T, N, KV, Hd, causal, window, qc, cross = ATTN_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((Bb, Sq, N, Hd)).astype(np.float32)
    k = rng.standard_normal((Bb, T, KV, Hd)).astype(np.float32)
    v = rng.standard_normal((Bb, T, KV, Hd)).astype(np.float32)
    proj = rng.standard_normal((Bb, Sq, N, Hd)).astype(np.float32)
    qp = np.arange(Sq, dtype=np.int32)
    kp = np.arange(T, dtype=np.int32)

    def jfn(q, k, v):
        o = j_blocked(q, k, v, jnp.asarray(qp), jnp.asarray(kp),
                      causal=causal, window=window, q_chunk=qc)
        return jnp.sum(o * proj), o

    (_, want), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    got = blocked_attention(tq, tk, tv, torch.from_numpy(qp).long(),
                            torch.from_numpy(kp).long(), causal=causal,
                            window=window, q_chunk=qc)
    (got * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for t, g in zip((tq, tk, tv), jg):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


# -------------------------------- chunked xent ------------------------------

@pytest.mark.parametrize("S_,chunk,masked", [(40, 16, True), (40, 16, False),
                                             (32, 512, False)])
def test_chunked_xent_matches_reference(S_, chunk, masked):
    """The mean NLL over the mask and its gradients (of h and the head)
    against the reference's, with a remainder chunk (40 = 2 x 16 + 8),
    a mask that drops positions, and one chunk."""
    cfg = get_smoke_config("starcoder2-3b")
    jcfg = j_smoke("starcoder2-3b")
    rng = np.random.default_rng(11)
    h = rng.standard_normal((2, S_, cfg.d_model)).astype(np.float32)
    W = rng.standard_normal((cfg.d_model, cfg.vocab)).astype(np.float32) \
        * 0.1
    labels = rng.integers(0, cfg.vocab, (2, S_)).astype(np.int32)
    mask = (rng.random((2, S_)) < 0.7).astype(np.float32) if masked \
        else None
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda h, W: j_xent(jcfg, {"lm_head": W}, h, labels, mask, chunk),
        argnums=(0, 1))(h, W)

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lm_head = torch.nn.Linear(cfg.d_model, cfg.vocab,
                                           bias=False)
            self.lm_head.weight = torch.nn.Parameter(torch.from_numpy(W.T))

    p = Head()
    th = torch.from_numpy(h).requires_grad_(True)
    got = chunked_xent(cfg, p, th, torch.from_numpy(labels),
                       None if mask is None else torch.from_numpy(mask),
                       chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=0,
                               atol=GRAD_REL * np.abs(jgh).max())
    np.testing.assert_allclose(p.lm_head.weight.grad.numpy().T,
                               np.asarray(jgw), rtol=0,
                               atol=GRAD_REL * np.abs(jgw).max())


# --------------------------------- the families -----------------------------

@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def family_case(request):
    arch = request.param
    jcfg, tcfg = j_smoke(arch), get_smoke_config(arch)
    params = ref_params(jcfg, tcfg, seed=2)
    batch = train_batch(tcfg)
    return arch, jcfg, tcfg, params, batch, \
        reference_loss_and_grads(jcfg, params, batch)


def test_loss_and_grads_match_reference(family_case):
    """``ModelApi.loss`` and every gradient leaf against
    ``jax.value_and_grad(api.loss)`` at the smoke config of one arch a
    family, f32; the MoE's ``aux_loss`` and ``dropped_frac`` too (the
    fraction exactly: the same tokens drop)."""
    arch, jcfg, tcfg, params, batch, (jl, jm, jg) = family_case
    tl, tm, tg = port_loss_and_grads(tcfg, params, batch)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert set(tm) == set(jm)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=LOSS_RTOL)
    if "aux_loss" in jm:
        np.testing.assert_allclose(tm["aux_loss"], jm["aux_loss"],
                                   rtol=LOSS_RTOL)
        assert tm["dropped_frac"] == jm["dropped_frac"]
    close_grads(tg, jg)


# bf16, the dtype the card trains in: (loss rtol, gradient leaf bound over
# the leaf's largest magnitude), each about twice to three times the gap
# measured here (loss; worst leaf): starcoder2-3b 4.9e-5, 1.40e-2;
# mixtral-8x7b 9.0e-5, 2.23e-2 (aux_loss 3.4e-5); internvl2-76b 1.6e-4,
# 1.67e-2; recurrentgemma-9b 4.3e-4, 5.34e-2; rwkv6-1.6b 1.3e-4, 1.38e-1.
# Both packages round every bf16 product and activation, at places that
# differ (a fused f32 chain in XLA, a rounded intermediate in torch), so
# the gap is some bf16 ulps (2^-8) of each leaf's largest; the
# recurrences compound theirs over the sequence.
BF16_BOUNDS = {"starcoder2-3b": (2e-4, 4e-2), "mixtral-8x7b": (2e-4, 4e-2),
               "internvl2-76b": (4e-4, 4e-2),
               "recurrentgemma-9b": (1e-3, 1e-1), "rwkv6-1.6b": (4e-4, 2.5e-1)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bf16_loss_and_grads_match_reference(arch):
    """The bf16 path, as the card trains: ``ModelApi.loss`` and every
    gradient leaf against ``jax.value_and_grad(api.loss)`` at the smoke
    config in bf16, within ``BF16_BOUNDS``; the MoE's ``dropped_frac``
    exactly. whisper-medium: the reference cannot take a bf16 loss (its
    decoder scan's carry comes back f32 from a bf16 input, which
    ``lax.scan`` refuses: a quirk of the reference, kept), so the port's
    loss and gradients are only checked finite there."""
    jcfg = j_smoke(arch).replace(dtype="bfloat16")
    tcfg = get_smoke_config(arch).replace(dtype="bfloat16")
    params = ref_params(jcfg, tcfg, seed=2)
    batch = train_batch(tcfg)
    tl, tm, tg = port_loss_and_grads(tcfg, params, batch)
    if arch == "whisper-medium":
        with pytest.raises(TypeError, match="carry"):
            reference_loss_and_grads(jcfg, params, batch)
        assert np.isfinite(tl)
        for p, a in _leaves(tg):
            assert np.isfinite(_f32(a)).all(), p
        return
    jl, jm, jg = reference_loss_and_grads(jcfg, params, batch)
    loss_rtol, rel = BF16_BOUNDS[arch]
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    assert set(tm) == set(jm)
    if "aux_loss" in jm:
        np.testing.assert_allclose(tm["aux_loss"], jm["aux_loss"],
                                   rtol=loss_rtol)
        assert tm["dropped_frac"] == jm["dropped_frac"]
    close_grads(_tree_f32(tg), _tree_f32(jg), rel=rel)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_gives_the_same_values(family_case, mode):
    """The remat policies change what backward recomputes, not the
    values: the loss and every gradient bit for bit as ``remat="none"``
    (one recomputed forward is the same arithmetic)."""
    arch, jcfg, tcfg, params, batch, _ = family_case
    base = port_loss_and_grads(tcfg, params, batch)
    got = port_loss_and_grads(tcfg.replace(remat=mode), params, batch)
    assert got[0] == base[0] and got[1] == base[1]
    for (p, a), (_, b) in zip(_leaves(got[2]), _leaves(base[2])):
        assert np.array_equal(a, b), p


def test_remat_two_levels_on_a_deep_stack():
    """16 layers under "full" take the reference's two-level checkpoint
    (groups of ``_sqrt_block(16)`` = 4): the same loss and gradients as
    "none", bit for bit, and as the reference's."""
    tcfg = get_smoke_config("starcoder2-3b").replace(n_layers=16)
    jcfg = j_smoke("starcoder2-3b").replace(n_layers=16, remat="full")
    params = ref_params(jcfg, tcfg, seed=4)
    batch = train_batch(tcfg, s=16)
    base = port_loss_and_grads(tcfg, params, batch)
    got = port_loss_and_grads(tcfg.replace(remat="full"), params, batch)
    assert got[0] == base[0]
    for (p, a), (_, b) in zip(_leaves(got[2]), _leaves(base[2])):
        assert np.array_equal(a, b), p
    jl, _, jg = reference_loss_and_grads(jcfg, params, batch)
    np.testing.assert_allclose(got[0], jl, rtol=LOSS_RTOL)
    close_grads(got[2], jg)


# ------------------------------- to_reference -------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_reference_inverts_from_reference(arch, dtype):
    """``to_reference`` of the port's module is the reference's tree:
    the paths, shapes and dtypes of ``jax.eval_shape`` of its ``init``
    (bf16 leaves as their bits, 'V2'), and ``from_reference`` of it
    gives back every parameter bit for bit; a dict keyed by parameter
    name (the gradients, AdamW's moments) maps the same way, and a
    missing or unknown name is refused."""
    import ml_dtypes
    tcfg = get_smoke_config(arch).replace(dtype=dtype)
    jcfg = j_smoke(arch).replace(dtype=dtype)
    model = get_model(tcfg).init(torch.Generator().manual_seed(5), "cpu")
    tree = to_reference(tcfg, model)
    want = jax.eval_shape(j_get_model(jcfg).init, jax.random.key(0))
    paths = {p: (a.shape, a.dtype) for p, a in _leaves(tree)}
    assert set(paths) == {p for p, _ in _leaves(want)}
    for p, sds in _leaves(want):
        shape, dt = paths[p]
        assert shape == sds.shape, p
        assert (dt.kind == "V" and dt.itemsize == 2) if \
            sds.dtype == ml_dtypes.bfloat16 else dt == sds.dtype, p
    back = from_reference(tcfg, tree, "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b), n
    named = {n: p.detach() * 2 for n, p in model.named_parameters()}
    twice = to_reference(tcfg, named)
    for (p, a), (_, b) in zip(_leaves(twice), _leaves(tree)):
        if a.dtype.kind != "V":
            assert np.array_equal(a, 2 * b), p
    del named[next(iter(named))]
    with pytest.raises(ValueError, match="no tensor"):
        to_reference(tcfg, named)
    with pytest.raises(ValueError, match="no parameter"):
        to_reference(tcfg, dict(named, stray=torch.zeros(1)))
