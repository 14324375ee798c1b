"""The port's mixture-of-experts feed-forward and MoE DecoderLM against the
JAX package's, on the same weights (``load_jax_params``) and numpy-seeded
inputs, dropout off.

The JAX module's dispatch and combine tensors are read off the two einsums
that consume them, so routing, slots and the keep mask are compared as
tensors: dispatch identical, combine within 1e-6.  Tolerances: f32 outputs
1e-5 abs, aux 1e-6, gradients 1e-4 in relative L2 norm (the key-projection
bias, whose exact gradient is 0, within 1e-6 of the global norm), model
logits 1e-5; bf16 outputs within 2e-2 * max(1, max |ref|).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu.models import moe as jmoe
from flashattn_tpu.training import make_moe_loss as jax_moe_loss

torch.set_num_threads(1)

V = 32


def _params(jax_module):
    return {n: np.asarray(a) for n, a in jax_module.named_parameters()}


def _moe_pair(top_k, capacity_factor, training, dtype="float32", seed=0):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = jmoe.MoEFeedForward(16, 32, 4, top_k=top_k,
                             capacity_factor=capacity_factor,
                             key=jax.random.PRNGKey(seed), dtype=jdt)
    tm = pt.MoEFeedForward(16, 32, 4, top_k=top_k,
                           capacity_factor=capacity_factor, dtype=tdt)
    pt.load_jax_params(tm, _params(jm))
    if not training:
        jm, tm = jm.eval(), tm.eval()
    return jm, tm


def _jax_routing(monkeypatch, jm, x):
    """JAX's forward_with_aux, with the dispatch and combine tensors that
    its first and last einsums receive."""
    seen = {}

    def einsum(spec, a, b):
        if spec == "tec,td->ecd":
            seen["dispatch"] = np.asarray(a, np.float32)
        if spec == "tec,ecd->td":
            seen["combine"] = np.asarray(a, np.float32)
        return jnp.einsum(spec, a, b)

    names = {n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("__")}
    monkeypatch.setattr(jmoe, "jnp", types.SimpleNamespace(
        **dict(names, einsum=einsum)))
    y, aux = jm.forward_with_aux(x)
    monkeypatch.undo()
    return np.asarray(y, np.float32), float(aux), seen


CASES = {
    "top1_train_drops": (1, 0.5, True),
    "top2_train_drops": (2, 0.6, True),
    "top2_train_roomy": (2, 4.0, True),
    "top1_eval_dropless": (1, 0.5, False),
    "top2_eval_dropless": (2, 0.6, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_with_aux_matches_jax(monkeypatch, case):
    """Outputs, aux, the dispatch (routing, slots and keep) and combine
    tensors; the drop cases do drop tokens in train mode, and eval mode is
    dropless (capacity = tokens)."""
    top_k, cf, training = CASES[case]
    jm, tm = _moe_pair(top_k, cf, training)
    x = np.random.default_rng(1).standard_normal((2, 12, 16)).astype(np.float32)
    want, want_aux, seen = _jax_routing(monkeypatch, jm, jnp.asarray(x))
    tx = torch.from_numpy(x)
    got, aux = tm.forward_with_aux(tx)
    _, combine, top_mask = tm._route(tx.reshape(-1, 16))
    assert combine.shape == seen["combine"].shape
    np.testing.assert_array_equal((combine > 0).float().numpy(),
                                  seen["dispatch"])
    np.testing.assert_allclose(combine.detach().numpy(), seen["combine"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    assert abs(float(aux.detach()) - want_aux) <= 1e-6
    kept = (combine > 0).sum((1, 2))
    if training and cf < 1:
        assert (kept < top_k).any()               # some choices dropped
    if not training:
        assert combine.shape[-1] == 24 and (kept == top_k).all()
    assert (top_mask.sum(-1) == top_k).all()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_grads_match_jax(top_k):
    """Gradients of sum(y^2) + 0.01 aux in x and every parameter against
    jax.grad, with capacity drops."""
    jm, tm = _moe_pair(top_k, 0.75, True, seed=2)
    x = np.random.default_rng(2).standard_normal((2, 16, 16)).astype(np.float32)

    def loss(m, x):
        y, aux = m.forward_with_aux(x)
        return jnp.sum(y ** 2) + 0.01 * aux

    jg_m, jg_x = jax.grad(loss, argnums=(0, 1))(jm, jnp.asarray(x))
    want = dict(_params(jg_m), x=np.asarray(jg_x))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tm.forward_with_aux(tx)
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad((y ** 2).sum() + 0.01 * aux, (tx,) + params)
    got = dict(zip(("x",) + names, (g.numpy() for g in grads)))
    assert set(got) == set(want)
    for n in want:
        assert _rel(got[n], want[n]) <= 1e-4, (n, _rel(got[n], want[n]))
    assert np.abs(got["router.weights"]).sum() > 0


def test_moe_bf16_matches_jax():
    """bf16 weights and input, top-2 with drops: within 2e-2 * max(1,
    max |ref|)."""
    jm, tm = _moe_pair(2, 0.75, True, "bfloat16", seed=3)
    x = np.random.default_rng(3).standard_normal((2, 16, 16)).astype(np.float32)
    want, want_aux = jm.forward_with_aux(jnp.asarray(x, jnp.bfloat16))
    got, aux = tm.forward_with_aux(torch.from_numpy(x).to(torch.bfloat16))
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().detach().numpy() - want).max()
    assert err <= 2e-2 * max(1.0, np.abs(want).max()), err
    assert abs(float(aux.detach()) - float(want_aux)) <= 1e-6


def _model_pair(seed=0, **kw):
    kw = dict(dict(p_dropout=0.0, n_layer=2, n_experts=4, middle_dim=64,
                   attn_impl="reference"), **kw)
    jm = ft.DecoderLM(V, 32, 4, 16, key=jax.random.PRNGKey(seed), **kw)
    tm = pt.DecoderLM(V, 32, 4, 16, device="cpu", **kw)
    pt.load_jax_params(tm, _params(jm))
    return jm, tm


_jax_fwd_aux = jax.jit(lambda m, t: m.forward_with_aux(t))
_jax_moe_value_and_grad = jax.jit(lambda m, t, y: jax.value_and_grad(
    jax_moe_loss(0.01))(m, t, y, None, None))


@pytest.mark.parametrize("remat", [False, True])
def test_moe_decoder_forward_with_aux_matches_jax(remat):
    """Train mode (capacity drops at top-1, cf 1.25): logits and the summed
    aux against JAX, and the gradients of make_moe_loss against jax.grad,
    with and without per-layer checkpointing."""
    jm, tm = _model_pair(5, moe_top_k=1)
    tm.remat = remat
    toks = np.random.default_rng(5).integers(0, V, (4, 12)).astype(np.int32)
    jl, jaux = _jax_fwd_aux(jm, jnp.asarray(toks))
    tt = torch.from_numpy(toks)
    tl, taux = tm.forward_with_aux(tt)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    assert abs(float(taux.detach()) - float(jaux)) <= 1e-6
    want_l, want_g = _jax_moe_value_and_grad(
        jm, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    got_l = pt.make_moe_loss(0.01)(tm, tt[:, :-1], tt[:, 1:])
    names, params = zip(*tm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(got_l, params)))
    assert abs(float(got_l.detach()) - float(want_l)) <= 1e-5
    want_g = _params(want_g)
    total = np.sqrt(sum(np.square(g).sum() for g in want_g.values()))
    for n, g in want_g.items():
        if n.endswith("k_projection.bias"):
            # exactly 0 (softmax ignores a shift shared by every key): both
            # sides return rounding noise, held to 1e-6 of the global norm
            assert max(np.abs(g).max(), grads[n].abs().max()) <= 1e-6 * total
            continue
        assert _rel(grads[n].numpy(), g) <= 1e-4, (n, _rel(grads[n].numpy(), g))


def test_moe_cached_decode_matches_forward_and_jax():
    """Eval mode (dropless): the cached decode's logits against the port's
    dense forward and JAX's cached decode, RoPE and GQA on."""
    jm, tm = _model_pair(9, pos_encoding="rope", n_kv_head=2)
    jm, tm = jm.eval(), tm.eval()
    toks = np.random.default_rng(10).integers(0, V, (2, 10)).astype(np.int32)
    step = jax.jit(lambda t, c, i: jm.forward_decode(t, c, i))
    caches, want = jm.init_cache(2, 10), []
    for i in range(10):
        lg, caches = step(jnp.asarray(toks[:, i:i + 1]), caches, i)
        want.append(np.asarray(lg[:, 0]))
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        dense = tm(tt).numpy()
        caches, got = tm.init_cache(2, 10), []
        for i in range(10):
            lg, caches = tm.forward_decode(tt[:, i:i + 1], caches,
                                           torch.tensor(i))
            got.append(lg[:, 0].numpy())
    got = np.stack(got, 1)
    np.testing.assert_allclose(got, np.stack(want, 1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, dense, atol=1e-5, rtol=0)


def test_moe_router_ignores_matmul_precision_setting():
    """The router's product stays in full f32 whatever the caller set (the
    setting is restored after): the same router probabilities and combine
    weights under "medium" (bf16 passes where the CPU has them)."""
    _, tm = _moe_pair(2, 2.0, False)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, 16)).astype(np.float32))
    want = tm._route(x)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = tm._route(x)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
