"""The port's Adafactor and the trainer's MoE and distillation losses against
the JAX package's, on the same numpy-seeded parameters, gradients, weights
(``load_jax_params``) and tokens, dropout off.

Tolerances, f32: Adafactor parameters within 1e-6 in relative L2 norm after
one step and 1e-5 after five, its statistics likewise; losses 1e-5 abs;
gradients 1e-4 in relative L2 norm (the key-projection bias, whose exact
gradient is 0, within 1e-6 of the global norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu import optim as jopt
from flashattn_tpu.training import trainer as jtr

torch.set_num_threads(1)

# matrix, 1-d, stacked (3-d, factored over its last two axes), and a row
SHAPES = {"w": (6, 5), "b": (7,), "e": (2, 3, 4), "r": (1, 9)}

OPTS = {
    "relative_step": lambda m: m.Adafactor(),
    "beta1": lambda m: m.Adafactor(beta1=0.9),
    "lr_schedule": lambda m: m.Adafactor(lr=m.warmup_cosine(3e-2, 2, 5),
                                         relative_step=False),
    "lr_weight_decay": lambda m: m.Adafactor(lr=1e-2, relative_step=False,
                                             weight_decay=0.1),
    "clipped": lambda m: m.Adafactor(clip_threshold=0.05, beta1=0.5,
                                     decay_exponent=0.5),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", list(OPTS))
def test_adafactor_matches_jax(name):
    """Five steps on random gradients (scaled per step so that clipping and
    the row / column statistics move): parameters after step 1 within 1e-6,
    after each later step within 1e-5; vr, vc (and m) likewise."""
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    t_model = nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v.copy()))
                                for k, v in init.items()})
    j_opt, t_opt = OPTS[name](jopt), OPTS[name](pt)
    j_state, t_state = j_opt.init(j_params), t_opt.init(t_model)
    for step in range(5):
        grads = {k: (rng.standard_normal(s) * 10.0 ** (step - 2)).astype(
            np.float32) for k, s in SHAPES.items()}
        j_params, j_state = j_opt.step(
            j_params, {k: jnp.asarray(g) for k, g in grads.items()}, j_state)
        t_model, t_state = t_opt.step(
            t_model, {k: torch.from_numpy(g) for k, g in grads.items()},
            t_state)
        tol = 1e-6 if step == 0 else 1e-5
        for k in SHAPES:
            assert _rel(t_model[k].detach(), j_params[k]) <= tol, (step, k)
            assert _rel(t_state.vr[k], j_state.vr[k]) <= tol, (step, k)
            if len(SHAPES[k]) >= 2:
                assert _rel(t_state.vc[k], j_state.vc[k]) <= tol, (step, k)
            if t_state.m is not None:
                assert t_state.m[k].dtype == torch.float32
                assert _rel(t_state.m[k], j_state.m[k]) <= tol, (step, k)
    assert t_state.step == int(j_state.step) == 5
    assert (t_state.m is None) == (j_state.m is None)
    for k, s in SHAPES.items():
        assert tuple(t_state.vr[k].shape) == j_state.vr[k].shape
        assert tuple(t_state.vc[k].shape) == j_state.vc[k].shape


def test_adafactor_refuses_wrong_lr_settings():
    with pytest.raises(ValueError, match="relative_step"):
        pt.Adafactor(relative_step=False)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pt.Adafactor(lr=1e-3)
    pt.Adafactor(lr=1e-3, relative_step=False)


V = 32


def _pair(seed=0, **kw):
    kw = dict(dict(p_dropout=0.0, n_layer=2, attn_impl="reference"), **kw)
    jm = ft.DecoderLM(V, 32, 4, 16, key=jax.random.PRNGKey(seed), **kw)
    tm = pt.DecoderLM(V, 32, 4, 16, device="cpu", **kw)
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


def _batch(seed, b=4, s=12):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, (b, s)).astype(np.int32)
    return tok, np.roll(tok, -1, 1), (rng.random((b, s)) < 0.7).astype(
        np.float32)


def _grads_close(t_model, loss, j_grads):
    names, params = zip(*t_model.named_parameters())
    got = dict(zip(names, torch.autograd.grad(loss, params)))
    want = {n: np.asarray(g) for n, g in j_grads.named_parameters()}
    assert set(got) == set(want)
    total = np.sqrt(sum(np.square(g).sum() for g in want.values()))
    for n, g in want.items():
        if n.endswith("k_projection.bias"):
            assert max(np.abs(g).max(), got[n].abs().max()) <= 1e-6 * total
            continue
        assert _rel(got[n], g) <= 1e-4, (n, _rel(got[n], g))


@pytest.mark.parametrize("masked", [False, True])
def test_moe_loss_and_grads_match_jax(masked):
    """make_moe_loss on a top-2 MoE model in train mode (capacity drops)."""
    jm, tm = _pair(1, n_experts=4, moe_top_k=2, middle_dim=48)
    tok, tgt, msk = _batch(1)
    msk = msk if masked else None
    j_args = [jnp.asarray(a) if a is not None else None for a in (tok, tgt, msk)]
    want, j_grads = jax.jit(jax.value_and_grad(jtr.make_moe_loss(0.05)))(
        jm, *j_args, None)
    t_args = [torch.from_numpy(a) if a is not None else None
              for a in (tok, tgt, msk)]
    got = pt.make_moe_loss(0.05)(tm, *t_args)
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    _grads_close(tm, got, j_grads)


DISTILL = {"kl": dict(), "kl_ce_t2": dict(alpha=0.7, temperature=2.0)}


@pytest.mark.parametrize("case", list(DISTILL))
def test_distill_loss_and_grads_match_jax(case):
    """make_distill_loss with the teacher in its closure: the loss and the
    student's gradients; the teacher, given in train mode, is run in eval
    mode and handed back in train mode."""
    kw = DISTILL[case]
    j_teacher, t_teacher = _pair(2, p_dropout=0.5)
    j_student, t_student = _pair(3, n_layer=1)
    tok, tgt, msk = _batch(2)
    want, j_grads = jax.jit(jax.value_and_grad(
        lambda s, t, *batch: jtr.make_distill_loss(t, **kw)(s, *batch)))(
        j_student, j_teacher, *map(jnp.asarray, (tok, tgt, msk)))
    t_teacher.train()
    got = pt.make_distill_loss(t_teacher, **kw)(
        t_student, torch.from_numpy(tok), torch.from_numpy(tgt),
        torch.from_numpy(msk))
    assert t_teacher.training
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    _grads_close(t_student, got, j_grads)
    assert all(p.grad is None for p in t_teacher.parameters())


def test_ctx_teacher_equals_closure_teacher():
    """Two steps of make_train_step and of make_train_scan with the teacher
    as ctx land the closure teacher's losses and parameters, and JAX's
    (ctx) losses; a ctx-free loss fn still takes five arguments."""
    j_teacher, t_teacher = _pair(4)
    _, s0 = _pair(5, n_layer=1)
    toks = [_batch(10 + i) for i in range(2)]
    runs = {}
    for label, loss_fn, ctx in (
            ("closure", pt.make_distill_loss(t_teacher), None),
            ("ctx", pt.make_distill_loss(), t_teacher)):
        student = pt.DecoderLM(V, 32, 4, 16, p_dropout=0.0, n_layer=1,
                               attn_impl="reference", device="cpu")
        student.load_state_dict(s0.state_dict())
        opt = pt.Adam(1e-2)
        step = pt.make_train_step(opt, loss_fn, grad_clip=1.0)
        state, losses = opt.init(student), []
        for tok, tgt, msk in toks:
            student, state, loss = step(
                student, state, *map(torch.from_numpy, (tok, tgt, msk)),
                None, ctx=ctx)
            losses.append(float(loss))
        scan = pt.make_train_scan(opt, loss_fn, grad_clip=1.0)
        stacked = [torch.from_numpy(np.stack(a)) for a in zip(*toks)]
        student, state, scan_losses = scan(student, state, *stacked, None,
                                           ctx=ctx)
        runs[label] = (losses + scan_losses.tolist(), student.state_dict())
    assert runs["ctx"][0] == runs["closure"][0]
    for n, p in runs["ctx"][1].items():
        torch.testing.assert_close(p, runs["closure"][1][n], atol=0, rtol=0)

    j_opt = jopt.Adam(1e-2)
    j_student = ft.DecoderLM(V, 32, 4, 16, p_dropout=0.0, n_layer=1,
                             attn_impl="reference", key=jax.random.PRNGKey(5))
    j_step = jtr.make_train_step(j_opt, jtr.make_distill_loss(),
                                 donate=False, grad_clip=1.0)
    j_state, j_losses = j_opt.init(j_student), []
    for tok, tgt, msk in toks:
        j_student, j_state, loss = j_step(
            j_student, j_state, *map(jnp.asarray, (tok, tgt, msk)), None,
            ctx=j_teacher)
        j_losses.append(float(loss))
    np.testing.assert_allclose(runs["ctx"][0][:2], j_losses, atol=1e-5,
                               rtol=0)

    plain = pt.make_train_step(pt.SGD(0.1))
    plain(s0, (), *map(torch.from_numpy, toks[0][:2]))


def test_adafactor_train_step_matches_jax():
    """Three make_train_step steps of Adafactor (relative step, clip 1.0)
    on a RoPE model: losses 1e-5 and every parameter within 1e-5."""
    jm, tm = _pair(6, pos_encoding="rope")
    j_opt, t_opt = jopt.Adafactor(), pt.Adafactor()
    j_step = jtr.make_train_step(j_opt, grad_clip=1.0, donate=False)
    t_step = pt.make_train_step(t_opt, grad_clip=1.0)
    j_state, t_state = j_opt.init(jm), t_opt.init(tm)
    for i in range(3):
        tok, tgt, msk = _batch(20 + i)
        jm, j_state, j_loss = j_step(jm, j_state,
                                     *map(jnp.asarray, (tok, tgt, msk)), None)
        tm, t_state, t_loss = t_step(tm, t_state,
                                     *map(torch.from_numpy, (tok, tgt, msk)))
        assert abs(float(t_loss) - float(j_loss)) <= 1e-5
    t_params = dict(tm.named_parameters())
    for n, want in jm.named_parameters():
        assert _rel(t_params[n].detach(), want) <= 1e-5, n
