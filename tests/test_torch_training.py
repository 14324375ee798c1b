"""The port's training path against the JAX package's on the CPU.

Optimizers, clipping and the LR schedule run on numpy-made parameter and
gradient trees in both packages; the losses and the train step run a small
DecoderLM whose JAX weights are copied into the port (``load_jax_params``).
Tolerances, float32: optimizer states atol 1e-6; losses 1e-5; parameters
after three Adam steps atol 1e-5 (Adam divides by sqrt(v), which turns
gradient noise of ~1e-9 on parameters with tiny gradients into update noise
of ~1e-6).  The bf16 mixed-precision step rounds in different places in the
two frameworks, so it is held to 2e-2 relative.
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
from flashattn_tpu.nn import functional as jF
from flashattn_tpu.training import trainer as jtr

torch.set_num_threads(1)

MODEL = ((64, 32, 4, 32), dict(n_layer=2, middle_dim=64))


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _pair(p_dropout=0.0, **kw):
    args, base = MODEL
    jm = ft.DecoderLM(*args, p_dropout=p_dropout, key=jax.random.PRNGKey(0),
                      **base, **kw)
    tm = pt.DecoderLM(*args, p_dropout=p_dropout, device="cpu", **base, **kw)
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


def _batch(seed=0, b=4, s=16):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 64, (b, s)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=1)
    msk = (rng.random((b, s)) < 0.7).astype(np.float32)
    return tok, tgt, msk


def _tt(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jj(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# -- optimizers ----------------------------------------------------------------

SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 3, 4)}

OPTS = {
    "sgd": lambda m: m.SGD(lr=0.1),
    "adam": lambda m: m.Adam(lr=1e-2),
    "adam_l2": lambda m: m.Adam(lr=1e-2, weight_decay=0.1),
    "adam_reference_bug": lambda m: m.Adam(lr=1e-2,
                                           reproduce_reference_bug=True),
    "adam_schedule": lambda m: m.Adam(lr=m.warmup_cosine(3e-2, 2, 5)),
    "adamw": lambda m: m.AdamW(lr=1e-2, weight_decay=0.1),
}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_parity(name):
    rng = np.random.default_rng(0)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    t_model = nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v.copy()))
                                for k, v in init.items()})
    j_opt, t_opt = OPTS[name](jopt), OPTS[name](pt)
    j_state, t_state = j_opt.init(j_params), t_opt.init(t_model)
    for _ in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in SHAPES.items()}
        j_params, j_state = j_opt.step(
            j_params, {k: jnp.asarray(g) for k, g in grads.items()}, j_state)
        t_model, t_state = t_opt.step(
            t_model, {k: torch.from_numpy(g) for k, g in grads.items()},
            t_state)
        for k in SHAPES:
            _close(t_model[k].detach(), j_params[k], atol=1e-6)
    if name != "sgd":
        assert t_state.step == int(j_state.step) == 5
        for k in SHAPES:
            _close(t_state.exp_avg_sq[k], j_state.exp_avg_sq[k], atol=1e-6)


@pytest.mark.parametrize("poison", [False, True])
def test_clip_by_global_norm_parity(poison):
    rng = np.random.default_rng(1)
    grads = {k: rng.standard_normal(s).astype(np.float32) * 3
             for k, s in SHAPES.items()}
    if poison:
        grads["b"][2] = np.inf       # a non-finite norm skips the update
    _close(pt.global_norm(dict(zip(grads, _tt(*grads.values())))),
           jopt.global_norm({k: jnp.asarray(g) for k, g in grads.items()}),
           atol=1e-5)
    got = pt.clip_by_global_norm(dict(zip(grads, _tt(*grads.values()))), 1.0)
    want = jopt.clip_by_global_norm({k: jnp.asarray(g)
                                     for k, g in grads.items()}, 1.0)
    for k in SHAPES:
        _close(got[k], want[k], atol=1e-6)
    if poison:
        assert all((g == 0).all() for g in got.values())


def test_warmup_cosine_parity():
    t_s, j_s = pt.warmup_cosine(1e-3, 10, 100), jopt.warmup_cosine(1e-3, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        _close(t_s(step), j_s(jnp.int32(step)), atol=1e-9, rtol=1e-6)


# -- losses and the train step -------------------------------------------------


def test_softmax_loss_parity():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((9, 17)).astype(np.float32) * 4
    target = rng.integers(0, 17, 9).astype(np.int32)
    _close(pt.F.softmax_loss(*_tt(logits, target)),
           jF.softmax_loss(*_jj(logits, target)))


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_parity(masked):
    jm, tm = _pair()
    tok, tgt, msk = _batch()
    msk = msk if masked else None
    with torch.no_grad():
        got = pt.lm_loss(tm, *_tt(tok, tgt, msk))
    _close(got, jtr.lm_loss(jm, *_jj(tok, tgt, msk)))


def test_train_step_parity():
    """Three Adam steps (lr 1e-3, grad_clip 1.0) from the same weights:
    losses and every parameter after each step."""
    jm, tm = _pair()
    j_opt, t_opt = jopt.Adam(lr=1e-3), pt.Adam(lr=1e-3)
    j_step = jtr.make_train_step(j_opt, grad_clip=1.0, donate=False)
    t_step = pt.make_train_step(t_opt, grad_clip=1.0)
    j_state, t_state = j_opt.init(jm), t_opt.init(tm)
    for i in range(3):
        tok, tgt, msk = _batch(seed=10 + i)
        jm, j_state, j_loss = j_step(jm, j_state, *_jj(tok, tgt, msk), None)
        tm, t_state, t_loss = t_step(tm, t_state, *_tt(tok, tgt, msk))
        _close(t_loss, j_loss)
        t_params = dict(tm.named_parameters())
        for name, want in jm.named_parameters():
            _close(t_params[name].detach(), want)


def test_mixed_precision_loss_and_grads_parity():
    """bf16 compute over f32 masters: the loss and each parameter's f32
    gradient against JAX's make_mixed_precision_loss, to 2e-2 relative
    (relative L2 norm for the gradients, norms below 1e-2 counted as 1e-2:
    the key-projection bias has an exactly zero gradient, softmax being
    blind to a shift shared by every key, and both frameworks return
    rounding noise of ~1e-5 there)."""
    jm, tm = _pair()
    tok, tgt, msk = _batch(seed=3)
    j_loss, j_grads = jax.value_and_grad(jtr.make_mixed_precision_loss())(
        jm, *_jj(tok, tgt, msk), None)
    loss = pt.make_mixed_precision_loss()(tm, *_tt(tok, tgt, msk))
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad(loss, params)
    assert all(g.dtype == torch.float32 for g in grads)
    _close(loss.detach(), j_loss, atol=0, rtol=2e-2)
    want = dict(j_grads.named_parameters())
    for name, g in zip(names, grads):
        w = np.asarray(want[name], np.float32)
        err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-2)
        assert err < 2e-2, (name, err)


def test_grad_accumulation_matches_full_batch():
    """accum_steps=2 with unequal mask counts per microbatch equals one
    full-batch step (SGD lr 1, so parameters differ by the gradients)."""
    _, tm = _pair()
    tm2 = pt.DecoderLM(*MODEL[0], p_dropout=0.0, device="cpu", **MODEL[1])
    tm2.load_state_dict(tm.state_dict())
    tok, tgt, msk = _batch(seed=4)
    msk[:2, :12] = 0.0
    opt = pt.SGD(lr=1.0)
    _, _, loss = pt.make_train_step(opt)(tm, (), *_tt(tok, tgt, msk))
    _, _, loss2 = pt.make_train_step(opt, accum_steps=2)(tm2, (),
                                                         *_tt(tok, tgt, msk))
    _close(loss2, loss, atol=1e-6)
    p2 = dict(tm2.named_parameters())
    for name, p in tm.named_parameters():
        _close(p2[name].detach(), p.detach(), atol=1e-6)


def test_train_scan_matches_repeated_steps():
    _, tm = _pair(p_dropout=0.1)
    tm2 = pt.DecoderLM(*MODEL[0], p_dropout=0.1, device="cpu", **MODEL[1])
    tm2.load_state_dict(tm.state_dict())
    batches = [_batch(seed=20 + i) for i in range(3)]
    tok, tgt, msk = (np.stack(x) for x in zip(*batches))
    opt = pt.Adam(lr=1e-3)
    scan = pt.make_train_scan(opt, grad_clip=1.0)
    tm, _, losses = scan(tm, opt.init(tm), *_tt(tok, tgt, msk),
                         torch.Generator().manual_seed(5))
    step, state = pt.make_train_step(opt, grad_clip=1.0), opt.init(tm2)
    g = torch.Generator().manual_seed(5)
    for i, (a, b, c) in enumerate(batches):
        tm2, state, loss = step(tm2, state, *_tt(a, b, c), g)
        _close(losses[i], loss, atol=0, rtol=0)
    p2 = dict(tm2.named_parameters())
    for name, p in tm.named_parameters():
        _close(p2[name].detach(), p.detach(), atol=0, rtol=0)


def test_eval_step_is_lm_loss_without_dropout():
    _, tm = _pair(p_dropout=0.5)
    tok, tgt, msk = _tt(*_batch(seed=6))
    tm.train()
    got = pt.make_eval_step()(tm, tok, tgt, msk)
    assert tm.training                         # mode restored
    with torch.no_grad():
        want = pt.lm_loss(tm.eval(), tok, tgt, msk)
    _close(got, want, atol=0, rtol=0)


# -- dropout threading and remat -----------------------------------------------


def test_model_dropout_threading():
    """Train mode with p 0.1 and a generator drops (differs from eval),
    reproducibly from the generator's seed; eval mode ignores it."""
    _, tm = _pair(p_dropout=0.1)
    tok = torch.from_numpy(_batch()[0])
    gen = lambda s: torch.Generator().manual_seed(s)
    with torch.no_grad():
        ref = tm.eval()(tok, generator=gen(1))
        assert torch.equal(ref, tm(tok))
        tm.train()
        a, b, c = tm(tok, gen(1)), tm(tok, gen(1)), tm(tok, gen(2))
    assert not torch.allclose(a, ref, atol=1e-3)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c, atol=1e-3)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_gradients_match(policy):
    """Checkpointed layers recompute the same dropout masks (seeds drawn up
    front), so remat changes no gradient."""
    _, tm = _pair(p_dropout=0.1)
    tr = pt.DecoderLM(*MODEL[0], p_dropout=0.1, device="cpu", remat=True,
                      remat_policy=policy, **MODEL[1])
    tr.load_state_dict(tm.state_dict())
    tok, tgt, msk = _tt(*_batch(seed=7))
    grads = []
    for m in (tm, tr):
        loss = pt.lm_loss(m.train(), tok, tgt, msk,
                          torch.Generator().manual_seed(9))
        grads.append(torch.autograd.grad(loss, list(m.parameters())))
    for a, b in zip(*grads):
        _close(b, a, atol=1e-6, rtol=1e-6)


def test_default_device_is_cuda():
    """An entry point runs on the card unless the caller asks for the CPU:
    without a GPU, DecoderLM() raises instead of building on the CPU."""
    if torch.cuda.is_available():
        m = pt.DecoderLM(64, 32, 4, 32, n_layer=1)
        assert next(m.parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            pt.DecoderLM(64, 32, 4, 32, n_layer=1)
    with pytest.raises(ValueError):
        pt.DecoderLM(64, 32, 4, 32, n_layer=1, device="cpu",
                     remat_policy="everything")
