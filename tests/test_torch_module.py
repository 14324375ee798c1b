"""The port's Module base and functional nn ops against the JAX package's
(mirrors tests/test_module.py and tests/test_nn.py).

Weights and inputs come from the JAX side (its seeded keys, as numpy
arrays) and go to both packages.  Gates: forward outputs within 1e-6 (f32,
the same ops in another summation order); Adam's 20-step loss within 1e-5
relative; the functional ops within 1e-6 of JAX's and their gradients
checked by the port's ``grad_check``.  ``Module`` keeps torch's meaning for
``named_parameters`` (registration order), ``modules()`` (self first) and
``train()`` / ``eval()`` (in place), which the mirrors state.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu_torch import F
from flashattn_tpu_torch.autodiff import grad_check
from flashattn_tpu_torch.module import Module, Parameter, map_module_tree, tree_arrays


class JaxMLP(ft.Module):
    def __init__(self, key):
        k1, k2 = jax.random.split(key)
        self.l1 = ft.Linear(4, 8, key=k1)
        self.l2 = ft.Linear(8, 2, key=k2)
        self.scale = 2.0  # static

    def forward(self, x):
        return self.l2(jnp.tanh(self.l1(x))) * self.scale


class MLP(Module):
    def __init__(self, jax_model=None):
        super().__init__()
        self.l1 = pt.Linear(4, 8, device="cpu")
        self.l2 = pt.Linear(8, 2, device="cpu")
        self.scale = 2.0
        if jax_model is not None:
            pt.load_jax_params(self, {n: np.asarray(a) for n, a
                                      in jax_model.named_parameters()})

    def forward(self, x):
        return self.l2(torch.tanh(self.l1(x))) * self.scale


def _pair(seed=0):
    jm = JaxMLP(jax.random.PRNGKey(seed))
    return MLP(jm), jm


# -- test_module.py -------------------------------------------------------------


def test_named_parameters():
    m, jm = _pair()
    names = [n for n, _ in m.named_parameters()]
    # torch's registration order; JAX sorts by attribute
    assert names == ["l1.weights", "l1.bias", "l2.weights", "l2.bias"]
    assert sorted(names) == [n for n, _ in jm.named_parameters()]
    assert m.num_parameters() == jm.num_parameters() == 4 * 8 + 8 + 8 * 2 + 2


def test_modules_walk():
    m, jm = _pair()
    # torch's modules() yields the module itself first; JAX lists the two
    # submodules
    assert list(m.modules())[0] is m
    assert len(list(m.modules())[1:]) == len(jm.modules()) == 2


def test_train_eval_functional():
    m, _ = _pair()
    assert m.training
    e = copy.deepcopy(m).eval()   # JAX's eval() returns a new module
    assert not e.training and m.training  # original untouched
    assert not e.l1.training
    t = e.train()
    assert t is e and t.training and t.l2.training


def test_pytree_roundtrip():
    """The port's counterpart of a pytree round trip: a state dict loaded
    into a fresh module, and an identity map_module_tree, both give the
    same outputs."""
    m, jm = _pair()
    x = np.ones((3, 4), np.float32)
    m2 = MLP()
    m2.load_state_dict(m.state_dict())
    m3 = map_module_tree(m, lambda mod: mod)
    assert isinstance(m3, MLP) and m3 is not m and m3.scale == 2.0
    want = np.asarray(jm(jnp.asarray(x)))
    for mod in (m, m2, m3):
        np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(),
                                   want, rtol=1e-6, atol=1e-6)


def test_jit_and_grad_through_module():
    m, jm = _pair()
    x = np.ones((3, 4), np.float32)
    loss = torch.sum(m(torch.from_numpy(x)) ** 2)
    grads = dict(zip([n for n, _ in m.named_parameters()],
                     torch.autograd.grad(loss, list(m.parameters()))))
    assert grads["l1.weights"].shape == m.l1.weights.shape
    assert float(grads["l2.weights"].abs().sum()) > 0
    jg = jax.grad(lambda mod: jnp.sum(mod(jnp.asarray(x)) ** 2))(jm)
    for n, g in jg.named_parameters():
        np.testing.assert_allclose(grads[n].numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-6)


def test_optimizer_reduces_loss():
    m, jm = _pair()
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (16, 4)))
    y = np.array(jax.random.normal(jax.random.PRNGKey(2), (16, 2)))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def loss_fn(model):
        return torch.mean((model(xt) - yt) ** 2)

    opt = pt.Adam(lr=1e-2)
    state = opt.init(m)
    l0 = loss_fn(m).item()
    names, params = zip(*m.named_parameters())
    for _ in range(20):
        g = torch.autograd.grad(loss_fn(m), params)
        m, state = opt.step(m, dict(zip(names, g)), state)
    assert loss_fn(m).item() < l0 * 0.9

    def jloss(model):
        return jnp.mean((model(jnp.asarray(x)) - jnp.asarray(y)) ** 2)

    jopt = ft.Adam(lr=1e-2)
    jstate = jopt.init(jm)
    for _ in range(20):
        jm, jstate = jopt.step(jm, jax.grad(jloss)(jm), jstate)
    np.testing.assert_allclose(loss_fn(m).item(), float(jloss(jm)), rtol=1e-5)


def test_replace():
    m, _ = _pair()
    m2 = m.replace(scale=3.0)
    assert m2.scale == 3.0 and m.scale == 2.0
    lin = pt.Linear(4, 8, device="cpu")
    m3 = m.replace(l1=lin)
    assert m3.l1 is lin and m.l1 is not lin and m3.l2 is m.l2
    assert [n for n, _ in m3.named_parameters()] == \
        [n for n, _ in m.named_parameters()]


def test_map_module_tree_post_order_and_tree_arrays():
    """map_module_tree visits children before parents, hands ``fn`` copies
    and leaves the input alone; tree_arrays lists parameters and buffers
    (the JAX helpers' roles)."""
    m, _ = _pair()
    seen = []

    def fn(mod):
        seen.append(type(mod).__name__)
        if isinstance(mod, pt.Linear):
            mod.scaled = True
        return mod

    out = map_module_tree({"a": [m], "b": (1,)}, fn)
    assert seen == ["Linear", "Linear", "MLP"]
    assert out["b"] == (1,) and out["a"][0].l1.scaled
    assert not hasattr(m.l1, "scaled")
    m.register_buffer("steps", torch.zeros(3))
    assert len(tree_arrays(m)) == 5 and tree_arrays({"x": [torch.ones(2)]})[0].shape == (2,)
    p = Parameter(np.ones(3), name="w")
    p.update(torch.zeros(2))
    assert p.name == "w" and p.value.shape == (2,)


# -- test_nn.py -----------------------------------------------------------------


def _rand(shape, seed=0, scale=1.0):
    """JAX's seeded normal draw as numpy, for both packages."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape) * scale)


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


def test_softmax_sums_to_one():
    x = _rand((4, 7), 1, 3.0)
    s = F.softmax(torch.from_numpy(x), 1)
    np.testing.assert_allclose(s.sum(1).numpy(), 1.0, rtol=1e-5)
    _close(s, F.softmax(torch.from_numpy(x) + 100.0, 1), 1e-5)
    _close(s, ft.F.softmax(jnp.asarray(x), 1))


def test_logsoftmax_matches_log_of_softmax():
    x = _rand((5, 6), 2, 2.0)
    got = F.logsoftmax(torch.from_numpy(x), 1)
    _close(got, torch.log(F.softmax(torch.from_numpy(x), 1)), 1e-5)
    _close(got, ft.F.logsoftmax(jnp.asarray(x), 1))


def test_logsumexp_keepdims_and_stability():
    x = _rand((3, 9), 3, 1.0) + 1000.0  # overflow for naive exp
    out = F.logsumexp(torch.from_numpy(x), 1)
    assert out.shape == (3, 1)
    ref = np.log(np.sum(np.exp(x.astype(np.float64) - 1000.0), axis=1,
                        keepdims=True)) + 1000.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    _close(out, ft.F.logsumexp(jnp.asarray(x), 1))


def test_softmax_loss_matches_manual():
    logits = _rand((8, 11), 4, 2.0)
    target = np.array(jax.random.randint(jax.random.PRNGKey(5), (8,), 0, 11))
    loss = F.softmax_loss(torch.from_numpy(logits), torch.from_numpy(target))
    assert loss.shape == (8,)
    lg = logits.astype(np.float64)
    manual = np.log(np.exp(lg).sum(1)) - lg[np.arange(8), target]
    np.testing.assert_allclose(loss.numpy(), manual, rtol=1e-4)
    assert np.all(loss.numpy() >= 0.0)
    _close(loss, ft.F.softmax_loss(jnp.asarray(logits), jnp.asarray(target)),
           1e-5)


def test_gelu_tanh_approx_values():
    x = np.asarray([-2.0, -1.0, 0.0, 0.5, 1.0, 3.0], np.float32)
    got = F.GELU(torch.from_numpy(x)).numpy()
    xd = x.astype(np.float64)
    expected = 0.5 * xd * (1 + np.tanh(np.sqrt(2 / np.pi) * (xd + 0.044715 * xd**3)))
    np.testing.assert_allclose(got, expected, atol=1e-5)
    assert got[2] == 0.0
    np.testing.assert_allclose(got[-1], 3.0, atol=5e-3)
    np.testing.assert_allclose(got, np.asarray(ft.F.GELU(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_one_hot():
    idx = np.asarray([[0, 2], [1, 1]])
    oh = F.one_hot(torch.from_numpy(idx), 3)
    assert oh.shape == (2, 2, 3)
    np.testing.assert_array_equal(oh.numpy(), np.eye(3)[idx].astype(np.float32))
    np.testing.assert_array_equal(oh.numpy(),
                                  np.asarray(ft.F.one_hot(jnp.asarray(idx), 3)))


def test_max_and_argmax():
    x = _rand((2, 3, 5), 6)
    m = F.max(torch.from_numpy(x), 2)
    assert m.shape == (2, 3, 1)
    np.testing.assert_array_equal(m.numpy(), np.max(x, axis=2, keepdims=True))
    am = F.argmax(torch.from_numpy(x), 2)
    assert am.numpy().sum(axis=2).min() >= 1
    np.testing.assert_array_equal(am.numpy(),
                                  np.asarray(ft.F.argmax(jnp.asarray(x), 2)))


@pytest.mark.parametrize("pool", ["avgpool2d", "maxpool2d"])
def test_pool2d(pool):
    x = _rand((2, 3, 8, 6), 7)
    out = getattr(F, pool)(torch.from_numpy(x), (2, 3))
    assert out.shape == (2, 3, 4, 2)
    xn = x.reshape(2, 3, 4, 2, 2, 3).transpose(0, 1, 2, 4, 3, 5).reshape(2, 3, 4, 2, 6)
    ref = xn.mean(-1) if pool == "avgpool2d" else xn.max(-1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    _close(out, getattr(ft.F, pool)(jnp.asarray(x), (2, 3)))


def test_dropout_modes():
    """The port's dropout takes an integer seed where JAX's takes a key:
    the masks differ, the semantics are JAX's."""
    x = torch.ones((100, 100))
    torch.testing.assert_close(F.dropout(x, 0.5, 0, ignore=True), x)
    torch.testing.assert_close(F.dropout(x, 0.0, 0), x)
    torch.testing.assert_close(F.dropout(x, 0.5, None), x)
    out = F.dropout(x, 0.3, 0, scale=True).numpy()
    kept = out > 0
    assert 0.6 < kept.mean() < 0.8
    # JAX divides by the weakly typed 1 - rate: f32(1 / 0.7) to 1e-5 here
    np.testing.assert_allclose(out[kept], 1.0 / 0.7, rtol=1e-5)
    unscaled = F.dropout(x, 0.3, 0, scale=False).numpy()
    np.testing.assert_array_equal(unscaled > 0, kept)
    np.testing.assert_array_equal(unscaled[kept], 1.0)


def test_grad_check_functionals():
    x = torch.from_numpy(_rand((3, 4), 8))
    grad_check(lambda a: F.softmax(a, 1), x, n_samples=5, tol=1e-2, epsilon=1e-3)
    grad_check(F.GELU, x, n_samples=5, tol=1e-2, epsilon=1e-3)
    grad_check(lambda a: F.logsumexp(a, 1), x, n_samples=5, tol=1e-2, epsilon=1e-3)


def test_dropout_res_bias():
    """Fused residual + dropout(x + bias): the unfused composition with the
    same seed; the identity wiring at rate 0 / without a seed."""
    x, b, r = (torch.from_numpy(_rand(s, i)) for s, i in
               (((64, 32), 1), ((32,), 2), ((64, 32), 3)))
    torch.testing.assert_close(F.dropout_res_bias(x, b, r, 0.0, 3), r + (x + b),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(F.dropout_res_bias(x, b, r, 0.5, None), r + (x + b),
                               rtol=1e-6, atol=1e-6)
    want = r + F.dropout(x + b, 0.3, 3)
    got = F.dropout_res_bias(x, b, r, 0.3, 3)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((F.dropout_res_bias(xg, b, r, 0.3, 3) ** 2).sum(), xg)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_dropout_act_bias(act):
    """Fused dropout(act(x + bias))."""
    x, b = torch.from_numpy(_rand((64, 32), 4)), torch.from_numpy(_rand((32,), 5))
    act_fn = F.GELU if act == "gelu" else torch.relu
    torch.testing.assert_close(F.dropout_act_bias(x, b, 0.0, 4, act=act),
                               act_fn(x + b), rtol=1e-6, atol=1e-6)
    want = F.dropout(act_fn(x + b), 0.25, 4)
    got = F.dropout_act_bias(x, b, 0.25, 4, act=act)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    xg = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((F.dropout_act_bias(xg, b, 0.25, 4, act=act) ** 2).sum(), xg)
    assert torch.isfinite(g).all()
