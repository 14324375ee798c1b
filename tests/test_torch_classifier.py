"""The port's toy classifier against the JAX package's (mirrors
tests/test_neural_network.py), and the threefry ``split`` / ``uniform``
that give it JAX's initial weights.

Gates: ``split`` / ``uniform`` equal to ``jax.random``'s bit for bit;
``Network``'s initial weights equal to JAX's for the same seed, its
forward within 1e-6; ``binary_nll`` within 1e-6; ten full-batch SGD steps'
losses and parameters within 1e-5 (f32, the same ops in XLA's order and
PyTorch's); ``train_classifier``'s accuracy equal to JAX's at the JAX
tests' arguments, its final loss within 1e-4 relative.  Everything runs on
the CPU (``device="cpu"``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu_torch as pt
from flashattn_tpu.training import classifier as jc
from flashattn_tpu_torch.serving import _threefry
from flashattn_tpu_torch.training.classifier import Network, binary_nll, train_classifier
from flashattn_tpu_torch.utils.datasets import datasets

SEEDS = [0, 1, 3, 42, 2**31 - 1]


def _key(seed):
    return _threefry.prng_key(torch.tensor(seed))


def _jax_params(net):
    return {n: np.asarray(a) for n, a in net.named_parameters()}


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_split_and_uniform_match_jax(seed):
    k0, k1 = _threefry.split(_key(seed), 4)
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), 4))
    np.testing.assert_array_equal(np.stack([k0, k1], -1), want.astype(np.int64))
    for i, (shape, lo, hi) in enumerate([((3, 7), -0.5, 0.5), ((11,), 0.0, 1.0),
                                         ((2, 3, 4), -1.0, 3.5), (5, -2.0, -1.0)]):
        got = _threefry.uniform((k0[i], k1[i]), shape, lo, hi).numpy()
        ref = np.asarray(jax.random.uniform(jnp.asarray(want[i]), np.shape(
            np.empty(shape)), minval=lo, maxval=hi))
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_linear_forward_shape_and_determinism():
    """Linear's seeded init: the same generator gives the same weights, drawn
    from U(-1/sqrt(in), 1/sqrt(in)) (reference modules_basic.py:107-157)."""
    lin = pt.Linear(50, 5, generator=torch.Generator().manual_seed(42), device="cpu")
    x = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    out = lin(x)
    assert out.shape == (3, 5)
    lin2 = pt.Linear(50, 5, generator=torch.Generator().manual_seed(42), device="cpu")
    torch.testing.assert_close(out, lin2(x), rtol=0, atol=0)
    bound = 1.0 / np.sqrt(50)
    assert lin.weights.abs().max().item() <= bound + 1e-6


@pytest.mark.parametrize("seed", [1, 7])
def test_network_forward_in_unit_interval(seed):
    net = Network(8, key=_key(seed), device="cpu")
    jnet = jc.Network(8, key=jax.random.PRNGKey(seed))
    want = _jax_params(jnet)
    for n, p in net.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[n])
    x = np.array(jax.random.uniform(jax.random.PRNGKey(2), (17, 2)))
    p = net(torch.from_numpy(x))
    assert p.shape == (17,)
    assert p.min().item() >= 0.0 and p.max().item() <= 1.0
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jnet(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_binary_nll_gradient_direction():
    p, y = torch.tensor([0.9, 0.1]), torch.tensor([1.0, 0.0])
    assert float(binary_nll(p, y)) < float(binary_nll(1.0 - p, y))
    rng = np.random.default_rng(0)
    probs = np.concatenate([rng.uniform(0, 1, 30), [0.0, 1.0, 1e-9]]).astype(np.float32)
    labels = rng.integers(0, 2, probs.shape).astype(np.float32)
    np.testing.assert_allclose(
        float(binary_nll(torch.from_numpy(probs), torch.from_numpy(labels))),
        float(jc.binary_nll(jnp.asarray(probs), jnp.asarray(labels))), rtol=1e-6)


def test_sgd_steps_match_jax():
    """Ten full-batch SGD steps from JAX's weights: the losses and the
    parameters after them within 1e-5."""
    g = datasets["Xor"](40, seed=0)
    X, y = np.asarray(g.X, np.float32), np.asarray(g.y, np.float32)
    net = Network(6, key=_key(0), device="cpu")
    jnet = jc.Network(6, key=jax.random.PRNGKey(0))
    opt, jopt = pt.SGD(lr=0.5), jc.SGD(lr=0.5)
    names, params = zip(*net.named_parameters())
    Xt, yt, Xj, yj = torch.from_numpy(X), torch.from_numpy(y), jnp.asarray(X), jnp.asarray(y)
    for _ in range(10):
        loss = binary_nll(net(Xt), yt)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        net, _ = opt.step(net, grads, ())
        jloss, jg = jax.value_and_grad(lambda m: jc.binary_nll(m(Xj), yj))(jnet)
        jnet, _ = jopt.step(jnet, jg, ())
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    want = _jax_params(jnet)
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-5, atol=1e-5)


def _trained_matches_jax(args):
    """(accuracy, final loss) of the port and of JAX for the same call."""
    model, acc = train_classifier(*args, device="cpu")
    jmodel, jacc = jc.train_classifier(*args)
    g = datasets[args[0]](args[1], seed=args[5])
    X, y = np.asarray(g.X, np.float32), np.asarray(g.y, np.float32)
    with torch.no_grad():
        loss = float(binary_nll(model(torch.from_numpy(X)), torch.from_numpy(y)))
    jloss = float(jc.binary_nll(jmodel(jnp.asarray(X)), jnp.asarray(y)))
    n = args[1]
    assert round(acc * n) == round(jacc * n), (acc, jacc)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    return acc


def test_trains_simple_dataset():
    acc = _trained_matches_jax(("Simple", 60, 6, 0.5, 250, 3))
    assert acc >= 0.95, f"Simple should be nearly separable, got {acc}"


def test_trains_xor_dataset():
    acc = _trained_matches_jax(("Xor", 60, 12, 0.5, 600, 0))
    assert acc >= 0.85, f"Xor accuracy too low: {acc}"
