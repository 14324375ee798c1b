"""The port's dropout-with-bias entry points and the rest of nn.functional
against the JAX package's, on the CPU.

At rate 0 or without a seed both packages compute the plain composition,
so values and gradients are compared with JAX to float32 rounding (atol
1e-6, gradients 1e-5).  At rate > 0 the masks cannot match across
frameworks (the port draws Philox4x32-10 bits, JAX its own generator), so
the port is held to the plain composition under its own ``keep_mask``: the
forward to float32 rounding (bit for bit where the arithmetic is the same),
and the hand-written backward (the plain version of the backward kernel,
which a CPU tensor runs) against ``torch.autograd`` of that composition.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu_torch as pt
from flashattn_tpu.nn import functional as jF
from flashattn_tpu.ops import dropout as jdr
from flashattn_tpu_torch.ops import dropout as dr

torch.set_num_threads(1)

SEED = 0xC0FFEE1234567
# (leading shape, d): d not a multiple of 4 or 8, one row, leading dims
SHAPES = [((16,), 128), ((9,), 7), ((1,), 33), ((2, 3), 20)]


def _data(lead, d, seed=0):
    rng = np.random.default_rng(seed)
    x, r = (rng.standard_normal(lead + (d,)).astype(np.float32)
            for _ in range(2))
    b = rng.standard_normal(d).astype(np.float32)
    return x, b, r


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _plain_act(u, act):
    c = math.sqrt(2.0 / math.pi)
    if act == "gelu":
        return 0.5 * u * (1.0 + torch.tanh(c * (u + 0.044715 * u**3)))
    return torch.relu(u)


# -- rate 0 / no seed: JAX parity -------------------------------------------


@pytest.mark.parametrize("rate, seed", [(0.0, SEED), (0.3, None)])
@pytest.mark.parametrize("lead, d", SHAPES)
def test_res_bias_plain_matches_jax(lead, d, rate, seed):
    x, b, r = _data(lead, d)
    xt, bt, rt = _t(x, b, r, grad=True)
    got = pt.fused_dropout_res_bias(xt, bt, rt, rate, seed)
    key = None if seed is None else jax.random.PRNGKey(1)
    fn = lambda a, bb, rr: jdr.fused_dropout_res_bias(a, bb, rr, rate, key)
    np.testing.assert_allclose(got.detach().numpy(), fn(x, b, r), atol=1e-6)
    gy = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    grads = torch.autograd.grad(got, (xt, bt, rt), torch.from_numpy(gy))
    want = jax.grad(lambda *a: jnp.sum(fn(*a) * gy), argnums=(0, 1, 2))(x, b, r)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


@pytest.mark.parametrize("rate, seed", [(0.0, SEED), (0.3, None)])
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("lead, d", SHAPES[:2])
def test_act_bias_plain_matches_jax(lead, d, act, rate, seed):
    x, b, _ = _data(lead, d, seed=1)
    xt, bt = _t(x, b, grad=True)
    got = pt.fused_dropout_act_bias(xt, bt, rate, seed, act)
    key = None if seed is None else jax.random.PRNGKey(2)
    fn = lambda a, bb: jdr.fused_dropout_act_bias(a, bb, rate, key, act)
    np.testing.assert_allclose(got.detach().numpy(), fn(x, b), atol=1e-6)
    gy = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    grads = torch.autograd.grad(got, (xt, bt), torch.from_numpy(gy))
    want = jax.grad(lambda *a: jnp.sum(fn(*a) * gy), argnums=(0, 1))(x, b)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


def test_functional_entry_points_match_jax():
    x, b, r = _data((8,), 24, seed=2)
    xt, bt, rt = _t(x, b, r)
    np.testing.assert_allclose(pt.F.dropout_res_bias(xt, bt, rt, 0.0).numpy(),
                               jF.dropout_res_bias(x, b, r, 0.0), atol=1e-6)
    for act in ("gelu", "relu"):
        np.testing.assert_allclose(
            pt.F.dropout_act_bias(xt, bt, 0.2, None, act).numpy(),
            jF.dropout_act_bias(x, b, 0.2, None, act), atol=1e-6)


# -- rate > 0: the plain composition under the port's own mask ---------------


def _keep(shape, rate, seed):
    return dr.keep_mask(math.prod(shape), rate, seed).reshape(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead, d", SHAPES)
def test_res_bias_forward_and_backward(lead, d, dtype):
    x, b, r = _data(lead, d, seed=3)
    rate = 0.25
    scale = torch.tensor(1 / (1 - rate), dtype=torch.float32)
    keep = _keep(x.shape, rate, SEED)
    xt, bt, rt = (t.to(dtype).requires_grad_() for t in _t(x, b, r))
    got = pt.fused_dropout_res_bias(xt, bt, rt, rate, SEED)
    assert got.dtype == dtype and got.shape == x.shape
    # JAX's rounding (tests/test_torch_faults.py): x + b, the quotient by
    # 1 - rate in the dtype, then r + it, each rounded to the dtype
    div = torch.tensor(float(torch.tensor(1 - rate, dtype=dtype)))
    u = (xt.float() + bt.float()).to(dtype).float()
    y = torch.where(keep, (u / div).to(dtype).float(), torch.zeros(()))
    want = rt.float() + y
    assert torch.equal(got, want.to(dtype))        # same arithmetic, bit for bit
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    gy = gy.to(dtype)
    grads = torch.autograd.grad(got, (xt, bt, rt), gy)
    xf, bf, rf = (t.detach().float().requires_grad_() for t in (xt, bt, rt))
    comp = rf + torch.where(keep, (xf + bf) * scale, torch.zeros(()))
    want = torch.autograd.grad(comp, (xf, bf, rf), gy.float())
    for g, w, t in zip(grads, want, (xt, bt, rt)):
        assert g.dtype == t.dtype and g.shape == t.shape
        tol = 1e-6 if dtype == torch.float32 else 2e-2 * max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("lead, d", SHAPES)
def test_act_bias_forward_and_backward(lead, d, act, dtype):
    x, b, _ = _data(lead, d, seed=5)
    rate = 0.4
    scale = torch.tensor(1 / (1 - rate), dtype=torch.float32)
    keep = _keep(x.shape, rate, SEED)
    xt, bt = (t.to(dtype).requires_grad_() for t in _t(x, b))
    got = pt.fused_dropout_act_bias(xt, bt, rate, SEED, act)
    assert got.dtype == dtype and got.shape == x.shape
    xf, bf = (t.detach().float().requires_grad_() for t in (xt, bt))
    comp = torch.where(keep, _plain_act(xf + bf, act) * scale, torch.zeros(()))
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    assert not got[~keep].any()
    np.testing.assert_allclose(got.detach().float().numpy(),
                               comp.detach().numpy(), atol=tol, rtol=tol)
    gy = torch.randn(x.shape, generator=torch.Generator().manual_seed(6))
    grads = torch.autograd.grad(got, (xt, bt), gy.to(dtype))
    want = torch.autograd.grad(comp, (xf, bf), gy)
    for g, w, t in zip(grads, want, (xt, bt)):
        assert g.dtype == t.dtype and g.shape == t.shape
        gtol = (1e-5 if dtype == torch.float32 else 2e-2) * max(
            1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), atol=gtol)


def test_same_stream_as_fused_dropout():
    """Zero bias and residual: the res-bias mask is fused_dropout's, element
    for element (one Philox stream keyed by the seed)."""
    x = torch.randn(37, 29, generator=torch.Generator().manual_seed(7))
    zeros = torch.zeros(29)
    got = pt.fused_dropout_res_bias(x, zeros, torch.zeros_like(x), 0.3, SEED)
    assert torch.equal(got, pt.fused_dropout(x, 0.3, SEED))
    relu = pt.fused_dropout_act_bias(x.abs() + 1, zeros, 0.3, SEED, "relu")
    assert torch.equal(relu != 0, pt.fused_dropout(x, 0.3, SEED) != 0)


def test_keep_fraction_and_seed_dependence():
    x = torch.ones(256, 256)
    b = torch.zeros(256)
    a = pt.fused_dropout_res_bias(x, b, torch.zeros_like(x), 0.1, 1)
    keep = float((a != 0).float().mean())
    assert abs(keep - 0.9) < 0.01
    c = pt.fused_dropout_res_bias(x, b, torch.zeros_like(x), 0.1, 2)
    assert not torch.equal(a, c)


def test_checks():
    x, b = torch.zeros(8, 128), torch.zeros(128)
    with pytest.raises(ValueError):
        pt.fused_dropout_act_bias(x, b, 0.1, 0, "swish")
    with pytest.raises(ValueError):
        pt.fused_dropout_act_bias(x, b, 0.0, 0, "swish")
    with pytest.raises(ValueError):
        pt.fused_dropout_res_bias(x, torch.zeros(127), x, 0.1, 0)
    with pytest.raises(ValueError):
        pt.fused_dropout_res_bias(x, b, x, 1.0, 0)


# -- the rest of nn.functional ------------------------------------------------


@pytest.mark.parametrize("name", ["max", "argmax", "softmax", "logsoftmax",
                                  "logsumexp"])
@pytest.mark.parametrize("dim", [0, -1])
def test_reductions_match_jax(name, dim):
    x = np.random.default_rng(8).standard_normal((5, 7)).astype(np.float32)
    x[2, 3] = x[2].max() + 1.0               # a unique max in that row
    got = getattr(pt.F, name)(torch.from_numpy(x), dim)
    np.testing.assert_allclose(got.numpy(), getattr(jF, name)(x, dim),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["avgpool2d", "maxpool2d"])
@pytest.mark.parametrize("kernel", [(2, 2), (1, 3), (4, 1)])
def test_pooling_matches_jax(name, kernel):
    x = np.random.default_rng(9).standard_normal((2, 3, 8, 6)).astype(
        np.float32)
    got = getattr(pt.F, name)(torch.from_numpy(x), kernel)
    np.testing.assert_allclose(got.numpy(), getattr(jF, name)(x, kernel),
                               atol=1e-6)


def test_tile_and_layer_norm_match_jax():
    x = np.random.default_rng(10).standard_normal((2, 3, 4, 6)).astype(
        np.float32)
    got, nh, nw = pt.F.tile(torch.from_numpy(x), (2, 3))
    want, jh, jw = jF.tile(x, (2, 3))
    assert (nh, nw) == (jh, jw)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        pt.F.tile(torch.from_numpy(x), (3, 3))
    for axis in (-1, 1):
        np.testing.assert_allclose(
            pt.F.layer_norm(torch.from_numpy(x), 1e-5, axis).numpy(),
            jF.layer_norm(x, 1e-5, axis), atol=1e-5)
