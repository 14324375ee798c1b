"""The port's scalar prelude, scalar tape engine and op tables against the
JAX package's (mirrors tests/test_operators.py, test_scalar.py and
test_tensor_general.py).

Inputs come from numpy (or hypothesis) and go to both packages.  Gates:
float32 results within 2 ulps of JAX's (subnormals flushed to zero first,
as XLA flushes them); on Python floats, where both modules apply Python's
own operators, equal; the scalar engine's derivatives equal to JAX's
module's; ``grad_check``'s (argument, index) draws equal to JAX's for the
same numpy generator, and a wrong ``autograd.Function`` backward made to
fail.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flashattn_tpu import autodiff as jad
from flashattn_tpu import operators as jops
from flashattn_tpu import scalar as jsc
from flashattn_tpu import testing as jtesting
from flashattn_tpu_torch import operators
from flashattn_tpu_torch.autodiff import grad_check
from flashattn_tpu_torch.scalar import (
    Scalar,
    backpropagate,
    central_difference,
    derivative_check,
    topological_sort,
)
from flashattn_tpu_torch.testing import ONE_ARG, RED_ARG, TWO_ARG, comp_testing

small_floats = st.floats(
    min_value=-100, max_value=100, allow_nan=False, width=32, allow_subnormal=False
)


def _ulps(got, want, n=2):
    """float32 arrays within ``n`` ulps, subnormals flushed to zero."""
    tiny = np.finfo(np.float32).tiny
    got, want = (np.where(np.abs(a) < tiny, 0.0, a).astype(np.float32)
                 for a in (np.asarray(got, np.float32), np.asarray(want, np.float32)))
    np.testing.assert_array_max_ulp(got, want, maxulp=n)


# -- test_operators.py ----------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(small_floats, small_floats)
def test_same_as_python(x: float, y: float) -> None:
    np.testing.assert_allclose(float(operators.mul(x, y)), x * y, rtol=1e-5)
    np.testing.assert_allclose(float(operators.add(x, y)), x + y, rtol=1e-5)
    np.testing.assert_allclose(float(operators.neg(x)), -x, rtol=1e-5)
    np.testing.assert_allclose(float(operators.max(x, y)), max(x, y), rtol=1e-5)
    if abs(x) > 1e-5:
        np.testing.assert_allclose(float(operators.inv(x)), 1.0 / x, rtol=1e-4)
    # the same as JAX's module on Python floats
    for name, args in (("mul", (x, y)), ("add", (x, y)), ("neg", (x,)),
                       ("max", (x, y)), ("lt", (x, y)), ("eq", (x, x))):
        assert float(getattr(operators, name)(*args)) == \
            float(getattr(jops, name)(*args)), name


@settings(max_examples=25, deadline=None)
@given(small_floats)
def test_relu(a: float) -> None:
    assert float(operators.relu(a)) == (a if a > 0 else 0.0)
    assert float(operators.relu(a)) == float(jops.relu(a))


@settings(max_examples=25, deadline=None)
@given(small_floats, small_floats)
def test_relu_back(a: float, b: float) -> None:
    expected = b if a > 0 else 0.0
    got = operators.relu_back(a, torch.tensor(b, dtype=torch.float32))
    assert float(got) == pytest.approx(expected)
    assert float(got) == float(jops.relu_back(a, jnp.float32(b)))


@settings(max_examples=25, deadline=None)
@given(small_floats)
def test_sigmoid(a: float) -> None:
    """sigmoid in [0,1], 1-sig(x)=sig(-x), sig(0)=0.5, monotone."""
    s = float(operators.sigmoid(a))
    assert 0.0 <= s <= 1.0
    np.testing.assert_allclose(1.0 - s, float(operators.sigmoid(-a)), atol=1e-5)
    assert float(operators.sigmoid(0.0)) == pytest.approx(0.5)
    _ulps(s, float(jops.sigmoid(a)))


@settings(max_examples=25, deadline=None)
@given(st.floats(min_value=0.0625, max_value=80, width=32))  # exp(x) finite in f32
def test_log_exp(a: float) -> None:
    np.testing.assert_allclose(float(operators.log(operators.exp(a))), a, rtol=1e-4)
    _ulps(float(operators.exp(a)), float(jops.exp(a)))


@settings(max_examples=25, deadline=None)
@given(small_floats, small_floats, small_floats)
def test_transitive(a: float, b: float, c: float) -> None:
    if float(operators.lt(a, b)) and float(operators.lt(b, c)):
        assert float(operators.lt(a, c)) == 1.0


def test_hofs_on_arrays() -> None:
    xs = torch.tensor([1.0, 2.0, 3.0, 4.0])
    ys = torch.tensor([10.0, 20.0, 30.0, 40.0])
    np.testing.assert_allclose(operators.map(operators.neg)(xs), -xs.numpy())
    np.testing.assert_allclose(
        operators.zipWith(operators.add)(xs, ys), xs.numpy() + ys.numpy())
    assert float(operators.sum(xs)) == pytest.approx(10.0)
    assert float(operators.prod(xs)) == pytest.approx(24.0)
    # reduce over a tensor is JAX's lax.reduce over the flattened array
    x = np.random.default_rng(0).uniform(-2, 2, (3, 5, 7)).astype(np.float32)
    for fn, jfn, start in ((operators.add, jops.add, 0.0),
                           (operators.mul, jops.mul, 1.0),
                           (operators.max, jops.max, -math.inf)):
        got = operators.reduce(fn, start)(torch.from_numpy(x))
        _ulps(got.numpy(), np.asarray(jops.reduce(jfn, start)(jnp.asarray(x))))
    assert float(operators.reduce(operators.add, 3.0)(torch.zeros(0))) == 3.0


def test_hofs_on_lists() -> None:
    assert operators.negList([1.0, -2.0]) == [-1.0, 2.0]
    assert operators.addLists([1.0, 2.0], [3.0, 4.0]) == [4.0, 6.0]
    assert operators.sum([1.0, 2.0, 3.0]) == pytest.approx(6.0)
    assert operators.prod([2.0, 3.0]) == pytest.approx(6.0)
    for name, args in (("negList", ([1.5, -2.25],)),
                       ("addLists", ([1.0, 2.5], [3.0, 4.0])),
                       ("sum", ([0.1, 0.2, 0.3],)), ("prod", ([0.1, 3.0],))):
        assert getattr(operators, name)(*args) == getattr(jops, name)(*args)


def test_tanh_pow() -> None:
    np.testing.assert_allclose(float(operators.tanh(0.5)), math.tanh(0.5), rtol=1e-6)
    np.testing.assert_allclose(float(operators.pow(2.0, 10)), 1024.0)


PRELUDE_1 = ["neg", "sigmoid", "relu", "exp", "tanh", "inv", "sigmoid_prime"]
PRELUDE_2 = ["mul", "add", "lt", "eq", "max", "is_close", "sigmoid_back",
             "log_back", "inv_back", "relu_back", "pow"]


@pytest.mark.parametrize("name", PRELUDE_1 + PRELUDE_2 + ["log"])
def test_prelude_matches_jax_on_tensors(name):
    """Every function of the prelude on float32 tensors against JAX's
    module on the same arrays: within 2 ulps (the sigmoid's derivatives:
    see below)."""
    rng = np.random.default_rng(5)
    a = rng.uniform(-5, 5, (4, 6)).astype(np.float32)
    b = rng.uniform(-5, 5, (4, 6)).astype(np.float32)
    b[0, :3] = a[0, :3]                      # ties for eq / max / lt
    if name in ("log", "log_back", "pow"):
        a = np.abs(a) + 0.5
    args = (a,) if name in PRELUDE_1 + ["log"] else (a, b)
    got = getattr(operators, name)(*map(torch.from_numpy, args))
    want = getattr(jops, name)(*map(jnp.asarray, args))
    assert got.dtype == torch.float32
    if name in ("sigmoid_prime", "sigmoid_back"):
        # s * (1 - s): where s nears 1, 1 - s turns the two sigmoids' ulp
        # into many of the result's; hold the sigmoids to 2 ulps and the
        # result to what 2 ulps of s (at 1.0) can move it
        _ulps(operators.sigmoid(torch.from_numpy(a)).numpy(),
              np.asarray(jops.sigmoid(jnp.asarray(a))))
        d = np.abs(b) if name == "sigmoid_back" else 1.0
        slack = 2 * np.finfo(np.float32).eps * d
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= slack)
        return
    _ulps(got.numpy(), np.asarray(want))


# -- test_scalar.py -------------------------------------------------------------


def _both(fn, *vals):
    """Backpropagate ``fn`` through the port's and JAX's scalar engines from
    the same values; returns the two lists of derivatives."""
    out = []
    for mod in (None, jsc):
        cls = Scalar if mod is None else mod.Scalar
        xs = [cls(v) for v in vals]
        fn(*xs).backward()
        out.append([x.derivative for x in xs])
    return out


def test_forward_ops():
    a, b = Scalar(2.0), Scalar(3.0)
    assert (a + b).data == 5.0
    assert (a * b).data == 6.0
    assert (a - b).data == -1.0
    assert (a / b).data == pytest.approx(2 / 3)
    assert (-a).data == -2.0
    assert (a < b).data == 1.0
    assert (a > b).data == 0.0
    assert Scalar(1.0).exp().data == pytest.approx(math.e)
    assert Scalar(math.e).log().data == pytest.approx(1.0)
    assert Scalar(-1.0).relu().data == 0.0
    assert Scalar(0.0).sigmoid().data == 0.5
    assert (a / b).data == (jsc.Scalar(2.0) / jsc.Scalar(3.0)).data


def test_simple_backward():
    a, b = Scalar(2.0), Scalar(3.0)
    out = a * b + a
    out.backward()
    assert a.derivative == pytest.approx(4.0)  # b + 1
    assert b.derivative == pytest.approx(2.0)  # a


def test_chain_backward():
    x = Scalar(0.5)
    out = (x * 2.0 + 1.0).sigmoid().log()
    out.backward()
    num = central_difference(lambda s: (s * 2.0 + 1.0).sigmoid().log(), 0.5)
    assert x.derivative == pytest.approx(num, rel=1e-3)
    got, want = _both(lambda s: (s * 2.0 + 1.0).sigmoid().log(), 0.5)
    assert got == want


def test_diamond_graph_accumulates():
    x = Scalar(3.0)
    y = x * x  # dy/dx = 2x via two paths
    y.backward()
    assert x.derivative == pytest.approx(6.0)


def test_topological_sort_order():
    a = Scalar(1.0)
    b = a + 2.0
    c = b * b
    order = topological_sort(c)
    ids = [v.unique_id for v in order]
    assert ids.index(c.unique_id) < ids.index(b.unique_id) < ids.index(a.unique_id)
    backpropagate(c, 2.0)
    assert a.derivative == 12.0   # 2 * 2b


SCALAR_FNS = [
    lambda a, b: a + b,
    lambda a, b: a * b,
    lambda a, b: a / b,
    lambda a, b: (a * b).sigmoid(),
    lambda a, b: (a + b).relu() + a * b,
    lambda a, b: (a * a + b).log(),
]


@pytest.mark.parametrize("fn", SCALAR_FNS)
def test_derivative_check_two_args(fn):
    derivative_check(fn, Scalar(0.7), Scalar(1.3))
    got, want = _both(fn, 0.7, 1.3)
    assert got == want


def test_reused_subexpression():
    x = Scalar(1.5)
    h = x.sigmoid()
    out = h * h + h
    out.backward()
    num = central_difference(
        lambda s: (lambda t: t * t + t)(s.sigmoid()), 1.5)
    assert x.derivative == pytest.approx(num, rel=1e-3)
    got, want = _both(lambda s: (lambda t: t * t + t)(s.sigmoid()), 1.5)
    assert got == want


# -- test_tensor_general.py -----------------------------------------------------

one_ids = [c.name for c in ONE_ARG]
two_ids = [c.name for c in TWO_ARG]
red_ids = [c.name for c in RED_ARG]
JAX_CASES = {c.name: c for tab in jtesting.comp_testing() for c in tab}


def _sample(shape, seed):
    return np.random.default_rng(seed).uniform(-100, 100, size=shape).astype(np.float32)


def test_tables_match_jax():
    """The same case names, in the same order, and the same differentiability."""
    for mine, theirs in zip(comp_testing(), jtesting.comp_testing()):
        assert [(c.name, c.differentiable) for c in mine] == \
            [(c.name, c.differentiable) for c in theirs]


@pytest.mark.parametrize("case", ONE_ARG, ids=one_ids)
def test_one_arg_vs_oracle(case):
    x = _sample((2, 3), 1)
    got = case.fn(torch.from_numpy(x)).numpy()
    want = np.vectorize(case.oracle)(x.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    _ulps(got, np.asarray(jax.jit(JAX_CASES[case.name].fn)(jnp.asarray(x))))


@pytest.mark.parametrize("case", ONE_ARG, ids=one_ids)
def test_one_arg_derivative(case):
    assert case.differentiable
    grad_check(case.fn, torch.from_numpy(_sample((2, 3), 2)), n_samples=4,
               tol=1e-2, epsilon=1e-3)


@pytest.mark.parametrize("case", TWO_ARG, ids=two_ids)
def test_two_arg_vs_oracle(case):
    a, b = _sample((2, 3), 3), _sample((2, 3), 4)
    got = case.fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.vectorize(case.oracle)(a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    _ulps(got, np.asarray(jax.jit(JAX_CASES[case.name].fn)(jnp.asarray(a),
                                                            jnp.asarray(b))))


@pytest.mark.parametrize("case", [c for c in TWO_ARG if c.differentiable],
                         ids=[c.name for c in TWO_ARG if c.differentiable])
def test_two_arg_broadcast_grad(case):
    """Broadcast (2,3)x(3,) and check that the gradients reduce to the leaf
    shapes (the reference's ``Tensor.expand`` reduction)."""
    a = torch.from_numpy(_sample((2, 3), 5)).requires_grad_(True)
    b = torch.from_numpy(_sample((3,), 6)).requires_grad_(True)
    out = case.fn(a, b)
    assert out.shape == (2, 3)
    ga, gb = torch.autograd.grad(out.sum(), (a, b))
    assert ga.shape == a.shape and gb.shape == b.shape
    grad_check(case.fn, a.detach(), b.detach(), n_samples=4, tol=1e-2,
               epsilon=1e-3)


@pytest.mark.parametrize("case", RED_ARG, ids=red_ids)
def test_reduce_vs_oracle(case):
    # keep magnitudes small so prod_red stays finite in f32
    x = np.random.default_rng(7).uniform(-3, 3, size=(5, 4)).astype(np.float32)
    got = case.fn(torch.from_numpy(x)).numpy()
    want = np.array([case.oracle(list(x[:, j].astype(np.float64)))
                     for j in range(x.shape[1])])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    _ulps(got, np.asarray(jax.jit(JAX_CASES[case.name].fn)(jnp.asarray(x))))
    # reduce over a singleton dim is identity-shaped (reference :139-148)
    np.testing.assert_allclose(
        case.fn(torch.from_numpy(x[:1])).numpy(),
        np.array([case.oracle([float(v)]) for v in x[0]]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ONE_ARG, ids=one_ids)
def test_one_arg_matches_under_vmap(case):
    """vmap(f) equals f on the batched tensor (the reference's "many
    backends, one graph" invariant)."""
    x = torch.from_numpy(_sample((4, 5), 8))
    np.testing.assert_allclose(case.fn(x).numpy(),
                               torch.func.vmap(case.fn)(x).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_permute_grad():
    """Permute round-trips values and gradients (reference test_cuda_permute)."""
    x = torch.from_numpy(_sample((2, 3, 4), 9))
    perm = (2, 0, 1)
    y = x.permute(perm)
    assert y.shape == (4, 2, 3)
    np.testing.assert_allclose(y.permute(*np.argsort(perm).tolist()).numpy(),
                               x.numpy())
    grad_check(lambda a: a.permute(perm) * 2.0, x, n_samples=4, tol=1e-2,
               epsilon=1e-3)


@pytest.mark.parametrize("dims", [(2, 3, 4), (5, 7, 3), (1, 1, 1), (16, 16, 16)])
def test_matmul_vs_numpy(dims):
    """Matmul equals the numpy oracle (reference test_cuda_matmul_numpy_eq)."""
    m, n, p = dims
    a, b = _sample((m, n), 10), _sample((n, p), 11)
    got = torch.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(
        got, a.astype(np.float64) @ b.astype(np.float64), rtol=1e-3, atol=1e-2)


def test_bmm_broadcast_and_transpose():
    """Batched matmul with broadcast batch dims + a transposed operand
    (reference test_bmm, test_cuda_matmul_transpose)."""
    a, b = _sample((2, 1, 3, 4), 12), _sample((1, 5, 4, 6), 13)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = np.matmul(a.astype(np.float64), b.astype(np.float64))
    got = torch.matmul(ta, tb).numpy()
    assert got.shape == (2, 5, 3, 6)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)
    at = ta.transpose(-1, -2)   # a strided view
    np.testing.assert_allclose(torch.matmul(at.transpose(-1, -2), tb).numpy(),
                               want, rtol=1e-3, atol=1e-2)
    grad_check(torch.matmul, ta[:, :, :2, :3], tb[:, :2, :3, :2], n_samples=4,
               tol=1e-2, epsilon=1e-3)


# -- grad_check itself ----------------------------------------------------------


class _LoggingRng:
    """A numpy generator that records what ``integers`` returns."""

    def __init__(self, seed):
        self.rng, self.draws = np.random.default_rng(seed), []

    def integers(self, n):
        self.draws.append(int(self.rng.integers(n)))
        return self.draws[-1]


def test_grad_check_draws_as_jax():
    """The same numpy generator gives the same (argument, index) draws."""
    a, b = _sample((3, 4), 14), _sample((4, 5), 15)
    mine, theirs = _LoggingRng(3), _LoggingRng(3)
    grad_check(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b),
               n_samples=6, tol=1e-2, epsilon=1e-3, rng=mine)
    jad.grad_check(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b),
                   n_samples=6, tol=1e-2, epsilon=1e-3, rng=theirs)
    assert mine.draws == theirs.draws and len(mine.draws) == 6 * 3


class _WrongBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2.0

    @staticmethod
    def backward(ctx, g):
        return g * 3.0


def test_grad_check_catches_wrong_backward():
    x = torch.from_numpy(_sample((2, 3), 16))
    grad_check(lambda t: t * 2.0, x, n_samples=3, epsilon=1e-3)
    with pytest.raises(AssertionError, match="grad mismatch"):
        grad_check(_WrongBackward.apply, x, n_samples=3, epsilon=1e-3)
