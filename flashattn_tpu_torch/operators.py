"""Scalar math prelude + higher-order map/zipWith/reduce (counterpart of
flashattn_tpu/operators.py).

The atoms of the reference's L0 layer (minitorch ``operators.py``) as
PyTorch ops.  Every function works element by element on tensors and on
Python floats, as the JAX module's ``jnp`` functions do: where JAX calls a
``jnp`` function the port returns a tensor (a 0-dim float32 one for Python
floats, whose weak type takes float32 in JAX), and where JAX applies a
Python operator (``mul``, ``add``, ``neg``, ``inv``, ``pow``, the
``*_back`` quotients) the port applies the same operator, so Python floats
stay Python floats.  A Python scalar next to a tensor takes the tensor's
dtype, as JAX's weakly typed scalars do.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable

import torch

Tensor = torch.Tensor


def _t(x) -> Tensor:
    """A tensor as it is; a Python number as a 0-dim float32 tensor."""
    return x if isinstance(x, Tensor) else torch.tensor(x, dtype=torch.float32)


def _pair(x, y):
    """Both as tensors, a Python scalar taking the other's dtype and
    device (JAX's weak types)."""
    if isinstance(x, Tensor) and not isinstance(y, Tensor):
        return x, torch.tensor(y, dtype=x.dtype, device=x.device)
    if isinstance(y, Tensor) and not isinstance(x, Tensor):
        return torch.tensor(x, dtype=y.dtype, device=y.device), y
    return _t(x), _t(y)


# ---------------------------------------------------------------------------
# Elementwise ops (reference operators.py:12-146)
# ---------------------------------------------------------------------------


def mul(x, y):
    ":math:`f(x, y) = x * y`"
    return x * y


def id(x):  # noqa: A001 - parity with reference name
    ":math:`f(x) = x`"
    return x


def add(x, y):
    ":math:`f(x, y) = x + y`"
    return x + y


def neg(x):
    ":math:`f(x) = -x`"
    return -x


def _compare(cmp: Callable, x, y) -> Tensor:
    """``cmp(x, y)`` as 1.0 / 0.0 in the promoted type of x, y and float32
    (``jnp.result_type(x, y, jnp.float32)``)."""
    a, b = _pair(x, y)
    return cmp(a, b).to(torch.promote_types(torch.result_type(a, b),
                                            torch.float32))


def lt(x, y):
    ":math:`f(x) = 1.0 if x < y else 0.0`"
    return _compare(torch.lt, x, y)


def eq(x, y):
    ":math:`f(x) = 1.0 if x == y else 0.0`"
    return _compare(torch.eq, x, y)


def max(x, y):  # noqa: A001
    ":math:`f(x, y) = max(x, y)` (NaN propagates, as ``jnp.maximum``)"
    return torch.maximum(*_pair(x, y))


def is_close(x, y, tol: float = 1e-2):
    ":math:`f(x) = |x - y| < tol`"
    a, b = _pair(x, y)
    return (torch.abs(a - b) < tol).to(torch.float32)


def sigmoid(x):
    r""":math:`f(x) = \frac{1}{1 + e^{-x}}` (numerically stable form)."""
    return torch.sigmoid(_t(x))


def sigmoid_back(x, d):
    "Derivative of sigmoid times d."
    s = torch.sigmoid(_t(x))
    return s * (1.0 - s) * d


def relu(x):
    ":math:`f(x) = max(0, x)`"
    return max(x, 0)


def log(x):
    ":math:`f(x) = log(x)`"
    return torch.log(_t(x))


def exp(x):
    ":math:`f(x) = e^{x}`"
    return torch.exp(_t(x))


def log_back(x, d):
    r"If :math:`f = log` as above, compute :math:`d \times f'(x)`."
    return d / x


def inv(x):
    ":math:`f(x) = 1/x`"
    return 1.0 / x


def inv_back(x, d):
    r"If :math:`f(x) = 1/x`, compute :math:`d \times f'(x)`."
    return -d / (x * x)


def relu_back(x, d):
    r"If :math:`f = relu`, compute :math:`d \times f'(x)`."
    a, dd = _t(x), _t(d)
    return torch.where(a > 0, dd, torch.zeros_like(dd))


def sigmoid_prime(x):
    s = torch.sigmoid(_t(x))
    return s * (1.0 - s)


def pow(base, exponent):  # noqa: A001
    ":math:`f(x) = base ** exponent`"
    return base**exponent


def tanh(x):
    ":math:`f(x) = tanh(x)`"
    return torch.tanh(_t(x))


EPS = 1e-6


# ---------------------------------------------------------------------------
# Higher-order functions (reference operators.py:153-255): on a tensor they
# apply ``fn`` to the whole tensor at once; on a list, element by element.
# ---------------------------------------------------------------------------


def map(fn: Callable) -> Callable:  # noqa: A001
    "Higher-order map: apply ``fn`` to each element of a tensor or iterable."

    def _map(xs):
        if isinstance(xs, Tensor):
            return fn(xs)
        return [fn(x) for x in xs]

    return _map


def zipWith(fn: Callable) -> Callable:
    "Higher-order zipWith: combine elements of two tensors with ``fn``."

    def _zip(xs, ys):
        if isinstance(xs, Tensor):
            return fn(xs, ys)
        return [fn(x, y) for x, y in zip(xs, ys)]

    return _zip


# The reductions that ``reduce`` runs as one torch reduction over the
# flattened tensor; any other ``fn`` is folded element by element.
_REDUCTIONS = {add: torch.sum, mul: torch.prod, max: torch.amax}


def reduce(fn: Callable, start: float) -> Callable:
    """Higher-order reduce with initial value ``start``.  On a tensor it
    reduces the flattened tensor and combines the result with ``start`` by
    ``fn`` (JAX: ``lax.reduce`` with ``start`` as its init value); on a list
    it folds from ``start``."""

    def _reduce(xs):
        if isinstance(xs, Tensor):
            flat = xs.reshape(-1)
            init = torch.tensor(start, dtype=flat.dtype, device=flat.device)
            if flat.numel() == 0:
                return init
            if fn in _REDUCTIONS:
                return fn(init, _REDUCTIONS[fn](flat))
            return functools.reduce(fn, flat, init)
        val = start
        for x in xs:
            val = fn(val, x)
        return val

    return _reduce


def negList(ls: Iterable) -> list:
    "Negate each element of a list."
    return map(neg)(list(ls))


def addLists(ls1: Iterable, ls2: Iterable) -> list:
    "Pairwise addition of two lists."
    return zipWith(add)(list(ls1), list(ls2))


def sum(ls) -> float:  # noqa: A001
    "Sum of a list/tensor."
    return reduce(add, 0.0)(ls)


def prod(ls) -> float:
    "Product of a list/tensor."
    if isinstance(ls, Tensor):
        return reduce(mul, 1.0)(ls)
    out = 1.0
    for x in ls:
        out = out * x
    return out
