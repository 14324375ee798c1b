"""Scalar autodiff twin: the pedagogical tape engine (counterpart of
flashattn_tpu/scalar.py).

The reference's Module-1 scalar autodiff (``minitorch/scalar.py``,
``scalar_functions.py``, ``autodiff.py:93-175``): a ``Scalar`` value class
whose operator overloads record a tape, plus DFS topological sort,
``backpropagate`` and ``derivative_check``.  The port's real autodiff is
``torch.autograd`` (see :mod:`.autodiff`); this module keeps the
reference's scalar engine, part of its public surface and test suite.
Values are plain Python floats, so it runs alike everywhere; the port keeps
its own copy rather than importing the JAX package's.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Tuple

_var_count = 0


class Context:
    """Saved-values container (reference autodiff.py:178-195)."""

    def __init__(self, no_grad: bool = False):
        self.no_grad = no_grad
        self.saved_values: Tuple = ()

    def save_for_backward(self, *values) -> None:
        if not self.no_grad:
            self.saved_values = values


class History:
    def __init__(self, last_fn=None, ctx=None, inputs=()):
        self.last_fn = last_fn
        self.ctx = ctx
        self.inputs = inputs


class Scalar:
    """Float wrapper with reverse-mode autodiff via a recorded tape."""

    def __init__(self, v: float, history: Optional[History] = None,
                 name: Optional[str] = None):
        global _var_count
        _var_count += 1
        self.data = float(v)
        self.history = History() if history is None else history
        self.derivative: Optional[float] = None
        self.unique_id = _var_count
        self.name = name if name is not None else str(self.unique_id)

    # -- variable protocol (reference autodiff.Variable) --------------------
    def is_leaf(self) -> bool:
        return self.history is not None and self.history.last_fn is None

    def is_constant(self) -> bool:
        return self.history is None

    @property
    def parents(self) -> Iterable["Scalar"]:
        return self.history.inputs

    def accumulate_derivative(self, x: float) -> None:
        assert self.is_leaf(), "only leaf variables accumulate derivatives"
        self.derivative = (self.derivative or 0.0) + x

    def chain_rule(self, d_output: float):
        h = self.history
        grads = h.last_fn._backward(h.ctx, d_output)
        if not isinstance(grads, tuple):
            grads = (grads,)
        return [(inp, g) for inp, g in zip(h.inputs, grads)
                if not inp.is_constant()]

    def backward(self, d_output: float = 1.0) -> None:
        backpropagate(self, d_output)

    # -- operators -----------------------------------------------------------
    def __add__(self, b):
        return Add.apply(self, _wrap(b))

    __radd__ = __add__

    def __mul__(self, b):
        return Mul.apply(self, _wrap(b))

    __rmul__ = __mul__

    def __sub__(self, b):
        return Add.apply(self, Neg.apply(_wrap(b)))

    def __rsub__(self, b):
        return Add.apply(_wrap(b), Neg.apply(self))

    def __truediv__(self, b):
        return Mul.apply(self, Inv.apply(_wrap(b)))

    def __rtruediv__(self, b):
        return Mul.apply(_wrap(b), Inv.apply(self))

    def __neg__(self):
        return Neg.apply(self)

    def __lt__(self, b):
        return LT.apply(self, _wrap(b))

    def __gt__(self, b):
        return LT.apply(_wrap(b), self)

    def __eq__(self, b):  # type: ignore[override]
        return EQ.apply(self, _wrap(b))

    def __hash__(self):
        return self.unique_id

    def __repr__(self):
        return f"Scalar({self.data})"

    def __bool__(self):
        return bool(self.data)

    def log(self):
        return Log.apply(self)

    def exp(self):
        return Exp.apply(self)

    def sigmoid(self):
        return Sigmoid.apply(self)

    def relu(self):
        return ReLU.apply(self)


def _wrap(x) -> Scalar:
    return x if isinstance(x, Scalar) else Scalar(x)


# -- functions (reference scalar_functions.py) -------------------------------


class ScalarFunction:
    @classmethod
    def apply(cls, *vals: Scalar) -> Scalar:
        ctx = Context()
        raw = [v.data for v in vals]
        out = cls._forward(ctx, *raw)
        return Scalar(out, History(cls, ctx, vals))

    @classmethod
    def _forward(cls, ctx, *args):
        return cls.forward(ctx, *args)

    @classmethod
    def _backward(cls, ctx, d_out):
        return cls.backward(ctx, d_out)


class Add(ScalarFunction):
    @staticmethod
    def forward(ctx, a, b):
        return a + b

    @staticmethod
    def backward(ctx, d):
        return d, d


class Mul(ScalarFunction):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return a * b

    @staticmethod
    def backward(ctx, d):
        a, b = ctx.saved_values
        return b * d, a * d


class Neg(ScalarFunction):
    @staticmethod
    def forward(ctx, a):
        return -a

    @staticmethod
    def backward(ctx, d):
        return -d


class Inv(ScalarFunction):
    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return 1.0 / a

    @staticmethod
    def backward(ctx, d):
        (a,) = ctx.saved_values
        return -d / (a * a)


class Log(ScalarFunction):
    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return math.log(a)

    @staticmethod
    def backward(ctx, d):
        (a,) = ctx.saved_values
        return d / a


class Exp(ScalarFunction):
    @staticmethod
    def forward(ctx, a):
        out = math.exp(a)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, d):
        (out,) = ctx.saved_values
        return d * out


class Sigmoid(ScalarFunction):
    @staticmethod
    def forward(ctx, a):
        out = 1.0 / (1.0 + math.exp(-a)) if a >= 0 else math.exp(a) / (1.0 + math.exp(a))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, d):
        (out,) = ctx.saved_values
        return d * out * (1.0 - out)


class ReLU(ScalarFunction):
    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return max(0.0, a)

    @staticmethod
    def backward(ctx, d):
        (a,) = ctx.saved_values
        return d if a > 0 else 0.0


class LT(ScalarFunction):
    @staticmethod
    def forward(ctx, a, b):
        return 1.0 if a < b else 0.0

    @staticmethod
    def backward(ctx, d):
        return 0.0, 0.0


class EQ(ScalarFunction):
    @staticmethod
    def forward(ctx, a, b):
        return 1.0 if a == b else 0.0

    @staticmethod
    def backward(ctx, d):
        return 0.0, 0.0


# -- engine (reference autodiff.py:93-175) -----------------------------------


def topological_sort(variable: Scalar) -> List[Scalar]:
    """DFS post-order, outputs before inputs."""
    seen = set()
    order: List[Scalar] = []

    def visit(var: Scalar):
        if var.unique_id in seen or var.is_constant():
            return
        seen.add(var.unique_id)
        if not var.is_leaf():
            for parent in var.parents:
                visit(parent)
        order.append(var)

    visit(variable)
    return list(reversed(order))


def backpropagate(variable: Scalar, deriv: float = 1.0) -> None:
    order = topological_sort(variable)
    grads = {variable.unique_id: deriv}
    for var in order:
        d = grads.pop(var.unique_id, 0.0)
        if var.is_leaf():
            var.accumulate_derivative(d)
            continue
        for inp, g in var.chain_rule(d):
            grads[inp.unique_id] = grads.get(inp.unique_id, 0.0) + g


def central_difference(f: Callable, *vals: float, arg: int = 0,
                       epsilon: float = 1e-6) -> float:
    up = [Scalar(v + (epsilon if i == arg else 0.0)) for i, v in enumerate(vals)]
    dn = [Scalar(v - (epsilon if i == arg else 0.0)) for i, v in enumerate(vals)]
    return (f(*up).data - f(*dn).data) / (2.0 * epsilon)


def derivative_check(f: Callable, *scalars: Scalar, tol: float = 1e-2) -> None:
    """Analytic vs numeric derivative (reference scalar.derivative_check)."""
    out = f(*scalars)
    out.backward()
    for i, s in enumerate(scalars):
        check = central_difference(f, *[x.data for x in scalars], arg=i)
        assert s.derivative is not None
        assert abs(s.derivative - check) < tol + tol * abs(check), (
            f"derivative mismatch for arg {i}: {s.derivative} vs {check}"
        )
