"""Table-driven property-test op cases (counterpart of
flashattn_tpu/testing.py).

The reference's ``minitorch/testing.py`` tables (MathTest /
MathTestVariable), whose ``_comp_testing()`` drives the property tests.
One :class:`OpCase` carries a pure-Python float oracle (``math`` module
precision) and a function written in the port's operators and torch ops on
tensors; the case names and oracles are the JAX module's.

Each case composes ops so that the chain rule, broadcasting and reduction
paths are all exercised; shift constants keep every case inside its domain
on the sampled range [-100, 100] (``log(a + 100000)``, ``relu(a + 5.5)``,
``exp(a - 200)``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch

from . import operators as ops


@dataclass(frozen=True)
class OpCase:
    """One property-test case: a name, a python-float oracle, a torch fn."""

    name: str
    oracle: Callable  # pure-python floats, math-module precision
    fn: Callable  # torch tensors
    differentiable: bool = True  # comparison ops have no useful grad


def _sig(x: float) -> float:
    # numerically-stable python sigmoid (reference operators.py:76-92 form)
    if x >= 0:
        return 1.0 / (1.0 + math.exp(-x))
    e = math.exp(x)
    return e / (1.0 + e)


# -- one-argument cases (reference MathTest one_arg table) -------------------

ONE_ARG: List[OpCase] = [
    OpCase("neg", lambda a: -a, ops.neg),
    OpCase("add_constant", lambda a: 5.0 + a, lambda a: 5.0 + a),
    OpCase("square", lambda a: a * a, lambda a: a * a),
    OpCase("cube", lambda a: a * a * a, lambda a: a * a * a),
    OpCase("sub_constant", lambda a: a - 5.0, lambda a: a - 5.0),
    OpCase("mult_constant", lambda a: 5.0 * a, lambda a: 5.0 * a),
    OpCase("div_constant", lambda a: a / 5.0, lambda a: a / 5.0),
    OpCase("inv", lambda a: 1.0 / (a + 130.0), lambda a: ops.inv(a + 130.0)),
    OpCase("sigmoid", _sig, ops.sigmoid),
    OpCase("log", lambda a: math.log(a + 100000.0),
           lambda a: ops.log(a + 100000.0)),
    OpCase("relu", lambda a: max(a + 5.5, 0.0), lambda a: ops.relu(a + 5.5)),
    OpCase("exp", lambda a: math.exp(a - 200.0), lambda a: ops.exp(a - 200.0)),
    OpCase("explog",
           lambda a: math.log(a + 100000.0) + math.exp(a - 200.0),
           lambda a: ops.log(a + 100000.0) + ops.exp(a - 200.0)),
    OpCase("tanh", math.tanh, ops.tanh),
    OpCase("complex",
           lambda a: math.log(_sig(max(max(a * 10 + 7, 0.0) * 6 + 5, 0.0)
                                   * 10)) / 50.0,
           lambda a: ops.log(ops.sigmoid(
               ops.relu(ops.relu(a * 10 + 7) * 6 + 5) * 10)) / 50.0),
]

# -- two-argument cases (reference MathTest *2 table) ------------------------

TWO_ARG: List[OpCase] = [
    OpCase("add2", lambda a, b: a + b, ops.add),
    OpCase("mul2", lambda a, b: a * b, ops.mul),
    OpCase("sub2", lambda a, b: a - b, lambda a, b: a - b),
    OpCase("div2", lambda a, b: a / (b + 205.5), lambda a, b: a / (b + 205.5)),
    OpCase("gt2", lambda a, b: float(b < a + 1.2),
           lambda a, b: ops.lt(b, a + 1.2), differentiable=False),
    OpCase("lt2", lambda a, b: float(a + 1.2 < b),
           lambda a, b: ops.lt(a + 1.2, b), differentiable=False),
    OpCase("eq2", lambda a, b: float(a == b + 5.5),
           lambda a, b: ops.eq(a, b + 5.5), differentiable=False),
    OpCase("max2", lambda a, b: max(a, b + 1e-3),
           lambda a, b: ops.max(a, b + 1e-3)),
    OpCase("pow2", lambda a, b: (abs(a) + 0.5) ** _sig(b),
           lambda a, b: ops.pow(torch.abs(a) + 0.5, ops.sigmoid(b))),
]

# -- reduction cases (reference MathTest *_red table) -------------------------
# oracle takes a python list; fn takes a tensor and reduces dim 0.

RED_ARG: List[OpCase] = [
    OpCase("sum_red", lambda xs: math.fsum(xs), lambda a: torch.sum(a, dim=0)),
    OpCase("mean_red", lambda xs: math.fsum(xs) / len(xs),
           lambda a: torch.mean(a, dim=0)),
    OpCase("max_red", lambda xs: max(xs), lambda a: torch.amax(a, dim=0)),
    OpCase("prod_red", lambda xs: math.prod(xs),
           lambda a: torch.prod(a, dim=0)),
    OpCase("logsumexp_red",
           lambda xs: max(xs) + math.log(math.fsum(
               math.exp(x - max(xs)) for x in xs)),
           lambda a: torch.amax(a, dim=0) + torch.log(torch.sum(
               torch.exp(a - torch.amax(a, dim=0, keepdim=True)), dim=0))),
]


def comp_testing() -> Tuple[List[OpCase], List[OpCase], List[OpCase]]:
    """(one_arg, two_arg, red_arg) tables, the reference ``_comp_testing()``
    shape (testing.py:147-153)."""
    return ONE_ARG, TWO_ARG, RED_ARG
