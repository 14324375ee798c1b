"""Gradient checking (counterpart of flashattn_tpu/autodiff.py).

The reference implements a tape-based autodiff engine plus a
central-difference checker run against a float64 forward
(``tensor_functions.py:691-744``).  In the port the engine is
``torch.autograd``; what remains worth owning is the checker, which the
tests use the way the reference's property tests use ``grad_check``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def central_difference(f: Callable, *vals, arg: int = 0, epsilon: float = 1e-6,
                       ind: tuple = ()) -> float:
    """Numerical derivative of ``sum(f(*vals))`` w.r.t. ``vals[arg][ind]``
    (reference autodiff.py:7-28 semantics), in float64 on the values'
    devices."""
    vals64 = [_tensor(v).detach().to(torch.float64) for v in vals]
    up = [v.clone() for v in vals64]
    dn = [v.clone() for v in vals64]
    up[arg][ind] += epsilon
    dn[arg][ind] -= epsilon
    with torch.no_grad():
        f_up = float(torch.sum(f(*up)))
        f_dn = float(torch.sum(f(*dn)))
    return (f_up - f_dn) / (2.0 * epsilon)


def grad_check(f: Callable, *vals, n_samples: int = 10, tol: float = 1e-2,
               epsilon: float = 1e-6,
               rng: Optional[np.random.Generator] = None) -> None:
    """Assert that the gradients of ``sum(f(*vals))`` from
    ``torch.autograd.grad`` match central differences at ``n_samples``
    random positions (reference tensor_functions.py:718-744 semantics).
    The positions come from ``rng`` (default ``default_rng(0)``) in the JAX
    module's order: an argument, then an index along each of its dims."""
    rng = rng or np.random.default_rng(0)
    xs = [_tensor(v).detach().requires_grad_(True) for v in vals]
    grads = torch.autograd.grad(torch.sum(f(*xs)), xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
    for _ in range(n_samples):
        arg = int(rng.integers(len(vals)))
        shape = xs[arg].shape
        ind = tuple(int(rng.integers(d)) for d in shape)
        analytic = float(grads[arg][ind])
        numeric = central_difference(f, *vals, arg=arg, epsilon=epsilon, ind=ind)
        np.testing.assert_allclose(
            analytic, numeric, rtol=tol, atol=tol,
            err_msg=f"grad mismatch at arg {arg} index {ind}",
        )
