"""Numerical-debug utilities (counterpart of flashattn_tpu/utils/debug.py).

The reference declares a NaN/Inf checker and a 2-norm probe but never
implements them (``src/includes/cuda_util.h:41-49``).  The JAX module makes
them real with ``checkify``; the port maps each to PyTorch:

* :func:`assert_finite` records ``isfinite(x).all()`` on the tensor's
  device without a host sync while :func:`checkify_errors` runs a function,
  which then checks every record with one sync; outside it checks at once.
  A failed check raises ``FloatingPointError`` on the host.  Nothing here
  uses a device-side assert (``torch._assert_async``): one that fires
  leaves the CUDA context unusable for the rest of the process.
* :func:`check_2norm` prints a tensor's float32 2-norm (a sync).
* :func:`tensor_stats` and :func:`find_nonfinite` sweep tensors on the host.
* :func:`enable_nan_debugging` turns on autograd's anomaly mode.
"""

from __future__ import annotations

import contextvars
import functools
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

# the records of the innermost checkify_errors call, None outside one
_RECORDS: contextvars.ContextVar = contextvars.ContextVar("records", default=None)


def _message(name: str) -> str:
    return f"{name} contains NaN/Inf"


def assert_finite(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """NaN/Inf check (cuda_util.h ``CHECK_NAN_INF`` role); returns ``x``
    unchanged so it can be threaded inline.  Inside
    :func:`checkify_errors` it records the check on the device, with no
    sync; outside it checks at once and raises ``FloatingPointError``."""
    ok = torch.isfinite(x.detach()).all()
    records = _RECORDS.get()
    if records is None:
        if not bool(ok):
            raise FloatingPointError(_message(name))
    else:
        records.append((name, ok))
    return x


def checkify_errors(fn: Callable) -> Callable:
    """Wrap ``fn`` so that the :func:`assert_finite` checks it runs raise
    ``FloatingPointError`` (``"{name} contains NaN/Inf"``, the first failed
    check in program order) after it returns, checked with one host sync."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        records: List[Tuple[str, torch.Tensor]] = []
        token = _RECORDS.set(records)
        try:
            out = fn(*args, **kwargs)
        finally:
            _RECORDS.reset(token)
        if records:
            dev = records[0][1].device
            oks = torch.stack([ok.to(dev) for _, ok in records]).cpu()
            bad = (~oks).nonzero()
            if len(bad):
                raise FloatingPointError(_message(records[int(bad[0])][0]))
        return out

    return run


def check_2norm(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """2-norm probe (cuda_util.h:49 ``check_2norm``): prints the float32 L2
    norm of ``x`` (a host sync); returns ``x`` unchanged."""
    n = torch.linalg.vector_norm(x.detach().float().reshape(-1))
    print(f"{name} 2-norm: {float(n)}")
    return x


def tensor_stats(x) -> Dict[str, Any]:
    """Host-side summary (min/max/mean/norm/nan count) for printf-debugging."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    a = np.asarray(x, dtype=np.float64)
    return {
        "shape": tuple(a.shape),
        "min": float(np.nanmin(a)) if a.size else 0.0,
        "max": float(np.nanmax(a)) if a.size else 0.0,
        "mean": float(np.nanmean(a)) if a.size else 0.0,
        "l2": float(np.linalg.norm(a.reshape(-1))),
        "nan": int(np.isnan(a).sum()),
        "inf": int(np.isinf(a).sum()),
    }


def _leaves(tree: Any, path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(tree, nn.Module):
        for name, t in (*tree.named_parameters(), *tree.named_buffers()):
            yield (f"{path}.{name}" if path else name), t
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}" if path else str(i))


def find_nonfinite(tree: Any, prefix: str = "") -> Dict[str, Dict[str, int]]:
    """Sweep a module's parameters and buffers, or the tensors of (nested)
    dicts, lists and tuples (gradients, optimizer state), and return
    ``{prefix + dotted path: {nan, inf}}`` for every floating tensor that
    holds a non-finite value."""
    bad: Dict[str, Dict[str, int]] = {}
    for path, t in _leaves(tree, ""):
        if not t.is_floating_point():
            continue
        t = t.detach()
        n_nan, n_inf = int(torch.isnan(t).sum()), int(torch.isinf(t).sum())
        if n_nan or n_inf:
            bad[prefix + path] = {"nan": n_nan, "inf": n_inf}
    return bad


def enable_nan_debugging(enable: bool = True) -> None:
    """Turn autograd's anomaly mode on or off (``jax_debug_nans``' role):
    each backward function is checked for NaN outputs and the forward op
    that made it is named.  It checks the backward, not every op of the
    forward (JAX's flag re-runs every jitted op); slow, for debugging only."""
    torch.autograd.set_detect_anomaly(enable)
