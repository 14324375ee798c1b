"""Module base on ``torch.nn.Module`` (counterpart of flashattn_tpu/module.py).

The JAX module makes a Module an immutable pytree; the port's modules are
``torch.nn.Module``s, whose parameter registry, ``.to()``, ``state_dict``
and optimizers PyTorch code relies on.  :class:`Module` adds what the JAX
API has beyond them: :meth:`Module.replace`, a shallow copy with some
attributes replaced, and :meth:`Module.num_parameters`.

Three JAX methods keep torch's meaning here, on purpose:

* ``named_parameters()`` lists names in registration order, where JAX
  sorts them by attribute name;
* ``modules()`` yields the module itself first, where JAX lists only the
  submodules;
* ``train()`` / ``eval()`` set the mode in place and return the same
  module, where JAX returns a new one (``copy.deepcopy(m).eval()`` gives
  JAX's).

:func:`map_module_tree` is the post-order walk that rebuilds a tree of
modules (JAX's ``apply_mesh`` and ``quantize_model_weights`` use it);
:class:`Parameter` is JAX's thin shim around an array.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List

import torch
from torch import nn


def _replace(module: nn.Module, **updates: Any) -> nn.Module:
    """A shallow copy of ``module`` with ``updates`` set on it: the copy has
    registries (parameters, buffers, submodules) of its own, so the updates
    leave ``module`` untouched; every other attribute is shared."""
    obj = copy.copy(module)
    for reg in ("_parameters", "_buffers", "_modules",
                "_non_persistent_buffers_set"):
        if reg in module.__dict__:
            obj.__dict__[reg] = copy.copy(module.__dict__[reg])
    for name, value in updates.items():
        setattr(obj, name, value)
    return obj


class Module(nn.Module):
    """``torch.nn.Module`` with the JAX module's ``replace`` and
    ``num_parameters`` (see the module docstring for the methods that keep
    torch's meaning)."""

    def replace(self, **updates: Any) -> "Module":
        """A copy of this module with the given attributes replaced; the
        original is untouched."""
        return _replace(self, **updates)

    def num_parameters(self) -> int:
        """The number of parameter elements in the tree."""
        return sum(p.numel() for p in self.parameters())


def map_module_tree(v: Any, fn: Callable[[nn.Module], Any]) -> Any:
    """Rebuild a tree of modules (and lists, tuples and dicts of them),
    applying ``fn`` to every module post-order: ``fn`` sees a copy whose
    submodules are already transformed, and may return it, change it or
    return a replacement of any type.  The input tree is left untouched."""
    if isinstance(v, nn.Module):
        updates = {name: map_module_tree(child, fn)
                   for name, child in v._modules.items() if child is not None}
        return fn(_replace(v, **updates))
    if isinstance(v, list):
        return [map_module_tree(x, fn) for x in v]
    if isinstance(v, tuple):
        return tuple(map_module_tree(x, fn) for x in v)
    if isinstance(v, dict):
        return {k: map_module_tree(x, fn) for k, x in v.items()}
    return v


def tree_arrays(tree: Any) -> List[torch.Tensor]:
    """Every tensor of a tree: a module's parameters and buffers, or the
    tensors in (nested) lists, tuples and dicts."""
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_arrays(x)]
    return []


class Parameter:
    """Thin compatibility shim mirroring the reference's ``Parameter``
    (module.py:138-166): a tensor ``value`` with an optional ``name``.  The
    port's modules hold ``torch.nn.Parameter``s; this is the JAX API's
    wrapper, which unwraps to its tensor."""

    def __init__(self, value, name: str | None = None):
        self.value = torch.as_tensor(value)
        self.name = name

    def update(self, value) -> None:
        self.value = torch.as_tensor(value)

    def __repr__(self) -> str:
        return f"Parameter(shape={tuple(self.value.shape)})"
