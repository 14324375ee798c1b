"""Copy a JAX model's parameters into its PyTorch counterpart.

The JAX side hands its parameters over as numpy arrays, so this module never
imports jax::

    params = {name: np.asarray(a) for name, a in jax_model.named_parameters()}
    load_jax_params(torch_model, params)

Names match one to one (``layers.0.attention.q_projection.weights`` ...)
because the port keeps the JAX modules' attribute names and layouts.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy ``params`` into ``model`` in place (cast to each parameter's dtype
    and device) and return it.  Raises ``KeyError`` on a missing or extra
    name and ``ValueError`` on a shape mismatch."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    with torch.no_grad():
        for name, p in own.items():
            src = np.asarray(params[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                                 f"match {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(src, np.float32)).to(p.dtype))
    return model
