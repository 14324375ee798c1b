"""Copy a JAX model's parameters into its PyTorch counterpart.

The JAX side hands its parameters over as numpy arrays, so this module never
imports jax::

    params = {name: np.asarray(a) for name, a in jax_model.named_parameters()}
    load_jax_params(torch_model, params)

Names match one to one (``layers.0.attention.q_projection.weights`` ...)
because the port keeps the JAX modules' attribute names and layouts: a
RoPE model has no ``position_embeddings.*``, and an MoE layer holds
``layers.{i}.ff.router.weights``, ``layers.{i}.ff.experts_in`` and
``layers.{i}.ff.experts_out``, so a learned-position model's weights do not
load into a RoPE model (``KeyError`` naming the position table).  A
weight-only quantized model (``quantize_model_weights``) carries its int8
or float8 payloads (``...q_projection.values``) and f32 ``scales`` across
exactly: quantize both models the same way first.  An
:class:`~.models.seq2seq.EncoderDecoderLM` carries ``encoder_layers.{i}.*``
and ``decoder_layers.{i}.*`` (``attention``, ``cross_attention``, ``ff``,
``ln_1``, ``ln_c``, ``ln_2``) beside the embeddings, ``ln_enc``, ``ln`` and
``lm_head``, all by the same names as the JAX model's.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _to_torch(name: str, src: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """``src`` as a tensor of ``dtype``; quantized payloads bit for bit."""
    if dtype == torch.int8:
        if src.dtype != np.int8:
            raise TypeError(f"{name}: int8 payload expected, got {src.dtype}")
        return torch.from_numpy(src.copy())
    if dtype == torch.float8_e4m3fn:
        if src.dtype.name != "float8_e4m3fn":
            raise TypeError(f"{name}: float8_e4m3fn payload expected, got "
                            f"{src.dtype}")
        return torch.from_numpy(src.view(np.uint8).copy()).view(dtype)
    return torch.from_numpy(np.array(src, np.float32)).to(dtype)


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy ``params`` into ``model``'s parameters in place (cast to each
    one's dtype and device; int8 and float8 payloads, which are parameters
    that do not require grad, copied exactly) and return it.  Raises
    ``KeyError`` on a missing or extra name, ``ValueError`` on a shape
    mismatch and ``TypeError`` when a quantized payload meets an array of
    another type."""
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
            p.copy_(_to_torch(name, src, p.dtype))
    return model
