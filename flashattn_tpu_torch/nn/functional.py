"""Functional nn ops of the serving and training slices (counterpart of
flashattn_tpu/nn/functional.py)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.dropout import fused_dropout


def GELU(input: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * input * (1.0 + torch.tanh(c * (input + 0.044715 * input**3)))


def one_hot(input: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Indices ``(*,)`` -> float32 one-hot ``(*, num_classes)``."""
    return torch.nn.functional.one_hot(input.long(), num_classes).float()


def softmax_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-example cross entropy, no reduction:
    ``loss_i = logsumexp(logits_i) - logits_i[target_i]``."""
    lse = torch.logsumexp(logits, dim=1)
    picked = logits.gather(1, target.long()[:, None])[:, 0]
    return lse - picked


def dropout(input: torch.Tensor, rate: float, seed: Optional[int] = None,
            ignore: bool = False, scale: bool = True) -> torch.Tensor:
    """Dropout keyed by an integer ``seed`` (the JAX package's takes a PRNG
    key).  ``scale=True`` is inverted dropout; ``scale=False`` keeps the
    survivors unscaled.  The identity with ``ignore=True``, ``rate <= 0`` or
    ``seed=None``.  Runs the fused dropout kernel on CUDA tensors
    (``ops.dropout.fused_dropout``)."""
    if ignore:
        return input
    return fused_dropout(input, rate, seed, scale)
