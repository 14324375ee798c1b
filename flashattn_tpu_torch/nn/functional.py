"""Functional nn ops used by the serving slice (counterpart of
flashattn_tpu/nn/functional.py)."""

from __future__ import annotations

import math

import torch


def GELU(input: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * input * (1.0 + torch.tanh(c * (input + 0.044715 * input**3)))


def one_hot(input: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Indices ``(*,)`` -> float32 one-hot ``(*, num_classes)``."""
    return torch.nn.functional.one_hot(input.long(), num_classes).float()
