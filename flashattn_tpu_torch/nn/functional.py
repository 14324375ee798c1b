"""Functional nn ops (counterpart of flashattn_tpu/nn/functional.py).

Plain torch ops where the JAX module is plain jnp; the dropout family runs
the fused dropout kernels on CUDA tensors (``ops.dropout``).  Dropout takes
an integer seed where the JAX module takes a PRNG key."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops._utils import gelu_tanh
from ..ops.dropout import (
    fused_dropout,
    fused_dropout_act_bias,
    fused_dropout_res_bias,
)


def max(input: torch.Tensor, dim: int) -> torch.Tensor:  # noqa: A001
    """Max reduction keeping the reduced dim (size 1)."""
    return torch.amax(input, dim=dim, keepdim=True)


def argmax(input: torch.Tensor, dim: int) -> torch.Tensor:
    """Argmax as a 1-hot tensor: 1 wherever the max along ``dim`` sits."""
    out = torch.amax(input, dim=dim, keepdim=True)
    return (input == out).to(input.dtype)


def softmax(input: torch.Tensor, dim: int) -> torch.Tensor:
    r""":math:`z_i = e^{x_i} / \sum_i e^{x_i}` along ``dim`` (stable)."""
    return torch.softmax(input, dim=dim)


def logsoftmax(input: torch.Tensor, dim: int) -> torch.Tensor:
    r""":math:`z_i = x_i - \log\sum_i e^{x_i}` along ``dim`` (stable)."""
    return torch.log_softmax(input, dim=dim)


def logsumexp(input: torch.Tensor, dim: int) -> torch.Tensor:
    """Stable logsumexp, keeping the reduced dim."""
    return torch.logsumexp(input, dim=dim, keepdim=True)


def GELU(input: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation; its constants take the input's
    dtype, as JAX's Python constants do (bf16 literals for bf16 input)."""
    return gelu_tanh(input)


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
            ignore: bool = False, scale: bool = True,
            offset: int = 0) -> torch.Tensor:
    """Dropout keyed by an integer ``seed``.  ``scale=True`` is inverted
    dropout; ``scale=False`` keeps the survivors unscaled.  The identity with
    ``ignore=True``, ``rate <= 0`` or ``seed=None``.  ``offset``: ``input``
    is elements [offset, offset + numel) of a larger tensor, whose mask it
    takes.  Runs the fused dropout kernel on CUDA tensors
    (``ops.dropout.fused_dropout``)."""
    if ignore:
        return input
    return fused_dropout(input, rate, seed, scale, offset)


def dropout_res_bias(input: torch.Tensor, bias: torch.Tensor,
                     residual: torch.Tensor, rate: float,
                     seed: Optional[int] = None) -> torch.Tensor:
    """``residual + dropout(input + bias)`` in one pass (inverted dropout,
    scale 1 / (1 - rate)); ``residual + input + bias`` without a seed or at
    rate 0.  Runs ``ops.dropout.fused_dropout_res_bias``: a kernel forward
    and backward on CUDA tensors."""
    return fused_dropout_res_bias(input, bias, residual, rate, seed)


def dropout_act_bias(input: torch.Tensor, bias: torch.Tensor, rate: float,
                     seed: Optional[int] = None,
                     act: str = "gelu") -> torch.Tensor:
    """``dropout(act(input + bias))`` in one pass, ``act`` "gelu" (tanh
    approximation, as :func:`GELU`) or "relu".  Runs
    ``ops.dropout.fused_dropout_act_bias``: a kernel forward and backward on
    CUDA tensors, the backward recomputing act' and regenerating the mask."""
    return fused_dropout_act_bias(input, bias, rate, seed, act)


# -- pooling -------------------------------------------------------------------


def tile(input: torch.Tensor, kernel: Tuple[int, int]):
    """Reshape (B, C, H, W) for 2D pooling -> ((B, C, H/kh, W/kw, kh*kw),
    H/kh, W/kw)."""
    batch, channel, height, width = input.shape
    kh, kw = kernel
    if height % kh or width % kw:
        raise ValueError(f"({height}, {width}) is not a multiple of the "
                         f"kernel {kernel}")
    new_height, new_width = height // kh, width // kw
    x = input.reshape(batch, channel, new_height, kh, new_width, kw)
    x = x.permute(0, 1, 2, 4, 3, 5)
    return (x.reshape(batch, channel, new_height, new_width, kh * kw),
            new_height, new_width)


def avgpool2d(input: torch.Tensor, kernel: Tuple[int, int]) -> torch.Tensor:
    """Tiled average pooling 2D."""
    x, _, _ = tile(input, kernel)
    return x.mean(dim=4)


def maxpool2d(input: torch.Tensor, kernel: Tuple[int, int]) -> torch.Tensor:
    """Tiled max pooling 2D."""
    x, _, _ = tile(input, kernel)
    return x.amax(dim=4)


def layer_norm(input: torch.Tensor, eps: float = 1e-5,
               axis: int = -1) -> torch.Tensor:
    """Plain (unfused, no-affine) layer norm over ``axis``."""
    mean = input.mean(dim=axis, keepdim=True)
    var = input.var(dim=axis, keepdim=True, unbiased=False)
    return (input - mean) * torch.rsqrt(var + eps)
