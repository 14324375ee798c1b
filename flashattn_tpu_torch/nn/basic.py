"""Basic NN modules: Embedding, Dropout, Linear, LayerNorm1d, FusedLayerNorm
(counterpart of flashattn_tpu/nn/basic.py).

Parameter names match the JAX modules (``weights``, ``bias``, ``gamma``,
``beta``) so ``convert.load_jax_params`` maps one onto the other by name.
Initialisation follows the same distributions (Embedding ~ N(0, 1), Linear
~ U(+-1/sqrt(in_size))), drawn from an explicit ``torch.Generator`` on the
CPU and then moved to ``device``; the numbers differ from ``jax.random``'s.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.layernorm import layernorm
from . import functional as F


def _randn(shape, generator, dtype, device):
    t = torch.randn(shape, generator=generator, dtype=torch.float32)
    return t.to(device=device, dtype=dtype)


def _uniform(shape, bound, generator, dtype, device):
    t = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (t * (2 * bound) - bound).to(device=device, dtype=dtype)


class Embedding(nn.Module):
    """Token embedding: a gather ``weights[x]``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weights = nn.Parameter(_randn((num_embeddings, embedding_dim),
                                           generator, dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, seq) int -> (batch, seq, embedding_dim)."""
        return self.weights[x.long()]


class Dropout(nn.Module):
    """Inverted dropout keyed by an integer seed (the JAX module takes a PRNG
    key); the identity at eval, with p = 0 or without a seed.  On CUDA
    tensors it runs the fused dropout kernel."""

    def __init__(self, p_dropout: float = 0.1):
        super().__init__()
        self.p_dropout = float(p_dropout)

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        if self.p_dropout == 0.0 or not self.training or seed is None:
            return x
        return F.dropout(x, self.p_dropout, seed=seed, scale=True)


class Linear(nn.Module):
    """y = x @ W + b with W stored (in_size, out_size), as in the JAX module."""

    def __init__(self, in_size: int, out_size: int, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.in_size = in_size
        self.out_size = out_size
        bound = 1.0 / (in_size**0.5)
        self.weights = nn.Parameter(_uniform((in_size, out_size), bound,
                                             generator, dtype, device))
        self.bias = (nn.Parameter(_uniform((out_size,), bound, generator,
                                           dtype, device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.weights
        if self.bias is not None:
            out = out + self.bias
        return out


class LayerNorm1d(nn.Module):
    """Plain LayerNorm over the last dim, with gamma/beta as ``weights``/``bias``."""

    def __init__(self, dim: int, eps: float = 1e-5, *,
                 elementwise_affine: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim = dim
        self.eps = float(eps)
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.weights = nn.Parameter(torch.ones(dim, dtype=dtype,
                                                   device=device))
            self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype,
                                                 device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        norm = (x - mean) * torch.rsqrt(var + self.eps)
        if self.elementwise_affine:
            norm = norm * self.weights + self.bias
        return norm


class FusedLayerNorm(nn.Module):
    """LayerNorm backed by the fused kernels (``ops.layernorm.layernorm``),
    forward and backward."""

    def __init__(self, n_embd: int, eps: float = 1e-5, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n_embd = n_embd
        self.eps = float(eps)
        self.gamma = nn.Parameter(torch.ones(n_embd, dtype=dtype, device=device))
        self.beta = nn.Parameter(torch.zeros(n_embd, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.gamma, self.beta, eps=self.eps)
