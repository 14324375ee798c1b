"""Basic NN modules: Embedding, Dropout, Linear, LayerNorm1d, FusedLayerNorm,
QuantizedLinear (counterpart of flashattn_tpu/nn/basic.py).

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
from ..ops.quant import (
    QuantizedTensor,
    int8_weight_only_matmul,
    quantize_fp8,
    quantize_int8,
)
from . import functional as F


def _randn(shape, generator, dtype, device):
    t = torch.randn(shape, generator=generator, dtype=torch.float32)
    return t.to(device=device, dtype=dtype)


def _uniform(shape, bound, generator, dtype, device):
    t = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (t * (2 * bound) - bound).to(device=device, dtype=dtype)


class Embedding(nn.Module):
    """Token embedding: a gather ``weights[x]``, or with
    ``use_one_hot_matmul=True`` the reference project's formulation
    ``one_hot(x) @ weights`` (a matmul over the vocabulary)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 generator: Optional[torch.Generator] = None,
                 use_one_hot_matmul: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.use_one_hot_matmul = use_one_hot_matmul
        self.weights = nn.Parameter(_randn((num_embeddings, embedding_dim),
                                           generator, dtype, device))
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(batch, seq) int -> (batch, seq, embedding_dim).

        An id outside the table gives what the JAX module gives, on every
        device: ``jnp.take`` wraps an id in [-n, 0) once and fills NaN for
        any other id past the table; ``jax.nn.one_hot`` gives a zero row for
        any id outside [0, n).  A table split over the embedding dim
        (:func:`~..parallel.sharding.shard_model`) all-gathers its rows to
        the full width."""
        n = self.num_embeddings
        idx = x.long()
        if self.use_one_hot_matmul:
            bs, seq = x.shape
            inside = (idx >= 0) & (idx < n)
            oh = F.one_hot(idx.clamp(0, n - 1), n) * inside[..., None]
            out = oh.reshape(bs * seq, n).to(self.weights.dtype) @ self.weights
            out = out.reshape(bs, seq, -1)
        else:
            idx = torch.where(idx < 0, idx + n, idx)
            inside = (idx >= 0) & (idx < n)
            out = self.weights[idx.clamp(0, n - 1)]
            out = torch.where(inside[..., None], out, float("nan"))
        return _gather_embed(self, out)


class Dropout(nn.Module):
    """Inverted dropout keyed by an integer seed (the JAX module takes a PRNG
    key); the identity at eval, with p = 0 or without a seed.  On CUDA
    tensors it runs the fused dropout kernel.

    Under a batch split (``batch_group``, set by
    :func:`~..parallel.sharding.apply_mesh`) ``x`` is this rank's block of
    equal batch rows, and it takes the mask that the unsharded dropout
    draws at those global positions."""

    def __init__(self, p_dropout: float = 0.1):
        super().__init__()
        self.p_dropout = float(p_dropout)
        self.batch_group = None

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        if self.p_dropout == 0.0 or not self.training or seed is None:
            return x
        offset = 0
        if self.batch_group is not None:
            from ..parallel.comm import group_rank

            offset = group_rank(self.batch_group) * x.numel()
        return F.dropout(x, self.p_dropout, seed=seed, scale=True,
                         offset=offset)


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
        # tensor-parallel role (parallel.sharding.shard_model): "col" or "row"
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _tp_input(self, x)
        w = self.weights
        if x.dtype != w.dtype:
            # JAX's dot(x, W, preferred_element_type=x.dtype): the product
            # in the promoted type, the result in x's
            dt = torch.promote_types(x.dtype, w.dtype)
            out = (x.to(dt) @ w.to(dt)).to(x.dtype)
        else:
            out = x @ w
        out = _tp_output(self, out)
        if self.bias is not None:
            out = out + self.bias
        return out


def _tp_input(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A column-parallel layer's input: the identity forward, its gradient
    summed over the ranks of the split."""
    if lin.tp is None or lin.tp.role != "col":
        return x
    from ..parallel.comm import copy_to_group

    return copy_to_group(x, lin.tp.group)


def _tp_output(lin: nn.Module, out: torch.Tensor) -> torch.Tensor:
    """A row-parallel layer's product summed over the ranks (before its
    replicated bias, as GSPMD adds it)."""
    if lin.tp is None or lin.tp.role != "row":
        return out
    from ..parallel.comm import reduce_from_group

    return reduce_from_group(out, lin.tp.group)


def _gather_embed(emb: nn.Module, out: torch.Tensor) -> torch.Tensor:
    if emb.tp is None:
        return out
    from ..parallel.comm import gather_from_group

    return gather_from_group(out, emb.tp.group, -1)


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


class QuantizedLinear(nn.Module):
    """Weight-only quantized Linear: y = x @ dequantize(W) + b with an int8
    or float8_e4m3fn payload ``values`` (in_size, out_size) and f32
    per-output-channel ``scales`` (1, out_size); the dequantization happens
    inside the matmul kernel (:func:`~..ops.quant.int8_weight_only_matmul`),
    so W never exists at full precision in device memory.  Built from a
    :class:`Linear` by :func:`quantize_linear`.

    ``values`` and ``scales`` are parameters that take no gradient, so that
    ``load_jax_params`` and ``state_dict`` see them by name.  Casting the
    module (``.to(torch.bfloat16)``, ``.half()``) casts the bias only: the
    payload keeps its type and the scales stay f32."""

    def __init__(self, values: torch.Tensor, scales: torch.Tensor,
                 bias: Optional[torch.Tensor], in_size: int, out_size: int):
        super().__init__()
        self.in_size = in_size
        self.out_size = out_size
        self.values = nn.Parameter(values, requires_grad=False)
        self.scales = nn.Parameter(scales.float(), requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias.detach().clone())
        self.tp = None

    def _apply(self, fn, recurse=True):
        # nn.Module casts every floating tensor it holds, fp8 payloads
        # included; apply ``fn`` to integer views of the payload and the
        # scales, which it can only move between devices.
        kept = {"values": self.values.dtype, "scales": self.scales.dtype}
        raw = {torch.float8_e4m3fn: torch.uint8, torch.float32: torch.int32}
        for name, dtype in kept.items():
            p = getattr(self, name)
            p.data = p.data.view(raw.get(dtype, dtype))
        try:
            return super()._apply(fn, recurse)
        finally:
            for name, dtype in kept.items():
                p = getattr(self, name)
                p.data = p.data.view(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _tp_input(self, x)
        w = QuantizedTensor(self.values, self.scales)
        out = int8_weight_only_matmul(x.reshape(-1, x.shape[-1]), w)
        out = _tp_output(self, out.reshape(*x.shape[:-1], -1))
        if self.bias is not None:
            out = out + self.bias
        return out


def quantize_linear(lin: Linear, dtype=torch.int8) -> QuantizedLinear:
    """Quantize a Linear's weights per output channel (int8 or fp8)."""
    if dtype not in (torch.int8, torch.float8_e4m3fn):
        raise TypeError(f"weights quantize to int8 or float8_e4m3fn, not {dtype}")
    quantize = quantize_int8 if dtype == torch.int8 else quantize_fp8
    q = quantize(lin.weights.detach(), axis=0)
    return QuantizedLinear(q.values, q.scales, lin.bias, lin.in_size,
                           lin.out_size)
