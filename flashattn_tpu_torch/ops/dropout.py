"""Fused dropout (counterpart of flashattn_tpu/ops/dropout.py::fused_dropout).

out = keep * x / (1 - rate), where keep = bits >= floor(rate * 2^32) as in
the TPU kernel's ``_keep``.  On a CUDA tensor the hand-written kernel
``csrc/dropout.cu`` runs (replacing the TPU kernel ``_mask_scale_kernel``);
on a CPU tensor the plain version :func:`dropout_reference`.

The random bits are Philox4x32-10 keyed by the whole 64-bit ``seed``:
element i takes word i % 4 of the block at counter i // 4.  The plain
version computes the same bits with int64 tensor ops (32 x 32-bit products
split into 16-bit halves so that they do not overflow), so a mask is
bit-identical on the CPU and on the card — not the TPU's bits, which come
from its in-core generator.

Backward regenerates the mask from the seed and saves nothing, as the TPU
path's ``_dropout_p`` does: dropout is its own adjoint.  The variants with
bias, residual or activation (``fused_dropout_res_bias``,
``fused_dropout_act_bias``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._utils import cdiv, on_cuda

_kernel = _build.Kernel("fa_dropout", [_build.P, _build.P, _build.I64,
                                       _build.U64, _build.U32, _build.F,
                                       _build.I])

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a 32-bit constant ``a`` and an
    int64 tensor ``b`` of 32-bit values, without int64 overflow."""
    p0 = a * (b & 0xFFFF)                  # < 2^48
    p1 = a * (b >> 16)                     # < 2^48
    mid = p0 + ((p1 & 0xFFFF) << 16)       # < 2^49
    return (p1 >> 16) + (mid >> 32), mid & _M32


def philox4x32(counter: torch.Tensor, key: tuple) -> torch.Tensor:
    """Philox4x32-10 of an int64 (..., 4) tensor of 32-bit counter words
    under a (k0, k1) key of 32-bit ints; returns (..., 4) int64 words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], -1)


def _threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def philox_bits(n: int, seed: int, device=None) -> torch.Tensor:
    """The (n,) int64 tensor of 32-bit words that element i of a kernel
    keyed by ``seed`` draws: word i % 4 of the Philox block at counter
    i // 4 (``csrc/philox.cuh``)."""
    j = torch.arange(cdiv(n, 4), device=device, dtype=torch.int64)
    zero = torch.zeros_like(j)
    bits = philox4x32(torch.stack([j & _M32, j >> 32, zero, zero], -1),
                      (seed & _M32, (seed >> 32) & _M32))
    return bits.reshape(-1)[:n]


def keep_mask(n: int, rate: float, seed: int, device=None) -> torch.Tensor:
    """The (n,) bool keep mask of a dropout of ``n`` elements."""
    return philox_bits(n, seed, device) >= _threshold(rate)


def _check(rate: float, seed: int):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be a 64-bit unsigned int, got {seed}")


def dropout(x: torch.Tensor, rate: float, seed: int,
            scale: float) -> torch.Tensor:
    """Kernel launch: keep ? x * scale : 0 (f32 arithmetic, x's dtype)."""
    _check(rate, seed)
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    _kernel(x.data_ptr(), out.data_ptr(), x.numel(), seed, _threshold(rate),
            float(scale), _build.dtype_code(x))
    return out


def dropout_reference(x: torch.Tensor, rate: float, seed: int,
                      scale: float) -> torch.Tensor:
    """Plain version of :func:`dropout`, bit for bit."""
    _check(rate, seed)
    keep = keep_mask(x.numel(), rate, seed, x.device).reshape(x.shape)
    y = x.float() * torch.tensor(scale, dtype=torch.float32)
    return torch.where(keep, y, torch.zeros_like(y)).to(x.dtype)


def _mask_scale(x, rate, seed, scale):
    if on_cuda(x):
        return dropout(x, rate, seed, scale)
    return dropout_reference(x, rate, seed, scale)


class _Dropout(torch.autograd.Function):
    """The mask-and-scale pass, forward and backward alike."""

    @staticmethod
    def forward(ctx, x, rate, seed, scale):
        ctx.args = (rate, seed, scale)
        return _mask_scale(x, rate, seed, scale)

    @staticmethod
    def backward(ctx, g):
        return _mask_scale(g, *ctx.args), None, None, None


def fused_dropout(x: torch.Tensor, rate: float, seed: Optional[int],
                  scale: bool = True) -> torch.Tensor:
    """Inverted dropout of ``x`` keyed by ``seed`` (an int in [0, 2^64));
    the identity when ``rate <= 0`` or ``seed`` is None.  ``scale=False``
    keeps the survivors unscaled (``nn.functional.dropout(scale=False)``)."""
    if rate <= 0.0 or seed is None:
        return x
    _check(rate, int(seed))
    factor = 1.0 / (1.0 - rate) if scale else 1.0
    return _Dropout.apply(x, float(rate), int(seed), factor)
