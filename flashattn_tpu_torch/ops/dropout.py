"""Fused dropout and its bias variants (counterpart of
flashattn_tpu/ops/dropout.py).

out = keep * x / (1 - rate), where keep = bits >= floor(rate * 2^32) as in
the TPU kernel's ``_keep``.  The kept value is divided (not multiplied by a
reciprocal) by 1 - rate rounded to the dtype it meets, as JAX's weakly
typed ``x / (1.0 - rate)`` does: by bf16(0.9) = 0.8984375 for a bf16 x.  On a CUDA tensor the hand-written kernel
``csrc/dropout.cu`` runs (replacing the TPU kernel ``_mask_scale_kernel``);
on a CPU tensor the plain version :func:`dropout_reference`.

The random bits are Philox4x32-10 keyed by the whole 64-bit ``seed``:
element i takes word i % 4 of the block at counter i // 4.  The plain
version computes the same bits with int64 tensor ops (32 x 32-bit products
split into 16-bit halves so that they do not overflow), so a mask is
bit-identical on the CPU and on the card — not the TPU's bits, which come
from its in-core generator.

Backward regenerates the mask from the seed and saves nothing, as the TPU
path's ``_dropout_p`` does: dropout is its own adjoint.

The variants with bias, residual or activation, :func:`fused_dropout_res_bias`
(``r + dropout(x + b)``) and :func:`fused_dropout_act_bias`
(``dropout(act(x + b))``, GELU-tanh or ReLU), launch ``csrc/dropout_bias.cu``
on CUDA tensors (replacing the TPU kernels ``_res_bias_kernel``,
``_act_bias_kernel``, ``_mask_colsum_kernel`` and ``_act_bias_bwd_kernel``)
and draw the same keep mask from the same seed as :func:`fused_dropout`.
Their backwards are kernels too (dx, and db summed over rows in a fixed
order); they save x and the bias, never the mask.  Any shape works: the
TPU's ``d % 128 == 0`` eligibility is dropped.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._utils import cdiv, gelu_tanh, in_dtype, on_cuda

_kernel = _build.Kernel("fa_dropout", [_build.P, _build.P, _build.I64,
                                       _build.U64, _build.U32, _build.F,
                                       _build.I])

_res_kernel = _build.Kernel("fa_dropout_res_bias", [
    _build.P] * 6 + [_build.I64, _build.I, _build.U64, _build.U32, _build.F,
                     _build.I, _build.I])
_act_kernel = _build.Kernel("fa_dropout_act_bias", [
    _build.P] * 6 + [_build.I64, _build.I, _build.U64, _build.U32, _build.F,
                     _build.I, _build.I, _build.I])

_ACTS = {"gelu": 0, "relu": 1}
_GELU_C = 0.7978845608028654   # sqrt(2 / pi), f32 in the act-bias kernels

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


def philox_bits(n: int, seed: int, device=None,
                offset: int = 0) -> torch.Tensor:
    """The (n,) int64 tensor of 32-bit words that elements offset ..
    offset + n - 1 of a kernel keyed by ``seed`` draw: element i takes
    word i % 4 of the Philox block at counter i // 4
    (``csrc/philox.cuh``)."""
    j = torch.arange(offset // 4, cdiv(offset + n, 4), device=device,
                     dtype=torch.int64)
    zero = torch.zeros_like(j)
    bits = philox4x32(torch.stack([j & _M32, j >> 32, zero, zero], -1),
                      (seed & _M32, (seed >> 32) & _M32))
    start = offset % 4
    return bits.reshape(-1)[start:start + n]


def keep_mask(n: int, rate: float, seed: int, device=None,
              offset: int = 0) -> torch.Tensor:
    """The (n,) bool keep mask of elements offset .. offset + n - 1 of a
    dropout."""
    return philox_bits(n, seed, device, offset) >= _threshold(rate)


def _check(rate: float, seed: int):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be a 64-bit unsigned int, got {seed}")


def _divisor(rate: float, dtype: torch.dtype, scale: bool = True) -> float:
    """What a kept value is divided by: 1 - rate in ``dtype`` (1 for
    ``scale=False``)."""
    return in_dtype(1.0 - rate, dtype) if scale else 1.0


def _divide(y: torch.Tensor, div: float) -> torch.Tensor:
    """f32 ``y / div``, a true division on any device: a Python or host
    divisor would make PyTorch's CUDA kernel multiply by its reciprocal."""
    return y / torch.tensor(div, dtype=torch.float32, device=y.device)


def _empty_alike(x: torch.Tensor) -> torch.Tensor:
    """An empty contiguous tensor shaped as contiguous ``x`` whose address
    lies as far past a 16-byte boundary as x's, so that the kernel's 16-byte
    accesses line up in both (for an x that is a view with a storage offset,
    a view into a buffer 16 bytes longer)."""
    off = x.data_ptr() % 16
    if off == 0:
        return torch.empty_like(x)
    isz = x.element_size()
    buf = torch.empty(x.numel() + 16 // isz, dtype=x.dtype, device=x.device)
    start = (off - buf.data_ptr() % 16) % 16 // isz
    return buf[start:start + x.numel()].view(x.shape)


def dropout(x: torch.Tensor, rate: float, seed: int,
            scale: bool = True, offset: int = 0) -> torch.Tensor:
    """Kernel launch: keep ? x / (1 - rate) : 0, 1 - rate rounded to x's
    dtype (f32 division, rounded once to x's dtype); ``scale=False`` keeps
    the survivors as they are.  ``offset`` > 0 (a rank's block of a batch
    split over ranks) runs the kernel over ``offset`` leading zeros and
    ``x``, whose tail is the block's mask: the kernel has no counter
    offset, so this costs ``offset`` more elements."""
    _check(rate, seed)
    x = x.detach().contiguous()
    if offset:
        padded = torch.zeros(offset + x.numel(), dtype=x.dtype,
                             device=x.device)
        padded[offset:] = x.reshape(-1)
        return dropout(padded, rate, seed, scale)[offset:].view(x.shape)
    out = _empty_alike(x)
    _kernel(x.data_ptr(), out.data_ptr(), x.numel(), seed, _threshold(rate),
            _divisor(rate, x.dtype, scale), _build.dtype_code(x))
    return out


def dropout_reference(x: torch.Tensor, rate: float, seed: int,
                      scale: bool = True, offset: int = 0) -> torch.Tensor:
    """Plain version of :func:`dropout`, bit for bit."""
    _check(rate, seed)
    keep = keep_mask(x.numel(), rate, seed, x.device, offset).reshape(x.shape)
    y = _divide(x.float(), _divisor(rate, x.dtype, scale))
    return torch.where(keep, y, torch.zeros_like(y)).to(x.dtype)


def _mask_scale(x, rate, seed, scale, offset):
    if on_cuda(x):
        return dropout(x, rate, seed, scale, offset)
    return dropout_reference(x, rate, seed, scale, offset)


class _Dropout(torch.autograd.Function):
    """The mask-and-scale pass, forward and backward alike."""

    @staticmethod
    def forward(ctx, x, rate, seed, scale, offset):
        ctx.args = (rate, seed, scale, offset)
        return _mask_scale(x, rate, seed, scale, offset)

    @staticmethod
    def backward(ctx, g):
        return _mask_scale(g, *ctx.args), None, None, None, None


def fused_dropout(x: torch.Tensor, rate: float, seed: Optional[int],
                  scale: bool = True, offset: int = 0) -> torch.Tensor:
    """Inverted dropout of ``x`` keyed by ``seed`` (an int in [0, 2^64));
    the identity when ``rate <= 0`` or ``seed`` is None.  ``scale=False``
    keeps the survivors unscaled (``nn.functional.dropout(scale=False)``).
    ``offset``: ``x`` is elements [offset, offset + numel) of a larger
    tensor and takes their mask."""
    if rate <= 0.0 or seed is None:
        return x
    _check(rate, int(seed))
    return _Dropout.apply(x, float(rate), int(seed), bool(scale), int(offset))


# -- dropout with bias, residual or activation ---------------------------------


def _flat(x: torch.Tensor, bias: torch.Tensor):
    """x as (n, d) and the bias as (d,)."""
    d = x.shape[-1]
    if bias.numel() != d:
        raise ValueError(f"bias must hold {d} values, got {tuple(bias.shape)}")
    return x.reshape(-1, d), bias.reshape(d)


def _act(u: torch.Tensor, act: str) -> torch.Tensor:
    """act(u) in u's dtype (GELU's constants too, as in JAX)."""
    if act == "gelu":
        return gelu_tanh(u)
    return torch.clamp_min(u, 0.0)


def _biased(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """f32 of x + b rounded to x's dtype: the TPU kernels add in the input
    dtype before any upcast (flashattn_tpu/ops/dropout.py:87, :95, :135)."""
    return (x.float() + bias.float()).to(x.dtype).float()


def _act_grad(u: torch.Tensor, act: str) -> torch.Tensor:
    """act'(u) by the formula of the TPU backward kernel
    (flashattn_tpu/ops/dropout.py:136-142)."""
    if act == "gelu":
        t = torch.tanh(_GELU_C * (u + 0.044715 * (u * u * u)))
        return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _GELU_C * (
            1.0 + 3 * 0.044715 * u * u)
    return (u > 0.0).float()


def _bias_launch(kernel, a, bias, rate, seed, div, *, x=None, r=None,
                 act=None, backward=False):
    """Launch a bias kernel on (n, d) ``a`` (x, or g in the backward), kept
    values divided by ``div``; returns out, or (dx, db f32) in the
    backward."""
    _check(rate, seed)
    n, d = a.shape
    a = _build.aligned(a.detach())
    out = torch.empty_like(a)
    part = db = None
    if backward:
        # the kernel's row lanes, each of which leaves one row of db partials
        lanes = _build.query("fa_dropout_bias_lanes", [_build.I64, _build.I,
                                                       _build.I, _build.I],
                             n, d, -1 if act is None else _ACTS[act],
                             _build.dtype_code(a))
        part = torch.empty((lanes, d), device=a.device, dtype=torch.float32)
        db = torch.empty(d, device=a.device, dtype=torch.float32)
    if bias is not None:
        bias = _build.aligned(bias.detach().float())
    if x is not None:
        x = _build.aligned(x.detach())
    if r is not None:
        r = _build.aligned(r.detach().to(a.dtype))
    ptrs = ([a, x, bias, out, part, db] if kernel is _act_kernel
            else [a, bias, r, out, part, db])
    kernel(*[None if t is None else t.data_ptr() for t in ptrs], n, d, seed,
           _threshold(rate), float(div),
           *([] if act is None else [_ACTS[act]]), int(backward),
           _build.dtype_code(a))
    return (out, db) if backward else out


def dropout_res_bias(x, bias, residual, rate, seed, scale=True):
    """Kernel launch: r + keep(x + b) / (1 - rate) over (n, d) x and
    residual of one dtype T, rounded as JAX rounds: x + b to T, the
    quotient (by 1 - rate in T) to T, then r + it to T."""
    return _bias_launch(_res_kernel, x, bias, rate, seed,
                        _divisor(rate, x.dtype, scale), r=residual)


def dropout_res_bias_bwd(g, rate, seed, scale=True):
    """Kernel launch: (dx, db) with dx = keep(g) / (1 - rate) in f32 and db
    its f32 column sum; one count covers its two launches (dx and the
    partials, then their column sum).  dr = g needs no launch."""
    return _bias_launch(_res_kernel, g, None, rate, seed,
                        _divisor(rate, torch.float32, scale), backward=True)


def dropout_act_bias(x, bias, rate, seed, scale=True, act="gelu"):
    """Kernel launch: keep(act(x + b)) / (1 - rate) over (n, d) x, x + b
    rounded to x's dtype, the rest in f32."""
    return _bias_launch(_act_kernel, x, bias, rate, seed,
                        _divisor(rate, torch.float32, scale), act=act)


def dropout_act_bias_bwd(g, x, bias, rate, seed, scale=True, act="gelu"):
    """Kernel launch: (dx, db) with dx = keep(g) / (1 - rate) * act'(x + b)
    in f32 and db its f32 column sum (two launches, one count)."""
    return _bias_launch(_act_kernel, g.to(x.dtype), bias, rate, seed,
                        _divisor(rate, torch.float32, scale), x=x, act=act,
                        backward=True)


def _keep2d(shape, rate, seed, device):
    return keep_mask(shape[0] * shape[1], rate, seed, device).reshape(shape)


def dropout_res_bias_reference(x, bias, residual, rate, seed, scale=True):
    """Plain version of :func:`dropout_res_bias`, bit for bit."""
    _check(rate, seed)
    keep = _keep2d(x.shape, rate, seed, x.device)
    y = _divide(_biased(x, bias), _divisor(rate, x.dtype, scale))
    y = torch.where(keep, y.to(x.dtype).float(), torch.zeros_like(y))
    return (residual.float() + y).to(x.dtype)


def dropout_res_bias_bwd_reference(g, rate, seed, scale=True):
    """Plain version of :func:`dropout_res_bias_bwd`: (dx, db f32)."""
    _check(rate, seed)
    keep = _keep2d(g.shape, rate, seed, g.device)
    dx = _divide(g.float(), _divisor(rate, torch.float32, scale))
    dx = torch.where(keep, dx, torch.zeros_like(dx))
    return dx.to(g.dtype), dx.sum(0)


def dropout_act_bias_reference(x, bias, rate, seed, scale=True, act="gelu"):
    """Plain version of :func:`dropout_act_bias`."""
    _check(rate, seed)
    keep = _keep2d(x.shape, rate, seed, x.device)
    y = _divide(_act(_biased(x, bias), act),
                _divisor(rate, torch.float32, scale))
    return torch.where(keep, y, torch.zeros_like(y)).to(x.dtype)


def dropout_act_bias_bwd_reference(g, x, bias, rate, seed, scale=True,
                                   act="gelu"):
    """Plain version of :func:`dropout_act_bias_bwd`: (dx, db f32)."""
    _check(rate, seed)
    keep = _keep2d(g.shape, rate, seed, g.device)
    dy = _divide(g.float(), _divisor(rate, torch.float32, scale))
    dy = torch.where(keep, dy, torch.zeros_like(dy))
    dx = dy * _act_grad(_biased(x, bias), act)
    return dx.to(x.dtype), dx.sum(0)


class _DropoutResBias(torch.autograd.Function):
    """residual + dropout(x + bias) over (n, d); saves nothing."""

    @staticmethod
    def forward(ctx, x, bias, residual, rate, seed, scale):
        ctx.args = (rate, seed, scale)
        ctx.bias_dtype = bias.dtype
        fwd = dropout_res_bias if on_cuda(x, bias, residual) else \
            dropout_res_bias_reference
        return fwd(x, bias, residual, rate, seed, scale)

    @staticmethod
    def backward(ctx, g):
        bwd = dropout_res_bias_bwd if on_cuda(g) else \
            dropout_res_bias_bwd_reference
        dx, db = bwd(g, *ctx.args)
        return dx, db.to(ctx.bias_dtype), g, None, None, None


class _DropoutActBias(torch.autograd.Function):
    """dropout(act(x + bias)) over (n, d); saves x and the bias."""

    @staticmethod
    def forward(ctx, x, bias, rate, seed, scale, act):
        ctx.args = (rate, seed, scale, act)
        ctx.save_for_backward(x, bias)
        fwd = dropout_act_bias if on_cuda(x, bias) else \
            dropout_act_bias_reference
        return fwd(x, bias, rate, seed, scale, act)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        bwd = dropout_act_bias_bwd if on_cuda(x) else \
            dropout_act_bias_bwd_reference
        dx, db = bwd(g, x, bias, *ctx.args)
        return dx, db.to(bias.dtype), None, None, None, None


def fused_dropout_res_bias(x: torch.Tensor, bias: torch.Tensor,
                           residual: torch.Tensor, rate: float,
                           seed: Optional[int]) -> torch.Tensor:
    """``residual + dropout(x + bias)`` in one pass, keyed by ``seed`` (an
    int in [0, 2^64)); the plain ``residual + x + bias`` when ``rate <= 0``
    or ``seed`` is None.  x and residual share a shape (any leading dims);
    the bias holds x.shape[-1] values.  The result takes the promoted dtype
    of the three."""
    if rate <= 0.0 or seed is None:
        return residual + (x + bias)
    _check(rate, int(seed))
    dtype = torch.promote_types(torch.promote_types(x.dtype, bias.dtype),
                                residual.dtype)
    x2, b = _flat(x.to(dtype), bias)
    out = _DropoutResBias.apply(x2, b, residual.to(dtype).reshape(x2.shape),
                                float(rate), int(seed), True)
    return out.reshape(x.shape)


def fused_dropout_act_bias(x: torch.Tensor, bias: torch.Tensor, rate: float,
                           seed: Optional[int],
                           act: str = "gelu") -> torch.Tensor:
    """``dropout(act(x + bias))`` in one pass, ``act`` "gelu" (tanh
    approximation) or "relu"; the plain ``act(x + bias)`` when ``rate <= 0``
    or ``seed`` is None.  The result takes the promoted dtype of x and the
    bias."""
    if act not in _ACTS:
        raise ValueError(f"act must be 'gelu' or 'relu', got {act!r}")
    if rate <= 0.0 or seed is None:
        return _act(x + bias, act)
    _check(rate, int(seed))
    x2, b = _flat(x.to(torch.promote_types(x.dtype, bias.dtype)), bias)
    out = _DropoutActBias.apply(x2, b, float(rate), int(seed), True, act)
    return out.reshape(x.shape)
