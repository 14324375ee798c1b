"""Fused LayerNorm, forward and backward (counterpart of
flashattn_tpu/ops/layernorm.py).

:func:`layernorm` is differentiable through :class:`_LayerNorm`, an
``autograd.Function`` that saves (x, gamma, mean, rstd) and computes the
gradients in one backward call.  On CUDA tensors both directions launch the
hand-written kernels of ``csrc/layernorm.cu`` (replacing the TPU kernels
``_ln_fwd_kernel`` and ``_ln_bwd_kernel``); on CPU tensors they run the
plain PyTorch versions beside them.
"""

from __future__ import annotations

import torch

from . import _build
from ._utils import on_cuda

_kernel = _build.Kernel("fa_layernorm_fwd", [_build.P] * 6 + [
    _build.I, _build.I, _build.F, _build.I, _build.I])
_bwd_kernel = _build.Kernel("fa_layernorm_bwd", [_build.P] * 10 + [
    _build.I] * 5)
# the backward's launch plan: how many partial rows of dgamma and dbeta it
# writes (its row kernel's block count) for given pointers and sizes
_BWD_PARTS = ("fa_layernorm_bwd_parts", [_build.P] * 4 + [_build.I] * 4)


def _check_params(h, gamma, beta):
    if gamma.shape != (h,) or beta.shape != (h,):
        raise ValueError(f"gamma/beta must be ({h},), got {tuple(gamma.shape)}"
                         f" and {tuple(beta.shape)}")
    if gamma.dtype != beta.dtype:
        raise TypeError("gamma and beta must share a dtype")


def layernorm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5):
    """Kernel launch: (y, mean, rstd) with y in x's dtype and mean/rstd f32 of
    shape (rows, 1), rows = x.numel() // x.shape[-1] — the outputs of the
    TPU kernel's ``_ln_fwd``."""
    h = x.shape[-1]
    _check_params(h, gamma, beta)
    x2 = x.detach().reshape(-1, h).contiguous()
    gamma, beta = gamma.detach().contiguous(), beta.detach().contiguous()
    n = x2.shape[0]
    y = torch.empty_like(x2)
    mean = torch.empty((n, 1), device=x.device, dtype=torch.float32)
    rstd = torch.empty((n, 1), device=x.device, dtype=torch.float32)
    _kernel(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, h, float(eps),
            _build.dtype_code(x2), _build.dtype_code(gamma))
    return y.reshape(x.shape), mean, rstd


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                  rstd: torch.Tensor, gamma: torch.Tensor):
    """Kernel launch: (dx, dgamma, dbeta), dx in x's dtype and dgamma/dbeta
    summed in f32 and returned in gamma's dtype — the outputs of the TPU
    kernel's ``_ln_bwd``.  One count covers its two launches (the rows, then
    the column sums of their partials).  The rows take the kernel's 16-byte
    path when h is a whole number of 16-byte chunks and x, dy, dx and gamma
    are 16-byte aligned, its generic path otherwise."""
    h = x.shape[-1]
    x2 = x.detach().reshape(-1, h).contiguous()
    dy2 = dy.detach().reshape(-1, h).to(x.dtype).contiguous()
    n = x2.shape[0]
    if mean.numel() != n or rstd.numel() != n or gamma.shape != (h,):
        raise ValueError("mean/rstd must hold one value per row and gamma "
                         f"({h},)")
    mean = mean.detach().float().contiguous()
    rstd = rstd.detach().float().contiguous()
    gamma = gamma.detach().contiguous()
    dx = torch.empty_like(x2)
    codes = _build.dtype_code(x2), _build.dtype_code(gamma)
    parts = _build.query(*_BWD_PARTS, x2.data_ptr(), dy2.data_ptr(),
                         gamma.data_ptr(), dx.data_ptr(), n, h, *codes)
    part = torch.empty((2, parts, h), device=x.device, dtype=torch.float32)
    dg = torch.empty_like(gamma)
    db = torch.empty_like(gamma)
    _bwd_kernel(x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
                part[0].data_ptr(), part[1].data_ptr(), dg.data_ptr(),
                db.data_ptr(), n, h, parts, *codes)
    return dx.reshape(x.shape), dg, db


def _layernorm_fwd_reference(x, gamma, beta, eps):
    """Plain version of :func:`layernorm_fwd`: (y, mean, rstd)."""
    h = x.shape[-1]
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mean.reshape(-1, 1), rstd.reshape(-1, 1)


def layernorm_bwd_reference(x, dy, mean, rstd, gamma):
    """Plain version of :func:`layernorm_bwd`: the explicit formulas of the
    TPU backward (flashattn_tpu/ops/layernorm.py:88-91), in f32."""
    h = x.shape[-1]
    xf = x.reshape(-1, h).float()
    dyf = dy.reshape(-1, h).float()
    xhat = (xf - mean) * rstd
    dyg = dyf * gamma.float()
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xhat).mean(-1, keepdim=True)
    dx = rstd * (dyg - m1 - xhat * m2)
    return (dx.to(x.dtype).reshape(x.shape), (dyf * xhat).sum(0).to(gamma.dtype),
            dyf.sum(0).to(gamma.dtype))


class _LayerNorm(torch.autograd.Function):
    """y = layernorm(x); the backward launches ``layernorm_bwd`` on CUDA."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        if on_cuda(x, gamma, beta):
            y, mean, rstd = layernorm_fwd(x, gamma, beta, eps)
        else:
            _check_params(x.shape[-1], gamma, beta)
            y, mean, rstd = _layernorm_fwd_reference(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        bwd = layernorm_bwd if on_cuda(x) else layernorm_bwd_reference
        dx, dg, db = bwd(x, dy, mean, rstd, gamma)
        return dx, dg, db, None


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer normalisation over the last dim of ``x`` (any leading dims);
    differentiable in x, gamma and beta."""
    return _LayerNorm.apply(x, gamma, beta, eps)


def layernorm_reference(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: statistics in f32, result in x's dtype."""
    return _layernorm_fwd_reference(x, gamma, beta, eps)[0]
