"""Fused LayerNorm forward (counterpart of flashattn_tpu/ops/layernorm.py).

On a CUDA tensor :func:`layernorm` launches the hand-written kernel
``csrc/layernorm.cu`` (replacing the TPU kernel ``_ln_fwd_kernel``); on a
CPU tensor it runs :func:`layernorm_reference`.  Forward-only on CUDA: the
backward kernel (``_ln_bwd_kernel``) belongs to the training slice.
"""

from __future__ import annotations

import torch

from . import _build
from ._utils import check_no_grad, on_cuda

_kernel = _build.Kernel("fa_layernorm_fwd", [_build.P] * 6 + [
    _build.I, _build.I, _build.F, _build.I, _build.I])


def layernorm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5):
    """Kernel launch: (y, mean, rstd) with y in x's dtype and mean/rstd f32 of
    shape (rows, 1), rows = x.numel() // x.shape[-1] — the outputs of the
    TPU kernel's ``_ln_fwd``."""
    check_no_grad(x, gamma, beta)
    h = x.shape[-1]
    if gamma.shape != (h,) or beta.shape != (h,):
        raise ValueError(f"gamma/beta must be ({h},), got {tuple(gamma.shape)}"
                         f" and {tuple(beta.shape)}")
    if gamma.dtype != beta.dtype:
        raise TypeError("gamma and beta must share a dtype")
    x2 = x.reshape(-1, h).contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    n = x2.shape[0]
    y = torch.empty_like(x2)
    mean = torch.empty((n, 1), device=x.device, dtype=torch.float32)
    rstd = torch.empty((n, 1), device=x.device, dtype=torch.float32)
    _kernel(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, h, float(eps),
            _build.dtype_code(x2), _build.dtype_code(gamma))
    return y.reshape(x.shape), mean, rstd


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer normalisation over the last dim of ``x`` (any leading dims)."""
    if on_cuda(x, gamma, beta):
        return layernorm_fwd(x, gamma, beta, eps)[0]
    return layernorm_reference(x, gamma, beta, eps)


def layernorm_reference(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: statistics in f32, result in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)
