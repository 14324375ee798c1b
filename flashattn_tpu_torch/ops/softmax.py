"""Fused masked attention softmax, forward and backward (counterpart of
flashattn_tpu/ops/softmax.py).

:func:`attn_softmax` is a softmax over the last dim of ``(B, H, F, T)``
scores with an optional additive f32 mask broadcast as (B|1, H|1, F|1, T)
and an optional ``causal`` flag that REPLACES every entry with col > row
(aligned top-left) by ``DEFAULT_MASK_VALUE``.  It is differentiable through
:class:`_AttnSoftmax`, which saves the output and nothing else; the mask
gets no gradient, as in the JAX custom VJP.

On CUDA tensors both directions launch the hand-written kernels of
``csrc/softmax.cu`` (replacing the TPU kernels ``_softmax_fwd_kernel``,
``_softmax_fwd_nomask_kernel`` and ``_softmax_bwd_kernel``) whatever
``impl`` says: the JAX package's ``impl="auto"`` picks its op graph from a
TPU measurement that does not carry over.  On CPU tensors the plain versions
beside them run.  There is no fallback and no length cap: any T works.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._utils import DEFAULT_MASK_VALUE, on_cuda

_fwd_kernel = _build.Kernel("fa_softmax_fwd", [
    _build.P, _build.P, _build.P, _build.I64, _build.I, _build.I, _build.I,
    _build.I64, _build.I64, _build.I64, _build.I, _build.I])
_bwd_kernel = _build.Kernel("fa_softmax_bwd", [
    _build.P, _build.P, _build.P, _build.I64, _build.I, _build.I])

_IMPLS = ("auto", "pallas")


def _check(inp: torch.Tensor, mask: Optional[torch.Tensor]):
    if inp.dim() != 4:
        raise ValueError(f"scores must be (B, H, F, T), got {tuple(inp.shape)}")
    if mask is None:
        return
    if mask.dim() != 4 or any(m not in (1, s) for m, s in
                              zip(mask.shape[:3], inp.shape[:3])) \
            or mask.shape[3] != inp.shape[3]:
        raise ValueError(f"mask {tuple(mask.shape)} does not broadcast as "
                         f"(B|1, H|1, F|1, T) over {tuple(inp.shape)}")


def softmax_fwd(inp: torch.Tensor, mask: Optional[torch.Tensor] = None,
                causal: bool = False) -> torch.Tensor:
    """Kernel launch: the masked / causal row softmax, f32 inside, in inp's
    dtype.  The mask is read through zero strides on its broadcast dims."""
    _check(inp, mask)
    b, h, f, t = inp.shape
    x = _build.aligned(inp.detach())
    out = torch.empty_like(x)
    strides, mask_ptr = (0, 0, 0), None
    if mask is not None:
        mask = _build.aligned(mask.detach().float())
        mb, mh, mf, _ = mask.shape
        strides = ((mb != 1) * mh * mf * t, (mh != 1) * mf * t, (mf != 1) * t)
        mask_ptr = mask.data_ptr()
    _fwd_kernel(x.data_ptr(), mask_ptr, out.data_ptr(), b * h * f, h, f, t,
                *strides, int(causal), _build.dtype_code(x))
    return out


def softmax_bwd(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Kernel launch: dinp = out * (dout - sum_row(dout * out)), f32
    accumulation, in out's dtype."""
    o = _build.aligned(out.detach())
    g = _build.aligned(dout.detach().to(out.dtype))
    if g.shape != o.shape:
        raise ValueError(f"dout {tuple(g.shape)} does not match out "
                         f"{tuple(o.shape)}")
    dinp = torch.empty_like(o)
    t = o.shape[-1]
    _bwd_kernel(o.data_ptr(), g.data_ptr(), dinp.data_ptr(), o.numel() // t,
                t, _build.dtype_code(o))
    return dinp


def attn_softmax_reference(inp: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version: f32 inside (mask added, then the causal entries
    replaced), the result in inp's dtype."""
    _check(inp, mask)
    x = inp.float()
    if mask is not None:
        x = x + mask.float()
    if causal:
        f, t = x.shape[-2:]
        rows = torch.arange(f, device=x.device)[:, None]
        cols = torch.arange(t, device=x.device)[None, :]
        x = x.masked_fill(cols > rows, DEFAULT_MASK_VALUE)
    return torch.softmax(x, dim=-1).to(inp.dtype)


def softmax_bwd_reference(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`softmax_bwd`, in f32."""
    o, g = out.float(), dout.float()
    return (o * (g - (o * g).sum(-1, keepdim=True))).to(out.dtype)


class _AttnSoftmax(torch.autograd.Function):
    """out = attn_softmax(inp, mask, causal); saves out, no mask gradient."""

    @staticmethod
    def forward(ctx, inp, mask, causal):
        fwd = softmax_fwd if on_cuda(inp, mask) else attn_softmax_reference
        out = fwd(inp, mask, causal)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, dout):
        (out,) = ctx.saved_tensors
        bwd = softmax_bwd if on_cuda(out) else softmax_bwd_reference
        return bwd(out, dout), None, None


def attn_softmax_pallas(inp: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """The kernel route of :func:`attn_softmax`, under the JAX package's
    name: the hand-written kernels on CUDA tensors (the plain versions on
    the CPU), differentiable through :class:`_AttnSoftmax`."""
    return _AttnSoftmax.apply(inp, mask, bool(causal))


def attn_softmax(inp: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 causal: bool = False, impl: str = "auto") -> torch.Tensor:
    """Fused masked softmax over the last dim of ``(B, H, F, T)`` scores.

    ``mask`` is additive, broadcastable as (B|1, H|1, F|1, T); ``causal``
    applies the triangular future mask in the kernel.  ``impl`` is "auto" or
    "pallas" (the JAX package's names); both run the kernel on CUDA and the
    plain version on the CPU."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want one of {_IMPLS})")
    return attn_softmax_pallas(inp, mask, causal)
