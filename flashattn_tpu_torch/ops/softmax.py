"""Fused masked attention softmax, forward and backward (counterpart of
flashattn_tpu/ops/softmax.py).

:func:`attn_softmax` is a softmax over the last dim of ``(B, H, F, T)``
scores with an optional additive mask broadcast as (B|1, H|1, F|1, T) and
an optional ``causal`` flag that REPLACES every entry with col > row
(aligned top-left) by ``DEFAULT_MASK_VALUE``.  The mask gets no gradient,
as in the JAX custom VJP.  ``impl`` picks one of the JAX package's two
functions:

* ``"auto"``: JAX's op graph (``attn_softmax_reference``, which JAX's
  ``impl="auto"`` runs), rounded where JAX rounds.  The result has JAX's
  promoted dtype of (scores, mask); in bf16 the mask is added in bf16, the
  causal entries become bf16(DEFAULT_MASK_VALUE), and d = x - max, e =
  exp(d), w = sum_f32(e) and out = e / w are each rounded to bf16.  The
  backward is JAX's autodiff of that graph (:func:`_softmax_bwd_op_graph`);
  it rebuilds e and w from the saved scores.
* ``"pallas"``: the Pallas kernels' function: f32 inside, the result in
  the scores' dtype; the backward is out * (dout - sum_row(dout * out)) in
  f32 from the saved output.

For f32 the two are one function.  On CUDA tensors both launch the
hand-written kernels of ``csrc/softmax.cu`` (replacing the TPU kernels
``_softmax_fwd_kernel``, ``_softmax_fwd_nomask_kernel`` and
``_softmax_bwd_kernel``), the rounding a template flag of each; on CPU
tensors the plain versions beside them run.  There is no fallback and no
length cap: any T works.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._utils import DEFAULT_MASK_VALUE, on_cuda

_fwd_kernel = _build.Kernel("fa_softmax_fwd", [
    _build.P, _build.P, _build.P, _build.I64, _build.I, _build.I, _build.I,
    _build.I64, _build.I64, _build.I64, _build.I, _build.I, _build.I])
_bwd_kernel = _build.Kernel("fa_softmax_bwd", [
    _build.P, _build.P, _build.P, _build.P, _build.I64, _build.I, _build.I,
    _build.I, _build.I64, _build.I64, _build.I64, _build.I, _build.I,
    _build.I])

_IMPLS = ("auto", "pallas")
# XLA:CPU rewrites a reduction longer than this into windows of this size
# (its TreeReductionRewriter), each summed in order
_XLA_WINDOW = 32


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


def _check_impl(impl: str):
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want one of {_IMPLS})")


def _op_graph(dtype: torch.dtype, impl: str) -> bool:
    """True where the two functions differ: JAX's op graph in bf16."""
    return impl == "auto" and dtype == torch.bfloat16


def _mask_args(mask: Optional[torch.Tensor], t: int):
    """The mask as the kernels read it (f32, T contiguous, 16-byte aligned:
    a bf16 mask's values are exact in f32) and its B, H, F strides in
    elements, 0 on a broadcast dim."""
    if mask is None:
        return None, (0, 0, 0), None
    mask = _build.aligned(mask.detach().float())
    mb, mh, mf, _ = mask.shape
    strides = ((mb != 1) * mh * mf * t, (mh != 1) * mf * t, (mf != 1) * t)
    return mask, strides, mask.data_ptr()


def softmax_fwd(inp: torch.Tensor, mask: Optional[torch.Tensor] = None,
                causal: bool = False, impl: str = "pallas") -> torch.Tensor:
    """Kernel launch: the masked / causal row softmax in inp's dtype, with
    ``impl``'s rounding (module docstring).  The mask is read through zero
    strides on its broadcast dims."""
    _check(inp, mask)
    _check_impl(impl)
    b, h, f, t = inp.shape
    x = _build.aligned(inp.detach())
    out = torch.empty_like(x)
    mask, strides, mask_ptr = _mask_args(mask, t)
    _fwd_kernel(x.data_ptr(), mask_ptr, out.data_ptr(), b * h * f, h, f, t,
                *strides, int(causal), int(_op_graph(x.dtype, impl)),
                _build.dtype_code(x))
    return out


def softmax_bwd(res: torch.Tensor, dout: torch.Tensor,
                mask: Optional[torch.Tensor] = None, causal: bool = False,
                impl: str = "pallas") -> torch.Tensor:
    """Kernel launch: dinp in res's dtype.  ``impl="pallas"`` (or f32):
    ``res`` is the forward's output and dinp = out * (dout - sum_row(dout *
    out)) with f32 accumulation (``mask`` and ``causal`` unused).
    ``impl="auto"`` in bf16: ``res`` is the forward's input, whose m, e and
    w the kernel rebuilds for each row before it applies JAX's autodiff of
    the op graph (:func:`_softmax_bwd_op_graph`)."""
    _check_impl(impl)
    r = _build.aligned(res.detach())
    g = _build.aligned(dout.detach().to(r.dtype))
    if g.shape != r.shape:
        raise ValueError(f"dout {tuple(g.shape)} does not match "
                         f"{tuple(r.shape)}")
    op = _op_graph(r.dtype, impl)
    if op:
        _check(r, mask)
    else:
        mask = None
    b, h, f, t = r.shape if r.dim() == 4 else (1, 1, r.numel() // r.shape[-1],
                                               r.shape[-1])
    mask, strides, mask_ptr = _mask_args(mask, t)
    dinp = torch.empty_like(r)
    _bwd_kernel(r.data_ptr(), mask_ptr, g.data_ptr(), dinp.data_ptr(),
                b * h * f, h, f, t, *strides, int(causal and op), int(op),
                _build.dtype_code(r))
    return dinp


def _masked_scores(inp, mask, causal):
    """x [+ mask] in their promoted dtype, the causal entries replaced by
    DEFAULT_MASK_VALUE rounded to that dtype through f32 (JAX's f32
    constant, converted)."""
    x = inp if mask is None else inp + mask
    if causal:
        f, t = x.shape[-2:]
        future = torch.ones(f, t, dtype=torch.bool, device=x.device).triu(1)
        fill = torch.tensor(DEFAULT_MASK_VALUE, dtype=torch.float32)
        x = x.masked_fill(future, float(fill.to(x.dtype)))
    return x


def attn_softmax_reference(inp: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of JAX's op graph (``attn_softmax_reference``,
    ``jax.nn.softmax``), one op at a time in the promoted dtype of (inp,
    mask): in bf16 each op rounds its f32 result, as XLA does, and the row
    sum accumulates in f32."""
    _check(inp, mask)
    x = _masked_scores(inp, mask, causal)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.float().sum(-1, keepdim=True).to(x.dtype)


def _attn_softmax_pallas_reference(inp: torch.Tensor,
                                   mask: Optional[torch.Tensor] = None,
                                   causal: bool = False) -> torch.Tensor:
    """Plain version of the Pallas kernel's function: f32 inside (mask added,
    then the causal entries replaced), the result in inp's dtype."""
    _check(inp, mask)
    x = _masked_scores(inp.float(), None if mask is None else mask.float(),
                       causal)
    return torch.softmax(x, dim=-1).to(inp.dtype)


def softmax_bwd_reference(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`softmax_bwd` for ``impl="pallas"``, in f32."""
    o, g = out.float(), dout.float()
    return (o * (g - (o * g).sum(-1, keepdim=True))).to(out.dtype)


def _xla_bf16_sum(z: torch.Tensor) -> torch.Tensor:
    """Row sums of bf16 ``z`` as XLA:CPU computes a bf16 ``reduce_sum``
    (``jax.jit(f).lower(...).compile().as_text()``): a row longer than 32
    is padded with zeros, pad // 2 in front, to whole windows of 32 and
    each window summed, recursively, until at most 32 values are left; every
    sum runs in order from 0 with the running value rounded to bf16 after
    each add."""
    def in_order(v):
        acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
        for j in range(v.shape[-1]):
            acc = acc + v[..., j]
        return acc

    while z.shape[-1] > _XLA_WINDOW:
        pad = -z.shape[-1] % _XLA_WINDOW
        z = torch.nn.functional.pad(z, (pad // 2, pad - pad // 2))
        z = in_order(z.unflatten(-1, (-1, _XLA_WINDOW)))
    return in_order(z)


def _softmax_bwd_op_graph(x: torch.Tensor, dout: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """Plain version of :func:`softmax_bwd` for ``impl="auto"`` in bf16:
    JAX's autodiff of the op graph (out = e / w, e = exp(x - stop_grad(m)),
    w = sum e), each op rounded to bf16 as XLA does:

        x2 = 1 / (w * w);  z = (dout * x2) * e;  ba = sum_bf16(z)
        dx = ((dout / w) - ba) * e,  0 where ``causal`` replaced the score

    with ``sum_bf16`` XLA:CPU's bf16 reduction (:func:`_xla_bf16_sum`)."""
    v = _masked_scores(x, mask, causal)
    e = torch.exp(v - v.amax(-1, keepdim=True))
    w = e.float().sum(-1, keepdim=True).to(e.dtype)
    g = dout.to(e.dtype)
    x2 = torch.ones_like(w) / (w * w)
    ba = _xla_bf16_sum((g * x2) * e).unsqueeze(-1)
    dx = (g / w - ba) * e
    if causal:
        f, t = dx.shape[-2:]
        future = torch.ones(f, t, dtype=torch.bool, device=dx.device).triu(1)
        dx = dx.masked_fill(future, 0.0)
    return dx


class _AttnSoftmax(torch.autograd.Function):
    """out = attn_softmax(inp, mask, causal, impl); no mask gradient.  The
    pallas function (and f32) saves the output; the bf16 op graph saves
    the scores and the mask, from which the backward rebuilds e and w."""

    @staticmethod
    def forward(ctx, inp, mask, causal, impl):
        if on_cuda(inp, mask):
            out = softmax_fwd(inp, mask, causal, impl)
        elif impl == "auto":
            out = attn_softmax_reference(inp, mask, causal)
        else:
            out = _attn_softmax_pallas_reference(inp, mask, causal)
        ctx.causal, ctx.impl = causal, impl
        ctx.op_graph = _op_graph(inp.dtype, impl)
        ctx.save_for_backward(*((inp, mask) if ctx.op_graph else (out,)))
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.op_graph:
            x, mask = ctx.saved_tensors
            if on_cuda(x):
                dinp = softmax_bwd(x, dout, mask, ctx.causal, "auto")
            else:
                dinp = _softmax_bwd_op_graph(x, dout, mask, ctx.causal)
        else:
            (out,) = ctx.saved_tensors
            bwd = softmax_bwd if on_cuda(out) else softmax_bwd_reference
            dinp = bwd(out, dout)
        return dinp, None, None, None


def attn_softmax_pallas(inp: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """The Pallas kernels' function under the JAX package's name: f32
    inside, the result in inp's dtype; the hand-written kernels on CUDA
    tensors (the plain versions on the CPU), differentiable through
    :class:`_AttnSoftmax`."""
    _check(inp, mask)
    return _AttnSoftmax.apply(inp, mask, bool(causal), "pallas")


def attn_softmax(inp: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 causal: bool = False, impl: str = "auto") -> torch.Tensor:
    """Fused masked softmax over the last dim of ``(B, H, F, T)`` scores.

    ``mask`` is additive, broadcastable as (B|1, H|1, F|1, T); ``causal``
    applies the triangular future mask in the kernel.  ``impl`` is "auto"
    (JAX's op graph, in the promoted dtype of scores and mask) or "pallas"
    (the Pallas kernels' function); module docstring."""
    _check_impl(impl)
    _check(inp, mask)
    if impl == "pallas":
        return attn_softmax_pallas(inp, mask, causal)
    if mask is not None:
        dtype = torch.result_type(inp, mask)
        inp, mask = inp.to(dtype), mask.to(dtype)
    return _AttnSoftmax.apply(inp, mask, bool(causal), "auto")
