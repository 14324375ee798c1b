"""Flash attention, forward and backward (counterpart of
flashattn_tpu/ops/flash_attention.py).

On CUDA tensors every entry point launches the hand-written kernels:
``csrc/flash_fwd.cu`` forward (a wgmma tensor-core kernel for bf16, the
CUDA-core kernel of ``attn_core.cuh`` for f32), which replaces the TPU
forward kernels
``_fwd_subrow_varlen_kernel`` (batched varlen prefill) and ``_fwd_kernel``
(causal / window / kv_lengths / GQA / cross-attention) and also covers the
dense causal function of ``_fwd_subrow_kernel``, ``_fwd_loop_kernel`` and
``_fwd_twolevel_kernel``; and ``csrc/flash_bwd.cu``, a dK/dV kernel and a dQ
kernel (wgmma tensor-core kernels for bf16, CUDA-core kernels for f32)
that replace the backward kernels of the grid (``_bwd_dkv_kernel``,
``_bwd_dq_kernel``), subrow (``_bwd_subrow_kernel``) and loop
(``_bwd_dq_loop_kernel``, ``_bwd_dkv_loop_kernel``) schedules.  There is no
length threshold and no fallback: a CUDA tensor always runs the kernels or
raises.  On CPU tensors the plain PyTorch versions run
(:func:`_reference_fwd_with_lse`, :func:`_reference_bwd`).

The three entry points share one ``autograd.Function`` (:class:`_Flash`):
its forward saves (q, k, v, o, lse) and its backward computes
di = rowsum(o * do) in plain torch, as the JAX package does, then the three
gradients.  kv_lengths gets no gradient.

The TPU-only knobs (``block_q``, ``block_k``, ``vmem_limit`` and the
schedule names in ``impl``) are not carried over: ``impl`` is ``"auto"``
(the kernels on CUDA) or ``"reference"`` (the plain forward anywhere,
differentiated by autograd).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from ._utils import DEFAULT_MASK_VALUE, LOG2E, on_cuda

_kernel = _build.Kernel("fa_flash_fwd", [_build.P] * 6 + [_build.I] * 8 + [
    _build.F, _build.I])
_bwd_kernel = _build.Kernel("fa_flash_bwd", [_build.P] * 10 + [_build.I] * 8
                            + [_build.F, _build.I])

HEAD_DIMS = (32, 64, 128)
_IMPLS = ("auto", "reference")


def repeat_kv(k: torch.Tensor, v: torch.Tensor, n_q_heads: int):
    """Broadcast GQA/MQA kv heads up to ``n_q_heads`` query heads: query head
    ``h`` reads kv head ``h // group`` (the kernel's convention)."""
    group = n_q_heads // k.shape[1]
    if group == 1:
        return k, v
    return (k.repeat_interleave(group, dim=1),
            v.repeat_interleave(group, dim=1))


def _check_heads(q, k, v):
    h, h_kv = q.shape[1], k.shape[1]
    if v.shape[1] != h_kv:
        raise ValueError(
            f"k has {h_kv} heads but v has {v.shape[1]}; they must match")
    if h_kv == 0 or h % h_kv != 0:
        raise ValueError(
            f"q heads ({h}) must be a positive multiple of kv heads "
            f"({h_kv}) for GQA/MQA grouping")


def _check_window(causal, window):
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window attention) requires "
                             "causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def _keep_mask(n_q, n_kv, causal, window, kv_lengths, device):
    """Boolean (b or 1, 1, n_q, n_kv) mask of the live (row, key) pairs, or
    None when every pair is live."""
    cols = torch.arange(n_kv, device=device)
    rows = torch.arange(n_q, device=device)
    keep = None
    if causal:
        keep = cols[None, :] <= rows[:, None]
        if window is not None:
            keep = keep & (cols[None, :] > rows[:, None] - window)
    if kv_lengths is not None:
        valid = cols[None, None, None, :] < kv_lengths.to(
            device)[:, None, None, None]
        keep = valid if keep is None else (keep & valid)
    return keep


def _reference_fwd_with_lse(q, k, v, causal, scale, kv_lengths=None,
                            window=None):
    """Plain PyTorch forward returning (o, lse (b, h, n_q, 1) f32).  Scores
    and softmax in f32; probabilities round to v's dtype before the PV
    product, as in the JAX oracle."""
    k, v = repeat_kv(k, v, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    keep = _keep_mask(q.shape[2], k.shape[2], causal, window, kv_lengths,
                      q.device)
    if keep is not None:
        s = s.masked_fill(~keep, DEFAULT_MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    if keep is not None and kv_lengths is not None:
        # rows with no live key output 0 (the kernel's convention)
        e = e.masked_fill(~keep, 0.0)
    l = e.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    p = (e / l_safe).to(v.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float())
    lse = torch.where(l == 0.0, torch.full_like(l, -math.inf),
                      m + torch.log(l_safe))
    return o.to(q.dtype), lse


def _reference_bwd(q, k, v, lse, di, do, causal, scale, kv_lengths=None,
                   window=None):
    """Plain version of :func:`flash_bwd`: (dq, dk, dv) by the explicit
    formulas, as the JAX backward kernels compute them — in base 2,
    p = exp2(s * scale * log2(e) - lse * log2(e)) on live pairs (0 elsewhere
    and on rows whose lse is -inf), ds = p (do v^T - di) scale in f32; p and
    ds round to q's dtype before dv = p^T do, dq = ds k and dk = ds^T q,
    which sum in f32, with dk/dv summed over each GQA group."""
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    kr, vr = repeat_kv(k, v, h)
    qf, kf, vf, dof = (t.float() for t in (q, kr, vr, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (scale * LOG2E)
    live = torch.isfinite(lse)
    p = torch.exp2(s - torch.where(live, lse, torch.zeros_like(lse)) * LOG2E)
    keep = _keep_mask(n_q, n_kv, causal, window, kv_lengths, q.device)
    p = p.masked_fill(~(live if keep is None else keep & live), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - di) * scale
    p, ds = (t.to(q.dtype).float() for t in (p, ds))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    if h != h_kv:
        dk = dk.reshape(b, h_kv, h // h_kv, n_kv, d).sum(2)
        dv = dv.reshape(b, h_kv, h // h_kv, n_kv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_args(q, k, v):
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of {HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (b, h_kv, n_kv, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share a dtype")


def _lengths(kv_lengths, b, device):
    if kv_lengths is None:
        return None
    lens = kv_lengths.to(device=device, dtype=torch.int32).contiguous()
    if lens.shape != (b,):
        raise ValueError(f"kv_lengths must be ({b},), got {tuple(lens.shape)}")
    return lens


def flash_fwd(q, k, v, *, causal, sm_scale, kv_lengths=None, window=None):
    """Kernel launch: (o, lse (b, h, n_q, 1) f32) for CUDA tensors."""
    _check_kernel_args(q, k, v)
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    code = _build.dtype_code(q)
    q, k, v = (_build.aligned(t.detach()) for t in (q, k, v))
    lens = _lengths(kv_lengths, b, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n_q, 1), device=q.device, dtype=torch.float32)
    _kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens is None else lens.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, h_kv, n_q, n_kv, d,
            int(causal), int(window or 0), float(sm_scale * LOG2E), code)
    return o, lse


def flash_bwd(q, k, v, lse, di, do, *, causal, sm_scale, kv_lengths=None,
              window=None):
    """Kernel launch: (dq, dk, dv) for CUDA tensors, dk/dv at the kv heads.
    ``lse`` is the forward's (b, h, n_q, 1) natural-log lse and
    ``di = rowsum(o * do)`` (b, h, n_q, 1) f32.  One count covers its two
    launches (dK/dV, then dQ)."""
    _check_kernel_args(q, k, v)
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    if do.shape != q.shape or lse.shape != (b, h, n_q, 1) \
            or di.shape != lse.shape:
        raise ValueError(f"do {tuple(do.shape)}, lse {tuple(lse.shape)} and "
                         f"di {tuple(di.shape)} do not match q "
                         f"{tuple(q.shape)}")
    code = _build.dtype_code(q)
    q, k, v, do = (_build.aligned(t.detach().to(q.dtype))
                   for t in (q, k, v, do))
    lse, di = (t.detach().float().contiguous() for t in (lse, di))
    lens = _lengths(kv_lengths, b, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _bwd_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr(),
                None if lens is None else lens.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, h, h_kv, n_q, n_kv, d, int(causal), int(window or 0),
                float(sm_scale), code)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """(o, lse) = flash attention; the backward launches ``flash_bwd`` on
    CUDA.  No gradient flows through lse: a nonzero one raises (the JAX
    package's ``flash_attention_with_lse`` is forward-only)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, causal, scale, window):
        if on_cuda(q, k, v):
            o, lse = flash_fwd(q, k, v, causal=causal, sm_scale=scale,
                               kv_lengths=kv_lengths, window=window)
        else:
            o, lse = _reference_fwd_with_lse(q, k, v, causal, scale,
                                             kv_lengths, window)
        ctx.save_for_backward(q, k, v, o, lse, kv_lengths)
        ctx.attrs = (causal, scale, window)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        if dlse is not None and bool((dlse != 0).any()):
            raise NotImplementedError(
                "flash attention has no gradient through lse; use the lse "
                "only where it is not differentiated")
        if do is None:
            return (None,) * 7
        q, k, v, o, lse, kv_lengths = ctx.saved_tensors
        causal, scale, window = ctx.attrs
        di = (o.float() * do.float()).sum(-1, keepdim=True)
        if on_cuda(q, k, v):
            dq, dk, dv = flash_bwd(q, k, v, lse, di, do, causal=causal,
                                   sm_scale=scale, kv_lengths=kv_lengths,
                                   window=window)
        else:
            dq, dk, dv = _reference_bwd(q, k, v, lse, di, do, causal, scale,
                                        kv_lengths, window)
        return dq, dk, dv, None, None, None, None


def _flash_fwd_entry(q, k, v, causal, sm_scale, impl="auto", window=None,
                     kv_lengths=None):
    _check_heads(q, k, v)
    _check_window(causal, window)
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if impl == "auto":
        return _Flash.apply(q, k, v, kv_lengths, causal, scale, window)
    return _reference_fwd_with_lse(q, k, v, causal, scale, kv_lengths, window)


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None, *, impl: str = "auto",
                    window: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v without materialising the scores.

    q: (batch, heads, seq_q, head_dim); k, v: (batch, kv_heads, seq_kv,
    head_dim) with heads a multiple of kv_heads (GQA/MQA).  ``causal``
    applies the top-left aligned triangular mask; ``window`` (requires
    causal) limits row i to cols (i - window, i].  sm_scale defaults to
    1/sqrt(head_dim).  Returns (batch, heads, seq_q, head_dim)."""
    return _flash_fwd_entry(q, k, v, causal, sm_scale, impl, window)[0]


def flash_attention_varlen(q, k, v, kv_lengths, causal: bool = False,
                           sm_scale: Optional[float] = None, *,
                           impl: str = "auto",
                           window: Optional[int] = None) -> torch.Tensor:
    """Flash attention over a padded batch: ``kv_lengths`` (B,) int gives each
    row's valid key prefix; keys past it are masked in-kernel.  Rows with
    length 0 output 0.  Padding query rows still attend the valid prefix."""
    return _flash_fwd_entry(q, k, v, causal, sm_scale, impl, window,
                            kv_lengths)[0]


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             sm_scale: Optional[float] = None, *,
                             impl: str = "auto", window: Optional[int] = None):
    """Forward returning ``(o, lse)``, lse (b, h, n_q, 1) f32 in natural log
    (-inf for a row with no live key).  Differentiable through o; a nonzero
    gradient arriving at lse raises ``NotImplementedError``."""
    return _flash_fwd_entry(q, k, v, causal, sm_scale, impl, window)


def mha_attention(q, k, v, causal: bool = False,
                  use_flash: bool = True) -> torch.Tensor:
    """Multi-head attention with the JAX package's dispatch: the flash path
    (:func:`flash_attention`) or the plain op graph
    (:func:`flash_attention_reference`)."""
    if use_flash:
        return flash_attention(q, k, v, causal)
    return flash_attention_reference(q, k, v, causal)


def flash_attention_reference(q, k, v, causal: bool = False,
                              sm_scale: Optional[float] = None,
                              kv_lengths=None,
                              window: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version, on any device."""
    _check_heads(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _reference_fwd_with_lse(q, k, v, causal, scale, kv_lengths,
                                   window)[0]
