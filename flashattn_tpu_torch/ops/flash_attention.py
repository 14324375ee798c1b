"""Flash-attention forward (counterpart of flashattn_tpu/ops/flash_attention.py).

On CUDA tensors every entry point launches the hand-written kernel
``csrc/flash_fwd.cu``, which replaces the TPU forward kernels
``_fwd_subrow_varlen_kernel`` (batched varlen prefill) and ``_fwd_kernel``
(causal / window / kv_lengths / GQA / cross-attention) and also covers the
dense causal function of ``_fwd_subrow_kernel`` and ``_fwd_loop_kernel``.
There is no length threshold and no fallback: a CUDA tensor always runs
the kernel or raises.  On CPU tensors the plain PyTorch version
(:func:`_reference_fwd_with_lse`) runs.

The TPU-only knobs (``block_q``, ``block_k``, ``vmem_limit`` and the
schedule names in ``impl``) are not carried over: ``impl`` is ``"auto"``
(the kernel on CUDA) or ``"reference"`` (the plain version anywhere).
Forward-only on CUDA: the backward kernels belong to the training slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from ._utils import DEFAULT_MASK_VALUE, LOG2E, check_no_grad, on_cuda

_kernel = _build.Kernel("fa_flash_fwd", [_build.P] * 6 + [_build.I] * 8 + [
    _build.F, _build.I])

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


def _reference_fwd_with_lse(q, k, v, causal, scale, kv_lengths=None,
                            window=None):
    """Plain PyTorch forward returning (o, lse (b, h, n_q, 1) f32).  Scores
    and softmax in f32; probabilities round to v's dtype before the PV
    product, as in the JAX oracle."""
    k, v = repeat_kv(k, v, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    nq, nk = s.shape[-2:]
    cols = torch.arange(nk, device=q.device)
    rows = torch.arange(nq, device=q.device)
    keep = None
    if causal:
        keep = cols[None, :] <= rows[:, None]
        if window is not None:
            keep = keep & (cols[None, :] > rows[:, None] - window)
        s = s.masked_fill(~keep, DEFAULT_MASK_VALUE)
    if kv_lengths is not None:
        valid = cols[None, None, None, :] < kv_lengths.to(
            q.device)[:, None, None, None]
        s = s.masked_fill(~valid, DEFAULT_MASK_VALUE)
        keep = valid if keep is None else (keep & valid)
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


def flash_fwd(q, k, v, *, causal, sm_scale, kv_lengths=None, window=None):
    """Kernel launch: (o, lse (b, h, n_q, 1) f32) for CUDA tensors."""
    check_no_grad(q, k, v)
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
    code = _build.dtype_code(q)
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    lens = None
    if kv_lengths is not None:
        lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (b,):
            raise ValueError(f"kv_lengths must be ({b},), got "
                             f"{tuple(lens.shape)}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n_q, 1), device=q.device, dtype=torch.float32)
    _kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens is None else lens.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, h_kv, n_q, n_kv, d,
            int(causal), int(window or 0), float(sm_scale * LOG2E), code)
    return o, lse


def _flash_fwd_entry(q, k, v, causal, sm_scale, impl="auto", window=None,
                     kv_lengths=None):
    _check_heads(q, k, v)
    _check_window(causal, window)
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if impl == "auto" and on_cuda(q, k, v):
        return flash_fwd(q, k, v, causal=causal, sm_scale=scale,
                         kv_lengths=kv_lengths, window=window)
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
    (-inf for a row with no live key)."""
    return _flash_fwd_entry(q, k, v, causal, sm_scale, impl, window)


def flash_attention_reference(q, k, v, causal: bool = False,
                              sm_scale: Optional[float] = None,
                              kv_lengths=None,
                              window: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version, on any device."""
    _check_heads(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _reference_fwd_with_lse(q, k, v, causal, scale, kv_lengths,
                                   window)[0]
