"""Paged attention over a paged KV cache (counterpart of
flashattn_tpu/ops/paged_attention.py).

On CUDA tensors :func:`paged_attention` launches the hand-written kernel
``csrc/paged_attention.cu``, which replaces both TPU kernels
(``_paged_dma_body``, the pipelined page walk, and ``_paged_kernel``, the
page-slot grid); on CPU tensors it runs :func:`paged_attention_reference`.

A pool is either in q's dtype or quantized: int8 or float8_e4m3fn payload
pages with per-token f32 scales ``k_scales``/``v_scales`` of shape
(n_kv_heads, n_pages, page_size, 1), K = payload * scale.  The kernel
dequantizes each K/V row in f32 as it stages it, as the plain version
dequantizes the pages in f32 (the JAX oracle's order; the TPU kernel
instead rounds p * v_scale to q's dtype before its PV dot).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from ._utils import check_no_grad, on_cuda, LOG2E

_kernel = _build.Kernel("fa_paged_attention", [_build.P] * 8 + [_build.I] * 9
                        + [_build.F, _build.I, _build.I])

HEAD_DIMS = (32, 64, 128)


def _check_pools(q, k_pages, v_pages, k_scales, v_scales):
    """A pool in q's dtype has no scales; a quantized pool (int8 / fp8
    payloads) has f32 scales (n_kv_heads, n_pages, page_size, 1) for K and
    V.  Anything else raises."""
    if k_pages.shape != v_pages.shape or k_pages.dim() != 4:
        raise ValueError(f"page pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} must be (n_kv_heads, n_pages, "
                         f"page_size, d) alike")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError(f"k and v pages differ in dtype: {k_pages.dtype} / "
                        f"{v_pages.dtype}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("give both k_scales and v_scales, or neither")
    quantized = k_pages.dtype in _build.PAYLOAD_DTYPES
    if k_scales is None:
        if quantized:
            raise TypeError(f"{k_pages.dtype} pages are quantized: they need "
                            f"k_scales and v_scales")
        if k_pages.dtype != q.dtype:
            raise TypeError(f"q ({q.dtype}) and the page pools "
                            f"({k_pages.dtype}) must share a dtype")
        return
    if not quantized:
        raise TypeError(f"scales come with int8 or float8_e4m3fn pages, not "
                        f"{k_pages.dtype}")
    want = k_pages.shape[:3] + (1,)
    for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(sc.shape) != tuple(want):
            raise ValueError(f"{name} {tuple(sc.shape)} must be {tuple(want)}")
        if sc.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {sc.dtype}")


def paged_attention_fwd(qg, k_pages, v_pages, lengths, page_indices, *,
                        chunk: int, sm_scale: float,
                        window: Optional[int] = None, k_scales=None,
                        v_scales=None) -> torch.Tensor:
    """Kernel launch on the kernel's layout: qg (B, Hkv, group*chunk, d) with
    rows in (group, chunk) order; returns the same shape."""
    check_no_grad(qg, k_pages, v_pages)
    _check_pools(qg, k_pages, v_pages, k_scales, v_scales)
    b, h_kv, rows, d = qg.shape
    n_pages, page_size = k_pages.shape[1], k_pages.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"paged kernel head_dim must be one of {HEAD_DIMS}, "
                         f"got {d}")
    if k_pages.shape != (h_kv, n_pages, page_size, d):
        raise ValueError(f"page pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(qg.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    code = _build.dtype_code(qg)
    page_code = code if k_scales is None else _build.payload_code(k_pages)
    qg, k_pages, v_pages = (_build.aligned(t) for t in (qg, k_pages, v_pages))
    scales = [None if t is None else _build.aligned(t)
              for t in (k_scales, v_scales)]
    lens = lengths.to(device=qg.device, dtype=torch.int32).contiguous()
    table = page_indices.to(device=qg.device, dtype=torch.int32).contiguous()
    if lens.shape != (b,) or table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"lengths {tuple(lens.shape)} / page_indices "
                         f"{tuple(table.shape)} do not match batch {b}")
    out = torch.empty_like(qg)
    _kernel(qg.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scales),
            lens.data_ptr(), table.data_ptr(), out.data_ptr(), b, h_kv, rows,
            chunk, n_pages, page_size, table.shape[1], d, int(window or 0),
            float(sm_scale * LOG2E), code, page_code)
    return out


def paged_attention(
    q: torch.Tensor,              # (B, n_q_heads, d) or (B, chunk, n_q_heads, d)
    k_pages: torch.Tensor,        # (n_kv_heads, n_pages, page_size, d)
    v_pages: torch.Tensor,
    lengths: torch.Tensor,        # (B,) int valid tokens per sequence
    page_indices: torch.Tensor,   # (B, pages_per_seq) int page table
    *,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Attention of one query token (or a ``chunk`` of tokens) per sequence
    against its paged KV history.  Returns (B, n_q_heads, d) (or (B, chunk,
    n_q_heads, d) for a 4-d q).

    Chunk row j sits at absolute position ``lengths - chunk + j`` and attends
    causally within the chunk; ``lengths`` counts valid tokens INCLUDING the
    chunk, whose K/V must already be in the pages.  ``window`` restricts
    attention to the last ``window`` positions.  A quantized pool (int8 or
    float8_e4m3fn pages) comes with its f32 ``k_scales``/``v_scales``."""
    if not on_cuda(q, k_pages, v_pages, k_scales, v_scales):
        return paged_attention_reference(q, k_pages, v_pages, lengths,
                                         page_indices, k_scales, v_scales,
                                         sm_scale=sm_scale, window=window)
    chunked_in = q.dim() == 4
    if not chunked_in:
        q = q[:, None]
    b, chunk, n_q_heads, d = q.shape
    n_kv_heads = k_pages.shape[0]
    if n_q_heads % n_kv_heads:
        raise ValueError(f"q heads ({n_q_heads}) must be a multiple of kv "
                         f"heads ({n_kv_heads})")
    group = n_q_heads // n_kv_heads
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    # (B, chunk, Hq, d) -> (B, Hkv, group*chunk, d), rows ordered (group, chunk)
    qg = q.reshape(b, chunk, n_kv_heads, group, d).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(b, n_kv_heads, group * chunk, d)
    out = paged_attention_fwd(qg, k_pages, v_pages, lengths, page_indices,
                              chunk=chunk, sm_scale=scale, window=window,
                              k_scales=k_scales, v_scales=v_scales)
    out = out.reshape(b, n_kv_heads, group, chunk, d).permute(0, 3, 1, 2, 4)
    out = out.reshape(b, chunk, n_q_heads, d)
    return out if chunked_in else out[:, 0]


def paged_attention_reference(q, k_pages, v_pages, lengths, page_indices,
                              k_scales=None, v_scales=None, sm_scale=None,
                              window=None):
    """Plain PyTorch version: gather pages densely, mask by length, full
    softmax in f32.  ``q`` may be (B, Hq, d) or chunked (B, chunk, Hq, d).
    A quantized pool is dequantized in f32 first."""
    _check_pools(q, k_pages, v_pages, k_scales, v_scales)
    if k_scales is not None:
        k_pages = k_pages.float() * k_scales
        v_pages = v_pages.float() * v_scales
    chunked_in = q.dim() == 4
    if not chunked_in:
        q = q[:, None]
    b, chunk, n_q_heads, d = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    table = page_indices.long().to(q.device)
    lengths = lengths.long().to(q.device)
    # (Hkv, B, pages, page, d) -> (B, Hkv, pages*page, d)
    k_seq = k_pages[:, table].permute(1, 0, 2, 3, 4).reshape(b, n_kv_heads, -1, d)
    v_seq = v_pages[:, table].permute(1, 0, 2, 3, 4).reshape(b, n_kv_heads, -1, d)
    qg = q.reshape(b, chunk, n_kv_heads, group, d).float()
    s = torch.einsum("bjhgd,bhkd->bjhgk", qg, k_seq.float()) * scale
    pos = torch.arange(s.shape[-1], device=q.device)
    bound = (lengths[:, None] - chunk + 1
             + torch.arange(chunk, device=q.device)[None, :])   # (B, chunk)
    bound = bound[:, :, None, None, None]
    keep = pos < bound
    if window is not None:
        keep = keep & (pos >= bound - window)
    s = s.masked_fill(~keep, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bjhgk,bhkd->bjhgd", w, v_seq.float())
    o = o.reshape(b, chunk, n_q_heads, d).to(q.dtype)
    return o if chunked_in else o[:, 0]
