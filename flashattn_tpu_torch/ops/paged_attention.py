"""Paged attention over a paged KV cache (counterpart of
flashattn_tpu/ops/paged_attention.py).

On CUDA tensors :func:`paged_attention` launches the hand-written kernels
of ``csrc/paged_attention.cu``, which replace both TPU kernels
(``_paged_dma_body``, the pipelined page walk, and ``_paged_kernel``, the
page-slot grid): a split-K grid over each sequence's page walk (a
``mma.sync`` decode tile at up to 16 rows per kv head, the flash forward's
``wgmma`` tile for wider extend waves; f32 q runs both in split precision
on the tensor cores, through its own entry point and launch count,
``_f32_kernel``), whose splits a merge kernel combines; for a wave wider than one
row tile a marks pass (:func:`paged_nonfinite`) and a poison pass give each
tile the effect of the walk's pages outside its own (C15).  On CPU tensors it runs
:func:`paged_attention_plain`, the TPU kernels' function in PyTorch.

Both follow the TPU kernels' rounding order, which JAX's model and engine
run: q prescaled by ``scale * log2(e)`` in q's dtype, f32 scores from
operands in q's dtype, the K scale on the scores, the softmax in exp2
against a running max, p times the V scale rounded to q's dtype before
the PV product.  :func:`paged_attention_reference` is the twin of JAX's
oracle instead (dense gather, one f32 softmax over dequantized pages).

A pool is either in q's dtype or quantized: int8 or float8_e4m3fn payload
pages with per-token f32 scales ``k_scales``/``v_scales`` of shape
(n_kv_heads, n_pages, page_size, 1), K = payload * scale.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from . import _build
from ._utils import cdiv, check_head_dim, check_no_grad, on_cuda, LOG2E

_ARGS = [_build.P] * 10 + [_build.I] * 11 + [_build.F, _build.I, _build.I]
_kernel = _build.Kernel("fa_paged_attention", _ARGS)             # bf16 q
_f32_kernel = _build.Kernel("fa_paged_attention_f32", _ARGS)     # f32 q
_nf_kernel = _build.Kernel("fa_paged_nonfinite", [_build.P] * 5 + [_build.I] * 9)

# rows per kv head up to which q takes the mma.sync decode tile (one m16
# tile), either dtype; wider waves take the 128-row wgmma tile
DECODE_ROWS = 16
EXTEND_ROWS = 128
# the least keys a split walks, so that its partial (d + 2 floats a row)
# stays small beside the K/V it reads
MIN_SPLIT_KEYS = 512
# a grid of row tiles under two waves of the card is split into about this
# many waves of blocks
WAVES = 4
# f32 q's decode tile: three to six times the bf16 tile's products a key
# and two blocks an SM, so splits from 256 keys (short histories fill the
# card) and two waves of them (half the partials to merge); its extend tile
# splits as the bf16 ones
F32_DECODE_MIN_SPLIT_KEYS = 256
F32_DECODE_WAVES = 2


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_tile(rows: int) -> int:
    """Rows of one block's tile: the decode tile's 16 (rows <= 16) or the
    extend tile's 128, for bf16 and f32 q alike."""
    return DECODE_ROWS if rows <= DECODE_ROWS else EXTEND_ROWS


def split_plan(b: int, h_kv: int, rows: int, chunk: int, page_size: int,
               pages_per_seq: int, dtype: torch.dtype, window: Optional[int],
               sm_count: int, split_pages: Optional[int] = None):
    """(split_pages, n_splits): how many pages of a sequence's walk one block
    takes, and the number of splits.  The walk has at most the table's
    width of pages (fewer under a window).  Without ``split_pages``, a grid
    of row tiles that fills two waves of the card takes one split (no
    merge); a smaller one as many splits as bring it near ``WAVES`` waves,
    each of at least ``MIN_SPLIT_KEYS`` keys (f32 q's decode tile:
    ``F32_DECODE_WAVES`` waves of at least ``F32_DECODE_MIN_SPLIT_KEYS``)."""
    walk = pages_per_seq
    if window is not None:
        walk = min(walk, cdiv(window + chunk - 1, page_size) + 1)
    walk = max(walk, 1)
    if split_pages is None:
        blocks = b * h_kv * cdiv(rows, row_tile(rows))
        split_pages = walk
        f32_decode = dtype == torch.float32 and rows <= DECODE_ROWS
        min_keys = F32_DECODE_MIN_SPLIT_KEYS if f32_decode else MIN_SPLIT_KEYS
        waves = F32_DECODE_WAVES if f32_decode else WAVES
        if blocks < 2 * sm_count:
            split_pages = max(cdiv(min_keys, page_size),
                              cdiv(walk, cdiv(waves * sm_count, blocks)))
    split_pages = max(1, min(int(split_pages), walk))
    return split_pages, cdiv(walk, split_pages)


def _walk(lengths, chunk, page_size, pages_per_seq, window):
    """(first, n): the page slots [first, n) of each sequence's walk, as the
    TPU kernels visit them for the whole wave: up to ``cdiv(length, page)``
    (at most the table's width), from the first page that the window of the
    wave's earliest row reaches."""
    n = torch.clamp(torch.div(lengths.clamp(min=0) + page_size - 1, page_size,
                              rounding_mode="floor"), max=pages_per_seq)
    first = torch.zeros_like(lengths)
    if window is not None:
        first = torch.div((lengths - chunk + 1 - window).clamp(min=0),
                          page_size, rounding_mode="floor")
    return first, n


def paged_nonfinite(v_pages, lengths, page_indices, chunk: int, *,
                    v_scales=None, window: Optional[int] = None) -> torch.Tensor:
    """The marks of the pages a row tile leaves out (C15): an int32 tensor
    (B, n_kv_heads, pages_per_seq, cdiv(d, 32) + 1) of bit words; for page
    slot i of sequence b's walk (zero outside it) bit c % 32 of word c // 32
    is set where column c of the page's V holds a non-finite value, and bit
    0 of the last word where a V scale of the page is not finite.

    JAX's page walk takes every row of a wave at each page it visits, so
    such a value makes columns of every row NaN (a masked key's p is 0, and
    0 * NaN is NaN); the paged kernels' row tiles read only their own pages,
    and ``fa_paged_attention``'s poison pass uses these marks for the rest.
    On CUDA tensors this launches ``paged_nonfinite_kernel``; on CPU tensors
    it runs :func:`paged_nonfinite_plain`."""
    if not on_cuda(v_pages, v_scales):
        return paged_nonfinite_plain(v_pages, lengths, page_indices, chunk,
                                     v_scales=v_scales, window=window)
    check_no_grad(v_pages)
    h_kv, n_pages, page_size, d = v_pages.shape
    check_head_dim(d, "paged marks kernel",
                   "paged_f32" if v_pages.dtype == torch.float32 else "paged_bf16")
    if (v_scales is None) == (v_pages.dtype in _build.PAYLOAD_DTYPES):
        raise TypeError(f"{v_pages.dtype} pages with v_scales "
                        f"{'absent' if v_scales is None else 'given'}")
    code = (_build.dtype_code(v_pages) if v_scales is None
            else _build.payload_code(v_pages))
    v_pages = _build.aligned(v_pages)
    vs = None if v_scales is None else _build.aligned(v_scales)
    lens = lengths.to(device=v_pages.device, dtype=torch.int32).contiguous()
    table = page_indices.to(device=v_pages.device, dtype=torch.int32).contiguous()
    b, pps = table.shape
    out = torch.empty((b, h_kv, pps, cdiv(d, 32) + 1), dtype=torch.int32,
                      device=v_pages.device)
    _nf_kernel(v_pages.data_ptr(), None if vs is None else vs.data_ptr(),
               lens.data_ptr(), table.data_ptr(), out.data_ptr(), b, h_kv,
               chunk, n_pages, page_size, pps, d, int(window or 0), code)
    return out


def paged_nonfinite_plain(v_pages, lengths, page_indices, chunk: int, *,
                          v_scales=None, window: Optional[int] = None):
    """Plain PyTorch version of :func:`paged_nonfinite`."""
    h_kv, n_pages, page_size, d = v_pages.shape
    dev = v_pages.device
    table = page_indices.to(dev).long().clamp(0, n_pages - 1)
    b, pps = table.shape
    first, n = _walk(lengths.to(dev).long(), chunk, page_size, pps, window)
    slot = torch.arange(pps, device=dev)
    walked = (first[:, None] <= slot) & (slot < n[:, None])        # (B, pps)
    # (H, B, pps, d): a column of the page holds a non-finite V value;
    # cdiv(d, 32) words of columns, the last one's bits past d clear
    bad = torch.isfinite(v_pages[:, table].float()).logical_not().any(dim=3)
    n_words = cdiv(d, 32)
    bad = torch.nn.functional.pad(bad, (0, 32 * n_words - d))
    words = (bad.reshape(h_kv, b, pps, n_words, 32).long()
             << torch.arange(32, device=dev)).sum(-1)
    scale = torch.zeros((h_kv, b, pps), dtype=torch.long, device=dev)
    if v_scales is not None:
        scale = torch.isfinite(v_scales[:, table, :, 0]).logical_not().any(dim=3).long()
    words = torch.cat([words, scale[..., None]], dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()   # uint32 bits
    return (words * walked[None, ..., None]).permute(1, 0, 2, 3).contiguous()


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


def paged_attention_fwd(q, k_pages, v_pages, lengths, page_indices, *,
                        sm_scale: float, window: Optional[int] = None,
                        k_scales=None, v_scales=None,
                        split_pages: Optional[int] = None) -> torch.Tensor:
    """Kernel launch: q (B, chunk, Hq, d), returns the same shape; the
    kernels read q and write o in this layout (a kv head's rows in (group,
    chunk) order).  ``split_pages`` overrides :func:`split_plan`'s pages a
    split (1: as many splits as pages).  Head dims: bf16 q up to 256, f32 q
    up to 128 (above, ``ValueError`` naming ROADMAP.md §B2b)."""
    check_no_grad(q, k_pages, v_pages)
    _check_pools(q, k_pages, v_pages, k_scales, v_scales)
    b, chunk, n_q_heads, d = q.shape
    h_kv, n_pages, page_size = k_pages.shape[:3]
    check_head_dim(d, "paged kernel",
                   "paged_f32" if q.dtype == torch.float32 else "paged_bf16")
    if n_q_heads % h_kv:
        raise ValueError(f"q heads ({n_q_heads}) must be a multiple of kv "
                         f"heads ({h_kv})")
    if k_pages.shape != (h_kv, n_pages, page_size, d):
        raise ValueError(f"page pools {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    rows = n_q_heads // h_kv * chunk
    code = _build.dtype_code(q)
    page_code = code if k_scales is None else _build.payload_code(k_pages)
    q, k_pages, v_pages = (_build.aligned(t) for t in (q, k_pages, v_pages))
    scales = [None if t is None else _build.aligned(t)
              for t in (k_scales, v_scales)]
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    table = page_indices.to(device=q.device, dtype=torch.int32).contiguous()
    if lens.shape != (b,) or table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"lengths {tuple(lens.shape)} / page_indices "
                         f"{tuple(table.shape)} do not match batch {b}")
    split_pages, n_splits = split_plan(
        b, h_kv, rows, chunk, page_size, table.shape[1], q.dtype, window,
        _sm_count(q.device.index or 0), split_pages)
    ws = None
    if n_splits > 1:
        ws = torch.empty((b, h_kv, n_splits, rows, d + 2), dtype=torch.float32,
                         device=q.device)
    # a wave wider than one row tile: the marks of its pages for the poison
    # pass (C15)
    nf = None
    if rows > row_tile(rows):
        nf = paged_nonfinite(v_pages, lens, table, chunk, v_scales=scales[1],
                             window=window)
    # q * scale_log2 is rounded to q's dtype in the kernels, as JAX rounds
    # its weakly typed product: the scale itself is rounded first
    scale_log2 = float(torch.tensor(sm_scale * LOG2E, dtype=q.dtype))
    out = torch.empty_like(q)
    kernel = _f32_kernel if q.dtype == torch.float32 else _kernel
    kernel(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scales),
            lens.data_ptr(), table.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if nf is None else nf.data_ptr(), b, h_kv, rows, chunk,
            n_pages, page_size, table.shape[1], d, int(window or 0),
            split_pages, n_splits, scale_log2, code, page_code)
    return out


# fa_paged_kernel_attr's kinds: the bf16-q tiles and the merge, the f32-q
# tiles
_BF16_KINDS = {0: "decode (bf16 q)", 1: "extend (bf16 q)", 3: "merge"}
_F32_KINDS = {2: "decode (f32 q, 8 rows)", 5: "decode (f32 q, 16 rows)",
              4: "extend (f32 q)"}


def kernel_attrs(d: int, page_dtype: torch.dtype) -> dict:
    """Registers a thread, dynamic shared memory and local (spill) bytes of
    the paged kernels for head dim ``d`` and a pool of ``page_dtype``,
    without launching: {kernel: (regs, smem, local)}.  A bf16 pool: the
    bf16-q tiles and the merge; an f32 pool: the f32-q tiles; int8 or fp8:
    both."""
    if page_dtype == torch.float32:
        code, kinds = 0, _F32_KINDS
    elif page_dtype == torch.bfloat16:
        code, kinds = 1, _BF16_KINDS
    else:
        code = _build.payload_code(torch.empty(0, dtype=page_dtype))
        kinds = {**_BF16_KINDS, **_F32_KINDS}
    return {name: tuple(_build.query("fa_paged_kernel_attr", [_build.I] * 4,
                                     kind, d, code, what) for what in range(3))
            for kind, name in kinds.items()}


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
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     page_indices, k_scales, v_scales,
                                     sm_scale=sm_scale, window=window)
    chunked_in = q.dim() == 4
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out = paged_attention_fwd(q if chunked_in else q[:, None], k_pages,
                              v_pages, lengths, page_indices, sm_scale=scale,
                              window=window, k_scales=k_scales,
                              v_scales=v_scales)
    return out if chunked_in else out[:, 0]


def paged_attention_plain(q, k_pages, v_pages, lengths, page_indices,
                          k_scales=None, v_scales=None, sm_scale=None,
                          window=None):
    """Plain PyTorch version of the TPU kernels' function (the page walk of
    ``_paged_dma_body`` / ``_paged_kernel``), which JAX's model and engine
    run: q is prescaled by ``scale * log2(e)`` rounded to q's dtype; scores
    are f32 dots of q with the payload in q's dtype, times the per-token K
    scale; the online softmax runs page by page in exp2 against the running
    max, masked scores at -1e30; p times the V scale is rounded to q's dtype
    before the PV dot, acc stays f32 and is multiplied by 1 / l at the end
    (1 where l is 0).  A page a sequence does not walk (before the window's
    first page, or at and past ``min(cdiv(length, page), pages_per_seq)``)
    leaves its m, l and acc untouched.  Page slots are walked across the
    batch at once."""
    _check_pools(q, k_pages, v_pages, k_scales, v_scales)
    chunked_in = q.dim() == 4
    if not chunked_in:
        q = q[:, None]
    b, chunk, n_q_heads, d = q.shape
    n_kv_heads, n_pages, page_size, _ = k_pages.shape
    group = n_q_heads // n_kv_heads
    rows = group * chunk
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    qg = q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=dev)
    qg = qg.reshape(b, chunk, n_kv_heads, group, d).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(b, n_kv_heads, rows, d).float()
    table = page_indices.to(dev).long()
    lengths = lengths.to(dev).long()
    pages_per_seq = table.shape[1]
    base = lengths - chunk
    first, n_walk = _walk(lengths, chunk, page_size, pages_per_seq, window)
    hi = base[:, None] + 1 + torch.arange(rows, device=dev)[None] % chunk
    m = torch.full((b, n_kv_heads, rows), -math.inf, device=dev)
    l = torch.zeros((b, n_kv_heads, rows), device=dev)
    acc = torch.zeros((b, n_kv_heads, rows, d), device=dev)
    for i in range(pages_per_seq):
        run = (first <= i) & (i < n_walk)
        if not bool(run.any()):
            continue
        pid = table[:, i].clamp(0, n_pages - 1)
        k = k_pages[:, pid].transpose(0, 1).to(q.dtype).float()   # (B, H, page, d)
        v = v_pages[:, pid].transpose(0, 1).to(q.dtype).float()
        s = qg @ k.transpose(-1, -2)                              # (B, H, rows, page)
        if k_scales is not None:
            s = s * k_scales[:, pid, :, 0].transpose(0, 1)[:, :, None]
        pos = i * page_size + torch.arange(page_size, device=dev)
        keep = pos[None, None] < hi[:, :, None]                   # (B, rows, page)
        if window is not None:
            keep = keep & (pos[None, None] >= hi[:, :, None] - window)
        s = torch.where(keep[:, None], s, -1e30)
        m_next = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_next)
        p = torch.exp2(s - m_next[..., None])
        l_next = alpha * l + p.sum(-1)
        if v_scales is not None:
            p = p * v_scales[:, pid, :, 0].transpose(0, 1)[:, :, None]
        pv = p.to(q.dtype).float() @ v
        live = run[:, None, None]
        m = torch.where(live, m_next, m)
        l = torch.where(live, l_next, l)
        acc = torch.where(live[..., None], acc * alpha[..., None] + pv, acc)
    inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    o = (acc * inv[..., None]).to(q.dtype)
    o = o.reshape(b, n_kv_heads, group, chunk, d).permute(0, 3, 1, 2, 4)
    o = o.reshape(b, chunk, n_q_heads, d)
    return o if chunked_in else o[:, 0]


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
