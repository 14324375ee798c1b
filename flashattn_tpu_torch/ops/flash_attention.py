"""Flash attention, forward and backward (counterpart of
flashattn_tpu/ops/flash_attention.py).

The function depends on the shape, as it does in the JAX package, whose
dispatcher picks a schedule by shape and each schedule rounds in its own
way.  :func:`_schedule` is a copy of that choice:

* ``"op_graph"``: kv_len < 1024 (``MIN_KERNEL_KV_LEN``), or an n_q or
  n_kv that ``largest_divisor_block`` cannot tile.  JAX runs XLA's op
  graph (:func:`_reference_fwd_with_lse`: f32 scores times sm_scale, the
  whole row's max, p normalised and then rounded to q's dtype) and its
  backward is autodiff of that graph.
* ``"subrow"`` (``_fwd_subrow_kernel``, ``_fwd_subrow_varlen_kernel``;
  zero padding of d < 128 keeps its function), ``"loop"``
  (``_fwd_loop_kernel``, blocks of 1024 keys, 512 in f32) and ``"grid"``
  (``_fwd_kernel``, key blocks of ``largest_divisor_block(n_kv, 1024)``):
  q is pre-scaled by sm_scale * log2(e) in its own dtype, the unnormalised
  p = exp2(s - m) rounds to q's dtype before the PV product, m being the
  whole row's max (subrow) or a running max per key block (loop, grid);
  o = pv / l (subrow) or acc * (1 / l).  :func:`_kernel_fwd_plain`.  The
  backward is the TPU backward kernels' (:func:`_reference_bwd`).

The dispatch is by shape and never by device.  On CUDA tensors every shape
launches a hand-written kernel: ``csrc/flash_fwd.cu`` (in bf16 a wgmma
tensor-core kernel with a mode per kernel schedule and a warp-level
mma.sync kernel for the op graph) and ``csrc/flash_bwd.cu`` (a dK/dV and a
dQ kernel: in bf16 wgmma kernels for the TPU kernels' backward and
mma.sync kernels for the op graph's autodiff, its dQ kernel leaving the
rows' statistics to the dK/dV kernel).  f32 has one function up to f32
rounding at every shape, on the tensor cores in split precision
(``csrc/flash_bwd_f32.cu`` for its backward; each f32
operand three bf16 pieces, six bf16 products a product; :func:`f32_route`
picks the kernels by the number of keys): from ``F32_TC_MIN_KV`` keys on
wgmma kernels behind a split pass (``fa_flash_fwd_f32``,
``fa_flash_bwd_f32``, counted by ``_f32_kernel`` and ``_f32_bwd_kernel``),
below it warp-level mma.sync kernels sized to the rows, which read the f32
inputs once and split them in registers (``fa_flash_fwd_f32_mma``,
``fa_flash_bwd_f32_mma``, counted by ``_f32_mma_kernel`` and
``_f32_mma_bwd_kernel``).  The warp-level kernels also compute a wgmma
call whose inputs hold a +-inf: the split pass flags it on the device,
the wgmma kernels exit and the warp-level ones, launched behind them,
run (C17; no host sync, the call's one count is the wgmma wrapper's).  On
CPU tensors the plain versions run (:func:`flash_fwd_plain`,
:func:`flash_bwd_plain`).

Head dims: the bf16 forward kernels take every multiple of 8 up to 256,
the f32 forward and every backward kernel up to 128 (at the least tile
width of 32, 64, 128 or, bf16 forward, 256 that holds d, zero-padded as
they load, as JAX's ``_pad128`` pads d for its subrow and loop schedules,
forward and backward); ``check_head_dim`` refuses any other on CUDA
tensors with ``ValueError`` naming the ROADMAP.md item (§B2b for the f32
forward, §B2c for the backward), never the plain version.

The three entry points share one ``autograd.Function`` (:class:`_Flash`):
its forward saves (q, k, v, o, lse) and its backward computes
di = rowsum(o * do) in plain torch, as the JAX package does, then the three
gradients.  kv_lengths gets no gradient.

The TPU-only knobs (``block_q``, ``block_k``, ``vmem_limit`` and the
schedule names in ``impl``) are not carried over: ``impl`` is ``"auto"``
(the dispatch above) or ``"reference"`` (the op graph at every shape,
differentiated by autograd).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import _build
from ._utils import (DEFAULT_MASK_VALUE, LN2, LOG2E, check_head_dim,
                     largest_divisor_block, on_cuda)

_kernel = _build.Kernel("fa_flash_fwd", [_build.P] * 6 + [_build.I] * 8 + [
    _build.F, _build.I, _build.I, _build.I])
_bwd_kernel = _build.Kernel("fa_flash_bwd", [_build.P] * 11 + [_build.I] * 8
                            + [_build.F, _build.I, _build.I])
# f32 on the tensor cores in split precision (csrc/split.cuh)
_f32_kernel = _build.Kernel("fa_flash_fwd_f32", [_build.P] * 8
                            + [_build.I] * 8 + [_build.F])
_f32_bwd_kernel = _build.Kernel("fa_flash_bwd_f32", [_build.P] * 12
                                + [_build.I] * 8 + [_build.F, _build.F])
# f32 on warp-level tensor-core kernels sized to the rows (split precision)
_f32_mma_kernel = _build.Kernel("fa_flash_fwd_f32_mma", [_build.P] * 6
                                + [_build.I] * 8 + [_build.F])
_f32_mma_bwd_kernel = _build.Kernel("fa_flash_bwd_f32_mma", [_build.P] * 11
                                    + [_build.I] * 8 + [_build.F, _build.F])

_IMPLS = ("auto", "reference")

# The JAX dispatcher's constants: below MIN_KERNEL_KV_LEN keys XLA's op
# graph runs; the kernels tile by blocks of up to 1024 rows and keys (512
# query rows above head dim 128), no smaller than 8.
MIN_KERNEL_KV_LEN = 1024
_BLOCK = 1024
_MIN_BLOCK = 8
# the C interface's codes of the kernel modes
_MODES = {"op_graph": 0, "grid": 1, "loop": 1, "subrow": 2}
# f32 takes the wgmma split-precision kernels from this many keys on;
# shorter walks (the MT model's 40, the distill draft's 128) take the
# warp-level ones, whose single launch, no split pass and blocks sized to
# the rows win there (tools/f32_flash_probe.py --time; PERF.md, rows 3-10')
F32_TC_MIN_KV = 256


# below this many keys the warp-level backward's dK/dV kernel leaves dS in
# a scratch of b h n_q n_kv floats for its dQ kernel, which then computes
# neither S nor dP again (from here on the scratch would outgrow the
# inputs; the wgmma route's +-inf calls recompute at any length, C17)
MMA_DS_MAX_KV = 256


def f32_route(n_kv: int) -> str:
    """The f32 kernels a CUDA call over ``n_kv`` keys launches: ``"wgmma"``
    (the split pass and the wgmma kernels) from ``F32_TC_MIN_KV`` keys on,
    else ``"mma"`` (the warp-level kernels).  A shape rule, never a device
    test."""
    return "wgmma" if n_kv >= F32_TC_MIN_KV else "mma"


class Schedule(NamedTuple):
    """The JAX schedule whose function a shape gets, and the keys over which
    one running max holds (the whole row for subrow, 0 for the op graph)."""

    name: str
    span: int


def _subrow_ok(n_q, n_kv, d, causal, window, itemsize):
    """JAX's ``_subrow_ok``: causal dense self-attention, d 128, n in
    [1024, 8192] a multiple of 512 (f32 only at 1024)."""
    if not causal or window is not None:
        return False
    if not (n_q == n_kv and d == 128 and 1024 <= n_q <= 8192
            and n_q % 512 == 0):
        return False
    return n_q <= 1024 or itemsize <= 2


def _pad128_ok(n_q, n_kv, d, causal, window, itemsize):
    """JAX's ``_pad128_ok``: head dims 16..120 (multiples of 8) zero-padded
    to 128 for the subrow and loop schedules; the padding changes no
    score."""
    if not causal or window is not None:
        return False
    if not (16 <= d < 128 and d % 8 == 0):
        return False
    if not (n_q == n_kv and n_q >= 1024 and n_q % 512 == 0):
        return False
    return n_q <= 1024 or itemsize <= 2 or n_q % 1024 == 0


def _loop_block(n_q, n_kv, d, causal, window, itemsize, block_q):
    """JAX's ``_loop_block`` under ``impl="auto"``: the loop schedule's key
    block (1024, or 512 in f32) for causal dense self-attention at d 128,
    else None."""
    if window is not None or not causal or n_q != n_kv or d != 128:
        return None
    if itemsize <= 2 and n_q % 1024 == 0 and block_q >= 1024:
        return 1024
    if itemsize == 4 and n_q % 512 == 0 and block_q >= 512:
        return 512
    return None


def _tileable(n_q, n_kv, d) -> bool:
    """Whether JAX's tiler divides the shape: ``largest_divisor_block`` of
    n_q by 1024 (512 above head dim 128) and of n_kv by 1024, at least 8."""
    return (largest_divisor_block(n_q, _BLOCK if d <= 128 else 512,
                                  _MIN_BLOCK) is not None
            and largest_divisor_block(n_kv, _BLOCK, _MIN_BLOCK) is not None)


def _schedule(q, k, causal, window, varlen=False) -> Schedule:
    """The schedule JAX's ``flash_attention`` (or, with ``varlen``,
    ``flash_attention_varlen``, which has no loop schedule) runs at these
    shapes under ``impl="auto"``: ``_use_kernel``, ``_subrow_ok``,
    ``_pad128_ok``, ``_loop_block``, then the grid."""
    n_q, n_kv, d = q.shape[2], k.shape[2], q.shape[3]
    isz = q.element_size()
    if n_kv < MIN_KERNEL_KV_LEN or not _tileable(n_q, n_kv, d):
        return Schedule("op_graph", 0)
    block_q = largest_divisor_block(n_q, _BLOCK if d <= 128 else 512,
                                    _MIN_BLOCK)
    if _pad128_ok(n_q, n_kv, d, causal, window, isz):
        d = 128
    if _subrow_ok(n_q, n_kv, d, causal, window, isz):
        return Schedule("subrow", n_kv)
    if not varlen:
        lb = _loop_block(n_q, n_kv, d, causal, window, isz, block_q)
        if lb is not None:
            return Schedule("loop", lb)
    return Schedule("grid", largest_divisor_block(n_kv, _BLOCK, _MIN_BLOCK))


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


def _kernel_fwd_plain(q, k, v, causal, scale, kv_lengths, window,
                      sched: Schedule):
    """Plain version of the TPU kernels' forward (``_fwd_subrow_kernel``,
    ``_fwd_subrow_varlen_kernel``, ``_fwd_loop_kernel``, ``_fwd_kernel``),
    returning (o, lse (b, h, n_q, 1) f32).  q is pre-scaled by
    sm_scale * log2(e) in its dtype; scores in f32, masked at
    DEFAULT_MASK_VALUE; m is the whole row's max (subrow) or a running max
    over blocks of ``sched.span`` keys, with acc and l rescaled by
    alpha = exp2(m_old - m_new); the unnormalised p = exp2(s - m) rounds to
    q's dtype before the PV product, which sums in f32; o = pv / l (subrow)
    or acc * (1 / l); lse = m ln 2 + ln l.  A row with no live key (a
    length-0 row) gives o = 0 and lse = -inf."""
    c = torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)
    k, v = repeat_kv(k, v, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", (q * c).float(), k.float())
    n_q, n_kv = s.shape[-2:]
    keep = _keep_mask(n_q, n_kv, causal, window, kv_lengths, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, DEFAULT_MASK_VALUE)
    # the kernels zero p off the mask where a row may see no key of a block
    zero = keep is not None and (kv_lengths is not None or window is not None)
    vf = v.float()
    if sched.name == "subrow":
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        if zero:
            p = p.masked_fill(~keep, 0.0)
        l = p.sum(-1, keepdim=True)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf)
        o = torch.where(l == 0.0, torch.zeros_like(pv), pv / l)
    else:
        m = torch.full_like(s[..., :1], -math.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(*s.shape[:-1], vf.shape[-1], device=s.device)
        for c0 in range(0, n_kv, sched.span):
            c1 = min(n_kv, c0 + sched.span)
            sb = s[..., c0:c1]
            m_new = torch.maximum(m, sb.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(sb - m_new)
            if zero:
                p = p.masked_fill(~keep[..., c0:c1], 0.0)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf[:, :, c0:c1])
            m = m_new
        o = acc * torch.where(l == 0.0, torch.ones_like(l),
                              torch.ones_like(l) / l)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l == 0.0, torch.full_like(l, -math.inf),
                      m * LN2 + torch.log(l_safe))
    return o.to(q.dtype), lse


def flash_fwd_plain(q, k, v, causal, scale, kv_lengths=None, window=None):
    """Plain version of :func:`flash_fwd`: (o, lse) of the function the
    shape's schedule computes (:func:`_schedule`)."""
    sched = _schedule(q, k, causal, window, kv_lengths is not None)
    if sched.name == "op_graph":
        return _reference_fwd_with_lse(q, k, v, causal, scale, kv_lengths,
                                       window)
    return _kernel_fwd_plain(q, k, v, causal, scale, kv_lengths, window,
                             sched)


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


def _op_graph_bwd(q, k, v, do, causal, scale, kv_lengths=None,
                  window=None):
    """Plain version of the op graph's backward: autograd of
    :func:`_reference_fwd_with_lse`, as JAX's is ``jax.vjp`` of its graph
    (``_flash_vjp_bwd`` below the kernel threshold)."""
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        o = _reference_fwd_with_lse(qg, kg, vg, causal, scale, kv_lengths,
                                    window)[0]
        return torch.autograd.grad(o, (qg, kg, vg), do.to(o.dtype))


def flash_bwd_plain(q, k, v, lse, di, do, causal, scale, kv_lengths=None,
                    window=None):
    """Plain version of :func:`flash_bwd`: at op-graph shapes autograd of
    the op graph (lse and di unused), else the TPU kernels' explicit
    formulas (:func:`_reference_bwd`)."""
    sched = _schedule(q, k, causal, window, kv_lengths is not None)
    if sched.name == "op_graph":
        return _op_graph_bwd(q, k, v, do, causal, scale, kv_lengths, window)
    return _reference_bwd(q, k, v, lse, di, do, causal, scale, kv_lengths,
                          window)


def _check_kernel_args(q, k, v, backward=False):
    """Shapes and dtypes the kernels take, forward and backward: every head
    dim ``check_head_dim`` allows the family (the bf16 or f32 forward, the
    backward; any other raises, never a plain fallback)."""
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    family = ("flash_bwd" if backward else "flash_fwd_bf16"
              if q.dtype == torch.bfloat16 else "flash_fwd_f32")
    check_head_dim(d, "flash backward kernel" if backward else "flash kernel",
                   family)
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
    """Kernel launch: (o, lse (b, h, n_q, 1) f32) for CUDA tensors, of the
    function of the shape's schedule (:func:`_schedule`).  In
    bf16 the kernel schedules take q pre-scaled by sm_scale * log2(e) in
    bf16, as JAX prescales it outside its kernels; the op graph's mode
    scales the f32 scores.  Head dims: bf16 up to 256, f32 up to 128
    (above, ``ValueError`` naming ROADMAP.md §B2b)."""
    _check_kernel_args(q, k, v)
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    sched = _schedule(q, k, causal, window, kv_lengths is not None)
    code = _build.dtype_code(q)
    mode = _MODES[sched.name]
    scale = float(sm_scale * LOG2E)
    if code == 1 and mode:
        q = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
        scale = 1.0
    elif code == 1:
        scale = float(sm_scale)
    q, k, v = (_build.aligned(t.detach()) for t in (q, k, v))
    lens = _lengths(kv_lengths, b, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n_q, 1), device=q.device, dtype=torch.float32)
    if code == 0 and f32_route(n_kv) == "mma":
        _f32_mma_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        None if lens is None else lens.data_ptr(), o.data_ptr(),
                        lse.data_ptr(), b, h, h_kv, n_q, n_kv, d, int(causal),
                        int(window or 0), scale)
        return o, lse
    if code == 0:
        planes = torch.empty(3 * (q.numel() + 2 * k.numel()),
                             dtype=torch.bfloat16, device=q.device)
        flags = torch.empty(2, dtype=torch.int32, device=q.device)
        _f32_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if lens is None else lens.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), planes.data_ptr(), flags.data_ptr(), b, h,
                    h_kv, n_q, n_kv, d, int(causal), int(window or 0), scale)
        return o, lse
    _kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens is None else lens.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, h_kv, n_q, n_kv, d,
            int(causal), int(window or 0), scale, code, mode, sched.span)
    return o, lse


def flash_bwd(q, k, v, lse, di, do, *, causal, sm_scale, kv_lengths=None,
              window=None, grid=False):
    """Kernel launch: (dq, dk, dv) for CUDA tensors, dk/dv at the kv heads.
    ``lse`` is the forward's (b, h, n_q, 1) natural-log lse and
    ``di = rowsum(o * do)`` (b, h, n_q, 1) f32.  At op-graph shapes in
    bf16 the kernels compute the op graph's autodiff from their own row
    statistics (lse and di unused; ``ops`` holds them between the two
    kernels), unless ``grid`` asks for the TPU backward kernels' function
    (:func:`_reference_bwd`) at every shape, as ring attention's pairs
    take it (JAX calls ``_flash_bwd`` there directly); f32 takes the
    explicit formulas at every shape.  One count covers its launches
    (``_bwd_kernel``'s in bf16; in f32 ``_f32_bwd_kernel``'s or
    ``_f32_mma_bwd_kernel``'s, by :func:`f32_route`).  Head dims: every
    multiple of 8 up to 128 (above, ``ValueError`` naming ROADMAP.md
    §B2c), each kernel at the least tile width that holds d, d the rows'
    stride (no padded copy)."""
    _check_kernel_args(q, k, v, backward=True)
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    if do.shape != q.shape or lse.shape != (b, h, n_q, 1) \
            or di.shape != lse.shape:
        raise ValueError(f"do {tuple(do.shape)}, lse {tuple(lse.shape)} and "
                         f"di {tuple(di.shape)} do not match q "
                         f"{tuple(q.shape)}")
    sched = _schedule(q, k, causal, window, kv_lengths is not None)
    code = _build.dtype_code(q)
    op_graph = int(code == 1 and sched.name == "op_graph" and not grid)
    q, k, v, do = (_build.aligned(t.detach().to(q.dtype))
                   for t in (q, k, v, do))
    lse, di = (t.detach().float().contiguous() for t in (lse, di))
    lens = _lengths(kv_lengths, b, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if code == 0 and f32_route(n_kv) == "mma":
        ds = (torch.empty((b, h, n_q, (n_kv + 3) // 4 * 4), device=q.device,
                          dtype=torch.float32) if n_kv < MMA_DS_MAX_KV else None)
        _f32_mma_bwd_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), di.data_ptr(),
                            None if lens is None else lens.data_ptr(),
                            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            None if ds is None else ds.data_ptr(), b, h,
                            h_kv, n_q, n_kv, d, int(causal), int(window or 0),
                            float(sm_scale), float(sm_scale * LOG2E))
        return dq, dk, dv
    if code == 0:
        planes = torch.empty(6 * (q.numel() + k.numel()), dtype=torch.bfloat16,
                             device=q.device)
        flags = torch.empty(1, dtype=torch.int32, device=q.device)
        _f32_bwd_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                        lse.data_ptr(), di.data_ptr(),
                        None if lens is None else lens.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        planes.data_ptr(), flags.data_ptr(), b, h, h_kv, n_q, n_kv, d,
                        int(causal), int(window or 0), float(sm_scale),
                        float(sm_scale * LOG2E))   # flash_fwd's q scale
        return dq, dk, dv
    ops = (torch.empty((b, h, n_q, 4), device=q.device, dtype=torch.float32)
           if op_graph else None)
    _bwd_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr(),
                None if ops is None else ops.data_ptr(),
                None if lens is None else lens.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, h, h_kv, n_q, n_kv, d, int(causal), int(window or 0),
                float(sm_scale), code, op_graph)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """(o, lse) = flash attention of the shape's schedule; the backward
    launches ``flash_bwd`` on CUDA.  No gradient flows through lse: a
    nonzero one raises (the JAX package's ``flash_attention_with_lse`` is
    forward-only)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, causal, scale, window):
        if on_cuda(q, k, v):
            o, lse = flash_fwd(q, k, v, causal=causal, sm_scale=scale,
                               kv_lengths=kv_lengths, window=window)
        else:
            o, lse = flash_fwd_plain(q, k, v, causal, scale, kv_lengths,
                                     window)
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
            dq, dk, dv = flash_bwd_plain(q, k, v, lse, di, do, causal, scale,
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
