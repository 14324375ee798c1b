"""Quantization (counterpart of flashattn_tpu/ops/quant.py): int8 / fp8
tensors, the weight-only quantized matmul, flash attention over a quantized
KV cache, stochastic-rounding int8 quantization and the serving-time model
transform.

Symmetric per-channel scales kept in f32: int8 payloads hold
round(x / (absmax / 127)), fp8 (e4m3) payloads x / (absmax / 448).  The
quantizers (:func:`quantize_int8`, :func:`quantize_fp8`, :func:`quantize_kv`,
:func:`requantize_fp8_to_int8`) are plain torch, as they are plain jnp in
the JAX package.  Three functions are hand-written CUDA kernels on CUDA
tensors, each with a plain PyTorch version beside it that the CPU runs:

* :func:`int8_weight_only_matmul` — ``csrc/wo_matmul.cu`` (TPU
  ``_wo_matmul_kernel``; a wgmma tensor-core tile above 16 rows, in split
  precision for f32 x, and a cluster GEMV at decode);
* :func:`flash_attention_kv_int8` — ``csrc/kv8_flash.cu`` (TPU
  ``_kv8_fwd_kernel``, ``_kv8_loop_kernel`` and ``_kv8_subrow_kernel``: one
  wgmma tensor-core kernel, in the mode of JAX's route for bf16 q and in
  split precision for f32 q);
* :func:`quantize_int8_stochastic` — ``csrc/quant.cu`` (TPU
  ``_stochastic_quant_kernel``).

``flash_attention_kv_int8`` computes the function of the route JAX's
dispatcher takes at the shape (:func:`_kv8_route`): the grid, loop and
subrow kernels each round in their own way in bf16.  Where
``largest_divisor_block`` cannot tile n_q (by 1024, or 512 above head dim
128) or n_kv (by 1024) (``flash_attention._tileable``), K and V are
dequantized to q's dtype and the flash op graph runs over them
(``flash_attention.flash_fwd`` in its op-graph mode on CUDA, its plain
version on the CPU), as JAX runs XLA's graph.  The other kernels take
every shape; the TPU tiling knobs (``block_m``, ``block_q`` ...) are not
carried over.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple, Optional

import torch

from . import _build
from . import flash_attention as _fa
from ._utils import (DEFAULT_MASK_VALUE, LN2, LOG2E, check_head_dim,
                     check_no_grad, largest_divisor_block, on_cuda)
from .dropout import philox_bits

_wo_kernel = _build.Kernel("fa_wo_matmul", [_build.P] * 4 + [_build.I] * 4)
# f32 x: the GEMV, or split precision on the tensor cores
_wo_f32_kernel = _build.Kernel("fa_wo_matmul_f32", [_build.P] * 5 + [_build.I] * 4)
_kv8_kernel = _build.Kernel("fa_kv8_flash", [_build.P] * 7 + [_build.I] * 7
                            + [_build.F] + [_build.I] * 3)
# f32 q: split precision on the tensor cores
_kv8_f32_kernel = _build.Kernel("fa_kv8_flash_f32", [_build.P] * 7
                                + [_build.I] * 7 + [_build.F, _build.I])
_sq_kernel = _build.Kernel("fa_stochastic_quant", [_build.P] * 3
                           + [_build.I, _build.I, _build.U64, _build.I])

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def absmax_scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """absmax / qmax, or 1 where absmax is 0, in absmax's dtype.  The
    division is elementwise: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which can differ in the last bit from the
    true division of the kernels and of the JAX package."""
    return torch.where(absmax == 0, 1.0, absmax / torch.full_like(absmax, qmax))


class QuantizedTensor(NamedTuple):
    """A quantized payload (int8 or float8_e4m3fn) and broadcastable f32
    scales: values * scales ~= the original."""

    values: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        return self.values.shape

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.values.to(dtype) * self.scales.to(dtype)


def quantize_int8(x: torch.Tensor, axis: int = -1) -> QuantizedTensor:
    """Symmetric int8 quantization (absmax / 127) along ``axis``.  As in the
    JAX package, the scale is computed in x's dtype and only then cast to
    f32 (so bf16 weights get a bf16-rounded scale)."""
    scale = absmax_scale(x.abs().amax(dim=axis, keepdim=True), 127.0).float()
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def quantize_fp8(x: torch.Tensor, axis: int = -1) -> QuantizedTensor:
    """Symmetric float8 (e4m3) quantization (absmax / 448) along ``axis``,
    in f32 throughout."""
    xf = x.float()
    scale = absmax_scale(xf.abs().amax(dim=axis, keepdim=True), FP8_MAX)
    return QuantizedTensor((xf / scale).to(torch.float8_e4m3fn), scale)


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Per-token int8 quantization of a KV cache: (B, H, N, D) -> payloads
    with (B, H, N, 1) scales."""
    return quantize_int8(k, axis=-1), quantize_int8(v, axis=-1)


def requantize_fp8_to_int8(t: QuantizedTensor) -> QuantizedTensor:
    """Transcode an fp8 payload to int8 per row (the scales absorb the
    int8 step), as the JAX dispatcher does before its int8 route."""
    vf = t.values.float()
    s = absmax_scale(vf.abs().amax(dim=-1, keepdim=True), 127.0)
    q8 = torch.round(vf / s).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(q8, t.scales * s)


# -- stochastic rounding -------------------------------------------------------


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be a 64-bit unsigned int, got {seed}")
    return seed


def _check_2d(x: torch.Tensor):
    if x.dim() != 2:
        raise ValueError(f"expected a 2-D (rows, cols) tensor, got "
                         f"{tuple(x.shape)}")


def quantize_int8_stochastic_reference(x: torch.Tensor,
                                       seed: int = 0) -> QuantizedTensor:
    """Plain version of :func:`quantize_int8_stochastic`, bit for bit: the
    same Philox words, from integer tensor ops."""
    _check_2d(x)
    seed = _check_seed(seed)
    xf = x.float()
    scale = absmax_scale(xf.abs().amax(dim=-1, keepdim=True), 127.0)
    bits = philox_bits(x.numel(), seed, x.device).reshape(x.shape)
    u = (bits >> 9).float() * (1.0 / (1 << 23))
    q = torch.floor(xf / scale + u).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def stochastic_quant(x: torch.Tensor, seed: int) -> QuantizedTensor:
    """Kernel launch of :func:`quantize_int8_stochastic` (CUDA tensors)."""
    _check_2d(x)
    seed = _check_seed(seed)
    n, h = x.shape
    code = _build.dtype_code(x)
    x = _build.aligned(x.detach())
    q = torch.empty((n, h), device=x.device, dtype=torch.int8)
    scales = torch.ones((n, 1), device=x.device, dtype=torch.float32)
    _sq_kernel(x.data_ptr(), q.data_ptr(), scales.data_ptr(), n, h, seed, code)
    return QuantizedTensor(q, scales)


def quantize_int8_stochastic(x: torch.Tensor, seed: int = 0) -> QuantizedTensor:
    """Per-row int8 quantization of a 2-D (rows, cols) f32 / bf16 tensor with
    stochastic rounding: q = clip(floor(x / s + u), -127, 127), s = row
    absmax / 127, u uniform on [0, 1) from Philox4x32-10 keyed by ``seed``
    (an int in [0, 2^64)); unbiased: E[q * s] = x."""
    if on_cuda(x):
        return stochastic_quant(x, seed)
    return quantize_int8_stochastic_reference(x, seed)


# -- weight-only quantized matmul ----------------------------------------------


def _check_wo(x: torch.Tensor, w: QuantizedTensor):
    if x.dim() != 2 or w.values.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.values.shape)} "
                         f"must be 2-D")
    k, n = w.values.shape
    if x.shape[1] != k:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.values.shape)}: "
                         f"inner dims differ")
    if tuple(w.scales.shape) != (1, n):
        raise ValueError(f"weight scales must be per output channel (1, {n}), "
                         f"got {tuple(w.scales.shape)}")


def int8_weight_only_matmul_reference(x: torch.Tensor,
                                      w: QuantizedTensor) -> torch.Tensor:
    """Plain version of :func:`int8_weight_only_matmul`: the payload in f32
    (exact for int8 and fp8, as in x's dtype), the product summed in f32,
    the per-column scale applied to the sum, one rounding to x's dtype."""
    _check_wo(x, w)
    return ((x.float() @ w.values.float()) * w.scales.float()).to(x.dtype)


def wo_matmul(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Kernel launch of :func:`int8_weight_only_matmul` (CUDA tensors): at
    M <= 16 the cluster split-K GEMV; above, bf16 x runs the tensor-core
    tile (the FMA kernel where K % 8 != 0) and f32 x the same tile in split
    precision, over x's three bf16 pieces (a bf16 scratch of 3 M K' values,
    K' = K rounded up to a multiple of 8).  Inference-only, as the JAX
    kernel: inputs that require grad raise."""
    _check_wo(x, w)
    check_no_grad(x)
    code, payload = _build.dtype_code(x), _build.payload_code(w.values)
    if w.scales.dtype != torch.float32:
        raise TypeError(f"weight scales must be float32, got {w.scales.dtype}")
    m, k = x.shape
    n = w.values.shape[1]
    x, values, scales = (_build.aligned(t.detach())
                         for t in (x, w.values, w.scales))
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    if code == 0:
        planes = torch.empty(3 * m * -(-k // 8) * 8 if m > 16 else 0,
                             device=x.device, dtype=torch.bfloat16)
        _wo_f32_kernel(x.data_ptr(), values.data_ptr(), scales.data_ptr(),
                       y.data_ptr(), planes.data_ptr(), m, n, k, payload)
    else:
        _wo_kernel(x.data_ptr(), values.data_ptr(), scales.data_ptr(),
                   y.data_ptr(), m, n, k, payload)
    return y


def int8_weight_only_matmul(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x (M, K) @ dequantize(w) (K, N) with per-output-channel scales (1, N):
    the weights are dequantized tile by tile inside the kernel and never
    exist at full precision in device memory.  Payloads int8 or fp8; x f32
    or bf16; any M, N, K."""
    if on_cuda(x, w.values, w.scales):
        return wo_matmul(x, w)
    return int8_weight_only_matmul_reference(x, w)


# -- flash attention over a quantized KV cache ---------------------------------


def _check_kv8(q, k: QuantizedTensor, v: QuantizedTensor):
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.values.shape[1], k.values.shape[2]
    if k.values.shape != (b, h_kv, n_kv, d) or v.values.shape != k.values.shape:
        raise ValueError(f"k/v payloads {tuple(k.values.shape)}/"
                         f"{tuple(v.values.shape)} do not match q {tuple(q.shape)}")
    if k.scales.shape != (b, h_kv, n_kv, 1) or v.scales.shape != k.scales.shape:
        raise ValueError(f"k/v scales must be {(b, h_kv, n_kv, 1)}, got "
                         f"{tuple(k.scales.shape)}/{tuple(v.scales.shape)}")
    if h_kv == 0 or h % h_kv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads "
                         f"({h_kv})")
    if k.values.dtype != v.values.dtype or \
            k.values.dtype not in _build.PAYLOAD_DTYPES:
        raise TypeError(f"k/v payloads must share int8 or float8_e4m3fn, got "
                        f"{k.values.dtype}/{v.values.dtype}")


def _prescale(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """sm_scale * log2(e) as a scalar of q's dtype (the JAX prefold)."""
    return torch.tensor(sm_scale * LOG2E, dtype=q.dtype)


class Kv8Route(NamedTuple):
    """The function JAX's ``flash_attention_kv_int8`` computes at a shape:
    ``name`` is ``"fallback"`` (the flash op graph over K and V dequantized
    to q's dtype), ``"subrow"`` (``_kv8_subrow_kernel``), ``"loop"``
    (``_kv8_loop_kernel``) or ``"grid"`` (``_kv8_fwd_kernel``); ``span`` is
    the number of keys over which one running max holds (the whole row for
    subrow, 0 for the fallback)."""

    name: str
    span: int


# the C interface's codes of the bf16 kernel's modes
_KV8_MODES = {"grid": 1, "subrow": 2, "loop": 3}


def _subrow_envelope(causal, n_q, n_kv, d) -> bool:
    """The shapes at which the JAX dispatcher takes its subrow schedule and
    transcodes fp8 payloads to int8 first."""
    return (causal and n_q == n_kv and d == 128 and 1024 <= n_q <= 8192
            and n_q % 512 == 0)


def _kv8_route(causal, n_q, n_kv, d) -> Kv8Route:
    """JAX's dispatcher (``flash_attention_kv_int8``), by shape alone: the
    fallback where its tiler cannot divide n_q or n_kv, then the subrow
    envelope, then the loop schedule (causal self-attention at d 128 whose
    query block ``largest_divisor_block(n_q, 1024)`` is a multiple of 128:
    key chunks of that block), else the grid (key blocks of
    ``largest_divisor_block(n_kv, 1024)``)."""
    if not _fa._tileable(n_q, n_kv, d):
        return Kv8Route("fallback", 0)
    if _subrow_envelope(causal, n_q, n_kv, d):
        return Kv8Route("subrow", n_kv)
    bq = largest_divisor_block(n_q, 1024 if d <= 128 else 512, 8)
    if causal and n_q == n_kv and d == 128 and bq % 128 == 0:
        return Kv8Route("loop", bq)
    return Kv8Route("grid", largest_divisor_block(n_kv, 1024, 8))


def _check_tileable(route: Kv8Route, n_q, n_kv):
    if route.name == "fallback":
        raise ValueError(f"n_q {n_q} / n_kv {n_kv}: JAX's tiler cannot divide "
                         f"them; flash_attention_kv_int8 falls back to the "
                         f"flash op graph there")


def flash_attention_kv_int8_reference(q, k: QuantizedTensor, v: QuantizedTensor,
                                      causal: bool = False,
                                      sm_scale: Optional[float] = None):
    """Plain version of the kernel launch (:func:`kv8_flash_fwd`) at a
    shape JAX's tiler divides, that is of :func:`flash_attention_kv_int8`
    without its fp8 transcode and fallback: returns (o, lse (B, H, Nq, 1))
    of the function JAX computes at the shape (:func:`_kv8_route`),
    rounding where its kernel rounds.

    q is pre-scaled by sm_scale * log2(e) in its dtype.  int8 payloads:
    each q row is quantized to int8 and the scores are the exact integer
    product q8 k8^T times the q row scale, then the key scale; fp8
    payloads: q k8^T in f32 times the key scale.  The softmax runs in f32
    in base 2 against a running max over blocks of ``span`` keys (grid,
    loop; acc and l rescaled by exp2(m_old - m_new) where a block starts)
    or the row's max (subrow).  grid: p = exp2(s - m) and V = v8 * vs each
    round to q's dtype before the PV product; loop and subrow fold the V
    scale into p, (p * vs) rounding to q's dtype against v8 (exact in it).
    PV sums in f32; o = acc * (1 / l) (grid, loop) or pv / l (subrow);
    lse = m ln 2 + ln l (-inf where l = 0)."""
    _check_kv8(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.values.shape[1], k.values.shape[2]
    route = _kv8_route(causal, n_q, n_kv, d)
    _check_tileable(route, n_q, n_kv)
    group = h // h_kv
    qp = q * _prescale(q, scale).to(q.device)
    k8, ks, v8, vs = (t.repeat_interleave(group, dim=1) for t in
                      (k.values, k.scales, v.values, v.scales))
    ks, vs_row = ks.transpose(-1, -2), vs.transpose(-1, -2)
    if k.values.dtype == torch.int8:
        # |q8 . k8| <= 128 * 127^2 < 2^24: the f32 product is the exact
        # integer one, in any order of summation
        q8 = quantize_int8(qp.float(), axis=-1)
        s = (q8.values.float() @ k8.float().transpose(-1, -2)) * q8.scales * ks
    else:
        s = (qp.float() @ k8.float().transpose(-1, -2)) * ks
    if causal:
        keep = (torch.arange(n_kv, device=q.device)[None, :]
                <= torch.arange(n_q, device=q.device)[:, None])
        s = s.masked_fill(~keep, DEFAULT_MASK_VALUE)
    v8f = v8.float()   # exact in q's dtype too

    def pv(p, c0, c1):
        if route.name == "grid":
            vd = (v8f[:, :, c0:c1] * vs[:, :, c0:c1]).to(q.dtype).float()
            return p.to(q.dtype).float() @ vd
        return (p * vs_row[..., c0:c1]).to(q.dtype).float() @ v8f[:, :, c0:c1]

    if route.name == "subrow":
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(-1, keepdim=True)
        o = pv(p, 0, n_kv) / torch.where(l == 0, 1.0, l)
    else:
        m = torch.full_like(s[..., :1], -math.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, n_q, d, device=q.device)
        for c0 in range(0, n_kv, route.span):
            c1 = min(n_kv, c0 + route.span)
            m_new = torch.maximum(m, s[..., c0:c1].amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s[..., c0:c1] - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + pv(p, c0, c1)
            m = m_new
        o = acc * torch.where(l == 0, 1.0, torch.ones_like(l) / l)
    lse = torch.where(l == 0, -math.inf, m * LN2 + torch.log(l))
    return o.to(q.dtype), lse


def kv8_flash_fwd(q, k: QuantizedTensor, v: QuantizedTensor, *, causal: bool,
                  sm_scale: float):
    """Kernel launch of :func:`flash_attention_kv_int8` (CUDA tensors) at a
    shape JAX's tiler divides: (o, lse (B, H, Nq, 1) f32).  bf16 q runs
    ``fa_kv8_flash`` in the mode of the shape's route, f32 q
    ``fa_kv8_flash_f32`` (one function for every route: in f32 they agree
    to f32 rounding)."""
    _check_kv8(q, k, v)
    check_no_grad(q)
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.values.shape[1], k.values.shape[2]
    check_head_dim(d, "kv8 flash kernel", "kv8_flash")
    route = _kv8_route(causal, n_q, n_kv, d)
    _check_tileable(route, n_q, n_kv)
    code, payload = _build.dtype_code(q), _build.payload_code(k.values)
    if k.scales.dtype != torch.float32 or v.scales.dtype != torch.float32:
        raise TypeError("k/v scales must be float32")
    q, kv_, vv, ks, vs = (_build.aligned(t.detach()) for t in
                          (q, k.values, v.values, k.scales, v.scales))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n_q, 1), device=q.device, dtype=torch.float32)
    args = (q.data_ptr(), kv_.data_ptr(), vv.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, h_kv, n_q, n_kv,
            d, int(causal), float(_prescale(q, sm_scale)), payload)
    if code == 0:
        _kv8_f32_kernel(*args)
    else:
        _kv8_kernel(*args, _KV8_MODES[route.name], route.span)
    return o, lse


def flash_attention_kv_int8(q: torch.Tensor, k: QuantizedTensor,
                            v: QuantizedTensor, causal: bool = False,
                            sm_scale: Optional[float] = None):
    """Flash attention with a quantized (int8 or fp8) KV cache.

    q: (B, H, Nq, D) f32 / bf16; k, v: payloads (B, Hkv, Nkv, D) with f32
    scales (B, Hkv, Nkv, 1), H a multiple of Hkv (query head h reads kv
    head h // (H / Hkv)).  Returns (o, lse (B, H, Nq, 1) in natural log).
    Inference-only.  The function is JAX's at the shape (:func:`_kv8_route`,
    by shape and never by device): with int8 payloads q is quantized per
    row to int8 after the sm_scale prefold, as the TPU kernels do; fp8
    payloads at the TPU subrow envelope (causal, Nq == Nkv, D 128,
    1024 <= N <= 8192, N % 512 == 0) are transcoded to int8 first
    (:func:`requantize_fp8_to_int8`), as the JAX dispatcher does.  Shapes
    the JAX tiler cannot divide (n_q or n_kv under 8 or without a
    power-of-two block of at least 8) take its fallback: the flash op graph
    over K and V dequantized to q's dtype."""
    b, h, n_q, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    route = _kv8_route(causal, n_q, k.values.shape[2], d)
    if route.name == "fallback":
        _check_kv8(q, k, v)
        check_no_grad(q)
        kd, vd = k.dequantize(q.dtype), v.dequantize(q.dtype)
        if on_cuda(q, kd, vd):
            return _fa.flash_fwd(q, kd, vd, causal=causal, sm_scale=scale)
        return _fa.flash_fwd_plain(q, kd, vd, causal, scale)
    if k.values.dtype == torch.float8_e4m3fn and route.name == "subrow":
        k, v = requantize_fp8_to_int8(k), requantize_fp8_to_int8(v)
    if on_cuda(q, k.values, v.values, k.scales, v.scales):
        return kv8_flash_fwd(q, k, v, causal=causal, sm_scale=scale)
    return flash_attention_kv_int8_reference(q, k, v, causal, scale)


# -- serving-time model transform ----------------------------------------------


def quantize_model_weights(model: torch.nn.Module, dtype=torch.int8,
                           min_params: int = 0) -> torch.nn.Module:
    """A copy of ``model`` with every :class:`~..nn.basic.Linear` whose
    weight has at least ``min_params`` elements replaced by a weight-only
    quantized :class:`~..nn.basic.QuantizedLinear` (int8 or fp8 payload,
    per-output-channel f32 scales).  The original is left as it was, as
    the JAX transform returns a new tree."""
    from ..nn.basic import Linear, quantize_linear

    def walk(module: torch.nn.Module) -> None:
        for name, child in module.named_children():
            if isinstance(child, Linear) and child.weights.numel() >= min_params:
                setattr(module, name, quantize_linear(child, dtype))
            else:
                walk(child)

    model = copy.deepcopy(model)
    walk(model)
    return model
