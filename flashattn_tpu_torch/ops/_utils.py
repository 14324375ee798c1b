"""Shared helpers for the kernel tier (counterpart of flashattn_tpu/ops/_utils.py)."""

from __future__ import annotations

import math

import torch

# Big-but-finite mask value used by the plain (reference) versions, as in
# the JAX package: -inf would give NaN in exp(-inf - (-inf)).
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# The kernels run the online softmax in base 2: log2(e) is folded into the
# score scale, and lse is converted back to natural log with ln(2).
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX's weakly typed Python scalars
    take the dtype of the array they meet (0.9 is 0.8984375 beside a bf16
    array).  PyTorch keeps a Python scalar at f32 precision instead, so the
    port rounds it first; a bf16 tensor times the rounded scalar is then
    the bf16 product JAX computes."""
    return float(torch.tensor(value, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation, with its constants in x's dtype (JAX's
    weak typing: sqrt(2/pi) is the bf16 literal 0.796875 for a bf16 x)."""
    c, k = (in_dtype(v, x.dtype) for v in (math.sqrt(2.0 / math.pi), 0.044715))
    return 0.5 * x * (1.0 + torch.tanh(c * (x + k * x**3)))


# The head dims each family of attention kernels takes on the card: every
# multiple of 8 up to the family's limit, run at the least tile width of 32,
# 64, 128 (and 256 where the family has that tile) that holds it,
# zero-padded as it loads (csrc/hopper.cuh::tile_width).  A family below
# 256 names the ROADMAP.md item that widens it.  The plain versions (CPU
# tensors) take any head dim.
MAX_HEAD_DIM = 256
HEAD_DIM_LIMITS = {
    "flash_fwd_bf16": (256, None),   # fa_flash_fwd: modes 0 and 1
    "paged_bf16": (256, None),       # bf16 q: decode, extend, merge, marks
    "flash_fwd_f32": (128, "§B2b"),  # both f32 routes
    "paged_f32": (128, "§B2b"),      # f32 q, and the marks of an f32 pool
    "kv8_flash": (128, "§B2b"),      # bf16 and f32
    "flash_bwd": (128, "§B2c"),      # the nine backward kernels
}


def check_head_dim(d: int, what: str, family: str) -> None:
    """Raise ``ValueError`` for a head dim the kernel family ``family``
    (a key of ``HEAD_DIM_LIMITS``) does not take: not a multiple of 8
    (ROADMAP.md §B3), above 256 (no tile), or above the family's limit (the
    ROADMAP.md item that widens it).  A rule of shape and dtype: the callers
    check it on CUDA tensors before any launch."""
    limit, item = HEAD_DIM_LIMITS[family]
    if d < 8 or d % 8:
        raise ValueError(f"{what} head_dim must be a multiple of 8, got {d}: "
                         f"other head dims are ROADMAP.md §B3")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what} head_dim must be at most {MAX_HEAD_DIM}, "
                         f"got {d}: no kernel tile is wider (ROADMAP.md §B)")
    if d > limit:
        raise ValueError(f"{what} head_dim must be at most {limit}, got {d}: "
                         f"head dims in ({limit}, {MAX_HEAD_DIM}] here are "
                         f"ROADMAP.md {item}")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the first tensor lies on a CUDA device: the op then launches
    its kernel (or raises).  A CPU tensor takes the plain PyTorch version.
    Mixed devices raise."""
    devices = {t.device.type for t in tensors if t is not None}
    if len(devices) > 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devices)}")
    return devices == {"cuda"}


def check_no_grad(*tensors: torch.Tensor) -> None:
    """For inference-only kernels (paged attention, which has no backward
    in the JAX package either): refuse inputs that require grad rather than
    return an output that silently stops the gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "this kernel is inference-only: it has no backward")


def largest_divisor_block(n: int, target: int, minimum: int = 8):
    """Largest block <= target that divides n, halving from min(target, n),
    or None below ``minimum`` (the JAX package's tiler, whose answer picks
    the attention schedule)."""
    b = min(target, n)
    while b >= minimum:
        if n % b == 0:
            return b
        b //= 2
    return None
