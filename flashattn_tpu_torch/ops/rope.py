"""Rotary position embeddings, RoPE (counterpart of flashattn_tpu/ops/rope.py).

The rotation is elementwise on (..., S, D) activations, so it stays plain
torch ops (the JAX package leaves it to XLA as well): q and the new keys are
rotated before they enter attention or a KV cache, and every attention
kernel stays position-agnostic.  Pairing is GPT-NeoX "rotate-half" (the
first D/2 lanes with the last D/2); the math runs in f32 and the result is
cast back to the input's dtype once.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Positions = Union[int, torch.Tensor]


def _positions(positions: Positions, device) -> torch.Tensor:
    """``positions`` as an f32 tensor of at least one dim on ``device``: a
    scalar keeps its own sequence axis, as ``jnp.atleast_1d`` does.  A
    Python int becomes a device fill, not a host-to-device copy."""
    if isinstance(positions, torch.Tensor):
        return torch.atleast_1d(positions.to(device=device, dtype=torch.float32))
    return torch.full((1,), float(positions), dtype=torch.float32, device=device)


def rope_angles(positions: Positions, head_dim: int, theta: float = 10000.0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables for ``positions`` (any shape; a scalar counts as
    (1,)), each ``positions.shape + (head_dim // 2,)`` in f32, on ``device``
    (the positions' own device when they are a tensor and ``device`` is
    None)."""
    if device is None and isinstance(positions, torch.Tensor):
        device = positions.device
    half = head_dim // 2
    # divide by a 0-dim tensor: CUDA's division by a Python scalar
    # multiplies by its reciprocal, which JAX does not
    exps = -torch.arange(half, dtype=torch.float32, device=device) / torch.full(
        (), half, dtype=torch.float32, device=device)
    freqs = torch.pow(theta, exps)
    ang = _positions(positions, device)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: Positions,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` (..., S, D) by per-position angles.

    ``positions`` broadcasts against x's (..., S) prefix: (S,) for a full
    sequence, a scalar for one decode step, or (B, k) per-row positions
    (paged decode and extend at per-sequence lengths).  D must be even."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"RoPE head_dim must be even, got {d}")
    cos, sin = rope_angles(positions, d, theta, device=x.device)
    # line the position prefix up from the right: its S axis is x's ndim - 2
    while cos.ndim < x.ndim:
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
