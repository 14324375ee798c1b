"""conv1d / conv2d (counterpart of flashattn_tpu/ops/conv.py).

The reference's ``minitorch/fast_conv.py`` semantics, as the JAX module
has them: correlation (no kernel flip), the output the same spatial size as
the input, the kernel anchored at each position and extending right / down,
zeros past the edge.  JAX leaves this to XLA (``lax.conv_general_dilated``,
no Pallas kernel), so the port uses plain torch ops: the input padded on the
right / bottom, then one product over its unfolded windows.  That product
is a matmul, so float32 stays float32 on the card, forward and backward
(cuDNN's convolution would run float32 in TF32 by default,
``torch.backends.cudnn.allow_tf32``); autograd gives the gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(input: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """input (batch, in_ch, w), weight (out_ch, in_ch, kw) -> (batch, out_ch, w)."""
    kw = weight.shape[-1]
    win = F.pad(input, (0, kw - 1)).unfold(2, kw, 1)           # (b, c, w, kw)
    return torch.einsum("bcwk,ock->bow", win, weight)


def conv2d(input: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """input (batch, in_ch, h, w), weight (out_ch, in_ch, kh, kw) ->
    (batch, out_ch, h, w)."""
    kh, kw = weight.shape[-2:]
    win = F.pad(input, (0, kw - 1, 0, kh - 1)).unfold(2, kh, 1).unfold(3, kw, 1)
    return torch.einsum("bchwij,ocij->bohw", win, weight)   # win (b, c, h, w, kh, kw)
