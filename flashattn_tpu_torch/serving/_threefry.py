"""JAX's counter-based PRNG (threefry2x32) in integer torch ops.

The engine's sampling randomness is a pure function of (request seed,
absolute position, salt): a sampled request draws the same numbers
whichever batch it shares.  The JAX engine derives its draws from
``jax.random`` keys (``jax_threefry_partitionable`` mode); this module
computes the same 32-bit words with int64 tensors masked to 32 bits, so
the port's draws equal JAX's bit for bit, on the CPU and on the card
alike.  No ``torch.Generator`` is involved.

* ``PRNGKey(s)`` is the pair (0, s);
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``, and key i of
  ``split(key, num)`` is ``threefry2x32(key, (0, i))``;
* the 32 random bits of element i of a draw are ``x0 ^ x1`` of
  ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``;
* a uniform float32 in [0, 1) is ``(bits >> 9) | 0x3F800000`` viewed as
  float32, minus 1; in [minval, maxval) that times (maxval - minval) plus
  minval in one rounding to float32 (XLA fuses the two into an FMA), at
  least minval.

A key is the pair of its two words, each an int64 tensor of any batch
shape (one key: 0-dim tensors).
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_BITS = 0x3F800000                      # float32 1.0
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on int64 tensors holding
    uint32 words; every argument broadcasts against the others.  Returns
    the two output words."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seeds: torch.Tensor):
    """``jax.random.PRNGKey`` of non-negative int32 seeds (B,): the key
    words (0, seed)."""
    seeds = seeds.to(torch.int64) & _M32
    return torch.zeros_like(seeds), seeds


def fold_in(key, data):
    """``jax.random.fold_in`` of each key with a non-negative integer (a
    tensor that broadcasts against the keys, or a Python int)."""
    data = torch.as_tensor(data, device=key[0].device).to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` of each key: the words of the ``num``
    new keys, of the keys' batch shape plus (num,)."""
    i = torch.arange(num, dtype=torch.int64, device=key[0].device)
    return threefry2x32(key[0][..., None], key[1][..., None],
                        torch.zeros_like(i), i)


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def random_bits(key, shape):
    """int64 holding the uint32 words ``jax.random.bits`` draws for
    ``shape`` (an int n: (n,)) from each key: the keys' batch shape plus
    ``shape``."""
    shape = _shape(shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=key[0].device)
    y0, y1 = threefry2x32(key[0][..., None], key[1][..., None],
                          torch.zeros_like(i), i)
    return (y0 ^ y1).reshape(*key[0].shape, *shape)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> float32 in [0, 1), as ``jax.random.uniform``
    forms them."""
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` per key
    (an int n: shape (n,)): the keys' batch shape plus ``shape``."""
    f = bits_to_uniform(random_bits(key, shape))
    if (minval, maxval) == (0.0, 1.0):
        return f   # f * 1 + 0, at least 0: f itself
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=key[0].device)
              for v in (minval, maxval))
    # f * (hi - lo) + lo rounded once, as an FMA: the f32 product is exact
    # in float64
    fma = f.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fma.float())


def gumbel(key, n: int) -> torch.Tensor:
    """(B, n) ``jax.random.gumbel(key, (n,), float32)`` per key: the
    uniform on [tiny, 1) then -log(-log(u))."""
    u = torch.clamp_min(uniform(key, n) + _TINY, _TINY)
    return -torch.log(-torch.log(u))
