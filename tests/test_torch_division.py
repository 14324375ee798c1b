"""The op graph's kernels divide by a row's sum through its reciprocal
(``csrc/attn_core.cuh::fa::div_rn``): with y = 1 / b rounded to nearest,
q = x y, then q + (x - b q) y, each step rounded to f32 as the card's
``__fmul_rn`` / ``__fmaf_rn`` round.  This emulates that sequence exactly
(rational arithmetic, then f32 round to nearest even) and holds it to the
f32 quotient rounded to nearest, bit for bit, as ``__fdiv_rn`` gives it,
over the kernels' operands: a probability or ``bf16(dp)`` over a row sum
of at least 1, with significands of every kind.
"""

from fractions import Fraction

import numpy as np
import pytest


def _rn32(value: Fraction) -> np.float32:
    """``value`` rounded to the nearest float32, ties to even."""
    f = np.float32(float(value))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - value),
                                     int(np.float32(c).view(np.uint32)) & 1))


def _exact(x) -> Fraction:
    return Fraction(float(x))


def _div_rn(x, b):
    y = _rn32(1 / _exact(b))
    q = _rn32(_exact(x) * _exact(y))
    rem = _rn32(_exact(x) - _exact(b) * _exact(q))
    return _rn32(_exact(rem) * _exact(y) + _exact(q))


@pytest.mark.parametrize("kind", ["probability", "bf16_dp", "all_ones"])
def test_reciprocal_division_is_correctly_rounded(kind):
    rng = np.random.default_rng({"probability": 0, "bf16_dp": 1, "all_ones": 2}[kind])
    n = 1500
    b = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(0, 14, n)).astype(np.float32)
    if kind == "probability":
        x = rng.uniform(0, 1, n).astype(np.float32) * b   # e <= l
        x = np.minimum(x, 1).astype(np.float32)
    elif kind == "bf16_dp":
        x = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 10, n)).astype(np.float32)
        x = (x.view(np.uint32) & 0xFFFF0000).view(np.float32)   # bf16 values
    else:   # significands with every low bit set, the divisions' hard cases
        x = ((rng.integers(0x3F000000, 0x3F800000, n) | 0x7FFF).astype(np.uint32)
             .view(np.float32))
        b = ((rng.integers(0x3F800000, 0x46000000, n) | 0x7FFF).astype(np.uint32)
             .view(np.float32))
    for xi, bi in zip(x, b):
        assert _div_rn(xi, bi) == _rn32(_exact(xi) / _exact(bi)), (xi, bi)
