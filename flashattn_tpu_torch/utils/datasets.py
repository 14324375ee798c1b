"""Toy 2-D classification datasets (counterpart of
flashattn_tpu/utils/datasets.py).

The reference's six dataset names and decision boundaries
(``minitorch/datasets.py:88-95``), built as the JAX module builds them: one
numpy point cloud drawn from a seed and a vectorised label rule per
dataset, so the port's points and labels equal JAX's exactly.  Plain numpy,
the port's own copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np


@dataclass
class Graph:
    """N points in the unit square with binary labels."""

    N: int
    X: List[Tuple[float, float]]
    y: List[int]


def _cloud(N: int, seed: int) -> np.ndarray:
    """Uniform points in the unit square, (N, 2)."""
    return np.random.default_rng(seed).random((N, 2))


def _labelled(N: int, seed: int, rule: Callable[[np.ndarray, np.ndarray], np.ndarray]) -> Graph:
    pts = _cloud(N, seed)
    labels = rule(pts[:, 0], pts[:, 1]).astype(int)
    return Graph(N, [tuple(map(float, p)) for p in pts], labels.tolist())


def simple(N: int, seed: int = 0) -> Graph:
    """Left half-plane positive: label = [x1 < 0.5]."""
    return _labelled(N, seed, lambda x1, x2: x1 < 0.5)


def diag(N: int, seed: int = 0) -> Graph:
    """Below the anti-diagonal: label = [x1 + x2 < 0.5]."""
    return _labelled(N, seed, lambda x1, x2: x1 + x2 < 0.5)


def split(N: int, seed: int = 0) -> Graph:
    """Two vertical bands: label = [x1 < 0.2 or x1 > 0.8]."""
    return _labelled(N, seed, lambda x1, x2: (x1 < 0.2) | (x1 > 0.8))


def xor(N: int, seed: int = 0) -> Graph:
    """Opposite quadrants: label = [x1 < 0.5] xor [x2 < 0.5]."""
    return _labelled(N, seed, lambda x1, x2: (x1 < 0.5) ^ (x2 < 0.5))


def circle(N: int, seed: int = 0) -> Graph:
    """Outside the centred radius-sqrt(0.1) disc."""
    return _labelled(
        N, seed, lambda x1, x2: (x1 - 0.5) ** 2 + (x2 - 0.5) ** 2 > 0.1)


def spiral(N: int, seed: int = 0) -> Graph:
    """Two interleaved Archimedean spiral arms (deterministic, seed unused —
    the point positions ARE the dataset)."""
    n_arm = N // 2
    # Parameter sweep per arm; radius grows linearly with angle, scaled to
    # stay inside the unit square around (0.5, 0.5).
    t = 10.0 * (np.arange(n_arm) + 5) / n_arm
    r = t / 20.0
    arm0 = np.stack([r * np.cos(t), r * np.sin(t)], axis=1)
    # Second arm: mirrored parameterisation (swap axes, negate angle).
    arm1 = np.stack([-r * np.sin(-t), -r * np.cos(-t)], axis=1)
    pts = np.concatenate([arm0, arm1]) + 0.5
    labels = [0] * n_arm + [1] * n_arm
    return Graph(N, [tuple(map(float, p)) for p in pts], labels)


datasets: Dict[str, Callable[..., Graph]] = {
    "Simple": simple,
    "Diag": diag,
    "Split": split,
    "Xor": xor,
    "Circle": circle,
    "Spiral": spiral,
}
