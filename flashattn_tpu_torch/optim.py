"""Optimizers over a model's parameters: SGD, Adam, AdamW (counterpart of
flashattn_tpu/optim.py).

The JAX names are kept outside and PyTorch idiom inside: ``opt.init(model)``
makes the state and ``opt.step(model, grads, state) -> (model, state)``
updates the parameters IN PLACE under ``torch.no_grad()`` (PyTorch
tensors are mutable; this saves a copy of the model per step) and returns
the same model.  ``grads`` maps each parameter name of
``model.named_parameters()`` to its gradient.

The update rules are the JAX package's, not ``torch.optim``'s: Adam keeps
eps outside sqrt(v) and folds sqrt(1 - beta2^t) into the step size, and
``reproduce_reference_bug`` keeps the reference's second-moment coefficient
for differential tests.  The step count is a Python int, so a schedule lr
is evaluated on the host with no device sync.  Adafactor is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch
from torch import nn

Grads = Dict[str, torch.Tensor]
LR = Union[float, Callable[[int], float]]


def global_norm(grads: Grads) -> torch.Tensor:
    """L2 norm over every gradient, accumulated in f32 (a 0-dim tensor)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


def clip_by_global_norm(grads: Grads, max_norm: float) -> Grads:
    """Scale every gradient so that the global L2 norm is at most
    ``max_norm``.  A non-finite norm (loss spike, overflow) zeroes every
    gradient instead, so the step changes nothing rather than poisoning
    every parameter.  No host sync."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    finite = torch.isfinite(norm)
    return {n: torch.where(finite, g * scale.to(g.dtype), torch.zeros_like(g))
            for n, g in grads.items()}


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable[[int], float]:
    """LR schedule: linear warmup to ``peak_lr``, then cosine decay to
    ``final_frac * peak_lr``.  Pass as ``Adam(lr=warmup_cosine(...))``."""

    def schedule(step: int) -> float:
        s = float(step)
        if s < warmup_steps:
            return peak_lr * s / max(warmup_steps, 1)
        prog = min(max((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0), 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * prog))
        return peak_lr * cos

    return schedule


def _params(model: nn.Module) -> Dict[str, nn.Parameter]:
    return dict(model.named_parameters())


class SGD:
    """Plain SGD: p <- p - lr * g."""

    def __init__(self, lr: float = 1.0):
        self.lr = lr

    def init(self, model: nn.Module) -> tuple:
        return ()

    def step(self, model: nn.Module, grads: Grads,
             state: tuple) -> Tuple[nn.Module, tuple]:
        """Update ``model``'s parameters in place; returns (model, state)."""
        with torch.no_grad():
            for name, p in _params(model).items():
                p.sub_(self.lr * grads[name].to(p.dtype))
        return model, state


class AdamState(NamedTuple):
    step: int
    exp_avg: Grads
    exp_avg_sq: Grads


class Adam:
    """Adam with bias correction, the JAX package's rule:

        m <- b1*m + (1-b1)*g
        v <- b2*v + (1-b2)*g^2          (reference bug: (1-b1) here)
        p <- p - lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)

    ``lr`` is a float or a schedule ``step -> lr`` called with t = step + 1
    (e.g. :func:`warmup_cosine`)."""

    def __init__(self, lr: LR = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 reproduce_reference_bug: bool = False):
        self.lr = lr
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.weight_decay = weight_decay
        self.reproduce_reference_bug = reproduce_reference_bug

    def _lr(self, t: int) -> float:
        return self.lr(t) if callable(self.lr) else self.lr

    def init(self, model: nn.Module) -> AdamState:
        zeros = {n: torch.zeros_like(p) for n, p in _params(model).items()}
        return AdamState(step=0, exp_avg=zeros,
                         exp_avg_sq={n: torch.zeros_like(z)
                                     for n, z in zeros.items()})

    def step(self, model: nn.Module, grads: Grads,
             state: AdamState) -> Tuple[nn.Module, AdamState]:
        """Update ``model``'s parameters and the moments in place; returns
        (model, state) with the step count advanced."""
        t = state.step + 1
        b1, b2 = self.beta1, self.beta2
        v_coef = (1.0 - b1) if self.reproduce_reference_bug else (1.0 - b2)
        step_size = self._lr(t) * math.sqrt(1.0 - b2**t) / (1.0 - b1**t)
        with torch.no_grad():
            for name, p in _params(model).items():
                g = grads[name].to(p.dtype)
                if self.weight_decay:
                    g = g + self.weight_decay * p
                m, v = state.exp_avg[name], state.exp_avg_sq[name]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=v_coef)
                p.sub_(step_size * m / (v.sqrt() + self.eps))
        return model, AdamState(t, state.exp_avg, state.exp_avg_sq)


class AdamW(Adam):
    """Adam with decoupled weight decay: p <- p * (1 - lr * wd) first, with
    lr taken at the step about to be made."""

    def __init__(self, lr: LR = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01):
        super().__init__(lr, beta1, beta2, eps, weight_decay=0.0)
        self.decoupled_weight_decay = weight_decay

    def step(self, model: nn.Module, grads: Grads, state: AdamState):
        if self.decoupled_weight_decay:
            decay = 1.0 - self._lr(state.step + 1) * self.decoupled_weight_decay
            with torch.no_grad():
                for p in _params(model).values():
                    p.mul_(decay)
        return super().step(model, grads, state)
