"""Optimizers over a model's parameters: SGD, Adam, AdamW, Adafactor
(counterpart of flashattn_tpu/optim.py).

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
is evaluated on the host with no device sync.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

Grads = Dict[str, torch.Tensor]
LR = Union[float, Callable[[int], float]]


def _split_groups(p, dims) -> list:
    """The process groups over which the dims ``dims`` of parameter ``p``
    are split (its ``spec`` and ``mesh``, set when a model is sharded over
    ranks); empty for a whole parameter."""
    mesh, spec = getattr(p, "mesh", None), getattr(p, "spec", None)
    if mesh is None or not spec:
        return []
    from .parallel.comm import dims_groups

    return dims_groups(spec, mesh, [d % p.ndim for d in dims])


def global_norm(grads: Grads, params: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """L2 norm over every gradient, accumulated in f32 (a 0-dim tensor).
    With ``params`` whose tensors are this rank's blocks of split
    parameters (``spec`` / ``mesh``), each split gradient's squares are
    summed over the ranks holding its blocks, and a whole one counts
    once."""
    if params is None:
        return torch.sqrt(sum(g.float().square().sum()
                              for g in grads.values()))
    from .parallel.comm import shard_sum

    buckets = {}
    for n, g in grads.items():
        groups = _split_groups(params[n], range(g.ndim))
        key = tuple(id(x) for x in groups)
        part = g.float().square().sum()
        prev = buckets.get(key)
        buckets[key] = (groups, part if prev is None else prev[1] + part)
    return torch.sqrt(sum(shard_sum(part, groups)
                          for groups, part in buckets.values()))


def clip_by_global_norm(grads: Grads, max_norm: float,
                        params: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Grads:
    """Scale every gradient so that the global L2 norm is at most
    ``max_norm``.  A non-finite norm (loss spike, overflow) zeroes every
    gradient instead, so the step changes nothing rather than poisoning
    every parameter.  No host sync.  ``params``: see :func:`global_norm`."""
    norm = global_norm(grads, params)
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


class AdafactorState(NamedTuple):
    step: int
    vr: Grads    # row statistics (ndim >= 2) / full second moment (ndim < 2)
    vc: Grads    # column statistics (ndim >= 2) / an empty placeholder
    m: Optional[Grads]   # f32 first moment when beta1 > 0, else None


def _rms(x: torch.Tensor, groups=()) -> torch.Tensor:
    """RMS of ``x``, or of the whole tensor whose blocks the ranks of
    ``groups`` hold."""
    if not groups:
        return torch.sqrt(x.float().square().mean() + 1e-30)
    from .parallel.comm import group_size, shard_sum

    n = x.numel() * math.prod(group_size(g) for g in groups)
    return torch.sqrt(shard_sum(x.float().square().sum(), groups) / n
                      + 1e-30)


def _mean(x: torch.Tensor, dim: int, groups, keepdim: bool = False):
    """``x.mean(dim)``, over the whole dim when the ranks of ``groups``
    hold its blocks."""
    if not groups:
        return x.mean(dim, keepdim=keepdim)
    from .parallel.comm import group_size, shard_sum

    n = x.shape[dim] * math.prod(group_size(g) for g in groups)
    return shard_sum(x.sum(dim, keepdim=keepdim), groups) / n


class Adafactor:
    """Adafactor (Shazeer & Stern 2018), the JAX package's rule: the second
    moment of a parameter with ndim >= 2 is factored into exp-decayed means
    of g^2 over its last axis (vr) and its second-to-last (vc), so the
    optimizer state is about one row plus one column a matrix.

    * 0/1-d parameters keep a full second moment;
    * the decay is beta2_t = 1 - t^-decay_exponent;
    * updates are RMS-clipped at ``clip_threshold``;
    * ``relative_step=True`` takes the step min(1e-2, 1/sqrt(t)) times
      max(eps2, rms(p)); otherwise ``lr`` (a float or a schedule called
      with t), and exactly one of the two must be given;
    * ``beta1 > 0`` adds first-moment momentum, kept in f32;
    * ``weight_decay`` scales p by (1 - weight_decay) before the update.

    The update is computed in f32 and subtracted in the parameter's dtype,
    in place; every step stays on the device."""

    def __init__(self, lr: Optional[LR] = None, *, beta1: float = 0.0,
                 decay_exponent: float = 0.8, eps1: float = 1e-30,
                 eps2: float = 1e-3, clip_threshold: float = 1.0,
                 relative_step: bool = True, weight_decay: float = 0.0):
        if lr is None and not relative_step:
            raise ValueError("give lr or set relative_step=True")
        if lr is not None and relative_step:
            raise ValueError(
                "lr and relative_step=True are mutually exclusive — an "
                "explicit lr would be silently ignored; pass "
                "relative_step=False with lr")
        self.lr = lr
        self.beta1 = beta1
        self.decay_exponent = decay_exponent
        self.eps1 = eps1
        self.eps2 = eps2
        self.clip_threshold = clip_threshold
        self.relative_step = relative_step
        self.weight_decay = weight_decay

    def init(self, model: nn.Module) -> AdafactorState:
        vr, vc = {}, {}
        for n, p in _params(model).items():
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                vr[n] = torch.zeros(p.shape[:-1], **f32)
                vc[n] = torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)
            else:
                vr[n] = torch.zeros(p.shape, **f32)
                vc[n] = torch.zeros((0,), **f32)
        m = ({n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in _params(model).items()} if self.beta1 > 0 else None)
        return AdafactorState(step=0, vr=vr, vc=vc, m=m)

    def _update(self, p, g, vr, vc, t: int, b2t: float,
                new_share: float) -> torch.Tensor:
        """Advance vr / vc in place (vr <- b2t vr + new_share mean(g^2))
        and return the f32 update for ``p``."""
        g = g.float()
        g2 = g.square() + self.eps1
        # the means span the whole parameter where ranks hold its blocks
        rows, cols = _split_groups(p, [-1]), _split_groups(p, [-2])
        every = _split_groups(p, range(p.ndim))
        if p.ndim >= 2:
            vr.mul_(b2t).add_(new_share * _mean(g2, -1, rows))
            vc.mul_(b2t).add_(new_share * _mean(g2, -2, cols))
            red = vr / _mean(vr, -1, cols, keepdim=True)
            u = g * torch.rsqrt(red)[..., None] * torch.rsqrt(vc)[..., None, :]
        else:
            vr.mul_(b2t).add_(new_share * g2)
            u = g * torch.rsqrt(vr)
        u = u / torch.clamp(_rms(u, every) / self.clip_threshold, min=1.0)
        if self.relative_step:
            rho = min(1e-2, 1.0 / math.sqrt(t))
            return u * (torch.clamp(_rms(p, every), min=self.eps2) * rho)
        return u * (self.lr(t) if callable(self.lr) else self.lr)

    def step(self, model: nn.Module, grads: Grads,
             state: AdafactorState) -> Tuple[nn.Module, AdafactorState]:
        """Update ``model``'s parameters and the statistics in place; returns
        (model, state) with the step count advanced."""
        t = state.step + 1
        # beta2_t and 1 - beta2_t rounded as JAX's f32 scalars are
        one = np.float32(1.0)
        b2t = one - np.float32(t) ** np.float32(-self.decay_exponent)
        with torch.no_grad():
            for name, p in _params(model).items():
                u = self._update(p, grads[name], state.vr[name],
                                 state.vc[name], t, float(b2t),
                                 float(one - b2t))
                if self.beta1 > 0:
                    m = state.m[name]
                    m.mul_(self.beta1).add_((1.0 - self.beta1) * u)
                    u = m
                if self.weight_decay:
                    p.mul_(1.0 - self.weight_decay)
                p.sub_(u.to(p.dtype))
        return model, AdafactorState(t, state.vr, state.vc, state.m)
