"""Training step and losses (counterpart of flashattn_tpu/training/trainer.py).

``make_train_step(opt, loss_fn, grad_clip, accum_steps)`` returns
``step(model, opt_state, tokens, targets, loss_mask, generator, ctx=None)
-> (model, opt_state, loss)``: forward, autograd backward, optional
global-norm clipping and the optimizer update, which changes the model's
parameters in place (see :mod:`..optim`).  PyTorch runs eagerly, so there
is no ``jit`` and no ``donate``; a JAX ``key`` becomes a ``torch.Generator``
from which the model draws its dropout seeds.  The loss comes back as a
0-dim device tensor, so a step does not wait for the device.  ``ctx``, when
given, reaches the loss as a sixth argument (a distillation teacher, see
:func:`make_distill_loss`).  ``ShardedTrainer`` is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..nn import functional as F
from ..optim import clip_by_global_norm

Tensor = torch.Tensor


def lm_loss(model: nn.Module, tokens: Tensor, targets: Tensor,
            loss_mask: Optional[Tensor] = None,
            generator: Optional[torch.Generator] = None) -> Tensor:
    """Masked next-token cross entropy.

    tokens:    (B, S) int input ids
    targets:   (B, S) int labels, already shifted
    loss_mask: (B, S) 1.0 where the position counts (None: every position)
    The loss is computed in f32 whatever the compute dtype."""
    logits = model(tokens, generator=generator).float()
    n_vocab = logits.shape[-1]
    losses = F.softmax_loss(logits.reshape(-1, n_vocab),
                            targets.reshape(-1)).reshape(targets.shape)
    return _masked_mean(losses, loss_mask)


def _masked_mean(per_pos: Tensor, loss_mask: Optional[Tensor]) -> Tensor:
    if loss_mask is None:
        return per_pos.mean()
    return (per_pos * loss_mask).sum() / torch.clamp(loss_mask.sum(), min=1.0)


def make_moe_loss(aux_alpha: float = 0.01) -> Callable[..., Tensor]:
    """Masked LM loss plus ``aux_alpha`` times the Switch load-balancing
    loss that ``forward_with_aux`` sums over the MoE layers.  A loss_fn for
    make_train_step / make_train_scan."""

    def loss_fn(model, tokens, targets, loss_mask=None, generator=None):
        logits, aux = model.forward_with_aux(tokens, generator)
        logits = logits.float()
        n_vocab = logits.shape[-1]
        losses = F.softmax_loss(logits.reshape(-1, n_vocab),
                                targets.reshape(-1)).reshape(targets.shape)
        return _masked_mean(losses, loss_mask) + aux_alpha * aux

    return loss_fn


def make_distill_loss(teacher: Optional[nn.Module] = None, alpha: float = 1.0,
                      temperature: float = 1.0) -> Callable[..., Tensor]:
    """Knowledge distillation for speculative-decoding drafts: KL(teacher ||
    student) over the vocabulary at every unmasked position, mixed with the
    hard-label cross entropy when ``alpha < 1`` (``alpha`` weights the KL,
    ``1 - alpha`` the CE), both at ``temperature``.

    The teacher runs in eval mode under ``torch.no_grad()`` and is left in
    the mode it had.  Give it here, or per call through the step
    factories' ``ctx`` argument (``make_train_scan(...)(model, state, tok,
    tgt, msk, generator, ctx=teacher)``), which wins when both are given."""

    def loss_fn(student, tokens, targets, loss_mask=None, generator=None,
                ctx=None):
        t_model = ctx if ctx is not None else teacher
        if t_model is None:
            raise ValueError("make_distill_loss: no teacher; pass one at "
                             "construction or as the step's ctx")
        was_training = t_model.training
        t_model.eval()
        try:
            with torch.no_grad():
                t_logits = t_model(tokens).float()
        finally:
            t_model.train(was_training)
        s_logits = student(tokens, generator=generator).float()
        temp = torch.full((), temperature, dtype=torch.float32,
                          device=s_logits.device)
        t_logp = torch.log_softmax(t_logits / temp, dim=-1)
        s_logp = torch.log_softmax(s_logits / temp, dim=-1)
        per_pos = (t_logp.exp() * (t_logp - s_logp)).sum(-1)
        if alpha < 1.0:
            n_vocab = s_logits.shape[-1]
            ce = F.softmax_loss(s_logits.reshape(-1, n_vocab),
                                targets.reshape(-1)).reshape(targets.shape)
            per_pos = alpha * per_pos + (1.0 - alpha) * ce
        return _masked_mean(per_pos, loss_mask)

    return loss_fn


class _Bound(nn.Module):
    """``loss_fn`` bound to ``model``, so that ``functional_call`` can swap
    the model's parameters for the duration of one loss evaluation."""

    def __init__(self, model: nn.Module, loss_fn: Callable[..., Tensor]):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *args):
        return self.loss_fn(self.model, *args)


def make_mixed_precision_loss(loss_fn: Callable[..., Tensor] = lm_loss,
                              compute_dtype=torch.bfloat16
                              ) -> Callable[..., Tensor]:
    """bf16 compute over f32 master weights.

    Wraps any ``loss_fn(model, ...)``: each floating parameter is cast to
    ``compute_dtype`` inside the differentiated function
    (``torch.func.functional_call``), so every matmul and kernel runs in
    bf16 while autograd differentiates through the cast and delivers f32
    gradients for the f32 masters.  Not ``torch.autocast``, which picks its
    own ops to keep in f32 and so computes something else."""

    def wrapped(model, tokens, targets, loss_mask=None, generator=None):
        bound = _Bound(model, loss_fn)
        cast = {"model." + n: (p.to(compute_dtype) if p.is_floating_point()
                               else p)
                for n, p in model.named_parameters()}
        return torch.func.functional_call(
            bound, cast, (tokens, targets, loss_mask, generator))

    return wrapped


def _call_loss(loss_fn, model, tokens, targets, loss_mask, generator, ctx):
    """Call a loss fn, passing ``ctx`` only when given (a plain loss fn
    takes five arguments, a ctx-aware one such as make_distill_loss's
    six)."""
    if ctx is None:
        return loss_fn(model, tokens, targets, loss_mask, generator)
    return loss_fn(model, tokens, targets, loss_mask, generator, ctx)


def _value_and_grad(loss_fn, model, tokens, targets, loss_mask, generator,
                    ctx=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    names, params = zip(*model.named_parameters())
    loss = _call_loss(loss_fn, model, tokens, targets, loss_mask, generator,
                      ctx)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


def make_train_step(opt: Any, loss_fn: Callable[..., Tensor] = lm_loss,
                    grad_clip: Optional[float] = None,
                    accum_steps: int = 1) -> Callable:
    """Returns step(model, opt_state, tokens, targets, loss_mask=None,
    generator=None, ctx=None) -> (model, opt_state, loss).

    ``grad_clip`` applies global-norm clipping.  ``accum_steps > 1`` splits
    the batch's leading dim into that many microbatches, runs them one after
    another (one microbatch of activations alive at a time) and applies ONE
    update with their gradients weighted by each microbatch's loss-mask
    token count, which reproduces the full-batch masked mean."""

    def grads_of(model, tokens, targets, loss_mask, generator, ctx):
        if accum_steps == 1:
            return _value_and_grad(loss_fn, model, tokens, targets,
                                   loss_mask, generator, ctx)
        if tokens.shape[0] % accum_steps:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"accum_steps {accum_steps}")
        split = lambda t: None if t is None else t.chunk(accum_steps)
        loss_sum, grad_sum, w_sum = 0.0, None, 0.0
        for tok, tgt, msk in zip(split(tokens), split(targets),
                                 split(loss_mask) or [None] * accum_steps):
            loss, grads = _value_and_grad(loss_fn, model, tok, tgt, msk,
                                          generator, ctx)
            w = msk.sum().float() if msk is not None else 1.0
            loss_sum = loss_sum + w * loss
            grad_sum = ({n: w * g.float() for n, g in grads.items()}
                        if grad_sum is None else
                        {n: grad_sum[n] + w * g.float()
                         for n, g in grads.items()})
            w_sum = w_sum + w
        scale = 1.0 / torch.clamp(torch.as_tensor(w_sum, dtype=torch.float32,
                                                  device=tokens.device),
                                  min=1e-9)
        params = dict(model.named_parameters())
        return loss_sum * scale, {n: (g * scale).to(params[n].dtype)
                                  for n, g in grad_sum.items()}

    def step(model, opt_state, tokens, targets, loss_mask=None,
             generator=None, ctx=None):
        loss, grads = grads_of(model, tokens, targets, loss_mask, generator,
                               ctx)
        if grad_clip is not None:
            grads = clip_by_global_norm(grads, grad_clip)
        model, opt_state = opt.step(model, grads, opt_state)
        return model, opt_state, loss

    return step


def _step_slice(t, i: int):
    """Slice ``i`` of a stacked batch: of each value of a dict (the seq2seq
    inputs ``{"src", "src_lens", "tgt_in"}``, as JAX's scan slices a
    pytree), else of the tensor; None stays None."""
    if t is None:
        return None
    if isinstance(t, dict):
        return {name: v[i] for name, v in t.items()}
    return t[i]


def make_train_scan(opt: Any, loss_fn: Callable[..., Tensor] = lm_loss,
                    grad_clip: Optional[float] = None) -> Callable:
    """Returns scan(model, opt_state, tokens, targets, loss_mask, generator,
    ctx=None) where tokens/targets/loss_mask carry a leading (n_steps,)
    axis: one train step per slice, in order, and the (n_steps,) losses.
    ``tokens`` may be a dict of such stacks (the seq2seq inputs); targets
    gives the step count.  (The JAX package runs these steps in one
    ``lax.scan`` dispatch; here it is a Python loop.)"""
    step = make_train_step(opt, loss_fn, grad_clip)

    def scan(model, opt_state, tokens, targets, loss_mask=None,
             generator=None, ctx=None):
        losses = []
        for i in range(targets.shape[0]):
            model, opt_state, loss = step(
                model, opt_state, _step_slice(tokens, i), targets[i],
                _step_slice(loss_mask, i), generator, ctx)
            losses.append(loss)
        return model, opt_state, torch.stack(losses)

    return scan


def make_eval_step(loss_fn: Callable[..., Tensor] = lm_loss) -> Callable:
    """Returns eval(model, tokens, targets, loss_mask) -> loss: the model in
    eval mode (no dropout) under ``torch.no_grad()``, its mode restored
    after."""

    def evaluate(model, tokens, targets, loss_mask=None):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return loss_fn(model, tokens, targets, loss_mask, None)
        finally:
            model.train(was_training)

    return evaluate
