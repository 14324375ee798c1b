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
:func:`make_distill_loss`).  :class:`ShardedTrainer` trains over a (data,
model) mesh, one process a rank.
"""

from __future__ import annotations

import contextlib
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
    return _masked_mean(losses, loss_mask, _batch_group(model))


def _batch_group(model: nn.Module):
    """The group over which ``model``'s batch is split (set by
    :func:`~..parallel.sharding.apply_mesh`), or None."""
    return getattr(model, "batch_group", None)


def _masked_mean(per_pos: Tensor, loss_mask: Optional[Tensor],
                 group=None) -> Tensor:
    """The masked mean over the positions; under a batch split over
    ``group`` the mean over the global batch, sum(loss * mask) / sum(mask)
    over every rank (not the mean of the ranks' means), each rank's
    gradient its own share."""
    if group is None:
        if loss_mask is None:
            return per_pos.mean()
        return (per_pos * loss_mask).sum() / torch.clamp(loss_mask.sum(),
                                                         min=1.0)
    from ..parallel.comm import all_reduce, reduce_from_group

    if loss_mask is None:
        num = per_pos.sum()
        den = torch.full((), float(per_pos.numel()), device=per_pos.device)
    else:
        num = (per_pos * loss_mask).sum()
        den = loss_mask.sum().float()
    den = torch.clamp(all_reduce(den.detach(), group), min=1.0)
    return reduce_from_group(num / den, group)


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
        return (_masked_mean(losses, loss_mask, _batch_group(model))
                + aux_alpha * aux)

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
        return _masked_mean(per_pos, loss_mask, _batch_group(student))

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


class ShardedTrainer:
    """DP x TP training over a (data, model) mesh, one process a rank.

    - parameters split per the Megatron TP rules (:func:`~..parallel.
      sharding.shard_model`), the model wired to the mesh
      (:func:`~..parallel.sharding.apply_mesh`), so that each rank runs
      its heads and FFN columns and the layers write out the reductions;
    - the batch split over the data axis (:meth:`put_batch` takes this
      rank's rows of the global batch); the loss is the global batch's
      masked mean, and the gradients are summed over the data axis, so
      that every update is the global batch's;
    - ``grad_clip`` clips by the norm of the whole (unsplit) gradient.

    ``zero=True`` also splits every parameter and optimizer moment over the
    *data* axis (``fsdp_spec_for``; ZeRO-3): between steps the model's
    parameters are this rank's (data, model) blocks, ``param.spec`` their
    FSDP spec.  A step all-gathers each into its TP block for the forward
    and backward (temporaries, freed when the step ends), reduce-scatters
    the gradients back into the blocks, and the optimizer steps the blocks.

    ``step`` and ``scan_steps`` return the loss(es) as device tensors.
    ``key`` is a ``torch.Generator`` for the dropout seeds (None: no
    dropout in ``step``; ``scan_steps`` then draws from the trainer's own
    generator, seeded by ``seed``)."""

    def __init__(self, model: nn.Module, opt: Any, mesh, data_axis: str = "data",
                 model_axis: str = "model",
                 loss_fn: Callable[..., Tensor] = lm_loss, zero: bool = False,
                 grad_clip: Optional[float] = None, seed: int = 0):
        from ..parallel.mesh import axis_group
        from ..parallel.sharding import (apply_mesh, fsdp_sharding_tree,
                                         shard_model)

        self.mesh = mesh
        self.opt = opt
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.loss_fn = loss_fn
        self.zero = zero
        self.grad_clip = grad_clip
        self._scan_gen = torch.Generator().manual_seed(seed)
        self._data_group = axis_group(mesh, data_axis)
        meshed = apply_mesh(model, mesh, batch_axis=data_axis,
                            head_axis=model_axis)
        self.model = shard_model(meshed, mesh, model_axis)
        self._fsdp_dim = {}
        if zero:
            specs = fsdp_sharding_tree(model, mesh, data_axis, model_axis)
            for name, p in self.model.named_parameters():
                spec = specs[name]
                dim = spec.index(data_axis) if data_axis in spec else None
                self._fsdp_dim[name] = dim
                if dim is not None:
                    p.data = _local_rows(p.detach(), self._data_group,
                                         dim).clone()
                p.spec = spec
        self.opt_state = opt.init(self.model)

    def put_batch(self, *arrays):
        """This rank's rows (dim 0 split over the data axis) of each global
        batch array, on the model's device."""
        return tuple(self._rows(a, 0) for a in arrays)

    def _rows(self, a, dim: int):
        if a is None:
            return None
        device = next(self.model.parameters()).device
        return _local_rows(torch.as_tensor(a), self._data_group, dim).to(device)

    def _reduce_grads(self, grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Sum the ranks' gradients over the data axis: all-reduced, or
        with ZeRO reduce-scattered into this rank's block."""
        from ..parallel.comm import group_size

        group = self._data_group
        if group_size(group) == 1:
            return grads
        out = {}
        whole = [n for n in grads if self._fsdp_dim.get(n) is None]
        if whole:
            flat = torch.cat([grads[n].reshape(-1) for n in whole])
            torch.distributed.all_reduce(flat, group=group)
            for n, part in zip(whole, flat.split([grads[n].numel()
                                                  for n in whole])):
                out[n] = part.view_as(grads[n])
        for n, dim in self._fsdp_dim.items():
            if dim is not None:
                out[n] = _reduce_scatter_rows(grads[n], group, dim)
        return {n: out[n] for n in grads}

    @contextlib.contextmanager
    def _gathered(self):
        """With ZeRO: the model's parameters hold their TP blocks (each
        all-gathered over the data axis) inside, their data blocks again
        on leaving; the gathered tensors are then freed."""
        from ..parallel.comm import all_gather

        split = [(p, dim) for name, p in self.model.named_parameters()
                 if (dim := self._fsdp_dim.get(name)) is not None]
        blocks = [p.data for p, _ in split]
        for p, dim in split:
            p.data = all_gather(p.data, self._data_group, dim)
        try:
            yield
        finally:
            for (p, _), block in zip(split, blocks):
                p.data = block

    def _step(self, tokens, targets, loss_mask, generator, ctx=None):
        with self._gathered():
            loss, grads = _value_and_grad(self.loss_fn, self.model, tokens,
                                          targets, loss_mask, generator, ctx)
        grads = self._reduce_grads(grads)
        if self.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.grad_clip,
                                        dict(self.model.named_parameters()))
        self.model, self.opt_state = self.opt.step(self.model, grads,
                                                   self.opt_state)
        return loss

    def step(self, tokens, targets, loss_mask=None, key=None) -> Tensor:
        """One update on the global batch (tokens, targets, loss_mask: the
        global arrays; this rank takes its rows).  Returns the loss."""
        tokens, targets, loss_mask = self.put_batch(tokens, targets,
                                                    loss_mask)
        return self._step(tokens, targets, loss_mask, key)

    def scan_steps(self, tokens, targets, loss_mask=None, key=None,
                   ctx=None) -> Tensor:
        """K updates, one a slice of the leading (n_steps,) axis of the
        stacked global batches (their dim 1 split over the data axis), in
        order; returns the (n_steps,) losses.  A missing mask counts every
        position, as ``make_train_scan`` does; with ``key=None`` the
        dropout seeds come from the trainer's own generator."""
        tokens, targets = self._rows(tokens, 1), self._rows(targets, 1)
        loss_mask = (torch.ones(targets.shape, device=targets.device)
                     if loss_mask is None else self._rows(loss_mask, 1))
        gen = self._scan_gen if key is None else key
        losses = [self._step(tokens[i], targets[i], loss_mask[i], gen, ctx)
                  for i in range(targets.shape[0])]
        return torch.stack(losses)


def _local_rows(t: Tensor, group, dim: int) -> Tensor:
    """This rank's block of ``t`` along ``dim`` over ``group``."""
    from ..parallel.comm import group_size, local_block

    if group_size(group) > 1 and t.shape[dim] % group_size(group):
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                         f"over {group_size(group)} data ranks")
    return local_block(t, group, dim)


def _reduce_scatter_rows(g: Tensor, group, dim: int) -> Tensor:
    """The sum over ``group`` of ``g``, this rank's block along ``dim``."""
    from ..parallel.comm import group_size

    n = group_size(group)
    src = g.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    torch.distributed.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()
