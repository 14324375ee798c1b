"""Mixture-of-experts feed-forward, Switch / GShard style (counterpart of
flashattn_tpu/models/moe.py).

Static shapes, as in the JAX module: each expert takes at most ``capacity``
tokens a batch in training (overflowing tokens fall through the residual),
dispatch and combine are one-hot products over a (T, E, capacity) tensor,
and the experts' weights are stacked ``(E, d, m)`` / ``(E, m, d)`` so that
the expert MLPs are one batched product.  Top-1 or top-2 routing with the
Switch load-balancing loss ``E * sum_e(mean_t(prob_e) * token_frac_e)``,
returned by :meth:`MoEFeedForward.forward_with_aux`.  All of it is plain
torch ops: the JAX package has no kernel here either.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..nn import functional as F
from ..nn.basic import Dropout, Linear, _uniform


@contextlib.contextmanager
def _highest_f32():
    """f32 matmuls in full f32 (no TF32, no bf16 passes) for the duration,
    whatever the caller set."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class _RouterMatmul(torch.autograd.Function):
    """(T, d) x (d, E) in full f32, forward and backward: the JAX module
    pins the router to ``Precision.HIGHEST``, since a near-tie flipped by a
    lower-precision product routes a token to another expert wholesale."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _highest_f32():
            return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _highest_f32():
            return g @ w.t(), x.t() @ g


class MoEFeedForward(nn.Module):
    """Token-routed expert GELU MLPs replacing a dense FeedForward.  The
    parameters are ``router.weights`` (d, E), ``experts_in`` (E, d, m) and
    ``experts_out`` (E, m, d), the JAX module's names."""

    def __init__(self, n_embd: int, middle_dim: int, n_experts: int, *,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 p_dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2, got {top_k}")
        self.n_embd = n_embd
        self.middle_dim = middle_dim
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dropout = Dropout(p_dropout)
        self.router = Linear(n_embd, n_experts, bias=False,
                             generator=generator, dtype=dtype, device=device)
        # Linear's +-1/sqrt(in) init, stacked over the experts
        self.experts_in = nn.Parameter(_uniform(
            (n_experts, n_embd, middle_dim), 1.0 / math.sqrt(n_embd),
            generator, dtype, device))
        self.experts_out = nn.Parameter(_uniform(
            (n_experts, middle_dim, n_embd), 1.0 / math.sqrt(middle_dim),
            generator, dtype, device))
        # the expert split (parallel.sharding.shard_model) and the data
        # split of the batch (parallel.sharding.apply_mesh)
        self.tp = None
        self.batch_group = None

    def _capacity(self, n_tokens: int) -> int:
        if not self.training:
            # dropless at eval: drops would make a token's output depend on
            # the rest of its batch, and the cached decode would leave the
            # dense forward.  The top-k experts of a token are distinct, so
            # one expert receives at most n_tokens assignments.
            return n_tokens
        cap = int(math.ceil(n_tokens * self.top_k * self.capacity_factor
                            / self.n_experts))
        return max(cap, self.top_k)

    def _route(self, xt: torch.Tensor):
        """Routing of tokens ``xt`` (T, d): (probs (T, E), combine (T, E,
        cap) f32 gate weights, top_mask (T, E) chosen experts).  A token's
        slot in its expert is its rank among the tokens before it (in the
        flattened order) that chose that expert, counting the earlier
        choices' slots first; slots at or past the capacity are dropped.
        Under a batch split (``batch_group``) the order and the capacity
        are the global batch's: this rank's tokens follow the earlier
        ranks'."""
        t, e = xt.shape[0], self.n_experts
        from ..parallel.comm import group_size

        cap = self._capacity(t * group_size(self.batch_group))
        logits = _RouterMatmul.apply(xt.float(), self.router.weights.float())
        probs = torch.softmax(logits, dim=-1)
        combine = xt.new_zeros((t, e, cap), dtype=torch.float32)
        gate_sum = xt.new_zeros((t,), dtype=torch.float32)
        top_mask = xt.new_zeros((t, e), dtype=torch.float32)
        masked = probs
        for _ in range(self.top_k):
            onehot = F.one_hot(masked.argmax(-1), e)                  # (T, E)
            gate = (probs * onehot).sum(-1)                           # (T,)
            pos = ((onehot.cumsum(0) - onehot) + self._before(onehot)[None]
                   + self._batch_sum(top_mask)[None])
            pos = (pos * onehot).sum(-1).long()                       # (T,)
            keep = (pos < cap).float()
            gate = gate * keep
            # jax.nn.one_hot gives a zero row past the range; torch's raises,
            # so clamp the index and zero the dropped rows by ``keep``
            slot = F.one_hot(pos.clamp(max=cap - 1), cap) * keep[:, None]
            combine = combine + (onehot * gate[:, None])[:, :, None] \
                * slot[:, None, :]
            gate_sum = gate_sum + gate
            top_mask = top_mask + onehot
            masked = masked * (1.0 - onehot)                          # exclude chosen
        if self.top_k > 1:
            # renormalise the kept gates (Mixtral); top-1 keeps the raw gate
            # (Switch), or the router would get no task gradient
            combine = combine / torch.clamp(gate_sum, min=1e-9)[:, None, None]
        return probs, combine, top_mask

    def _before(self, onehot: torch.Tensor) -> torch.Tensor:
        """(E,) choices of each expert on the ranks before this one of the
        batch split (0 without one)."""
        if self.batch_group is None:
            return torch.zeros_like(onehot[0])
        from ..parallel.comm import all_gather, group_rank

        counts = all_gather(onehot.sum(0)[None], self.batch_group, 0)
        return counts[:group_rank(self.batch_group)].sum(0)

    def _batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """(E,) sum over the tokens of the global batch (no gradient)."""
        from ..parallel.comm import all_reduce

        return all_reduce(t.sum(0), self.batch_group)

    def forward_with_aux(self, x: torch.Tensor, seed: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (..., S, d) -> (y, aux loss): routing is per token; ``seed``
        keys the output dropout."""
        shape = x.shape
        xt = x.reshape(-1, shape[-1])                                 # (T, d)
        probs, combine, top_mask = self._route(xt)
        dispatch = (combine > 0.0).to(xt.dtype)                       # (T, E, cap)
        combine = combine.to(xt.dtype)
        if self.tp is not None:
            # this rank's experts; their combine sums over the ranks
            from ..parallel.comm import (copy_to_group, local_block,
                                         reduce_from_group, scatter_to_group)

            group = self.tp.group
            xt = copy_to_group(xt, group)
            dispatch = local_block(dispatch, group, 1)
            combine = scatter_to_group(combine, group, 1)
        expert_in = torch.einsum("tec,td->ecd", dispatch, xt)         # (E, cap, d)
        h = F.GELU(torch.bmm(expert_in, self.experts_in))
        expert_out = torch.bmm(h, self.experts_out)                   # (E, cap, d)
        y = torch.einsum("tec,ecd->td", combine, expert_out)
        if self.tp is not None:
            y = reduce_from_group(y, group)
        frac_tokens = self._batch_mean(top_mask) / self.top_k
        aux = (frac_tokens * self._batch_mean(probs)).sum() * self.n_experts
        return self.dropout(y.reshape(shape), seed), aux

    def _batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over the tokens, of the global batch under a data split
        (``batch_group``): the ranks' sums, summed, over the global count."""
        if self.batch_group is None:
            return t.mean(0)
        from ..parallel.comm import group_size, reduce_from_group

        n = t.shape[0] * group_size(self.batch_group)
        return reduce_from_group(t.sum(0), self.batch_group) / n

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        return self.forward_with_aux(x, seed)[0]
