"""Attention over a mesh: batch- and head-parallel flash and paged
attention, and ring attention over a sequence axis (counterpart of
flashattn_tpu/parallel/sharded_attention.py).

JAX wraps its Pallas kernels in ``shard_map`` so that each device runs them
on its block.  A rank of the port already holds its block, so
:func:`sharded_flash_attention` and :func:`sharded_paged_attention` take
this rank's shards (its batch rows, its heads, its KV heads' pages) and
run the ported kernels on them, with no communication: the collectives
live in the projections around them.

:func:`ring_flash_attention` is sequence (context) parallelism: q, k and v
are this rank's block of the sequence.  K/V blocks travel around the
``seq`` axis's ring (:func:`~.comm.send_recv`); each step runs
:func:`~..ops.flash_attention.flash_attention_with_lse` on the resident
pair (its schedule picked by the shard's shape, as JAX's is) and merges
the partial result by its lse (:func:`_merge_partials`).  Causal rings
skip the blocks of later shards.  Its backward is the reverse ring of
JAX's ``custom_vjp``: each pair's gradient is the TPU grid backward's
function (``_flash_bwd``) against the global (o, lse), and the dK/dV
accumulators travel with their blocks and make one final hop home.

The per-rank, per-step work is factored into :func:`ring_forward_step`
and :func:`ring_backward_step`, so that a single process can run a whole
ring of ``n`` ranks with them (the rotation is then a list roll).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops._utils import on_cuda
from ..ops.flash_attention import (
    _reference_bwd,
    flash_attention,
    flash_attention_varlen,
    flash_attention_with_lse,
    flash_bwd,
)
from ..ops.paged_attention import paged_attention
from .comm import group_rank, group_size, send_recv
from .mesh import axis_group


def sharded_flash_attention(q, k, v, causal: bool = False, *, mesh,
                            batch_axis: Optional[str] = "data",
                            head_axis: Optional[str] = "model",
                            sm_scale: Optional[float] = None,
                            kv_lengths=None, window: Optional[int] = None):
    """Flash attention on this rank's block: q/k/v (B_local, H_local, N,
    d) are its batch rows (``batch_axis``) and heads (``head_axis``), the
    sequence and head dim whole.  ``kv_lengths`` (B_local,) selects the
    varlen kernel; ``window`` is sliding-window attention.  No
    communication; differentiable."""
    if kv_lengths is None:
        return flash_attention(q, k, v, causal, sm_scale, window=window)
    return flash_attention_varlen(q, k, v, kv_lengths, causal, sm_scale,
                                  window=window)


def sharded_paged_attention(q, k_pages, v_pages, lengths, page_indices, *,
                            mesh, head_axis: Optional[str] = "model",
                            k_scales=None, v_scales=None,
                            sm_scale: Optional[float] = None,
                            window: Optional[int] = None):
    """Paged attention over this rank's KV heads and their pages: q (B,
    Hq_local, d) or (B, chunk, Hq_local, d), pools (Hkv_local, pages, page,
    d); the page table and lengths are replicated.  No communication."""
    return paged_attention(q, k_pages, v_pages, lengths, page_indices,
                           k_scales=k_scales, v_scales=v_scales,
                           sm_scale=sm_scale, window=window)


def _merge_partials(o1, lse1, o2, lse2):
    """Online-softmax merge of two partial attentions by their lse; an
    empty partial carries lse = -inf, and two empty ones give o = 0, lse
    = -inf."""
    m = torch.maximum(lse1, lse2)
    neg_inf = lambda t: torch.isinf(t) & (t < 0)
    m_safe = torch.where(neg_inf(m), torch.zeros_like(m), m)
    w1 = torch.where(neg_inf(lse1), torch.zeros_like(lse1),
                     torch.exp(lse1 - m_safe))
    w2 = torch.where(neg_inf(lse2), torch.zeros_like(lse2),
                     torch.exp(lse2 - m_safe))
    denom = w1 + w2
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (w1 * o1 + w2 * o2) / denom_safe
    lse = m_safe + torch.log(denom_safe)
    lse = torch.where(denom == 0.0, torch.full_like(lse, -math.inf), lse)
    return o, lse


def _attends(step: int, me: int, n: int, causal: bool) -> bool:
    """Whether rank ``me`` attends the block resident at ``step``: the
    diagonal always; another shard's block unless the ring is causal and
    that block comes from a later (or the same) shard."""
    return step == 0 or not causal or (me - step) % n < me


def ring_forward_step(q, k_blk, v_blk, o, lse, *, step: int, me: int,
                      n: int, causal: bool, scale: float):
    """One rank's forward work at one ring step: (o f32, lse) after the
    block resident at ``step`` (step 0: the diagonal block, causal when the
    ring is; ``o`` and ``lse`` unused)."""
    if not _attends(step, me, n, causal):
        return o, lse
    o_p, lse_p = flash_attention_with_lse(q, k_blk, v_blk,
                                          causal and step == 0, scale)
    if step == 0:
        return o_p.float(), lse_p
    return _merge_partials(o, lse, o_p.float(), lse_p)


def _pair_bwd(q, k, v, lse, di, do, causal, scale):
    """(dq, dk, dv) f32 of one (q-shard, kv-block) pair against the global
    (o, lse): the TPU grid backward's function (``_flash_bwd``) at every
    shape, which on the card is flash_bwd's kernel mode (``grid=True``)."""
    if on_cuda(q, k, v):
        out = flash_bwd(q, k, v, lse, di, do, causal=causal, sm_scale=scale,
                        grid=True)
    else:
        out = _reference_bwd(q, k, v, lse, di, do, causal, scale)
    return tuple(t.float() for t in out)


def ring_backward_step(q, k_blk, v_blk, lse, di, do, dq, dk_acc, dv_acc, *,
                       step: int, me: int, n: int, causal: bool,
                       scale: float):
    """One rank's backward work at one ring step: (dq, dk_acc, dv_acc) in
    f32 after the pair with the block resident at ``step`` (step 0 starts
    the sums; the accumulators travel with their block)."""
    if not _attends(step, me, n, causal):
        return dq, dk_acc, dv_acc
    dq_p, dk_p, dv_p = _pair_bwd(q, k_blk, v_blk, lse, di, do,
                                 causal and step == 0, scale)
    if step == 0:
        return dq_p, dk_p, dv_p
    return dq + dq_p, dk_acc + dk_p, dv_acc + dv_p


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, group):
        n, me = group_size(group), group_rank(group)
        kw = dict(me=me, n=n, causal=causal, scale=scale)
        o = lse = None
        k_blk, v_blk = k, v
        for step in range(n):
            if step:
                k_blk = send_recv(k_blk, group)
                v_blk = send_recv(v_blk, group)
            o, lse = ring_forward_step(q, k_blk, v_blk, o, lse, step=step,
                                       **kw)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, group)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, group = ctx.args
        n, me = group_size(group), group_rank(group)
        kw = dict(me=me, n=n, causal=causal, scale=scale)
        di = (o.float() * do.float()).sum(-1, keepdim=True)
        dq = dk = dv = None
        k_blk, v_blk = k, v
        for step in range(n):
            if step:
                k_blk, v_blk, dk, dv = (send_recv(t, group)
                                        for t in (k_blk, v_blk, dk, dv))
            dq, dk, dv = ring_backward_step(q, k_blk, v_blk, lse, di, do, dq,
                                            dk, dv, step=step, **kw)
        # one final hop completes the revolution: the accumulators go home
        dk, dv = send_recv(dk, group), send_recv(dv, group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def ring_flash_attention(q, k, v, causal: bool = False, *, mesh,
                         seq_axis: str = "seq",
                         batch_axis: Optional[str] = None,
                         head_axis: Optional[str] = None,
                         sm_scale: Optional[float] = None):
    """Context-parallel attention: q/k/v are this rank's block of the
    sequence (and of the batch and heads over ``batch_axis`` /
    ``head_axis``, which need no communication here).  Returns this rank's
    block of the output.  Differentiable: the backward runs the reverse
    ring.  The output accumulates in f32 across merges and is cast to q's
    dtype once."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _RingFlash.apply(q, k, v, causal, scale, axis_group(mesh, seq_axis))


def _ring_in_process(q, k, v, do, causal: bool, n: int,
                     sm_scale: Optional[float] = None):
    """The ring of ``n`` ranks run in one process on whole (B, H, N, d)
    tensors, split into ``n`` sequence blocks: every rank's steps by
    :func:`ring_forward_step` and :func:`ring_backward_step`, the rotation
    a list roll (rank r receives rank r - 1's block).  Returns (o, lse, dq,
    dk, dv) whole, for checking the ring's per-step work against the
    unsharded attention where only one rank exists (one card)."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qs, ks, vs, dos = (list(t.chunk(n, dim=2)) for t in (q, k, v, do))
    roll = lambda xs: [xs[(r - 1) % n] for r in range(n)]
    kw = dict(n=n, causal=causal, scale=scale)
    o, lse = [None] * n, [None] * n
    k_blk, v_blk = ks, vs
    for step in range(n):
        if step:
            k_blk, v_blk = roll(k_blk), roll(v_blk)
        for r in range(n):
            o[r], lse[r] = ring_forward_step(qs[r], k_blk[r], v_blk[r], o[r],
                                             lse[r], step=step, me=r, **kw)
    o = [x.to(q.dtype) for x in o]
    di = [(a.float() * b.float()).sum(-1, keepdim=True)
          for a, b in zip(o, dos)]
    dq, dk, dv = [None] * n, [None] * n, [None] * n
    k_blk, v_blk = ks, vs
    for step in range(n):
        if step:
            k_blk, v_blk, dk, dv = (roll(x) for x in (k_blk, v_blk, dk, dv))
        for r in range(n):
            dq[r], dk[r], dv[r] = ring_backward_step(
                qs[r], k_blk[r], v_blk[r], lse[r], di[r], dos[r], dq[r],
                dk[r], dv[r], step=step, me=r, **kw)
    dk, dv = roll(dk), roll(dv)
    cat = lambda xs, t: torch.cat(xs, dim=2).to(t.dtype)
    return (torch.cat(o, dim=2), torch.cat(lse, dim=2), cat(dq, q),
            cat(dk, k), cat(dv, v))
