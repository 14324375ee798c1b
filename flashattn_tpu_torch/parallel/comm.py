"""Collectives with the gradients of JAX's SPMD program.

Under GSPMD the JAX package writes no collective for the tensor-parallel
layers: XLA inserts them.  A process per rank has to write each one out,
with the backward that makes autograd give JAX's gradient.  Megatron's
conjugate pairs:

* :func:`copy_to_group`: the identity forward, an all-reduce (sum)
  backward, at the input of a column-parallel matmul: every rank consumes
  the whole replicated input and contributes part of its gradient;
* :func:`reduce_from_group`: an all-reduce forward, the identity backward,
  after a row-parallel matmul (each rank holds a partial sum) and wherever
  a sum over ranks feeds a replicated consumer.  The identity backward is
  what keeps a replicated loss's gradient at 1x:
  ``torch.distributed.nn.functional.all_reduce`` sums the gradient too and
  so multiplies it by the world size;
* :func:`gather_from_group` / :func:`scatter_to_group`: an all-gather along
  a dim whose backward takes this rank's block, and the reverse;
* :func:`ppermute`: ``jax.lax.ppermute`` by a shift around a group's ring
  (send to rank + shift, receive from rank - shift); its backward is the
  reverse permutation.

A group of one rank (``None``) makes each of them the identity, with no
autograd node.  The plain helpers (:func:`all_reduce`, :func:`all_gather`,
:func:`send_recv`) are the same collectives without autograd, for code that
writes its own backward (ring attention, the pipeline).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor; ``t`` untouched)."""
    if group_size(group) == 1:
        return t
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def local_block(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` split evenly along ``dim``."""
    n = group_size(group)
    if n == 1:
        return t
    w = t.shape[dim] // n
    return t.narrow(dim, group_rank(group) * w, w).contiguous()


def send_recv(t: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``t`` of rank ``r - shift`` around the ring of ``group`` (this rank
    sends its ``t`` to ``r + shift``): one P2P exchange a call."""
    n = group_size(group)
    if n == 1 or shift % n == 0:
        return t
    r = group_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    send = t.detach().contiguous()
    out = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return local_block(g, *ctx.args), None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return local_block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.args = (group, shift)
        return send_recv(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        group, shift = ctx.args
        return send_recv(g, group, -shift), None, None


def _differentiable(fn, x, *args):
    if group_size(args[0]) == 1:
        return x
    return fn.apply(x, *args)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; all-reduce of the gradient over ``group``."""
    return _differentiable(_CopyToGroup, x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward; identity backward."""
    return _differentiable(_ReduceFromGroup, x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward; this rank's block backward."""
    return _differentiable(_GatherFromGroup, x, group, dim)


def scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` forward; all-gather backward."""
    return _differentiable(_ScatterToGroup, x, group, dim)


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``x`` of rank ``r - shift`` (each rank sends to ``r + shift``);
    backward sends the gradient the other way."""
    return _differentiable(_PPermute, x, group, shift)


def shard_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed over each group of ``groups`` (no gradient): a local
    partial of a reduction over a split dim made whole."""
    for g in groups:
        x = all_reduce(x, g)
    return x


def dims_groups(spec, mesh, dims) -> list:
    """The process groups of the mesh axes that split ``dims`` under
    ``spec`` (a tensor's placement), each once."""
    from .mesh import _spec_dims, axis_group

    entries = _spec_dims(spec, max(len(spec), max(dims, default=-1) + 1))
    out = []
    for d in dims:
        for name in entries[d]:
            g = axis_group(mesh, name)
            if g is not None and g not in out:
                out.append(g)
    return out


__all__ = ["all_reduce", "all_gather", "local_block", "send_recv",
           "copy_to_group", "reduce_from_group", "gather_from_group",
           "scatter_to_group", "ppermute", "shard_sum", "dims_groups",
           "group_size", "group_rank"]
