"""Pipeline parallelism (GPipe) over a named mesh axis (counterpart of
flashattn_tpu/parallel/pipeline.py).

Each rank of the ``stage`` axis holds the parameters of one pipeline stage
(a contiguous slice of the layer stack), activations flow stage to stage
around the axis's ring, and microbatches fill the pipeline.  Schedule: T =
n_microbatches + n_stages - 1 rotations; at rotation t stage s works on
microbatch t - s when 0 <= t - s < M; stage 0 feeds from the input queue,
the last stage banks its output, and the banked outputs are summed over
the stages (only the last stage's are nonzero), so that every rank
returns them.

JAX differentiates the ``shard_map``'d loop, ``ppermute`` transposing to
the reverse ring.  Here :func:`pipeline_apply` is one
``autograd.Function``: its forward records each rotation's stage graph,
and its backward runs the rotations in reverse, each rank sending its
input's gradient to the previous stage at every rotation (zeros when
idle), so that every rank makes the same exchanges in the same order.
The input's gradient is summed over the stages (only stage 0's is
nonzero), as the input is replicated over them.

Stacked parameters are ``{name: tensor}`` dicts with a leading stage axis
(and, after :func:`split_layers_into_stages`, a layers-per-stage axis);
:func:`shard_stage_params` takes this rank's block of them, which is what
:func:`pipeline_apply` runs.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.flash_attention import flash_attention
from ..nn import functional as F
from .comm import (all_reduce, copy_to_group, group_rank, group_size,
                   reduce_from_group, send_recv)
from .mesh import P, axis_group, local_shard
from .sharding import tp_spec_for

STAGE_AXIS = "stage"

# the mesh of the pipeline_apply call running a stage (megatron_layer_fn
# finds its model axis's group there, as JAX's psum finds its axis in the
# enclosing shard_map)
_MESHES: list = []


@contextlib.contextmanager
def _running_on(mesh):
    _MESHES.append(mesh)
    try:
        yield
    finally:
        _MESHES.pop()


def _axes(spec) -> set:
    """The mesh axes a placement spec names (none for None)."""
    return {a for e in (spec or ()) if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


def _as_tree(params: Any) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def stack_stage_params(stage_params: Sequence[Any]) -> Dict[str, torch.Tensor]:
    """Stack per-stage parameter trees (dicts, or modules by their named
    parameters) along a new leading stage axis."""
    trees = [_as_tree(p) for p in stage_params]
    return {n: torch.stack([t[n].detach() for t in trees]) for n in trees[0]}


def stage_sharding(mesh, axis: str = STAGE_AXIS) -> P:
    """The placement of stacked parameters: the leading axis over ``axis``."""
    return P(axis)


def shard_stage_params(stacked: Dict[str, torch.Tensor], mesh,
                       axis: str = STAGE_AXIS,
                       param_specs: Optional[Dict[str, P]] = None
                       ) -> Dict[str, torch.Tensor]:
    """This rank's block of the stacked parameters (leading dim 1), under
    ``param_specs`` (default ``P(axis)`` a leaf), as leaves that take
    gradients."""
    specs = param_specs or {n: stage_sharding(mesh, axis) for n in stacked}
    return {n: local_shard(t, mesh, specs[n]).detach().clone()
            .requires_grad_(t.dtype.is_floating_point)
            for n, t in stacked.items()}


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, mesh, group, data, n_mb, names, x, *params):
        n_stages, s = group_size(group), group_rank(group)
        t_all = n_mb + n_stages - 1
        x_mb = x.reshape((n_mb, -1) + tuple(x.shape[1:]))
        local = {n: p[0].detach().requires_grad_(p.requires_grad)
                 for n, p in zip(names, params)}
        buf = torch.zeros_like(x_mb[0])
        outs = torch.zeros_like(x_mb)
        records = {}
        for t in range(t_all):
            mb = t - s
            send = torch.zeros_like(buf)
            if 0 <= mb < n_mb:
                inp = (x_mb[t] if s == 0 else buf).detach().requires_grad_()
                with torch.enable_grad(), _running_on(mesh):
                    y = stage_fn(local, inp)
                records[t] = (inp, y)
                send = y.detach()
                if s == n_stages - 1:
                    outs[mb] = send
            if t < t_all - 1:
                buf = send_recv(send, group, 1)
        ctx.state = (records, local, names, group, data, n_mb, x.shape)
        return all_reduce(outs, group).reshape(x.shape)

    @staticmethod
    def backward(ctx, g_out):
        records, local, names, group, data, n_mb, x_shape = ctx.state
        n_stages, s = group_size(group), group_rank(group)
        t_all = n_mb + n_stages - 1
        g_mb = g_out.reshape((n_mb, -1) + tuple(x_shape[1:]))
        leaves = [local[n] for n in names if local[n].requires_grad]
        g_params = [torch.zeros_like(p) for p in leaves]
        g_x = torch.zeros_like(g_mb)
        g_buf = None
        for t in reversed(range(t_all)):
            g_y = (send_recv(g_buf, group, -1) if t < t_all - 1
                   else torch.zeros_like(g_mb[0]))
            g_buf = torch.zeros_like(g_mb[0])
            mb = t - s
            if not 0 <= mb < n_mb:
                continue
            if s == n_stages - 1:
                g_y = g_y + g_mb[mb]
            inp, y = records.pop(t)
            grads = torch.autograd.grad(y, [inp] + leaves, g_y,
                                        allow_unused=True)
            for acc, g in zip(g_params, grads[1:]):
                if g is not None:
                    acc += g
            if s == 0:
                g_x[t] += grads[0]
            else:
                g_buf = grads[0]
        g_x = all_reduce(g_x, group).reshape(x_shape)
        # a parameter replicated over the data axis sums its ranks'
        # gradients, as JAX's AD does for a shard_map input replicated there
        data_group, summed = data
        it = iter(g_params)
        g_all = [(all_reduce(next(it), data_group) if sum_ else next(it))
                 .unsqueeze(0) if local[n].requires_grad else None
                 for n, sum_ in zip(names, summed)]
        return (None, None, None, None, None, None, g_x, *g_all)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Dict[str, torch.Tensor], x: torch.Tensor,
                   mesh, *, n_microbatches: int, axis: str = STAGE_AXIS,
                   data_axis: Optional[str] = None,
                   param_specs: Optional[Dict[str, P]] = None
                   ) -> torch.Tensor:
    """Run ``x`` through the pipeline of stages.

    Args:
      stage_fn: ``(stage_params, activations) -> activations``, one stage's
        computation (e.g. :func:`scan_stage_fn` over its layers); the
        activations keep their shape and dtype.
      stacked_params: this rank's block of the stacked parameters (leading
        stage dim 1; :func:`shard_stage_params`).
      x: (batch, ...) activations, replicated over ``axis``.  With
        ``data_axis`` they are this rank's block of the global batch in the
        microbatch layout: ``x_global.reshape(M, mb, ...)`` split over
        ``data_axis`` on its dim 1, flattened back to (M * mb_local, ...);
        the output comes back in the same layout.  The gradient of each
        parameter that ``param_specs`` does not split over ``data_axis``
        is summed over it, so that every data rank holds the global
        batch's.
      mesh: the mesh holding ``axis``, whose size is the number of stages.
      n_microbatches: the GPipe microbatch count M (bubble ~ (S-1)/(M+S-1)).
      param_specs: the placement the blocks came from (e.g.
        :func:`megatron_stage_specs`, whose model axis ``stage_fn`` reduces
        over); each must split its leading dim over ``axis``.

    Returns the (batch, ...) activations of the last stage on every rank."""
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible into "
                         f"{n_microbatches} microbatches")
    if param_specs is not None:
        for n, spec in param_specs.items():
            if not spec or spec[0] != axis:
                raise ValueError(f"{n}: spec {spec} does not split the "
                                 f"leading dim over {axis!r}")
    names = list(stacked_params)
    specs = param_specs or {}
    summed = [data_axis is not None and data_axis not in _axes(specs.get(n))
              for n in names]
    data = (axis_group(mesh, data_axis) if data_axis is not None else None,
            summed)
    return _Pipeline.apply(stage_fn, mesh, axis_group(mesh, axis), data,
                           n_microbatches, names, x,
                           *[stacked_params[n] for n in names])


def split_layers_into_stages(layer_params: Sequence[Any],
                             n_stages: int) -> list:
    """Group a list of per-layer parameter trees (dicts, or layer modules)
    into ``n_stages`` trees stacked over their layers (len / n_stages
    each)."""
    n_layers = len(layer_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{n_stages} stages")
    per = n_layers // n_stages
    return [stack_stage_params(layer_params[i * per:(i + 1) * per])
            for i in range(n_stages)]


def _sub(p: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {n[len(prefix):]: t for n, t in p.items() if n.startswith(prefix)}


def megatron_layer_fn(template: nn.Module, model_axis: str = "model",
                      causal: bool = True
                      ) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """A pipeline layer fn that replays a ``TransformerLayer``'s forward on
    this rank's Megatron blocks of one layer's parameters (``{name:
    tensor}`` by the template's parameter names), with the collectives
    written out over ``model_axis`` of the running pipeline's mesh:

    * q/k/v projections column-parallel (flash attention on the local
      heads, no communication),
    * the attention out-projection and ``ff.linear_out`` row-parallel, one
      all-reduce each, their replicated biases added after it,
    * ``ff.linear_in`` column-parallel (its bias split with it),
    * layernorms replicated.

    No dropout (no per-microbatch seed threading), as in JAX: for eval or
    p_dropout = 0 training."""
    attn = template.attention
    hd = attn.attn_hidden_dim

    def layer_fn(p, h):
        group = axis_group(_MESHES[-1], model_axis)

        def linear(name, x, col):
            if col:
                x = copy_to_group(x, group)
            y = x @ p[name + ".weights"]
            if not col:
                y = reduce_from_group(y, group)
            bias = p.get(name + ".bias")
            return y if bias is None else y + bias

        def proj(name, src):
            y = linear("attention." + name, src, True)
            b_, s_, ld = y.shape
            return y.reshape(b_, s_, ld // hd, hd).transpose(1, 2)

        norm = lambda name, x: torch.func.functional_call(
            getattr(template, name), _sub(p, name + "."), (x,))
        a = norm("ln_1", h)
        q, k, v = (proj(n, a) for n in
                   ("q_projection", "k_projection", "v_projection"))
        q, k = attn._rope(q, k, torch.arange(a.shape[1], device=a.device))
        o = flash_attention(q, k, v, causal, window=attn.window)
        b_, nh, s_, _ = o.shape
        o = o.transpose(1, 2).reshape(b_, s_, nh * hd)
        h = h + linear("attention.out_projection", o, False)
        u = linear("ff.linear_in", norm("ln_2", h), True)
        return h + linear("ff.linear_out", F.GELU(u), False)

    return layer_fn


def megatron_stage_specs(template: nn.Module, axis: str = STAGE_AXIS,
                         model_axis: str = "model") -> Dict[str, P]:
    """Specs of stacked real-layer parameters: ``P(stage, None (layers a
    stage), *tp_spec)`` a leaf, the TP part by the Megatron rules.  Give
    them to :func:`shard_stage_params` and :func:`pipeline_apply`."""
    return {n: P(axis, None, *tp_spec_for(n, model_axis))
            for n, _ in template.named_parameters()}


def scan_stage_fn(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor]
                  ) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Lift a one-layer fn into a stage fn over its stack of layers (stage
    parameters with a leading layers-a-stage axis)."""

    def stage(params, x):
        n = next(iter(params.values())).shape[0]
        for i in range(n):
            x = layer_fn({k: v[i] for k, v in params.items()}, x)
        return x

    return stage
