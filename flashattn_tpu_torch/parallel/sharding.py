"""Tensor-parallel parameter sharding rules and model/mesh wiring
(counterpart of flashattn_tpu/parallel/sharding.py).

The Megatron layout for the DecoderLM family over a (data, model) mesh:

* QKV projections column-parallel (heads split over ``model``),
* attention output projection row-parallel,
* FFN ``linear_in`` column-parallel / ``linear_out`` row-parallel,
* lm_head and the embeddings column-parallel over the vocabulary /
  embedding dim, mixture-of-experts weights split over the experts,
* layernorm parameters replicated.

JAX places each parameter on the mesh and GSPMD inserts the collectives.
Here :func:`shard_model` returns a copy of the model whose parameters are
this rank's blocks, each carrying its spec (``param.spec``, and
``module.param_specs``), and marks each sharded module with its role
(``module.tp``, a :class:`Shard`); the modules then write out the
reductions GSPMD would insert (:mod:`.comm`):

* a column-parallel Linear takes its input through ``copy_to_group``;
* a row-parallel Linear all-reduces its product, then adds its replicated
  bias (``reduce_from_group``);
* a split Embedding all-gathers its rows to the full width, the model
  all-gathers the vocabulary-split logits;
* an expert-split MoE layer runs its experts and sums their combine over
  the ranks.

:func:`apply_mesh` wires the mesh into every ``MultiHeadAttention`` (its
four ``mesh*`` attributes), which then runs the kernels on its local
heads and batch rows or, over a ``seq`` axis, through the ring.  It also
tells the batch-split layers where this rank's rows sit: the dropout
masks of the global positions, the MoE router statistics and the LM
loss's mean over the global batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

from torch import nn

from ..models.moe import MoEFeedForward
from ..models.transformer import MultiHeadAttention
from ..module import _replace, map_module_tree
from ..nn.basic import Dropout, Embedding, Linear, QuantizedLinear
from .mesh import (DATA_AXIS, MODEL_AXIS, P, _spec_dims, axis_group,
                   axis_names, axis_size, check_mesh, local_shard)

# (suffix pattern, spec maker) checked in order; first match wins.
# QuantizedLinear (weight-only int8/fp8) stores ``.values`` (in, out) and
# ``.scales`` (1, out): values shard exactly like ``.weights``; per-output-
# channel scales follow the out axis (replicated for row-parallel layers
# whose out axis is unsharded).
_TP_RULES = [
    ("q_projection.weights", lambda m: P(None, m)),
    ("k_projection.weights", lambda m: P(None, m)),
    ("v_projection.weights", lambda m: P(None, m)),
    ("q_projection.bias", lambda m: P(m)),
    ("k_projection.bias", lambda m: P(m)),
    ("v_projection.bias", lambda m: P(m)),
    ("out_projection.weights", lambda m: P(m, None)),
    ("out_projection.bias", lambda m: P()),
    ("linear_in.weights", lambda m: P(None, m)),
    ("linear_in.bias", lambda m: P(m)),
    ("linear_out.weights", lambda m: P(m, None)),
    ("linear_out.bias", lambda m: P()),
    ("lm_head.weights", lambda m: P(None, m)),
    ("lm_head.bias", lambda m: P(m)),
    ("token_embeddings.weights", lambda m: P(None, m)),
    ("position_embeddings.weights", lambda m: P(None, m)),
    ("q_projection.values", lambda m: P(None, m)),
    ("k_projection.values", lambda m: P(None, m)),
    ("v_projection.values", lambda m: P(None, m)),
    ("q_projection.scales", lambda m: P(None, m)),
    ("k_projection.scales", lambda m: P(None, m)),
    ("v_projection.scales", lambda m: P(None, m)),
    ("out_projection.values", lambda m: P(m, None)),
    ("out_projection.scales", lambda m: P()),
    ("linear_in.values", lambda m: P(None, m)),
    ("linear_in.scales", lambda m: P(None, m)),
    ("linear_out.values", lambda m: P(m, None)),
    ("linear_out.scales", lambda m: P()),
    ("lm_head.values", lambda m: P(None, m)),
    ("lm_head.scales", lambda m: P(None, m)),
    # Expert parallelism: stacked expert weights shard over the expert
    # (leading) axis; the router replicates and the combine sums over
    # the ranks.
    ("ff.experts_in", lambda m: P(m, None, None)),
    ("ff.experts_out", lambda m: P(m, None, None)),
    ("ff.router.weights", lambda m: P()),
]


def tp_spec_for(path: str, model_axis: str = MODEL_AXIS) -> P:
    """PartitionSpec for a dotted parameter path under the TP rules."""
    for suffix, build in _TP_RULES:
        if path.endswith(suffix):
            return build(model_axis)
    return P()  # replicated (layernorm gamma/beta, etc.)


class Shard(NamedTuple):
    """A module's tensor-parallel role: "col" (output dim split), "row"
    (input dim split), "embed" (embedding dim split) or "expert" (experts
    split), over mesh axis ``axis`` of ``size`` ranks, whose process group
    is ``group``."""

    role: str
    axis: str
    group: Any
    size: int


def sharding_tree(model: nn.Module, mesh, model_axis: str = MODEL_AXIS,
                  rule: Optional[Callable[[str], P]] = None) -> Dict[str, P]:
    """``{parameter path: spec}`` under the TP rules (or ``rule``)."""
    rule = rule or (lambda path: tp_spec_for(path, model_axis))
    return {name: P(*rule(name)) for name, _ in model.named_parameters()}


def _role(module: nn.Module, specs: Dict[str, P], mesh) -> Optional[Shard]:
    """The TP role that ``specs`` (a module's own parameters') give
    ``module``; raises for a layout that the module cannot compute with."""
    def single(axes):
        if len(axes) > 1:
            raise ValueError(f"{type(module).__name__}: a dim split over "
                             f"several axes {axes} is not a layout the port "
                             f"computes with")
        return axes[0] if axes else None

    split = {n: [single(a) for a in _spec_dims(s, getattr(module, n).ndim)]
             for n, s in specs.items()}
    sharded = {n: dims for n, dims in split.items() if any(dims)}
    if not sharded:
        return None

    def shard(role, axis):
        return Shard(role, axis, axis_group(mesh, axis), axis_size(mesh, axis))

    if isinstance(module, (Linear, QuantizedLinear)):
        w = split.get("weights", split.get("values"))
        bias = split.get("bias")
        if w[0] is None and w[1] is not None:
            if bias is not None and bias[0] not in (None, w[1]):
                raise ValueError(f"column-parallel bias spec {bias}")
            return shard("col", w[1])
        if w[1] is None and w[0] is not None \
                and (bias is None or bias[0] is None) \
                and "scales" not in sharded:
            return shard("row", w[0])
    elif isinstance(module, Embedding):
        w = split["weights"]
        if w[0] is None and w[1] is not None:
            return shard("embed", w[1])
    elif isinstance(module, MoEFeedForward):
        a, b = split["experts_in"], split["experts_out"]
        if a[0] is not None and a == b and not any(a[1:]):
            return shard("expert", a[0])
    raise ValueError(f"{type(module).__name__}: parameter specs {specs} are "
                     f"not a layout the port computes with")


def _check_tp_attention(m: MultiHeadAttention) -> None:
    roles = [getattr(lin, "tp", None) for lin in
             (m.q_projection, m.k_projection, m.v_projection,
              m.out_projection)]
    if not any(roles):
        return
    want = ("col", "col", "col", "row")
    if any(r is None or r.role != w or r.axis != roles[0].axis
           for r, w in zip(roles, want)):
        raise ValueError("MultiHeadAttention: the q/k/v projections must be "
                         "column-parallel and out_projection row-parallel "
                         "over one axis")
    tp = roles[0].size
    if m.n_head % tp or m.n_kv_head % tp:
        raise ValueError(
            f"MultiHeadAttention(n_head={m.n_head}, n_kv_head={m.n_kv_head}) "
            f"cannot be sharded over mesh axis {roles[0].axis!r} of size "
            f"{tp}: both head counts must be divisible by the axis size")


def shard_model(model: nn.Module, mesh, model_axis: str = MODEL_AXIS,
                rule: Optional[Callable[[str], P]] = None) -> nn.Module:
    """A copy of ``model`` whose parameters are this rank's blocks under
    the TP rules (or ``rule``), each with its ``spec``; the input is left
    untouched.  The copy's modules compute the sharded function (see the
    module docstring)."""
    check_mesh(mesh)
    rule = rule or (lambda path: tp_spec_for(path, model_axis))

    def visit(module: nn.Module, prefix: str) -> nn.Module:
        new = _replace(module, **{
            name: visit(child, f"{prefix}{name}.")
            for name, child in module._modules.items() if child is not None})
        specs = {}
        for name, p in module._parameters.items():
            if p is None:
                continue
            spec = P(*rule(prefix + name))
            local = local_shard(p.detach(), mesh, spec).clone()
            q = nn.Parameter(local, requires_grad=p.requires_grad)
            q.spec, q.mesh = spec, mesh
            new._parameters[name] = q
            specs[name] = spec
        if specs:
            new.param_specs = specs
            role = _role(new, specs, mesh)
            if role is not None:
                new.tp = role
        if isinstance(new, MultiHeadAttention):
            _check_tp_attention(new)
        return new

    return visit(model, "")


def fsdp_spec_for(path: str, shape, mesh, data_axis: str = DATA_AXIS,
                  model_axis: str = MODEL_AXIS, min_size: int = 2**14) -> P:
    """Compose the TP spec with ZeRO/FSDP sharding over the data axis: the
    parameter (and so each optimizer moment) is additionally split over
    the *data* axis on its largest divisible dim that TP leaves whole.
    Parameters smaller than ``min_size`` elements keep their TP spec."""
    spec = tp_spec_for(path, model_axis)
    ndim = len(shape)
    dims = list(spec) + [None] * (ndim - len(spec))
    n = axis_size(mesh, data_axis)
    size = 1
    for d in shape:
        size *= int(d)

    def as_spec(dims):
        while dims and dims[-1] is None:  # P(None) != P() under ==
            dims.pop()
        return P(*dims)

    if n == 1 or size < min_size:
        return as_spec(dims)
    best = None
    for i in range(ndim):
        if dims[i] is not None:
            continue  # already TP-sharded
        if shape[i] % n:
            continue  # not divisible over the data axis
        if best is None or shape[i] > shape[best]:
            best = i
    if best is not None:
        dims[best] = data_axis
    return as_spec(dims)


def fsdp_sharding_tree(model: nn.Module, mesh, data_axis: str = DATA_AXIS,
                       model_axis: str = MODEL_AXIS,
                       min_size: int = 2**14) -> Dict[str, P]:
    """``{parameter path: spec}`` under the TP + FSDP rules, for the
    model's global (unsharded) parameter shapes."""
    return {name: fsdp_spec_for(name, tuple(p.shape), mesh, data_axis,
                                model_axis, min_size)
            for name, p in model.named_parameters()}


def apply_mesh(model: nn.Module, mesh, batch_axis: Optional[str] = DATA_AXIS,
               head_axis: Optional[str] = MODEL_AXIS,
               seq_axis: Optional[str] = None) -> nn.Module:
    """Wire the mesh into every MultiHeadAttention (a copy of the tree;
    the input is untouched): its kernels then run on this rank's heads and
    batch rows, or through the ring when ``seq_axis`` is one of the mesh's
    axes.  Validates the head counts up front: ``n_head`` and
    ``n_kv_head`` must both divide by the ``head_axis`` size.  The batch
    split (``batch_axis``) also reaches the dropout sites, the MoE layers
    and the model itself (see the module docstring)."""
    check_mesh(mesh)
    names = axis_names(mesh) if mesh is not None else ()
    batch_group = (axis_group(mesh, batch_axis)
                   if batch_axis in names else None)

    def wire(m: Any) -> Any:
        if isinstance(m, MultiHeadAttention):
            if head_axis in names:
                tp = axis_size(mesh, head_axis)
                if m.n_head % tp or m.n_kv_head % tp:
                    raise ValueError(
                        f"MultiHeadAttention(n_head={m.n_head}, "
                        f"n_kv_head={m.n_kv_head}) cannot be sharded over "
                        f"mesh axis {head_axis!r} of size {tp}: both head "
                        f"counts must be divisible by the axis size")
            m.mesh = mesh
            m.mesh_batch_axis = batch_axis
            m.mesh_head_axis = head_axis
            m.mesh_seq_axis = seq_axis
        elif isinstance(m, Dropout) or isinstance(m, MoEFeedForward) \
                or hasattr(m, "lm_head"):
            m.batch_group = batch_group
        return m

    return map_module_tree(model, wire)
