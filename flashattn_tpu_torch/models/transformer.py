"""Decoder-only transformer LM with KV-cached and paged-KV decoding
(counterpart of flashattn_tpu/models/transformer.py).

Module and parameter names match the JAX model (``layers.{i}.attention.
q_projection.weights`` ...), so ``convert.load_jax_params`` copies a JAX
model into this one by name.  The dense cache is ``{"k", "v"}`` of ``(B,
n_kv_head, max_len, head_dim)`` a layer; the paged methods keep the JAX pool
layout ``(n_kv_head, total_pages, page_size, head_dim)``.  Both are updated
IN PLACE (PyTorch tensors are mutable; this saves a cache-sized copy per
step) while still being returned, so callers read like the JAX code.
``pos_encoding="rope"`` rotates q and the new keys on every path before any
cache write; ``n_experts`` swaps each FeedForward for a
:class:`~.moe.MoEFeedForward`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint

from ..nn import functional as F
from ..nn.basic import Dropout, Embedding, FusedLayerNorm, LayerNorm1d, Linear
from ..ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_attention_varlen,
    repeat_kv,
)
from ..ops._build import PAYLOAD_DTYPES
from ..ops.paged_attention import paged_attention
from ..ops.quant import FP8_MAX, absmax_scale
from ..ops.rope import apply_rope
from ..ops.softmax import attn_softmax
from .moe import MoEFeedForward


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of the weight matmuls (2-D products with no batch dim, the ops
    ``x @ W`` lowers to) and recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(name: Optional[str]):
    """Map a policy name onto a ``torch.utils.checkpoint`` context factory
    (None = plain checkpointing).  ``"nothing"`` saves only each layer's
    input and recomputes the layer in the backward; ``"dots"`` also saves
    the weight matmuls' outputs, as JAX's
    ``dots_with_no_batch_dims_saveable`` does."""
    if name in (None, "nothing", "none"):
        return None
    if name == "dots":
        return functools.partial(checkpoint.create_selective_checkpoint_contexts,
                                 _dots_saveable)
    raise ValueError(f"unknown remat policy {name!r} (want nothing|dots)")


_remat_policy = remat_policy   # DecoderLM's argument of the same name shadows it


class _Method(nn.Module):
    """``getattr(module, name)`` as a forward, so that
    ``torch.func.functional_call`` can run any method of ``module``."""

    def __init__(self, module: nn.Module, name: str):
        super().__init__()
        self.module = module
        self.name = name

    def forward(self, *args):
        return getattr(self.module, self.name)(*args)


def remat_step(method: str, context):
    """``step(layer, x, seed, *args) = getattr(layer, method)(x, *args,
    seed)``, checkpointed (``torch.utils.checkpoint``, non-reentrant) under
    ``context`` (a :func:`remat_policy`).  The layer's parameters as the
    forward finds them are inputs of the checkpoint, so the backward's
    recomputation runs on the same tensors: under
    :func:`..training.trainer.make_mixed_precision_loss` those are the bf16
    casts that ``functional_call`` swapped in, which the module no longer
    holds by the time the backward runs."""
    ctx = {} if context is None else dict(context_fn=context)

    def run(params, layer, x, seed, *args):
        return torch.func.functional_call(_Method(layer, method), params,
                                          (x, *args, seed))

    def step(layer, x, seed, *args):
        params = {"module." + n: p for n, p in layer.named_parameters()}
        return checkpoint.checkpoint(run, params, layer, x, seed, *args,
                                     use_reentrant=False, **ctx)

    return step


def _quantize_kv(t: torch.Tensor, dtype):
    """Per-token symmetric quantization of pool writes, in f32 throughout:
    payload in ``dtype`` (int8 absmax / 127, fp8 e4m3 absmax / 448) and f32
    scales (..., 1)."""
    tf = t.float()
    scale = absmax_scale(tf.abs().amax(-1, keepdim=True),
                         127.0 if dtype == torch.int8 else FP8_MAX)
    payload = tf / scale
    if dtype == torch.int8:
        payload = torch.round(payload).clamp(-127, 127)
    return payload.to(dtype), scale


def _scatter_kv(pool: dict, k: torch.Tensor, v: torch.Tensor,
                page_ids: torch.Tensor, offs: torch.Tensor) -> None:
    """Write k/v (B, n_kv_head, S, hd) at (page_ids, offs) (B, S) in place;
    a quantized pool (``"ks"``/``"vs"`` present) takes payloads and
    per-token scales."""
    flat_pages = page_ids.reshape(-1).long()
    flat_offs = offs.reshape(-1).long()
    kv_heads, hd = k.shape[1], k.shape[3]
    for name, t in (("k", k), ("v", v)):
        new = t.transpose(0, 1).reshape(kv_heads, -1, hd)   # (nh, B*S, hd)
        if name + "s" in pool:
            new, scale = _quantize_kv(new, pool[name].dtype)
            pool[name + "s"][:, flat_pages, flat_offs] = scale
        pool[name][:, flat_pages, flat_offs] = new.to(pool[name].dtype)


def dropout_seeds(generator: Optional[torch.Generator], n: int) -> list:
    """``n`` integer dropout seeds drawn from ``generator`` (None each
    without one).  A model draws all of a forward's seeds up front, which
    lets a checkpointed layer recompute the same masks."""
    if generator is None:
        return [None] * n
    return [s & (2**64 - 1) for s in torch.randint(
        -2**63, 2**63 - 1, (n,), generator=generator,
        device=generator.device).tolist()]


def head_logits(lm_head: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """``lm_head(h)``; a head split over the vocabulary
    (:func:`~..parallel.sharding.shard_model`) all-gathers its logits, so
    that every rank holds (and samples from) the whole distribution."""
    logits = lm_head(h)
    if lm_head.tp is None:
        return logits
    from ..parallel.comm import gather_from_group

    return gather_from_group(logits, lm_head.tp.group, -1)


class MultiHeadAttention(nn.Module):
    """Multi-head (optionally causal) self-attention with GQA and an optional
    sliding window, or cross-attention over another sequence (``kv``).
    ``attn_impl`` is "flash" (the flash kernel),
    "fused_softmax" (score matmul, the fused softmax kernel, matmul with V)
    or "reference" (the plain PyTorch version)."""

    def __init__(self, n_embd: int, n_head: int, causal: bool = False,
                 p_dropout: float = 0.1, bias: bool = True, *,
                 n_kv_head: Optional[int] = None, attn_impl: str = "flash",
                 pos_encoding: str = "none", rope_theta: float = 10000.0,
                 window: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if n_embd % n_head:
            raise ValueError(f"n_embd {n_embd} not divisible by n_head {n_head}")
        if window is not None and not causal:
            raise ValueError("window requires causal attention")
        if attn_impl not in ("flash", "fused_softmax", "reference"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if pos_encoding not in ("none", "rope"):
            raise ValueError(f"pos_encoding must be 'none' or 'rope', got "
                             f"{pos_encoding!r}")
        # "rope" rotates q and k by position after the projections, so the
        # caches and pools hold rotated keys; "none" leaves positions to the
        # model (learned absolute embeddings)
        self.pos_encoding = pos_encoding
        self.rope_theta = rope_theta
        self.window = window
        self.n_embd = n_embd
        self.n_head = n_head
        self.n_kv_head = n_kv_head or n_head
        if n_head % self.n_kv_head:
            raise ValueError("n_head must be a multiple of n_kv_head")
        self.causal = causal
        self.attn_hidden_dim = n_embd // n_head
        self.attn_impl = attn_impl
        # Multi-rank wiring, set by parallel.sharding.apply_mesh: with a
        # mesh the kernels run on this rank's heads and batch rows; with a
        # seq axis in it, through the ring over sequence blocks.
        self.mesh = None
        self.mesh_batch_axis = None
        self.mesh_head_axis = None
        self.mesh_seq_axis = None
        kv_dim = self.n_kv_head * self.attn_hidden_dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.q_projection = Linear(n_embd, n_embd, bias, **kw)
        self.k_projection = Linear(n_embd, kv_dim, bias, **kw)
        self.v_projection = Linear(n_embd, kv_dim, bias, **kw)
        self.out_projection = Linear(n_embd, n_embd, bias, **kw)
        self.dropout = Dropout(p_dropout)

    @property
    def local_heads(self):
        """(query heads, kv heads) this rank holds: all of them, or their
        block when the projections are split over a mesh axis
        (:func:`~..parallel.sharding.shard_model`)."""
        tp = self.q_projection.tp
        n = 1 if tp is None else tp.size
        return self.n_head // n, self.n_kv_head // n

    def project_to_query_key_value(self, x: torch.Tensor,
                                   kv_src: Optional[torch.Tensor] = None):
        """(B,S,E) -> q (B,nh,S,hd), k/v (B,n_kv_head,Skv,hd) (this rank's
        heads when the projections are split).  ``kv_src`` (B,Skv,E) routes
        K and V through another sequence (cross-attention over an encoder's
        memory); by default they come from ``x``."""
        kv_src = x if kv_src is None else kv_src
        heads, kv_heads = self.local_heads

        def proj(lin: Linear, src: torch.Tensor, heads: int) -> torch.Tensor:
            bs, seq, _ = src.shape
            return lin(src).reshape(bs, seq, heads,
                                    self.attn_hidden_dim).transpose(1, 2)

        return (proj(self.q_projection, x, heads),
                proj(self.k_projection, kv_src, kv_heads),
                proj(self.v_projection, kv_src, kv_heads))

    def _rope(self, q, k, positions):
        """Rotate q and the NEW keys at ``positions`` (cached keys are
        rotated already); the identity unless pos_encoding is "rope"."""
        if self.pos_encoding != "rope":
            return q, k
        return (apply_rope(q, positions, self.rope_theta),
                apply_rope(k, positions, self.rope_theta))

    def _on_seq_axis(self) -> bool:
        from ..parallel.mesh import axis_names

        return (self.mesh is not None and self.mesh_seq_axis is not None
                and self.mesh_seq_axis in axis_names(self.mesh))

    def _ring_attention(self, q, k, v):
        """The ring over the mesh's seq axis: q/k/v (whole sequences, as
        every rank of the ring computes them) go in by this rank's block
        of the sequence and the output comes back whole; the gradient of
        each block reaches every rank (``scatter_to_group`` /
        ``gather_from_group``)."""
        from ..parallel.comm import gather_from_group, scatter_to_group
        from ..parallel.mesh import axis_group, axis_names
        from ..parallel.sharded_attention import ring_flash_attention

        names = axis_names(self.mesh)
        group = axis_group(self.mesh, self.mesh_seq_axis)
        q, k, v = (scatter_to_group(t, group, 2) for t in (q, k, v))
        out = ring_flash_attention(
            q, k, v, self.causal, mesh=self.mesh, seq_axis=self.mesh_seq_axis,
            batch_axis=(self.mesh_batch_axis
                        if self.mesh_batch_axis in names else None),
            head_axis=(self.mesh_head_axis
                       if self.mesh_head_axis in names else None))
        return gather_from_group(out, group, 2)

    def self_attention(self, q, k, v, kv_lengths=None) -> torch.Tensor:
        """softmax(q k^T / sqrt(hd)) v -> (B, Sq, E) (this rank's heads'
        columns under a head split).  The flash path runs the ring when the
        mesh has the seq axis (no varlen, no window); otherwise every path
        runs the kernels on this rank's block as it stands (its batch rows
        and heads: no communication)."""
        bs, _, seq, _ = q.shape
        if self.attn_impl == "flash" and self._on_seq_axis():
            # real raises: a stripped guard would compute full attention
            if kv_lengths is not None:
                raise ValueError(
                    "ring attention path does not support varlen masks")
            if self.window is not None:
                raise ValueError(
                    "ring attention path does not support sliding windows")
            out = self._ring_attention(q, k, v)
        elif self.attn_impl == "flash":
            if kv_lengths is not None:
                out = flash_attention_varlen(q, k, v, kv_lengths, self.causal,
                                             window=self.window)
            else:
                out = flash_attention(q, k, v, self.causal, window=self.window)
        elif self.attn_impl == "fused_softmax":
            out = self._fused_softmax_attention(q, k, v, kv_lengths)
        else:
            out = flash_attention_reference(q, k, v, self.causal,
                                            kv_lengths=kv_lengths,
                                            window=self.window)
        return out.transpose(1, 2).reshape(bs, seq, -1)

    def _fused_softmax_attention(self, q, k, v, kv_lengths):
        """The JAX ``fused_softmax`` branch: scores in q's dtype (product,
        then division by sqrt(hd)), additive -1e9 masks for ``kv_lengths``
        and the window (summed when both are set), the fused softmax kernel,
        then the product with V.  No dropout on the weights, as in JAX.  The
        divisor is a 0-dim tensor on the scores' device: PyTorch's CUDA
        division by a Python scalar multiplies by its reciprocal instead.
        The masks are built in f32 and summed, then taken to the scores'
        dtype, as JAX's weakly typed masks (built from Python floats) meet
        bf16 scores: the weights and the output stay in the scores'
        dtype."""
        seq = q.shape[2]
        k, v = repeat_kv(k, v, q.shape[1])
        s = torch.matmul(q, k.transpose(-1, -2))
        s = s / torch.full((), math.sqrt(self.attn_hidden_dim), dtype=s.dtype,
                           device=s.device)
        n_kv = k.shape[2]
        cols = torch.arange(n_kv, device=q.device)
        mask = None
        if kv_lengths is not None:
            valid = cols[None, :] < kv_lengths.to(q.device)[:, None]
            mask = torch.where(valid, 0.0, -1e9)[:, None, None, :]
        if self.window is not None:
            # absolute row positions equal col positions here (self-attn)
            rows = torch.arange(seq, device=q.device)
            local = cols[None, :] > rows[:, None] - self.window
            wmask = torch.where(local, 0.0, -1e9)[None, None, :, :]
            mask = wmask if mask is None else mask + wmask
        if mask is not None:
            mask = mask.to(s.dtype)
        return torch.matmul(attn_softmax(s, mask, self.causal), v)

    def forward(self, x: torch.Tensor, kv_lengths=None, *,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Self-attention over ``x`` (B, S, E); cross-attention over ``kv``
        (B, Skv, E), an encoder's memory, when it is given.  ``kv_lengths``
        (B,) masks the keys past each row's valid prefix.  RoPE rotates
        self-attention only, as in JAX (the query and the memory do not
        share a position scale)."""
        q, k, v = self.project_to_query_key_value(x, kv)
        if kv is None:
            q, k = self._rope(q, k, torch.arange(x.shape[1], device=x.device))
        return self.out_projection(self.self_attention(q, k, v, kv_lengths))

    # -- KV-cached decode path -------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> dict:
        """Static-shape cache {"k", "v"} of (batch, n_kv_head, max_len, hd),
        on the module's device unless ``device`` names another.  f32 by
        default, as in JAX: a bf16 model's cached decode then computes its
        scores in f32."""
        if device is None:
            device = self.q_projection.weights.device
        shape = (batch, self.local_heads[1], max_len, self.attn_hidden_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def forward_decode(self, x: torch.Tensor, cache: dict, index):
        """One decode step: x (B, 1, E) at position ``index`` (a Python int
        or a 0-dim tensor).  Writes the new (rotated) key and value at
        ``index`` in place, attends over positions <= index (and > index -
        window) with plain torch ops, and returns (out (B, 1, E), cache).

        The scores, softmax and product with V run in the promoted dtype of
        q and the cache, as JAX's einsums promote; out-of-range positions
        take finfo(dtype).min / 2."""
        bs = x.shape[0]
        q, k, v = self.project_to_query_key_value(x)       # (B, nh, 1, hd)
        q, k = self._rope(q, k, index)
        ck, cv = cache["k"], cache["v"]
        if isinstance(index, torch.Tensor):
            at = index.to(device=ck.device, dtype=torch.long).reshape(1)
            ck.index_copy_(2, at, k.to(ck.dtype))
            cv.index_copy_(2, at, v.to(cv.dtype))
        else:
            ck[:, :, index:index + 1] = k
            cv[:, :, index:index + 1] = v
        dt = torch.promote_types(q.dtype, ck.dtype)
        rk, rv = repeat_kv(ck, cv, q.shape[1])
        s = torch.matmul(q.to(dt), rk.to(dt).transpose(-1, -2))
        s = s / torch.full((), math.sqrt(self.attn_hidden_dim), dtype=dt,
                           device=s.device)
        pos = torch.arange(ck.shape[2], device=s.device)
        valid = pos <= index
        if self.window is not None:
            valid = valid & (pos > index - self.window)
        s = torch.where(valid, s, torch.finfo(dt).min / 2)
        out = torch.matmul(torch.softmax(s, dim=-1), rv.to(dt))
        out = out.transpose(1, 2).reshape(bs, 1, -1)
        return self.out_projection(out), cache

    # -- paged serving path --------------------------------------------------

    def init_page_pool(self, total_pages: int, page_size: int,
                       dtype=torch.float32, device=None) -> dict:
        """Per-layer paged KV pool (n_kv_head, total_pages, page_size, hd).
        An int8 or float8_e4m3fn ``dtype`` builds a quantized pool: payloads
        plus per-token f32 scales ``"ks"``/``"vs"`` (..., 1), starting at 1.
        Under a head split the pool holds this rank's KV heads."""
        shape = (self.local_heads[1], total_pages, page_size, self.attn_hidden_dim)
        pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
        if dtype in PAYLOAD_DTYPES:
            for name in ("ks", "vs"):
                pool[name] = torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                                        device=device)
        return pool

    def forward_prefill_paged(self, x, pool: dict, page_table, prompt_lens):
        """Batched prefill: x (B, S, E) padded prompts, prompt_lens (B,) valid
        tokens (0 = idle row, routed to a trash page by the caller's table).
        Writes all S positions' K/V into the pages; attention is causal and
        varlen-masked, on the full-precision q/k/v whatever the pool's dtype
        (the cache holds nothing older).  Returns (out (B, S, E), pool)."""
        bs, seq, _ = x.shape
        page_size = pool["k"].shape[2]
        q, k, v = self.project_to_query_key_value(x)
        pos = torch.arange(seq, device=x.device)
        q, k = self._rope(q, k, pos)
        page_ids = page_table[:, pos // page_size]               # (B, S)
        offs = (pos % page_size).expand(bs, seq)
        _scatter_kv(pool, k, v, page_ids, offs)
        out = flash_attention_varlen(q, k, v, prompt_lens, True,
                                     1.0 / math.sqrt(self.attn_hidden_dim),
                                     window=self.window)
        out = out.transpose(1, 2).reshape(bs, seq, -1)
        return self.out_projection(out), pool

    def forward_extend_paged(self, x, pool: dict, page_table, lengths):
        """Multi-token decode: x (B, k, E) extends each sequence by k tokens at
        positions ``lengths + j`` (causal within the chunk).  ``lengths`` is
        the BASE (tokens already cached).  Returns (out (B, k, E), pool)."""
        bs, kk, _ = x.shape
        page_size = pool["k"].shape[2]
        q, k, v = self.project_to_query_key_value(x)
        positions = lengths.long()[:, None] + torch.arange(
            kk, device=x.device)[None]                            # (B, k)
        q, k = self._rope(q, k, positions)     # unclamped, as in JAX
        # clamp WRITE positions to the table's capacity: a chunked-prefill
        # wave's padding can run past a short row's last real page; clamped
        # writes land on position cap-1, overwritten before any read
        cap = page_table.shape[1] * page_size
        write_pos = positions.clamp(max=cap - 1)
        page_ids = torch.gather(page_table.long(), 1, write_pos // page_size)
        _scatter_kv(pool, k, v, page_ids, write_pos % page_size)
        qc = q.transpose(1, 2)                                    # (B, k, nh, hd)
        out = paged_attention(qc, pool["k"], pool["v"], lengths + kk,
                              page_table, k_scales=pool.get("ks"),
                              v_scales=pool.get("vs"),
                              sm_scale=1.0 / math.sqrt(self.attn_hidden_dim),
                              window=self.window)
        return self.out_projection(out.reshape(bs, kk, -1)), pool

    def forward_decode_paged(self, x, pool: dict, page_table, lengths):
        """One decode step: the k=1 case of :meth:`forward_extend_paged`."""
        return self.forward_extend_paged(x, pool, page_table, lengths)


class FeedForward(nn.Module):
    """GELU MLP n_embd -> middle_dim -> n_embd."""

    def __init__(self, n_embd: int, middle_dim: int = 256,
                 p_dropout: float = 0.1, bias: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.linear_in = Linear(n_embd, middle_dim, bias, **kw)
        self.linear_out = Linear(middle_dim, n_embd, bias, **kw)
        self.dropout = Dropout(p_dropout)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        x = F.GELU(self.linear_in(x))
        return self.dropout(self.linear_out(x), seed)


class TransformerLayer(nn.Module):
    """Pre-LN layer: ln_1 -> causal MHA -> residual -> ln_2 -> FFN (dense, or
    mixture-of-experts with ``n_experts``) -> residual."""

    def __init__(self, n_embd: int, n_head: int, p_dropout: float = 0.1,
                 ln_eps: float = 1e-5, bias: bool = True, *,
                 middle_dim: int = 256, n_kv_head: Optional[int] = None,
                 attn_impl: str = "flash", pos_encoding: str = "none",
                 rope_theta: float = 10000.0, window: Optional[int] = None,
                 n_experts: Optional[int] = None, moe_top_k: int = 2,
                 use_fused_layernorm: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.attention = MultiHeadAttention(
            n_embd, n_head, causal=True, p_dropout=p_dropout, bias=bias,
            n_kv_head=n_kv_head, attn_impl=attn_impl,
            pos_encoding=pos_encoding, rope_theta=rope_theta, window=window,
            **kw)
        if n_experts:
            self.ff = MoEFeedForward(n_embd, middle_dim, n_experts,
                                     top_k=moe_top_k, p_dropout=p_dropout,
                                     **kw)
        else:
            self.ff = FeedForward(n_embd, middle_dim, p_dropout, bias, **kw)
        norm = FusedLayerNorm if use_fused_layernorm else LayerNorm1d
        self.ln_1 = norm(n_embd, ln_eps, dtype=dtype, device=device)
        self.ln_2 = norm(n_embd, ln_eps, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        return self.forward_with_aux(x, seed)[0]

    def forward_with_aux(self, x: torch.Tensor, seed: Optional[int] = None):
        """(x, aux): an MoE layer's load-balancing loss, 0 for a dense layer.
        ``seed`` keys the layer's one dropout site, the FFN output (the
        attention applies none, as in the JAX layer)."""
        x = x + self.attention(self.ln_1(x))
        if isinstance(self.ff, MoEFeedForward):
            y, aux = self.ff.forward_with_aux(self.ln_2(x), seed)
        else:
            y = self.ff(self.ln_2(x), seed)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + y, aux

    def forward_decode(self, x, cache: dict, index):
        attn, cache = self.attention.forward_decode(self.ln_1(x), cache, index)
        x = x + attn
        return x + self.ff(self.ln_2(x)), cache

    def _paged(self, method: str, x, pool, page_table, lengths):
        attn, pool = getattr(self.attention, method)(
            self.ln_1(x), pool, page_table, lengths)
        x = x + attn
        return x + self.ff(self.ln_2(x)), pool

    def forward_prefill_paged(self, x, pool, page_table, prompt_lens):
        return self._paged("forward_prefill_paged", x, pool, page_table,
                           prompt_lens)

    def forward_extend_paged(self, x, pool, page_table, lengths):
        return self._paged("forward_extend_paged", x, pool, page_table, lengths)

    def forward_decode_paged(self, x, pool, page_table, lengths):
        return self._paged("forward_decode_paged", x, pool, page_table, lengths)


class DecoderLM(nn.Module):
    """Decoder-only pre-LN transformer LM: token embeddings (+ learned
    position embeddings unless ``pos_encoding="rope"``) -> dropout ->
    n_layer TransformerLayers -> final LN -> lm_head.

    Weights are drawn from ``generator`` (a ``torch.Generator``; one seeded
    with 0 when omitted) and placed on ``device``, the CUDA device unless the
    caller names another (``device="cpu"`` runs the plain versions of the
    kernels).  ``remat=True`` checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant) under ``remat_policy``
    ("nothing" or "dots", see :func:`remat_policy`)."""

    def __init__(self, n_vocab: int, n_embd: int, n_head: int,
                 n_positions: int, p_dropout: float = 0.1,
                 ln_eps: float = 1e-5, bias: bool = True, *,
                 n_layer: int = 4, middle_dim: int = 256,
                 n_kv_head: Optional[int] = None, attn_impl: str = "flash",
                 pos_encoding: str = "learned", rope_theta: float = 10000.0,
                 window: Optional[int] = None,
                 n_experts: Optional[int] = None, moe_top_k: int = 2,
                 use_fused_layernorm: bool = True,
                 remat: bool = False, remat_policy: str = "nothing",
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"pos_encoding must be 'learned' or 'rope', got "
                             f"{pos_encoding!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        device = torch.device("cuda" if device is None else device)
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.remat = remat
        self.remat_policy = remat_policy
        self._remat_context = _remat_policy(remat_policy)
        self.n_embd = n_embd
        self.n_vocab = n_vocab
        self.n_positions = n_positions
        self.pos_encoding = pos_encoding
        self.token_embeddings = Embedding(n_vocab, n_embd, **kw)
        if pos_encoding == "learned":
            self.position_embeddings = Embedding(n_positions, n_embd, **kw)
        self.layers = nn.ModuleList([
            TransformerLayer(n_embd, n_head, p_dropout, ln_eps, bias,
                             middle_dim=middle_dim, n_kv_head=n_kv_head,
                             attn_impl=attn_impl,
                             pos_encoding=("rope" if pos_encoding == "rope"
                                           else "none"),
                             rope_theta=rope_theta, window=window,
                             n_experts=n_experts, moe_top_k=moe_top_k,
                             use_fused_layernorm=use_fused_layernorm, **kw)
            for _ in range(n_layer)])
        self.dropout = Dropout(p_dropout)
        norm = FusedLayerNorm if use_fused_layernorm else LayerNorm1d
        self.ln = norm(n_embd, ln_eps, dtype=dtype, device=device)
        self.lm_head = Linear(n_embd, n_vocab, bias, **kw)
        # the data split of the batch (parallel.sharding.apply_mesh): the
        # LM losses then average over the global batch
        self.batch_group = None

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return head_logits(self.lm_head, self.ln(h))

    def _embed(self, idx: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Token plus learned position embeddings.  A position past the
        table embeds as NaN (``Embedding``'s ``jnp.take`` function), the
        padding of a paged wave too, as in JAX: a cached decode step past
        ``n_positions`` gives NaN logits (argmax 0) in both packages."""
        x = self.token_embeddings(idx)
        if self.pos_encoding != "learned":
            return x       # rope: positions enter inside attention
        return x + self.position_embeddings(pos)

    def forward(self, idx: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S) int token ids -> (B, S, n_vocab) logits."""
        return self.forward_with_aux(idx, generator)[0]

    def forward_with_aux(self, idx: torch.Tensor,
                         generator: Optional[torch.Generator] = None):
        """(logits, aux): aux sums the MoE layers' load-balancing losses (0
        for a dense model); add ``alpha * aux`` to the training loss.

        With a ``generator``, one integer seed per dropout site (the
        embedding dropout, then each layer's FFN dropout) is drawn from it
        up front, in that order — the counterpart of the JAX model's key
        split.  Drawing them before the layers run is what lets a
        checkpointed layer recompute the same masks."""
        seeds = dropout_seeds(generator, len(self.layers) + 1)
        pos = torch.arange(idx.shape[1], device=idx.device)[None, :]
        x = self.dropout(self._embed(idx, pos), seeds[0])
        step = lambda layer, x, seed: layer.forward_with_aux(x, seed)
        if self.remat and torch.is_grad_enabled():
            step = remat_step("forward_with_aux", self._remat_context)
        aux = torch.zeros((), dtype=torch.float32, device=idx.device)
        for layer, seed in zip(self.layers, seeds[1:]):
            x, a = step(layer, x, seed)
            aux = aux + a
        return self._logits(x), aux

    # -- KV-cached decoding ----------------------------------------------------

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=torch.float32, device=None) -> list:
        """One dense cache a layer (see :meth:`MultiHeadAttention.
        init_cache`), ``max_len`` positions (n_positions by default)."""
        max_len = max_len or self.n_positions
        return [layer.attention.init_cache(batch, max_len, dtype, device)
                for layer in self.layers]

    def forward_decode(self, idx_tok: torch.Tensor, caches: list, index):
        """One decode step: idx_tok (B, 1) int ids at position ``index`` (a
        Python int or a 0-dim tensor).  Returns (logits (B, 1, n_vocab),
        caches), the caches updated in place."""
        if isinstance(index, torch.Tensor):
            pos = index.to(device=idx_tok.device).reshape(1, 1)
        else:
            pos = torch.full((1, 1), index, dtype=torch.long,
                             device=idx_tok.device)
        x = self._embed(idx_tok, pos)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer.forward_decode(x, cache, index)
            new_caches.append(cache)
        return self._logits(x), new_caches

    # -- paged decoding (serving: continuous batching over page pools) ------

    def init_page_pools(self, total_pages: int, page_size: int,
                        dtype=torch.float32, device=None) -> list:
        return [layer.attention.init_page_pool(total_pages, page_size, dtype,
                                               device)
                for layer in self.layers]

    def _paged(self, method: str, tokens, pos, pools, page_table, lengths):
        x = self._embed(tokens, pos)
        new_pools = []
        for layer, pool in zip(self.layers, pools):
            x, pool = getattr(layer, method)(x, pool, page_table, lengths)
            new_pools.append(pool)
        return self._logits(x), new_pools

    def forward_decode_paged(self, idx_tok, pools: list, page_table, lengths):
        """One decode step: idx_tok (B, 1) at positions ``lengths`` (tokens
        already cached).  Returns (logits (B, 1, n_vocab), pools)."""
        pos = lengths.long()[:, None]
        return self._paged("forward_decode_paged", idx_tok, pos, pools,
                           page_table, lengths)

    def forward_extend_paged(self, tokens, pools: list, page_table, lengths):
        """tokens (B, k) extend each sequence at positions ``lengths + j``.
        Returns (logits (B, k, n_vocab), pools); logits[:, j] predicts the
        token after position ``lengths + j``."""
        pos = lengths.long()[:, None] + torch.arange(
            tokens.shape[1], device=tokens.device)[None]
        return self._paged("forward_extend_paged", tokens, pos, pools,
                           page_table, lengths)

    def forward_prefill_paged(self, tokens, pools: list, page_table,
                              prompt_lens):
        """Batched prefill of padded prompts tokens (B, S).  Returns (logits
        (B, S, n_vocab), pools).  Rows with prompt_lens == 0 are idle."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        return self._paged("forward_prefill_paged", tokens, pos, pools,
                           page_table, prompt_lens)
