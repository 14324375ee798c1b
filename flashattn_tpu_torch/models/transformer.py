"""Decoder-only transformer LM with paged-KV serving methods (counterpart of
flashattn_tpu/models/transformer.py).

Module and parameter names match the JAX model (``layers.{i}.attention.
q_projection.weights`` ...), so ``convert.load_jax_params`` copies a JAX
model into this one by name.  The paged methods keep the JAX pool layout
``(n_kv_head, total_pages, page_size, head_dim)`` and update the pools IN
PLACE (PyTorch tensors are mutable; this saves a pool-sized copy per step)
while still returning them, so callers read like the JAX code.
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
from ..ops.softmax import attn_softmax


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


class MultiHeadAttention(nn.Module):
    """Multi-head (optionally causal) self-attention with GQA and an optional
    sliding window.  ``attn_impl`` is "flash" (the flash kernel),
    "fused_softmax" (score matmul, the fused softmax kernel, matmul with V)
    or "reference" (the plain PyTorch version)."""

    def __init__(self, n_embd: int, n_head: int, causal: bool = False,
                 p_dropout: float = 0.1, bias: bool = True, *,
                 n_kv_head: Optional[int] = None, attn_impl: str = "flash",
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
        self.window = window
        self.n_embd = n_embd
        self.n_head = n_head
        self.n_kv_head = n_kv_head or n_head
        if n_head % self.n_kv_head:
            raise ValueError("n_head must be a multiple of n_kv_head")
        self.causal = causal
        self.attn_hidden_dim = n_embd // n_head
        self.attn_impl = attn_impl
        kv_dim = self.n_kv_head * self.attn_hidden_dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.q_projection = Linear(n_embd, n_embd, bias, **kw)
        self.k_projection = Linear(n_embd, kv_dim, bias, **kw)
        self.v_projection = Linear(n_embd, kv_dim, bias, **kw)
        self.out_projection = Linear(n_embd, n_embd, bias, **kw)
        self.dropout = Dropout(p_dropout)

    def project_to_query_key_value(self, x: torch.Tensor):
        """(B,S,E) -> q (B,nh,S,hd), k/v (B,n_kv_head,S,hd)."""
        bs, seq, _ = x.shape

        def proj(lin: Linear, heads: int) -> torch.Tensor:
            return lin(x).reshape(bs, seq, heads,
                                  self.attn_hidden_dim).transpose(1, 2)

        return (proj(self.q_projection, self.n_head),
                proj(self.k_projection, self.n_kv_head),
                proj(self.v_projection, self.n_kv_head))

    def self_attention(self, q, k, v, kv_lengths=None) -> torch.Tensor:
        """softmax(q k^T / sqrt(hd)) v -> (B, Sq, E)."""
        bs, _, seq, _ = q.shape
        if self.attn_impl == "flash":
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
        return out.transpose(1, 2).reshape(bs, seq, self.n_embd)

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

    def forward(self, x: torch.Tensor, kv_lengths=None) -> torch.Tensor:
        q, k, v = self.project_to_query_key_value(x)
        return self.out_projection(self.self_attention(q, k, v, kv_lengths))

    # -- paged serving path --------------------------------------------------

    def init_page_pool(self, total_pages: int, page_size: int,
                       dtype=torch.float32, device=None) -> dict:
        """Per-layer paged KV pool (n_kv_head, total_pages, page_size, hd).
        An int8 or float8_e4m3fn ``dtype`` builds a quantized pool: payloads
        plus per-token f32 scales ``"ks"``/``"vs"`` (..., 1), starting at 1."""
        shape = (self.n_kv_head, total_pages, page_size, self.attn_hidden_dim)
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
        page_ids = page_table[:, pos // page_size]               # (B, S)
        offs = (pos % page_size).expand(bs, seq)
        _scatter_kv(pool, k, v, page_ids, offs)
        out = flash_attention_varlen(q, k, v, prompt_lens, True,
                                     1.0 / math.sqrt(self.attn_hidden_dim),
                                     window=self.window)
        out = out.transpose(1, 2).reshape(bs, seq, self.n_embd)
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
        return self.out_projection(out.reshape(bs, kk, self.n_embd)), pool

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
    """Pre-LN layer: ln_1 -> causal MHA -> residual -> ln_2 -> FFN -> residual."""

    def __init__(self, n_embd: int, n_head: int, p_dropout: float = 0.1,
                 ln_eps: float = 1e-5, bias: bool = True, *,
                 middle_dim: int = 256, n_kv_head: Optional[int] = None,
                 attn_impl: str = "flash", window: Optional[int] = None,
                 use_fused_layernorm: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.attention = MultiHeadAttention(
            n_embd, n_head, causal=True, p_dropout=p_dropout, bias=bias,
            n_kv_head=n_kv_head, attn_impl=attn_impl, window=window, **kw)
        self.ff = FeedForward(n_embd, middle_dim, p_dropout, bias, **kw)
        norm = FusedLayerNorm if use_fused_layernorm else LayerNorm1d
        self.ln_1 = norm(n_embd, ln_eps, dtype=dtype, device=device)
        self.ln_2 = norm(n_embd, ln_eps, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        """``seed`` keys the layer's one dropout site, the FFN output (the
        attention applies none, as in the JAX layer)."""
        x = x + self.attention(self.ln_1(x))
        return x + self.ff(self.ln_2(x), seed)

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
    """Decoder-only pre-LN transformer LM: token + learned position
    embeddings -> dropout -> n_layer TransformerLayers -> final LN -> lm_head.

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
                 pos_encoding: str = "learned", window: Optional[int] = None,
                 n_experts: Optional[int] = None,
                 use_fused_layernorm: bool = True,
                 remat: bool = False, remat_policy: str = "nothing",
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if pos_encoding != "learned":
            raise NotImplementedError(
                f"pos_encoding={pos_encoding!r} is not ported yet; only "
                "'learned' (ROADMAP A6)")
        if n_experts:
            raise NotImplementedError(
                "mixture-of-experts layers are not ported yet (ROADMAP A6)")
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
        self.position_embeddings = Embedding(n_positions, n_embd, **kw)
        self.layers = nn.ModuleList([
            TransformerLayer(n_embd, n_head, p_dropout, ln_eps, bias,
                             middle_dim=middle_dim, n_kv_head=n_kv_head,
                             attn_impl=attn_impl, window=window,
                             use_fused_layernorm=use_fused_layernorm, **kw)
            for _ in range(n_layer)])
        self.dropout = Dropout(p_dropout)
        norm = FusedLayerNorm if use_fused_layernorm else LayerNorm1d
        self.ln = norm(n_embd, ln_eps, dtype=dtype, device=device)
        self.lm_head = Linear(n_embd, n_vocab, bias, **kw)

    def _embed(self, idx: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        # padding positions of a chunked-prefill wave may run past the
        # table; clamp them (their outputs are never read) instead of
        # indexing out of range on the device
        pos = pos.clamp(max=self.n_positions - 1)
        return self.token_embeddings(idx) + self.position_embeddings(pos)

    def forward(self, idx: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S) int token ids -> (B, S, n_vocab) logits.

        With a ``generator``, one integer seed per dropout site (the
        embedding dropout, then each layer's FFN dropout) is drawn from it
        up front, in that order — the counterpart of the JAX model's key
        split.  Drawing them before the layers run is what lets a
        checkpointed layer recompute the same masks."""
        seeds = [None] * (len(self.layers) + 1)
        if generator is not None:
            seeds = [s & (2**64 - 1) for s in torch.randint(
                -2**63, 2**63 - 1, (len(seeds),), generator=generator,
                device=generator.device).tolist()]
        pos = torch.arange(idx.shape[1], device=idx.device)[None, :]
        x = self.dropout(self._embed(idx, pos), seeds[0])
        run = lambda layer, x, seed: layer(x, seed)
        if self.remat and torch.is_grad_enabled():
            ctx = {} if self._remat_context is None else dict(
                context_fn=self._remat_context)
            run = functools.partial(checkpoint.checkpoint, use_reentrant=False,
                                    **ctx)
        for layer, seed in zip(self.layers, seeds[1:]):
            x = run(layer, x, seed)
        return self.lm_head(self.ln(x))

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
        return self.lm_head(self.ln(x)), new_pools

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
