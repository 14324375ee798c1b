"""Encoder-decoder (seq2seq) transformer (counterpart of
flashattn_tpu/models/seq2seq.py).

* :class:`EncoderLayer`: pre-LN bidirectional self-attention and FFN; a
  padded source batch is masked by ``src_lens`` inside the attention
  (``flash_attention_varlen``), never by a materialised mask.
* :class:`CrossDecoderLayer`: causal self-attention, cross-attention over
  the encoder's memory (masked by ``memory_lens``), FFN, each pre-LN with a
  residual.
* :class:`EncoderDecoderLM`: embeddings -> encoder stack -> ``ln_enc`` ->
  decoder stack -> ``ln`` -> ``lm_head``, with a cached decode: the
  decoder's self-attention keeps :class:`MultiHeadAttention`'s dense cache,
  and the cross-attention K/V are projected once from the memory
  (:meth:`EncoderDecoderLM.precompute_cross`) and read every step.

Module and parameter names are the JAX model's (``encoder_layers.{i}``,
``decoder_layers.{i}.cross_attention``, ``ln_c``, ``ln_enc``, ``ln``,
``lm_head``), so ``convert.load_jax_params`` copies one into the other.
Every attention runs through :class:`MultiHeadAttention`, so ``attn_impl``
("flash", "fused_softmax", "reference") and GQA apply unchanged.  Dropout,
as in :class:`DecoderLM`, sits on the embeddings and each FFN output, with
one integer seed a site drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
from torch import nn

from ..nn.basic import Dropout, Embedding, FusedLayerNorm, LayerNorm1d, Linear
from .transformer import (FeedForward, MultiHeadAttention, dropout_seeds,
                          head_logits, remat_step)
from .transformer import remat_policy as _remat_policy

Tensor = torch.Tensor


def _make_ln(n_embd, eps, fused, dtype, device):
    norm = FusedLayerNorm if fused else LayerNorm1d
    return norm(n_embd, eps, dtype=dtype, device=device)


class EncoderLayer(nn.Module):
    """Pre-LN bidirectional transformer block of the encoder stack."""

    def __init__(self, n_embd: int, n_head: int, p_dropout: float = 0.1,
                 ln_eps: float = 1e-5, bias: bool = True, *,
                 middle_dim: int = 256, n_kv_head: Optional[int] = None,
                 attn_impl: str = "flash", use_fused_layernorm: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.attention = MultiHeadAttention(
            n_embd, n_head, causal=False, p_dropout=p_dropout, bias=bias,
            n_kv_head=n_kv_head, attn_impl=attn_impl, **kw)
        self.ff = FeedForward(n_embd, middle_dim, p_dropout, bias, **kw)
        self.ln_1 = _make_ln(n_embd, ln_eps, use_fused_layernorm, dtype,
                             device)
        self.ln_2 = _make_ln(n_embd, ln_eps, use_fused_layernorm, dtype,
                             device)

    def forward(self, x: Tensor, src_lens: Optional[Tensor] = None,
                seed: Optional[int] = None) -> Tensor:
        x = x + self.attention(self.ln_1(x), src_lens)
        return x + self.ff(self.ln_2(x), seed)


class CrossDecoderLayer(nn.Module):
    """Pre-LN decoder block: causal self-attention -> cross-attention ->
    FFN."""

    def __init__(self, n_embd: int, n_head: int, p_dropout: float = 0.1,
                 ln_eps: float = 1e-5, bias: bool = True, *,
                 middle_dim: int = 256, n_kv_head: Optional[int] = None,
                 attn_impl: str = "flash", use_fused_layernorm: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        mha = functools.partial(MultiHeadAttention, n_embd, n_head,
                                p_dropout=p_dropout, bias=bias,
                                n_kv_head=n_kv_head, attn_impl=attn_impl, **kw)
        self.attention = mha(causal=True)
        self.cross_attention = mha(causal=False)
        self.ff = FeedForward(n_embd, middle_dim, p_dropout, bias, **kw)
        self.ln_1 = _make_ln(n_embd, ln_eps, use_fused_layernorm, dtype,
                             device)
        self.ln_c = _make_ln(n_embd, ln_eps, use_fused_layernorm, dtype,
                             device)
        self.ln_2 = _make_ln(n_embd, ln_eps, use_fused_layernorm, dtype,
                             device)

    def forward(self, x: Tensor, memory: Tensor,
                memory_lens: Optional[Tensor] = None,
                seed: Optional[int] = None) -> Tensor:
        x = x + self.attention(self.ln_1(x))
        x = x + self.cross_attention(self.ln_c(x), memory_lens, kv=memory)
        return x + self.ff(self.ln_2(x), seed)

    # -- cached decode -------------------------------------------------------

    def precompute_cross(self, memory: Tensor) -> Tuple[Tensor, Tensor]:
        """The cross-attention's K and V (B, n_kv_head, S_src, hd), projected
        once a generation from the encoder's memory."""
        _, k, v = self.cross_attention.project_to_query_key_value(
            memory[:, :1], memory)
        return k, v

    def forward_decode(self, x: Tensor, cache: dict, index, cross_k: Tensor,
                       cross_v: Tensor, memory_lens: Optional[Tensor] = None):
        """One decode step: x (B, 1, E) at target position ``index``.
        Returns (out (B, 1, E), cache), the cache written in place.

        Over JAX's f32 cache a bf16 model's residual turns f32 after the
        self-attention, so its cross query is f32 against bf16 K/V: both
        are then taken to the promoted dtype (exact for K and V), where
        JAX's op graph would round the probabilities to V's bf16."""
        attn, cache = self.attention.forward_decode(self.ln_1(x), cache, index)
        x = x + attn
        ca = self.cross_attention
        bs = x.shape[0]
        q = ca.q_projection(self.ln_c(x)).reshape(
            bs, 1, ca.n_head, ca.attn_hidden_dim).transpose(1, 2)
        dt = torch.promote_types(q.dtype, cross_k.dtype)
        out = ca.self_attention(q.to(dt), cross_k.to(dt), cross_v.to(dt),
                                memory_lens)
        x = x + ca.out_projection(out)
        return x + self.ff(self.ln_2(x)), cache


class EncoderDecoderLM(nn.Module):
    """Encoder-decoder LM over one shared vocabulary.

    ``forward(src, tgt, src_lens)`` gives next-token logits over the
    target (teacher forcing); ``encode`` / ``init_cache`` /
    ``precompute_cross`` / ``forward_decode`` factor generation into one
    encoder pass, one cross K/V projection and cached decode steps.

    Weights are drawn from ``generator`` (one seeded with 0 when omitted)
    and placed on ``device``, the CUDA device unless the caller names
    another.  ``remat=True`` checkpoints each encoder and decoder block
    (``torch.utils.checkpoint``, non-reentrant) under ``remat_policy``
    ("nothing" or "dots", see :func:`.transformer.remat_policy`)."""

    def __init__(self, n_vocab: int, n_embd: int, n_head: int,
                 n_positions: int, p_dropout: float = 0.1,
                 ln_eps: float = 1e-5, bias: bool = True, *,
                 n_encoder_layer: int = 4, n_decoder_layer: int = 4,
                 middle_dim: int = 256, n_kv_head: Optional[int] = None,
                 attn_impl: str = "flash", use_fused_layernorm: bool = True,
                 remat: bool = False, remat_policy: str = "nothing",
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        device = torch.device("cuda" if device is None else device)
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.n_embd = n_embd
        self.n_vocab = n_vocab
        self.n_positions = n_positions
        self.remat = remat
        self.remat_policy = remat_policy
        self._remat_context = _remat_policy(remat_policy)
        self.token_embeddings = Embedding(n_vocab, n_embd, **kw)
        self.position_embeddings = Embedding(n_positions, n_embd, **kw)
        layer_kw = dict(middle_dim=middle_dim, n_kv_head=n_kv_head,
                        attn_impl=attn_impl,
                        use_fused_layernorm=use_fused_layernorm, **kw)
        self.encoder_layers = nn.ModuleList([
            EncoderLayer(n_embd, n_head, p_dropout, ln_eps, bias, **layer_kw)
            for _ in range(n_encoder_layer)])
        self.decoder_layers = nn.ModuleList([
            CrossDecoderLayer(n_embd, n_head, p_dropout, ln_eps, bias,
                              **layer_kw)
            for _ in range(n_decoder_layer)])
        self.dropout = Dropout(p_dropout)
        self.ln_enc = _make_ln(n_embd, ln_eps, use_fused_layernorm, dtype,
                               device)
        self.ln = _make_ln(n_embd, ln_eps, use_fused_layernorm, dtype, device)
        self.lm_head = Linear(n_embd, n_vocab, bias, **kw)

    def _embed(self, idx: Tensor, pos: Tensor, seed=None) -> Tensor:
        x = self.token_embeddings(idx) + self.position_embeddings(pos)
        return self.dropout(x, seed)

    def _stack(self, layers, x, seeds, *args) -> Tensor:
        """Run ``layers`` over ``x``, each ``layer(x, *args, seed)``,
        checkpointed with ``remat`` while gradients are on."""
        step = lambda layer, x, seed, *a: layer(x, *a, seed)
        if self.remat and torch.is_grad_enabled():
            step = remat_step("forward", self._remat_context)
        for layer, seed in zip(layers, seeds):
            x = step(layer, x, seed, *args)
        return x

    def encode(self, src: Tensor, src_lens: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Tensor:
        """(B, S_src) ids -> (B, S_src, E) memory.  Rows past a length are
        garbage that no consumer reads: every one masks by the lengths."""
        seeds = dropout_seeds(generator, len(self.encoder_layers) + 1)
        pos = torch.arange(src.shape[1], device=src.device)[None, :]
        x = self._embed(src, pos, seeds[0])
        x = self._stack(self.encoder_layers, x, seeds[1:], src_lens)
        return self.ln_enc(x)

    def decode(self, tgt: Tensor, memory: Tensor,
               src_lens: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Tensor:
        """(B, S_tgt) ids over the memory -> (B, S_tgt, n_vocab) logits."""
        seeds = dropout_seeds(generator, len(self.decoder_layers) + 1)
        pos = torch.arange(tgt.shape[1], device=tgt.device)[None, :]
        x = self._embed(tgt, pos, seeds[0])
        x = self._stack(self.decoder_layers, x, seeds[1:], memory, src_lens)
        return head_logits(self.lm_head, self.ln(x))

    def forward(self, src: Tensor, tgt: Tensor,
                src_lens: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """(B, S_src), (B, S_tgt) ids -> (B, S_tgt, n_vocab) logits."""
        memory = self.encode(src, src_lens, generator)
        return self.decode(tgt, memory, src_lens, generator)

    # -- cached generation ---------------------------------------------------

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=torch.float32, device=None) -> list:
        """One dense self-attention cache a decoder layer (f32 by default,
        as in JAX), ``max_len`` positions (n_positions by default)."""
        max_len = max_len or self.n_positions
        return [layer.attention.init_cache(batch, max_len, dtype, device)
                for layer in self.decoder_layers]

    def precompute_cross(self, memory: Tensor) -> List[Tuple[Tensor, Tensor]]:
        return [layer.precompute_cross(memory)
                for layer in self.decoder_layers]

    def forward_decode(self, tok: Tensor, caches: list, cross_kvs: list,
                       index, src_lens: Optional[Tensor] = None):
        """One decode step: tok (B, 1) ids at target position ``index`` (a
        Python int or a 0-dim tensor).  Returns (logits (B, 1, n_vocab),
        caches), the caches updated in place."""
        if isinstance(index, torch.Tensor):
            pos = index.to(device=tok.device).reshape(1, 1)
        else:
            pos = torch.full((1, 1), index, dtype=torch.long,
                             device=tok.device)
        x = self._embed(tok, pos)
        new_caches = []
        for layer, cache, (ck, cv) in zip(self.decoder_layers, caches,
                                          cross_kvs):
            x, cache = layer.forward_decode(x, cache, index, ck, cv, src_lens)
            new_caches.append(cache)
        return head_logits(self.lm_head, self.ln(x)), new_caches
