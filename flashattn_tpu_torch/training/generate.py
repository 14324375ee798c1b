"""KV-cached autoregressive generation (counterpart of
flashattn_tpu/training/generate.py).

Each function is one device loop of ``forward_decode`` steps over a
static-shape dense cache, under ``torch.inference_mode()``: the JAX package
runs the same steps as one jitted ``lax.scan``.  ``greedy_generate`` and
``beam_search_generate`` take ``total - 1`` steps of
``DecoderLM.forward_decode``; ``greedy_generate_seq2seq`` runs one
``EncoderDecoderLM.encode``, one ``precompute_cross`` and ``max_new_tokens``
cached steps.  The state (token buffer, caches, done flags, beam scores)
stays on the model's device and the loop reads nothing back to the host.
The model runs in eval mode and is left in the mode it had.
"""

from __future__ import annotations

import contextlib
from typing import Tuple, Union

import torch
from torch import nn

Tensor = torch.Tensor


@contextlib.contextmanager
def _eval_inference(model: nn.Module):
    """``model`` in eval mode under ``torch.inference_mode()``, its mode
    restored after (JAX's ``model.eval()`` returns a copy; torch's mutates
    the module)."""
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        model.train(was_training)


def _buffer(model: nn.Module, prompt, prompt_len, max_new_tokens: int,
            repeat: int = 1) -> Tuple[Tensor, Tensor, torch.device]:
    """(buf (B*repeat, max_prompt + max_new_tokens) token ids, plen
    (B*repeat,) prompt lengths, device): each row ``repeat`` times."""
    dev = next(model.parameters()).device
    prompt = torch.as_tensor(prompt, device=dev).long()
    b = prompt.shape[0]
    plen = torch.as_tensor(prompt_len, device=dev).long().expand(b)
    buf = torch.cat([prompt, prompt.new_zeros((b, max_new_tokens))], dim=1)
    return (buf.repeat_interleave(repeat, 0), plen.repeat_interleave(repeat),
            dev)


def greedy_generate(model: nn.Module, prompt, prompt_len: Union[int, Tensor],
                    max_new_tokens: int, eos_id=None) -> Tensor:
    """Greedy decode with per-row prompt lengths.

    prompt:     (B, max_prompt) int ids, padded arbitrarily past each row's
                ``prompt_len``.
    prompt_len: an int or (B,) actual prompt lengths.
    Returns (B, max_prompt + max_new_tokens) int64 ids: each row follows its
    prompt verbatim up to its length, then its greedy tokens; past
    ``eos_id`` a row is padded with eos."""
    buf, plen, dev = _buffer(model, prompt, prompt_len, max_new_tokens)
    b, total = buf.shape
    eos = None if eos_id is None else int(eos_id)
    with _eval_inference(model):
        caches = model.init_cache(b, total, device=dev)
        steps = torch.arange(total, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        for i in range(total - 1):
            logits, caches = model.forward_decode(buf[:, i:i + 1], caches,
                                                  steps[i])
            nxt = logits[:, -1].argmax(-1)
            in_gen = (i + 1) >= plen
            if eos is not None:
                nxt = torch.where(done, eos, nxt)
                done = done | (in_gen & (nxt == eos))
            at = min(i + 1, total - 1)
            buf[:, at] = torch.where(in_gen, nxt, buf[:, at])
    return buf


def greedy_generate_seq2seq(model: nn.Module, src, src_lens,
                            max_new_tokens: int, bos_id: int,
                            eos_id=None) -> Tensor:
    """Greedy decode from an :class:`EncoderDecoderLM`.

    src:      (B, S_src) int source ids, padded arbitrarily past each row's
              length.
    src_lens: an int or (B,) source lengths.
    The decoder starts from ``bos_id``.  Returns (B, max_new_tokens) int64
    ids; once a row emits ``eos_id`` the rest of it is eos."""
    dev = next(model.parameters()).device
    src = torch.as_tensor(src, device=dev).long()
    b = src.shape[0]
    lens = torch.as_tensor(src_lens, device=dev).long().expand(b)
    eos = None if eos_id is None else int(eos_id)
    with _eval_inference(model):
        memory = model.encode(src, lens)
        cross_kvs = model.precompute_cross(memory)
        caches = model.init_cache(b, max_new_tokens, device=dev)
        steps = torch.arange(max_new_tokens, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        tok = torch.full((b, 1), int(bos_id), dtype=torch.long, device=dev)
        out = torch.empty((b, max_new_tokens), dtype=torch.long, device=dev)
        for i in range(max_new_tokens):
            logits, caches = model.forward_decode(tok, caches, cross_kvs,
                                                  steps[i], lens)
            nxt = logits[:, -1].argmax(-1)
            if eos is not None:
                nxt = torch.where(done, eos, nxt)
                done = done | (nxt == eos)
            out[:, i] = nxt
            tok = nxt[:, None]
    return out


def _beam_search(model: nn.Module, buf: Tensor, plen: Tensor, beam: int,
                 eos_id: int, length_penalty: float) -> Tuple[Tensor, Tensor]:
    """The beam loop over ``buf`` (B*beam, total) with each prompt repeated
    per beam.  Returns (each row's best hypothesis (B, total), the final
    beam scores (B, beam) f32)."""
    bb, total = buf.shape
    b = bb // beam
    dev = buf.device
    caches = model.init_cache(bb, total, device=dev)
    steps = torch.arange(total, device=dev)
    neg = -1e30
    # only beam 0 is live at first, so the first expansion draws ``beam``
    # distinct tokens from it rather than ``beam`` copies of its argmax
    scores = torch.full((b, beam), neg, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((b, beam), dtype=torch.bool, device=dev)
    gen_len = torch.zeros((b, beam), dtype=torch.long, device=dev)
    beam_iota = torch.arange(beam, device=dev)[None]               # (1, beam)
    row_base = torch.arange(b, device=dev)[:, None] * beam
    plen0 = plen.reshape(b, beam)[:, :1]                           # (B, 1)
    eos_only = None
    for i in range(total - 1):
        logits, caches = model.forward_decode(buf[:, i:i + 1], caches,
                                              steps[i])
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        v = logp.shape[-1]
        logp = logp.reshape(b, beam, v)
        if eos_only is None:
            # finished beams may only extend with EOS, at an unchanged
            # score; an eos id outside the vocabulary is never reached
            # (JAX's scatter drops an out-of-range index)
            eos_only = torch.full((v,), neg, dtype=torch.float32, device=dev)
            if -v <= eos_id < v:
                eos_only[eos_id] = 0.0
        cand = scores[:, :, None] + torch.where(done[:, :, None],
                                                eos_only[None, None], logp)
        # jax.lax.top_k takes the lower index among equal values; a stable
        # descending sort does the same, torch.topk does not promise it
        top_s, top_i = torch.sort(cand.reshape(b, beam * v), dim=-1,
                                  descending=True, stable=True)
        top_s, top_i = top_s[:, :beam], top_i[:, :beam]
        parent = top_i // v
        new_tok = top_i % v
        # prompt phase, per row: follow the prompt verbatim, keep the state
        in_gen = (i + 1) >= plen0                                  # (B, 1)
        at = min(i + 1, total - 1)
        parent = torch.where(in_gen, parent, beam_iota)
        new_tok = torch.where(in_gen, new_tok, buf[:, at].reshape(b, beam))
        scores = torch.where(in_gen, top_s, scores)
        # reorder every per-beam state by its parent
        flat = (row_base + parent).reshape(-1)
        caches = [{name: c.index_select(0, flat) for name, c in cache.items()}
                  for cache in caches]
        buf = buf.index_select(0, flat)
        done = done.reshape(-1)[flat].reshape(b, beam)
        gen_len = gen_len.reshape(-1)[flat].reshape(b, beam)
        gen_len = gen_len + (in_gen & ~done).long()
        done = done | (in_gen & (new_tok == eos_id))
        buf[:, at] = new_tok.reshape(-1)
    # length-normalised choice (GNMT's denominator)
    denom = ((5.0 + torch.clamp(gen_len, min=1).float()) / 6.0) ** length_penalty
    best = (scores / denom).argmax(dim=1)
    out = buf.reshape(b, beam, total)[torch.arange(b, device=dev), best]
    return out, scores


def beam_search_generate(model: nn.Module, prompt,
                         prompt_len: Union[int, Tensor], max_new_tokens: int,
                         beam_size: int, eos_id: int,
                         length_penalty: float = 0.6) -> Tensor:
    """Beam-search decode over a dense KV cache.

    The (batch, beam) axes fold into one device batch.  Each step expands
    every live beam over the vocabulary, keeps each row's top ``beam_size``
    continuations and reorders every cache by the parent-beam gather;
    finished beams extend with EOS only, at an unchanged score; the chosen
    hypothesis maximises score / ((5 + length) / 6) ** length_penalty.  The
    prompt phase runs with the beams already replicated (they stay in step
    through the identity parent), which costs beam_size times the prompt's
    work.  Returns (B, max_prompt + max_new_tokens) int64 ids, each row's
    best hypothesis."""
    buf, plen, _ = _buffer(model, prompt, prompt_len, max_new_tokens,
                           repeat=beam_size)
    with _eval_inference(model):
        out, _ = _beam_search(model, buf, plen, beam_size, int(eos_id),
                              length_penalty)
    return out
