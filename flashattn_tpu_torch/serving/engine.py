"""Continuous-batching greedy decode engine over a paged KV cache
(counterpart of flashattn_tpu/serving/engine.py).

The host scheduler (plain Python/numpy) admits queued requests into free
slots mid-flight, allocates physical pages from a free list as sequences
cross page boundaries, and retires finished sequences, returning their
pages.  The device work is the model's paged methods under
``torch.inference_mode()``:

* admission runs ONE batched prefill over the newly admitted slots
  (``forward_prefill_paged``: varlen flash attention), prompt lengths
  bucketed to powers of two; prompts longer than ``prefill_chunk`` stream
  through fixed-width ``forward_extend_paged`` waves (paged attention);
* decode runs every slot of a fixed ``max_batch`` one token per step
  (``forward_decode_paged``); when no scheduling event is due, K =
  ``steps_per_dispatch`` steps run back to back on the device with the
  sampled tokens fed forward on the device and ONE host sync at the end.

This slice is greedy only.  Sampling (temperature, top-k/p, min-p),
penalties, speculative decoding, prefix caching and tensor-parallel
serving raise ``NotImplementedError`` and are later ROADMAP items (A5a,
A5b, A7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch


def _token_logprob(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """(B,) log p of ``toks`` under the model distribution (f32 log-softmax)."""
    lps = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lps, 1, toks.long()[:, None])[:, 0]


def _apply_stop(req: "Request") -> bool:
    """Trim ``req.generated`` at the earliest stop-sequence match (match kept
    in the output).  Returns True when a match ended the request.  Only
    matches a token appended since the last scan could have completed are
    checked, so the work over a generation is linear."""
    if not req.stop or not req.generated:
        return False
    gen = req.generated
    max_n = max(len(s) for s in req.stop)
    scan_from = max(0, req._stop_scanned - max_n + 1)
    best = None
    for seq in req.stop:
        n = len(seq)
        if n == 0 or n > len(gen):
            continue
        for end in range(max(n, scan_from + n), len(gen) + 1):
            if gen[end - n:end] == seq:
                if best is None or end < best:
                    best = end
                break
    req._stop_scanned = len(gen)
    if best is None:
        return False
    del gen[best:]
    del req.token_logprobs[best:]
    req._streamed = min(req._streamed, len(gen))
    return True


class PagePool:
    """Host-side free list of physical page ids."""

    def __init__(self, total_pages: int):
        self.free: List[int] = list(range(total_pages - 1, -1, -1))
        self.total = total_pages

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError("page pool exhausted")
        return self.free.pop()

    def release(self, pages: List[int]) -> None:
        self.free.extend(pages)

    @property
    def n_free(self) -> int:
        return len(self.free)


@dataclasses.dataclass
class Request:
    """One generation request."""

    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    # stop sequences (token-id lists): generation ends when the tail of
    # ``generated`` equals one of them; the match is kept in the output
    stop: Optional[List[List[int]]] = None
    # filled by the engine:
    uid: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    # log p of each generated token (f32 log-softmax of the raw logits)
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    # per-position next-token logits (engine built with collect_logits=True):
    # one row per consumed position, prefill included
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False  # stopped early (KV page pool exhausted)
    cancelled: bool = False
    # streaming: on_token(request, new_tokens) after each step that landed
    # tokens for this request
    on_token: Optional[Callable[["Request", List[int]], None]] = None
    _streamed: int = 0
    _stop_scanned: int = 0


@dataclasses.dataclass
class _Slot:
    request: Request
    pages: List[Optional[int]]  # None = released behind the sliding window
    length: int = 0             # tokens already in the KV cache
    next_input: int = 0         # token id to feed at position `length`


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class ContinuousBatchingEngine:
    """Continuous-batching greedy decoder for a :class:`DecoderLM`: paged KV
    pools, batched and chunked prefill, per-token logprobs, stop sequences,
    streaming and cancellation."""

    def __init__(self, model, *, max_batch: int = 8, page_size: int = 128,
                 pages_per_seq: int = 16, total_pages: Optional[int] = None,
                 dtype=torch.float32, collect_logits: bool = False,
                 steps_per_dispatch: int = 8, prefill_chunk: int = 512,
                 mesh=None, head_axis: str = "model", seed: int = 0,
                 draft_model=None, spec_len: int = 4,
                 spec_waves_per_dispatch: int = 4, prompt_lookup: int = 0,
                 lookup_max_ngram: int = 3,
                 enable_prefix_cache: bool = False):
        if mesh is not None:
            _not_ported("tensor-parallel serving (mesh)", "A7")
        if draft_model is not None:
            _not_ported("draft-model speculative decoding", "A5b")
        if prompt_lookup:
            _not_ported("prompt-lookup speculative decoding", "A5b")
        knobs = dict(spec_len=(spec_len, 4),
                     spec_waves_per_dispatch=(spec_waves_per_dispatch, 4),
                     lookup_max_ngram=(lookup_max_ngram, 3))
        for name, (value, default) in knobs.items():
            if value != default:
                _not_ported(f"speculative decoding ({name}={value})", "A5b")
        if enable_prefix_cache:
            _not_ported("the prefix cache", "A5b")
        # head_axis names the mesh axis of tensor-parallel serving (A7); it
        # is accepted and unused.  seed keys sampling, which is A5a.
        self.seed = seed
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.max_batch = max_batch
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        total_pages = total_pages or max_batch * pages_per_seq
        self.pool = PagePool(total_pages)
        # One extra physical page (id = total_pages) absorbs the K/V writes
        # of inactive slots and padding: the device step is fixed-shape, so
        # empty slots still scatter somewhere, never into a live page.
        self._trash_page = total_pages
        self.pools = self.model.init_page_pools(total_pages + 1, page_size,
                                                dtype, self.device)
        self.page_table = np.full((max_batch, pages_per_seq), self._trash_page,
                                  np.int32)
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._uid = 0
        self.collect_logits = collect_logits
        self.steps_per_dispatch = steps_per_dispatch
        self.prefill_chunk = prefill_chunk
        # Sliding-window model => pages wholly behind every layer's window
        # return to the pool (the widest window wins; any full-attention
        # layer disables release).
        windows = [layer.attention.window for layer in self.model.layers]
        self._window = (max(windows) if windows
                        and all(w is not None for w in windows) else None)

    # -- public API ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        """KV positions per sequence (pages_per_seq * page_size)."""
        return self.pages_per_seq * self.page_size

    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_id: Optional[int] = None, temperature: float = 0.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               min_p: Optional[float] = None, seed: Optional[int] = None,
               repetition_penalty: Optional[float] = None,
               frequency_penalty: Optional[float] = None,
               presence_penalty: Optional[float] = None,
               stop: Optional[List[List[int]]] = None,
               on_token: Optional[Callable[[Request, List[int]], None]] = None,
               ) -> Request:
        if temperature > 0 or top_k or (top_p and top_p < 1.0) or min_p \
                or seed is not None:
            _not_ported("sampling (temperature/top-k/top-p/min-p/seed)", "A5a")
        if (repetition_penalty not in (None, 1.0) or frequency_penalty
                or presence_penalty):
            _not_ported("repetition/frequency/presence penalties", "A5a")
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if len(prompt) >= self.capacity:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds per-sequence KV "
                f"capacity {self.capacity} (pages_per_seq * page_size)")
        need = max(1, -(-len(prompt) // self.page_size))
        if need > self.pool.total:
            raise ValueError(
                f"prompt needs {need} pages but the pool only has "
                f"{self.pool.total}; request can never be admitted")
        req = Request([int(t) for t in prompt], max_new_tokens, eos_id,
                      stop=[list(s) for s in stop] if stop else None,
                      uid=self._uid, on_token=on_token)
        self._uid += 1
        self.queue.append(req)
        return req

    def cancel(self, req: Request) -> bool:
        """Cancel a request: a queued one is dropped, an active one is retired
        immediately (pages returned, partial ``generated`` kept).  Returns
        False if it already finished."""
        if req.done:
            return False
        req.cancelled = True
        if req in self.queue:
            self.queue.remove(req)
            req.done = True
            self.finished.append(req)
            return True
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request is req:
                self._retire(i)
                self._flush_stream(req)
                return True
        return False

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until every submitted request finishes; returns them."""
        for _ in range(max_steps):
            if not self.step():
                break
        return self.finished

    # -- device calls ----------------------------------------------------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def _device_prefill(self, tokens, table, lens):
        logits, self.pools = self.model.forward_prefill_paged(
            self._t(tokens), self.pools, self._t(table), self._t(lens))
        last = self._t(np.clip(lens - 1, 0, tokens.shape[1] - 1)).long()
        chosen = logits[torch.arange(logits.shape[0], device=self.device), last]
        sampled = chosen.argmax(-1).to(torch.int32)
        lps = _token_logprob(chosen, sampled)
        full = logits.float().cpu().numpy() if self.collect_logits else None
        return sampled.cpu().numpy(), lps.cpu().numpy(), full

    @torch.inference_mode()
    def _device_extend(self, tokens, table, base, take: int, done: List[int]):
        """One chunked-prefill wave.  Copies to the host only what is read:
        the last real row of each prompt finishing in this wave (``done``),
        and the wave's real rows when ``collect_logits`` is set."""
        logits, self.pools = self.model.forward_extend_paged(
            self._t(tokens), self.pools, self._t(table), self._t(base))
        last = logits[done, take - 1].float().cpu().numpy()
        full = (logits[:, :take].float().cpu().numpy() if self.collect_logits
                else None)
        return last, full

    @torch.inference_mode()
    def _device_decode(self, tokens, lengths, n_steps: int):
        """K greedy decode steps back to back on the device: each step's
        argmax feeds the next without a host round trip; one sync at the
        end.  Returns (sampled (K, B), logprobs (K, B), logits of the last
        step (B, V) or None)."""
        toks = self._t(tokens)
        lens = self._t(lengths)
        table = self._t(self.page_table)
        sampled, lps = [], []
        for _ in range(n_steps):
            logits, self.pools = self.model.forward_decode_paged(
                toks[:, None], self.pools, table, lens)
            last = logits[:, 0]
            toks = last.argmax(-1).to(torch.int32)
            sampled.append(toks)
            lps.append(_token_logprob(last, toks))
            lens = lens + 1
        full = last.float().cpu().numpy() if self.collect_logits else None
        return (torch.stack(sampled).cpu().numpy(),
                torch.stack(lps).cpu().numpy(), full)

    # -- scheduler ------------------------------------------------------------

    def _admit(self) -> List[int]:
        """Admit queued requests into free slots, allocating every page the
        prompt needs up front.  Returns the newly admitted slot ids."""
        admitted = []
        for i in range(self.max_batch):
            if self.slots[i] is not None or not self.queue:
                continue
            prompt = self.queue[0].prompt
            need = max(1, -(-len(prompt) // self.page_size))
            if self.pool.n_free < need:
                break
            req = self.queue.pop(0)
            pages = [self._alloc_page() for _ in range(need)]
            self.page_table[i, :need] = pages
            self.slots[i] = _Slot(req, pages, length=0,
                                  next_input=req.prompt[0])
            admitted.append(i)
        return admitted

    def _prefill(self, admitted: List[int]) -> None:
        """One batched prefill for the newly admitted slots: every prompt
        position's K/V lands in its pages, the last position's logits seed
        generation.  Other rows are idle (length 0, trash-page table).
        Prompts longer than ``prefill_chunk`` take the chunked path."""
        s_max = max(len(self.slots[i].request.prompt) for i in admitted)
        if s_max > self.prefill_chunk:
            return self._prefill_chunked(admitted)
        s_pad = min(max(8, 1 << (s_max - 1).bit_length()), self.capacity)
        tokens = np.zeros((self.max_batch, s_pad), np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        table = np.full_like(self.page_table, self._trash_page)
        for i in admitted:
            p = self.slots[i].request.prompt
            tokens[i, :len(p)] = p
            lens[i] = len(p)
            table[i] = self.page_table[i]
        sampled, lps, logits = self._device_prefill(tokens, table, lens)
        if self.collect_logits:
            for i in admitted:
                req = self.slots[i].request
                req.logits.extend(logits[i, :len(req.prompt)])
        self._seed_after_prefill(admitted, sampled, lps)

    def _prefill_chunked(self, admitted: List[int]) -> None:
        """Stream long prompts through fixed (B, width) extend waves.  Each
        wave consumes ``take = min(chunk, shortest remaining)`` real tokens
        per unfinished row, so no unfinished row is padded mid-prompt;
        finished rows ride along with trash-routed tables."""
        c = self.prefill_chunk
        consumed = {i: 0 for i in admitted}
        plen = {i: len(self.slots[i].request.prompt) for i in admitted}
        final_logits = np.zeros((self.max_batch, self.model.n_vocab),
                                np.float32)
        while True:
            unfinished = [i for i in admitted if consumed[i] < plen[i]]
            if not unfinished:
                break
            take = min(c, min(plen[i] - consumed[i] for i in unfinished))
            width = min(c, max(8, 1 << (take - 1).bit_length()))
            tokens = np.zeros((self.max_batch, width), np.int32)
            base = np.zeros((self.max_batch,), np.int32)
            table = np.full_like(self.page_table, self._trash_page)
            for i in unfinished:
                p = self.slots[i].request.prompt
                tokens[i, :take] = p[consumed[i]:consumed[i] + take]
                base[i] = consumed[i]
                table[i] = self.page_table[i]
            done = [i for i in unfinished if consumed[i] + take == plen[i]]
            last, full = self._device_extend(tokens, table, base, take, done)
            final_logits[done] = last
            for i in unfinished:
                if full is not None:
                    self.slots[i].request.logits.extend(full[i])
                consumed[i] += take
        sampled = final_logits.argmax(-1).astype(np.int32)
        shifted = final_logits - final_logits.max(-1, keepdims=True)
        lse = np.log(np.exp(shifted).sum(-1)) + final_logits.max(-1)
        lps = final_logits[np.arange(len(sampled)), sampled] - lse
        self._seed_after_prefill(admitted, sampled, lps)

    def _seed_after_prefill(self, admitted: List[int], sampled,
                            logprobs) -> None:
        """Shared prefill epilogue: record lengths, append the first sampled
        token, then retire or allocate like the decode epilogue."""
        for i in admitted:
            slot = self.slots[i]
            req = slot.request
            slot.length = len(req.prompt)
            self._release_behind_window(i)
            tok = int(sampled[i])
            req.generated.append(tok)
            req.token_logprobs.append(float(logprobs[i]))
            slot.next_input = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if (len(req.generated) >= req.max_new_tokens or hit_eos
                    or slot.length >= self.capacity):
                self._retire(i)
            elif not self._ensure_pages(i, slot.length):
                req.truncated = True
                self._retire(i)

    def _alloc_page(self) -> Optional[int]:
        """A free page, or None when the pool is dry."""
        return self.pool.alloc() if self.pool.n_free else None

    def _ensure_pages(self, i: int, upto_pos: int) -> bool:
        """Allocate pages so the slot owns every table column up to the one
        holding ``upto_pos``; False if the pool runs dry."""
        slot = self.slots[i]
        need_cols = min(upto_pos // self.page_size + 1, self.pages_per_seq)
        while len(slot.pages) < need_cols:
            page = self._alloc_page()
            if page is None:
                return False
            slot.pages.append(page)
            self.page_table[i, len(slot.pages) - 1] = page
        return True

    def _release_behind_window(self, i: int) -> None:
        """Return pages wholly behind the sliding window to the pool."""
        if self._window is None:
            return
        slot = self.slots[i]
        first_needed = max(0, slot.length - self._window) // self.page_size
        freed = []
        for idx in range(min(first_needed, len(slot.pages))):
            if slot.pages[idx] is not None:
                freed.append(slot.pages[idx])
                slot.pages[idx] = None
                self.page_table[i, idx] = self._trash_page
        if freed:
            self.pool.release(freed)

    def _retire(self, i: int) -> None:
        slot = self.slots[i]
        slot.request.done = True
        self.finished.append(slot.request)
        self.pool.release([p for p in slot.pages if p is not None])
        self.slots[i] = None
        # reset the WHOLE row: stale columns would route a later prefill's
        # padding writes into pages owned by live requests
        self.page_table[i, :] = self._trash_page

    def _decode_chunk_len(self, active: List[int]) -> int:
        """How many decode steps can run on the device before ANY host
        scheduling event (admission, page boundary, retirement by count),
        rounded down to a power of two."""
        if self.collect_logits or self.steps_per_dispatch <= 1:
            return 1
        if self.queue and any(s is None for s in self.slots):
            return 1  # an admission is pending
        k = self.steps_per_dispatch
        for i in active:
            slot = self.slots[i]
            req = slot.request
            k = min(k,
                    req.max_new_tokens - len(req.generated),
                    self.page_size - (slot.length % self.page_size),
                    self.capacity - slot.length)
        return max(1, 1 << (max(k, 1).bit_length() - 1))

    def _run_chunk(self, active, tokens, lengths, n_steps) -> None:
        """Decode ``n_steps`` tokens for every active slot in one device run
        and land them through the retire/window/page epilogue."""
        sampled, lps, logits = self._device_decode(tokens, lengths, n_steps)
        for i in active:
            slot = self.slots[i]
            req = slot.request
            if logits is not None:
                req.logits.append(logits[i])
            slot.length += n_steps
            self._release_behind_window(i)
            slot.next_input = int(sampled[-1, i])
            for t in range(n_steps):
                tok = int(sampled[t, i])
                req.generated.append(tok)
                req.token_logprobs.append(float(lps[t, i]))
                if req.eos_id is not None and tok == req.eos_id:
                    # tokens decoded after EOS inside the chunk are dropped
                    self._retire(i)
                    break
            else:
                if (len(req.generated) >= req.max_new_tokens
                        or slot.length >= self.capacity):
                    self._retire(i)
                elif not self._ensure_pages(i, slot.length):
                    req.truncated = True
                    self._retire(i)

    def step(self) -> bool:
        """One engine iteration: admit (+ prefill) or decode, then advance,
        retire and stream.  Returns False when idle."""
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request.cancelled:
                self._retire(i)
        for r in self.queue:
            if r.cancelled:
                r.done = True
                self.finished.append(r)
        self.queue = [r for r in self.queue if not r.cancelled]
        pre_finished = len(self.finished)
        progressed = self._step_inner()
        for i, slot in enumerate(self.slots):
            if slot is not None and _apply_stop(slot.request):
                self._retire(i)
        for req in self.finished[pre_finished:]:
            _apply_stop(req)
        for slot in self.slots:
            if slot is not None:
                self._flush_stream(slot.request)
        for req in self.finished[pre_finished:]:
            self._flush_stream(req)
        return progressed

    @staticmethod
    def _flush_stream(req: Request) -> None:
        if req.on_token is not None and len(req.generated) > req._streamed:
            new = req.generated[req._streamed:]
            req._streamed = len(req.generated)
            req.on_token(req, new)

    def _step_inner(self) -> bool:
        admitted = self._admit()
        if admitted:
            self._prefill(admitted)
            return True
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return bool(self.queue)
        tokens = np.zeros((self.max_batch,), np.int32)
        lengths = np.zeros((self.max_batch,), np.int32)
        for i in active:
            tokens[i] = self.slots[i].next_input
            lengths[i] = self.slots[i].length
        self._run_chunk(active, tokens, lengths,
                        self._decode_chunk_len(active))
        return True
