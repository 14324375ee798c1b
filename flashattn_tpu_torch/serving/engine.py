"""Continuous-batching decode engine over a paged KV cache
(counterpart of flashattn_tpu/serving/engine.py).

The host scheduler (plain Python/numpy) admits queued requests into free
slots mid-flight, allocates physical pages from a free list as sequences
cross page boundaries, and retires finished sequences, returning their
pages.  The device work is the model's paged methods under
``torch.inference_mode()``:

* admission runs ONE batched prefill over the newly admitted slots
  (``forward_prefill_paged``: varlen flash attention), prompt lengths
  bucketed to powers of two; prompts longer than ``prefill_chunk``, and
  prompts whose leading pages the prefix cache already holds, stream
  through fixed-width ``forward_extend_paged`` waves (paged attention);
* decode runs every slot of a fixed ``max_batch`` one token per step
  (``forward_decode_paged``); when no scheduling event is due, K =
  ``steps_per_dispatch`` steps run back to back on the device with the
  sampled tokens fed forward on the device and ONE host sync at the end;
* speculative waves (a draft model, or prompt lookup) verify k+1 tokens
  per sequence in one ``forward_extend_paged`` pass.

Sampling (temperature, top-k, top-p, min-p), the repetition, frequency
and presence penalties, per-request seeds, the prefix cache and both
speculation modes follow the JAX engine.  Sampling randomness is a pure
function of (request seed, absolute position, salt), drawn with JAX's
threefry in integer torch ops (:mod:`._threefry`), so a sampled request
draws what the JAX engine draws.

Tensor-parallel serving (``mesh=``): every rank runs this engine, the same
host scheduler on the same requests; the model (and the draft) is split
over the mesh's ``head_axis`` (:func:`~..parallel.sharding.shard_model`),
each rank's page pools hold its KV heads' pages, and the logits are
all-gathered before sampling, so that every rank chooses the same tokens.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import _threefry

# Randomness substreams per (request seed, absolute position): plain
# sampling, speculative acceptance uniforms, speculative residual sampling.
_SALT_SAMPLE, _SALT_ACCEPT, _SALT_RESIDUAL = 0, 1, 2


def _row_keys(seeds: torch.Tensor, pos: torch.Tensor, salt: int):
    """Per-row threefry keys from (request seed, absolute token position,
    substream salt): ``fold_in(fold_in(PRNGKey(seed), pos), salt)``.
    Sampling randomness is a function of the REQUEST, so a sampled
    request's output is reproducible and independent of which other
    requests share its batch (with speculation the per-token marginals are
    unchanged, but wave eligibility is batch-global)."""
    key = _threefry.fold_in(_threefry.prng_key(seeds), pos)
    return _threefry.fold_in(key, salt)


def _row_gumbel(seeds, pos, salt: int, v: int) -> torch.Tensor:
    """(B, V) Gumbel noise from per-row keys: argmax(logits + gumbel) is an
    exact per-row categorical draw (the Gumbel-max trick)."""
    return _threefry.gumbel(_row_keys(seeds, pos, salt), v)


def _sample_tokens(logits, temps, topks, topps, seeds, pos, *,
                   greedy_only: bool = False, presence=None, reps=None,
                   minps=None, freqs=None, press=None) -> torch.Tensor:
    """Per-row sampling: temperature 0 -> greedy; top_k 0 -> unrestricted;
    top_p 0 (or 1) -> no nucleus cut; min_p 0 -> no min-p cut; the HF
    repetition penalty plus the OpenAI frequency/presence penalties when
    ``presence`` is given.

    logits (B, V); temps (B,) f32; topks (B,) int32; topps/minps (B,) f32;
    seeds (B,) int32 per-request seeds; pos (B,) absolute position of the
    token being sampled; presence (B, V) f32 counts of seen tokens (prompt
    + generated); reps (B,) f32 (1 = off); freqs/press (B,) f32 (0 = off)
    subtract ``freq * count + pres * (count > 0)`` from seen tokens'
    logits.  One descending sort serves top-k and top-p; min-p needs none.
    ``greedy_only`` skips the sort and the draw: the scheduler passes it
    when every active request has temperature 0.  Returns (B,) int32."""
    if presence is not None:
        # HF repetition penalty: for seen tokens, positive logits divide by
        # the penalty, the others multiply (both push probability down)
        pen = torch.clamp_min(reps, 1e-6)[:, None]
        adj = torch.where(logits > 0, logits / pen, logits * pen)
        logits = torch.where((presence > 0) & (pen != 1.0), adj, logits)
        if freqs is not None:
            logits = logits - (freqs[:, None] * presence
                               + press[:, None] * (presence > 0))
    greedy = logits.argmax(-1).to(torch.int32)
    if greedy_only:
        return greedy
    v = logits.shape[-1]
    ninf = float("-inf")
    # only threshold VALUES are read, so the order of ties does not matter
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_idx = torch.clamp(torch.where(topks > 0, topks, v) - 1, 0, v - 1).long()
    thresh = sorted_desc.gather(1, k_idx[:, None])
    # nucleus (top-p) over the RENORMALISED top-k survivors (HF/vLLM
    # sequential semantics): positions >= k collapse to -inf before the
    # softmax; `cum - p_i < p` always keeps the top-1 token
    temp_safe = torch.clamp_min(temps, 1e-6)[:, None]
    in_k = (torch.arange(v, device=logits.device)[None, :]
            <= k_idx[:, None])
    sorted_surv = torch.where(in_k, sorted_desc, ninf)
    p_sorted = torch.softmax(sorted_surv / temp_safe, dim=-1)
    cum = torch.cumsum(p_sorted, dim=-1)
    keep_sorted = (cum - p_sorted) < topps[:, None]
    cnt = torch.clamp_min((keep_sorted & in_k).sum(-1), 1)
    p_thresh = sorted_desc.gather(1, (cnt - 1)[:, None])
    p_on = (topps > 0.0) & (topps < 1.0)
    p_thresh = torch.where(p_on[:, None], p_thresh, ninf)
    keep = (logits >= thresh) & (logits >= p_thresh)
    if minps is not None:
        # min-p: drop tokens whose temperature-scaled probability is below
        # min_p * p_max, i.e. logits below max_logit + T log(min_p)
        m_on = minps > 0.0
        mp_thresh = (logits.max(-1, keepdim=True).values
                     + temp_safe * torch.log(torch.clamp_min(minps, 1e-9))
                     [:, None])
        keep &= (logits >= mp_thresh) | ~m_on[:, None]
    scaled = torch.where(keep, logits, ninf) / temp_safe
    g = _row_gumbel(seeds, pos, _SALT_SAMPLE, v)
    sampled = (scaled + g).argmax(-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def _token_logprob(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log p of ``toks`` (...,) under the raw model distribution: the f32
    log-softmax of the pre-penalty, pre-temperature logits (..., V)."""
    lps = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lps, -1, toks.long()[..., None])[..., 0]


def _spec_accept_sampled(logits, proposed, temps, seeds, pos0):
    """Exact speculative SAMPLING acceptance for a deterministic proposal
    (a point-mass draft): at each position accept the proposed token d with
    probability p(d) under the temperature-scaled target distribution; on
    the first rejection sample from the residual (p without d's mass), so
    the landed tokens are distributed exactly as the target's.  Rows with
    temperature 0 use argmax acceptance.

    logits (B, n, V) target logits over the chunk; proposed (B, n-1)
    drafted tokens (-1 pads are never accepted); temps (B,) f32; seeds (B,)
    per-request seeds; pos0 (B,) absolute position of the wave's first
    landed token.  Returns (n_acc (B,) accepted-proposal counts, toks
    (B, n) with the landed tokens in positions 0..n_acc, lps (B, n)
    raw-model logprobs of toks)."""
    b, n, v = logits.shape
    k = n - 1
    dev = logits.device
    lf = logits.float()
    greedy = lf.argmax(-1).to(torch.int32)                      # (B, n)
    t_on = temps > 0
    logp_t = torch.log_softmax(
        lf / torch.clamp_min(temps, 1e-6)[:, None, None], -1)
    # one scalar uniform per (row, proposal): key f(seed, pos0 + t, ACCEPT)
    t_idx = torch.arange(k, device=dev)
    u_keys = _row_keys(seeds[:, None].expand(b, k).reshape(-1),
                       (pos0[:, None] + t_idx[None]).reshape(-1),
                       _SALT_ACCEPT)
    u = _threefry.uniform(u_keys, 1).reshape(b, k)
    prop = proposed.long()
    prop_safe = torch.clamp_min(prop, 0)
    p_prop = torch.exp(torch.gather(logp_t[:, :k], -1,
                                    prop_safe[..., None])[..., 0])
    accept = torch.where(t_on[:, None], u < p_prop,
                         prop == greedy[:, :k]) & (prop >= 0)
    # accepted prefix length: stop at the first rejection
    n_acc = torch.cumprod(accept.long(), -1).sum(-1)              # (B,)
    rows = torch.arange(b, device=dev)
    logp_at = logp_t[rows, n_acc]                                 # (B, V)
    prop_pad = torch.cat([prop_safe, prop_safe.new_zeros(b, 1)], 1)
    rej_tok = prop_pad[rows, n_acc]
    was_rej = n_acc < k
    res = torch.where((torch.arange(v, device=dev)[None, :] == rej_tok[:, None])
                      & was_rej[:, None], float("-inf"), logp_at)
    g = _row_gumbel(seeds, pos0 + n_acc, _SALT_RESIDUAL, v)
    sampled = (res + g).argmax(-1)
    final = torch.where(t_on, sampled, greedy[rows, n_acc].long())
    idx = torch.arange(n, device=dev)[None, :]
    toks = torch.where(idx < n_acc[:, None], prop_pad, 0)
    toks = torch.where(idx == n_acc[:, None], final[:, None], toks)
    return n_acc, toks.to(torch.int32), _token_logprob(lf, toks)


def _ngram_propose(ctx: List[int], k: int, max_ngram: int = 3) -> List[int]:
    """Prompt-lookup proposal: find the rightmost earlier occurrence of the
    context's trailing n-gram (longest n first) and propose the up-to-k
    tokens that followed it (the plain version of the native proposer,
    :func:`..utils.native_loader.ngram_propose_native`)."""
    L = len(ctx)
    for n in range(max_ngram, 0, -1):
        if L <= n:
            continue
        pat = ctx[-n:]
        for s in range(L - n - 1, -1, -1):
            if ctx[s:s + n] == pat:
                # s <= L-n-1 guarantees at least one continuation token
                return ctx[s + n:s + n + k]
    return []


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
    # sampling: 0 temperature = greedy; top_k limits candidates (None =
    # all); top_p keeps the smallest nucleus of mass >= p (None/1.0 = off)
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None  # drop tokens with p < min_p * p_max
    # per-request sampling seed: randomness is f(seed, position), so a
    # sampled request reproduces exactly whatever its batch (None = derived
    # from the engine seed and the uid)
    seed: Optional[int] = None
    # HF repetition penalty over prompt + generated tokens (None/1.0 = off);
    # applies to greedy decoding too
    repetition_penalty: Optional[float] = None
    # OpenAI additive penalties over prompt + generated tokens (None/0.0 =
    # off): seen tokens' logits lose frequency_penalty * count +
    # presence_penalty
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
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
    shared_pages: int = 0       # leading pages attached from the prefix cache
    # penalties: per-vocab counts of seen tokens (built at admit from the
    # prompt, grown as tokens land) and how many generated tokens are in
    presence: Optional[np.ndarray] = None
    presence_counted: int = 0


def _has_penalty(req: Request) -> bool:
    return bool((req.repetition_penalty and req.repetition_penalty != 1.0)
                or req.frequency_penalty or req.presence_penalty)


def _shard_for_serving(model, mesh, head_axis: str):
    from ..parallel.sharding import apply_mesh, shard_model

    meshed = apply_mesh(model, mesh, batch_axis=None, head_axis=head_axis)
    return shard_model(meshed, mesh, head_axis).eval()


class ContinuousBatchingEngine:
    """Continuous-batching decoder for a :class:`DecoderLM`: paged KV pools,
    batched and chunked prefill, per-request sampling (temperature, top-k,
    top-p, min-p, repetition/frequency/presence penalties), per-token
    logprobs, stop sequences, streaming, cancellation, prefix caching and
    speculative decoding (draft-model or prompt-lookup).  Temperature-0
    requests ride a greedy path that skips sampling."""

    def __init__(self, model, *, max_batch: int = 8, page_size: int = 128,
                 pages_per_seq: int = 16, total_pages: Optional[int] = None,
                 dtype=torch.float32, collect_logits: bool = False,
                 steps_per_dispatch: int = 8, mesh=None,
                 head_axis: str = "model", seed: int = 0,
                 draft_model=None, spec_len: int = 4,
                 spec_waves_per_dispatch: int = 4, prompt_lookup: int = 0,
                 lookup_max_ngram: int = 3, prefill_chunk: int = 512,
                 enable_prefix_cache: bool = False):
        self.seed = seed
        self.model = model.eval()
        self.mesh = mesh
        if mesh is not None:
            # TP-sharded serving: weights per the Megatron rules, each rank
            # holding its heads' KV pools, paged attention on them
            self.model = _shard_for_serving(self.model, mesh, head_axis)
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

        # Sliding-window model => pages wholly behind every window return to
        # the pool.  The widest window across the target AND the draft wins
        # (the draft walks the same page ids); any full-attention layer
        # disables release.
        layers = list(self.model.layers)
        if draft_model is not None:
            layers += list(draft_model.layers)
        windows = [layer.attention.window for layer in layers]
        self._window = (max(windows) if windows
                        and all(w is not None for w in windows) else None)

        # Speculative decoding (greedy-exact): a draft model proposes
        # spec_len - 1 tokens, the target verifies the chunk in one
        # forward_extend_paged pass; all-greedy batches scan
        # spec_waves_per_dispatch waves per dispatch with device-side
        # acceptance.
        self.draft_model = None
        self.spec_len = spec_len
        self.spec_waves_per_dispatch = spec_waves_per_dispatch
        self.spec_stats = [0, 0]   # [accepted tokens, waves]
        # Prompt-lookup speculation: n-gram proposals from the request's own
        # context, verified by the same multi-token pass.
        self.prompt_lookup = prompt_lookup
        self.lookup_max_ngram = lookup_max_ngram
        self.lookup_stats = [0, 0]  # [accepted tokens, waves]
        self._ngram_impl = None  # resolved lazily: native C++ or Python
        if prompt_lookup and draft_model is not None:
            raise ValueError("prompt_lookup and draft_model are mutually "
                             "exclusive speculation modes")
        if prompt_lookup and collect_logits:
            print("[engine] collect_logits disables speculative decoding; "
                  "ignoring prompt_lookup")
            self.prompt_lookup = 0
        if draft_model is not None and collect_logits:
            print("[engine] collect_logits disables speculative decoding; "
                  "ignoring draft_model")
            draft_model = None
        if draft_model is not None:
            self.draft_model = draft_model.eval()
            if mesh is not None:
                # the draft shards over the same (mesh, head_axis)
                self.draft_model = _shard_for_serving(self.draft_model, mesh,
                                                      head_axis)
            self.draft_pools = self.draft_model.init_page_pools(
                total_pages + 1, page_size, dtype, self.device)

        # Prefix caching (opt-in): FULL pages of a prompt are content-
        # addressed (key = the token prefix through that page) and shared
        # read-only.  Refcount = attached slots + 1 while registered; pages
        # return to the pool at ref 0 (cache entries evict LRU when the pool
        # is dry).  The last table column is never shared.
        self.enable_prefix_cache = (enable_prefix_cache
                                    and self._window is None
                                    and not collect_logits)
        if enable_prefix_cache and self._window is not None:
            print("[engine] sliding-window rolling release and prefix "
                  "caching don't compose; prefix cache disabled")
        if enable_prefix_cache and collect_logits:
            print("[engine] collect_logits needs every position's forward; "
                  "prefix cache disabled")
        self._prefix_cache: Dict[bytes, int] = {}  # prefix digest -> page
        self._page_refs: Dict[int, int] = {}       # shared page -> refs

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
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      min_p=min_p, seed=seed,
                      repetition_penalty=repetition_penalty,
                      frequency_penalty=frequency_penalty,
                      presence_penalty=presence_penalty,
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

    def stats(self) -> dict:
        """Request and token counters, speculative acceptance and KV page
        pool use."""
        out = {
            "finished_requests": len(self.finished),
            "active_requests": sum(s is not None for s in self.slots),
            "queued_requests": len(self.queue),
            "generated_tokens": sum(len(r.generated) for r in self.finished)
            + sum(len(s.request.generated) for s in self.slots
                  if s is not None),
            "pages_total": self.pool.total,
            "pages_free": self.pool.n_free,
            "prefix_cache_pages": len(self._prefix_cache),
        }
        if self.spec_stats[1]:
            out["spec_acceptance"] = self.spec_stats[0] / self.spec_stats[1]
            out["spec_waves"] = self.spec_stats[1]
        if self.lookup_stats[1]:
            out["lookup_acceptance"] = (self.lookup_stats[0]
                                        / self.lookup_stats[1])
            out["lookup_waves"] = self.lookup_stats[1]
        return out

    # -- sampling settings -----------------------------------------------------

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sampling_arrays(self):
        """(temps, topks, topps, minps, seeds, all_greedy) of the slots, as
        device tensors.  ``all_greedy`` lets the device steps skip sampling
        entirely; the tensors are then None (never read).  Seeds are
        per-REQUEST (see :func:`_row_keys`)."""
        temps = np.zeros((self.max_batch,), np.float32)
        topks = np.zeros((self.max_batch,), np.int32)
        topps = np.zeros((self.max_batch,), np.float32)
        minps = np.zeros((self.max_batch,), np.float32)
        seeds = np.zeros((self.max_batch,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot is not None:
                temps[i] = slot.request.temperature
                topks[i] = slot.request.top_k or 0
                topps[i] = slot.request.top_p or 0.0
                minps[i] = slot.request.min_p or 0.0
                seeds[i] = self._request_seed(slot.request)
        if not temps.any():
            return None, None, None, None, None, True
        return (*(self._t(a) for a in (temps, topks, topps, minps, seeds)),
                False)

    def _request_seed(self, req) -> int:
        """Per-request sampling seed: an explicit ``submit(seed=...)`` wins,
        else one derived from (engine seed, request uid)."""
        if req.seed is not None:
            return int(req.seed) & 0x7FFFFFFF
        return (self.seed * 1_000_003 + req.uid * 7919 + 17) & 0x7FFFFFFF

    def _penalty_arrays(self):
        """(reps, freqs, press, presence, pen_on) as device tensors; presence
        (B, V) counts prompt + generated tokens per active row.  When no
        active request carries a penalty, ``pen_on`` is False and the
        tensors are None (the device steps skip the (B, V) work)."""
        reps = np.ones((self.max_batch,), np.float32)
        freqs = np.zeros((self.max_batch,), np.float32)
        press = np.zeros((self.max_batch,), np.float32)
        pen_on = False
        for i, slot in enumerate(self.slots):
            if slot is not None:
                req = slot.request
                if req.repetition_penalty:
                    reps[i] = req.repetition_penalty
                freqs[i] = req.frequency_penalty or 0.0
                press[i] = req.presence_penalty or 0.0
                pen_on = (pen_on or reps[i] != 1.0 or freqs[i] != 0.0
                          or press[i] != 0.0)
        if not pen_on:
            return None, None, None, None, False
        # per-slot presence vectors grow INCREMENTALLY (built from the prompt
        # at admit, new tokens folded in here): host work O(new tokens)
        presence = np.zeros((self.max_batch, self.model.n_vocab), np.float32)
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.presence is not None:
                new = slot.request.generated[slot.presence_counted:]
                if new:
                    np.add.at(slot.presence, new, 1.0)
                    slot.presence_counted = len(slot.request.generated)
                presence[i] = slot.presence
        return (self._t(reps), self._t(freqs), self._t(press),
                self._t(presence), True)

    @staticmethod
    def _sample(logits, pos, samp, pen):
        """:func:`_sample_tokens` under one dispatch's settings."""
        temps, topks, topps, minps, seeds, greedy = samp
        reps, freqs, press, presence, pen_on = pen
        return _sample_tokens(logits, temps, topks, topps, seeds, pos,
                              greedy_only=greedy,
                              presence=presence if pen_on else None,
                              reps=reps, minps=minps, freqs=freqs,
                              press=press)

    # -- device calls ----------------------------------------------------------

    @torch.inference_mode()
    def _device_prefill(self, tokens, table, lens, samp, pen):
        """Batched prefill of the target (and the draft, whose pools must
        hold the same history on the same page ids); samples each row's
        seed token at position ``lens``."""
        tokens_t, table_t, lens_t = (self._t(a) for a in (tokens, table, lens))
        logits, self.pools = self.model.forward_prefill_paged(
            tokens_t, self.pools, table_t, lens_t)
        if self.draft_model is not None:
            _, self.draft_pools = self.draft_model.forward_prefill_paged(
                tokens_t, self.draft_pools, table_t, lens_t)
        last = torch.clamp(lens_t - 1, 0, tokens.shape[1] - 1).long()
        chosen = logits[torch.arange(logits.shape[0], device=self.device), last]
        sampled = self._sample(chosen, lens_t, samp, pen)
        lps = _token_logprob(chosen, sampled)
        full = logits.float().cpu().numpy() if self.collect_logits else None
        return sampled.cpu().numpy(), lps.cpu().numpy(), full

    @torch.inference_mode()
    def _device_extend(self, tokens, table, base, take: int, done: List[int]):
        """One chunked-prefill wave (target and draft).  Copies to the host
        only what is read: the last real row of each prompt finishing in
        this wave (``done``), and the wave's real rows when
        ``collect_logits`` is set."""
        tokens_t, table_t, base_t = (self._t(a) for a in (tokens, table, base))
        logits, self.pools = self.model.forward_extend_paged(
            tokens_t, self.pools, table_t, base_t)
        if self.draft_model is not None:
            _, self.draft_pools = self.draft_model.forward_extend_paged(
                tokens_t, self.draft_pools, table_t, base_t)
        last = logits[done, take - 1].float().cpu().numpy()
        full = (logits[:, :take].float().cpu().numpy() if self.collect_logits
                else None)
        return last, full

    @torch.inference_mode()
    def _device_sample(self, logits: np.ndarray, pos: np.ndarray, samp, pen):
        return self._sample(self._t(logits), self._t(pos), samp,
                            pen).cpu().numpy()

    @torch.inference_mode()
    def _device_decode(self, tokens, lengths, n_steps: int, samp, pen):
        """K decode steps back to back on the device: each step's sample
        feeds the next without a host round trip, and penalised rows fold
        it into their presence counts; one sync at the end.  Returns
        (sampled (K, B), logprobs (K, B), logits of the last step (B, V) or
        None)."""
        toks = self._t(tokens)
        lens = self._t(lengths)
        table = self._t(self.page_table)
        presence = pen[3]
        rows = torch.arange(self.max_batch, device=self.device)
        sampled, lps = [], []
        for _ in range(n_steps):
            logits, self.pools = self.model.forward_decode_paged(
                toks[:, None], self.pools, table, lens)
            last = logits[:, 0]
            # pos = the index of the sampled token (last consumed + 1)
            toks = self._sample(last, lens + 1, samp, pen)
            if pen[4]:  # newly sampled tokens join the seen set mid-chunk
                presence[rows, toks.long()] += 1.0
            sampled.append(toks)
            lps.append(_token_logprob(last, toks))
            lens = lens + 1
        full = last.float().cpu().numpy() if self.collect_logits else None
        return (torch.stack(sampled).cpu().numpy(),
                torch.stack(lps).cpu().numpy(), full)

    def _draft_scan(self, tok, lens, table, n_spec: int) -> torch.Tensor:
        """n_spec greedy draft steps from ``tok`` at ``lens``: they write
        positions lens .. lens + n_spec - 1 of the draft pools (keeping them
        warm for the next wave) and return d_1 .. d_n (B, n_spec)."""
        drafts = []
        for _ in range(n_spec):
            logits, self.draft_pools = self.draft_model.forward_decode_paged(
                tok[:, None], self.draft_pools, table, lens)
            tok = logits[:, 0].argmax(-1).to(torch.int32)
            drafts.append(tok)
            lens = lens + 1
        return torch.stack(drafts, 1)

    def _verify(self, chunk, table, lens):
        """The target's multi-token pass over ``chunk`` (B, n) at base
        ``lens``: (logits, argmax (B, n), their logprobs (B, n))."""
        logits, self.pools = self.model.forward_extend_paged(
            chunk, self.pools, table, lens)
        greedy = logits.argmax(-1).to(torch.int32)
        return logits, greedy, _token_logprob(logits, greedy)

    @torch.inference_mode()
    def _device_spec(self, tokens, lengths, n_spec: int, n_waves: int):
        """``n_waves`` greedy draft-model waves in one dispatch: draft scan,
        multi-token verify and device-side acceptance per wave; rows advance
        by their own acceptance.  Returns (drafts (W, B, n-1), target argmax
        (W, B, n), logprobs (W, B, n), landed counts (W, B))."""
        tok = self._t(tokens)
        lens = self._t(lengths)
        table = self._t(self.page_table)
        rows = torch.arange(self.max_batch, device=self.device)
        out = []
        for _ in range(n_waves):
            drafts = self._draft_scan(tok, lens, table, n_spec)
            chunk = torch.cat([tok[:, None], drafts[:, :-1]], 1)
            _, greedy, lps = self._verify(chunk, table, lens)
            # greedy acceptance: longest proposal prefix the target agrees
            # with, plus the target's own next token
            match = (drafts[:, :-1] == greedy[:, :-1]).to(torch.int32)
            acc = torch.cumprod(match, 1).sum(1)
            n_land = (acc + 1).to(torch.int32)
            tok = greedy[rows, acc]
            lens = lens + n_land
            out.append((drafts[:, :-1], greedy, lps, n_land))
        return [torch.stack(t).cpu().numpy() for t in zip(*out)]

    def _verify_sampled(self, chunk, proposed, table, lens, temps, seeds):
        """The target's pass over ``chunk`` with the exact accept/residual
        rule; ``proposed`` (B, n-1) marks pad positions -1."""
        logits, self.pools = self.model.forward_extend_paged(
            chunk, self.pools, table, lens)
        n_acc, toks, lps = _spec_accept_sampled(
            logits, proposed, self._t(temps), self._t(seeds), lens + 1)
        return n_acc.cpu().numpy(), toks.cpu().numpy(), lps.cpu().numpy()

    @torch.inference_mode()
    def _device_spec_sampled(self, tokens, lengths, temps, seeds,
                             n_spec: int):
        """One draft-model wave under sampling: the draft proposes its argmax
        chunk, the target applies the exact accept/residual rule."""
        tok = self._t(tokens)
        lens = self._t(lengths)
        table = self._t(self.page_table)
        drafts = self._draft_scan(tok, lens, table, n_spec)
        chunk = torch.cat([tok[:, None], drafts[:, :-1]], 1)
        return self._verify_sampled(chunk, drafts[:, :-1], table, lens, temps,
                                    seeds)

    @torch.inference_mode()
    def _device_verify(self, chunk, lengths):
        """A prompt-lookup wave's greedy verify."""
        _, greedy, lps = self._verify(self._t(chunk),
                                      self._t(self.page_table),
                                      self._t(lengths))
        return greedy.cpu().numpy(), lps.cpu().numpy()

    @torch.inference_mode()
    def _device_verify_sampled(self, chunk, proposed, lengths, temps, seeds):
        """A prompt-lookup wave's verify under sampling."""
        return self._verify_sampled(self._t(chunk), self._t(proposed),
                                    self._t(self.page_table),
                                    self._t(lengths), temps, seeds)

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
            # prefix cache: attach the longest run of already-cached FULL
            # prompt pages (never the final token's page, so prefill always
            # has at least one position to produce seed logits from)
            shared: List[int] = []
            if self.enable_prefix_cache:
                max_cols = min((len(prompt) - 1) // self.page_size,
                               self.pages_per_seq - 1)
                for key in self._page_keys(prompt, max_cols):
                    page = self._prefix_cache.get(key)
                    if page is None:
                        break
                    shared.append(page)
                    # LRU touch: re-insert so hot prefixes evict last
                    self._prefix_cache[key] = self._prefix_cache.pop(key)
            own_need = need - len(shared)
            # the shared pages are about to be protected (ref bump), so they
            # must not count as evictable supply for this admission
            if (self.pool.n_free + self._evictable_pages(exclude=shared)
                    < own_need):
                break
            req = self.queue.pop(0)
            for p in shared:           # protect from eviction before alloc
                self._page_refs[p] += 1
            own = [self._alloc_page() for _ in range(own_need)]
            pages = shared + own
            self.page_table[i, :need] = pages
            slot = _Slot(req, pages, length=0, next_input=req.prompt[0],
                         shared_pages=len(shared))
            if _has_penalty(req):
                slot.presence = np.zeros((self.model.n_vocab,), np.float32)
                np.add.at(slot.presence, req.prompt, 1.0)
            self.slots[i] = slot
            admitted.append(i)
        return admitted

    def _prefill(self, admitted: List[int]) -> None:
        """One batched prefill for the newly admitted slots: every prompt
        position's K/V lands in its pages, the last position's logits seed
        generation.  Other rows are idle (length 0, trash-page table).
        Prompts longer than ``prefill_chunk``, and admissions with cached
        prefix pages, take the chunked path."""
        s_max = max(len(self.slots[i].request.prompt) for i in admitted)
        if (s_max > self.prefill_chunk
                or any(self.slots[i].shared_pages for i in admitted)):
            # cached-prefix skipping needs the chunked path's per-row base
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
        sampled, lps, logits = self._device_prefill(
            tokens, table, lens, self._sampling_arrays(),
            self._penalty_arrays())
        if self.collect_logits:
            for i in admitted:
                req = self.slots[i].request
                req.logits.extend(logits[i, :len(req.prompt)])
        self._seed_after_prefill(admitted, sampled, lps)

    def _prefill_chunked(self, admitted: List[int]) -> None:
        """Stream long prompts through fixed (B, width) extend waves.  Each
        wave consumes ``take = min(chunk, shortest remaining)`` real tokens
        per unfinished row, so no unfinished row is padded mid-prompt;
        finished rows ride along with trash-routed tables.  Cached prefix
        pages already hold their K/V, so a row starts past them."""
        c = self.prefill_chunk
        consumed = {i: self.slots[i].shared_pages * self.page_size
                    for i in admitted}
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
        pos = np.zeros((self.max_batch,), np.int32)
        for i in admitted:
            pos[i] = plen[i]
        sampled = self._device_sample(final_logits, pos,
                                      self._sampling_arrays(),
                                      self._penalty_arrays())
        shifted = final_logits - final_logits.max(-1, keepdims=True)
        lse = np.log(np.exp(shifted).sum(-1)) + final_logits.max(-1)
        lps = final_logits[np.arange(len(sampled)), sampled] - lse
        self._seed_after_prefill(admitted, sampled, lps)

    def _register_prefix_pages(self, i: int) -> None:
        """Content-address this slot's FULL prompt pages so later requests
        with the same prefix can attach to them."""
        if not self.enable_prefix_cache:
            return
        slot = self.slots[i]
        prompt = slot.request.prompt
        ncols = min((len(prompt) - 1) // self.page_size,
                    self.pages_per_seq - 1)
        for j, key in enumerate(self._page_keys(prompt, ncols)):
            if key in self._prefix_cache:
                continue
            page = slot.pages[j]
            # the page gains two holders: the cache entry AND the owning
            # slot (which held it implicitly, outside the ref system)
            self._page_refs[page] = self._page_refs.get(page, 0) + 2
            self._prefix_cache[key] = page

    def _seed_after_prefill(self, admitted: List[int], sampled,
                            logprobs) -> None:
        """Shared prefill epilogue: record lengths, append the first sampled
        token, then retire or allocate like the decode epilogue."""
        for i in admitted:
            self._register_prefix_pages(i)
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
        """A free page, evicting the oldest cache-only prefix page if the
        pool is dry.  None when nothing can be freed."""
        if self.pool.n_free:
            return self.pool.alloc()
        for key, page in list(self._prefix_cache.items()):  # insertion order
            if self._page_refs.get(page, 0) == 1:      # cache-only
                del self._prefix_cache[key]
                del self._page_refs[page]
                return page
        return None

    def _evictable_pages(self, exclude=()) -> int:
        ex = set(exclude)
        return sum(1 for p in self._prefix_cache.values()
                   if self._page_refs.get(p, 0) == 1 and p not in ex)

    def _page_keys(self, prompt, ncols: int) -> List[bytes]:
        """Running-digest content keys for the first ``ncols`` FULL pages."""
        h = hashlib.sha256()
        keys = []
        for j in range(ncols):
            page = prompt[j * self.page_size:(j + 1) * self.page_size]
            h.update(np.asarray(page, np.int64).tobytes())
            keys.append(h.digest())
        return keys

    def _drop_page_ref(self, page: int) -> None:
        """Detach one holder from a page; return it to the pool when no
        holder (slot or cache) remains."""
        if page in self._page_refs:
            self._page_refs[page] -= 1
            if self._page_refs[page] <= 0:
                del self._page_refs[page]
                self.pool.release([page])
        else:
            self.pool.release([page])

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
        for p in slot.pages:
            if p is not None:
                self._drop_page_ref(p)
        self.slots[i] = None
        # reset the WHOLE row: stale columns would route a later prefill's
        # padding writes into pages owned by live requests
        self.page_table[i, :] = self._trash_page

    # -- speculative waves ------------------------------------------------------

    def _spec_ready(self, active: List[int]) -> bool:
        """Draft-model speculative wave allowed (see _wave_ready)."""
        if (self.draft_model is None or self.spec_len < 2
                or self.collect_logits):
            return False
        return self._wave_ready(active, self.spec_len, allow_sampling=True)

    def _wave_plausible(self, active: List[int]) -> bool:
        """Cheap static disqualifiers for a lookup wave, checked before the
        O(history) proposal scan (no preallocation)."""
        if self.queue and any(s is None for s in self.slots):
            return False
        for i in active:
            req = self.slots[i].request
            if _has_penalty(req):
                return False
            if req.temperature > 0 and (req.top_k or req.min_p
                                        or (req.top_p and req.top_p < 1.0)):
                return False
        return True

    def _wave_ready(self, active: List[int], width: int,
                    allow_sampling: bool = False) -> bool:
        """Speculative wave of ``width`` verify positions allowed: no pending
        admission and every active slot has room for the whole wave.
        Greedy-only unless ``allow_sampling`` (the exact accept/residual
        wave handles plain temperature sampling; top-k/p, min-p and
        penalties always fall back).  On success, write room is
        PREALLOCATED."""
        if self.queue and any(s is None for s in self.slots):
            return False
        for i in active:
            slot = self.slots[i]
            req = slot.request
            if _has_penalty(req):
                return False  # spec verification ignores penalties
            if req.temperature > 0 and not allow_sampling:
                return False
            if req.temperature > 0 and (req.top_k or req.min_p
                                        or (req.top_p and req.top_p < 1.0)):
                return False
            if slot.length + width > self.capacity:
                return False
        # all-or-nothing preallocation of write room for positions
        # length .. length + width - 1: COUNT first, so a half-failed
        # prealloc cannot strand pages
        need = 0
        for i in active:
            slot = self.slots[i]
            need_cols = min((slot.length + width - 1) // self.page_size + 1,
                            self.pages_per_seq)
            need += max(0, need_cols - len(slot.pages))
        if need > self.pool.n_free + self._evictable_pages():
            return False
        for i in active:
            self._ensure_pages(i, self.slots[i].length + width - 1)
        return True

    def _trim_pages(self, i: int) -> None:
        """Release trailing pages beyond the next write position (stranded
        speculative preallocation), so fallback paths see the same pool a
        draft-free engine would."""
        slot = self.slots[i]
        needed_cols = slot.length // self.page_size + 1
        while len(slot.pages) > needed_cols and slot.pages[-1] is not None:
            idx = len(slot.pages) - 1
            self._drop_page_ref(slot.pages.pop())
            self.page_table[i, idx] = self._trash_page

    def _run_spec(self, active, tokens, lengths) -> None:
        drafts, greedy, lps, _ = self._device_spec(tokens, lengths,
                                                   self.spec_len, 1)
        self._accept_wave(active, drafts[0], greedy[0], lps[0],
                          self.spec_len, self.spec_stats)

    def _spec_scan_waves(self, active) -> int:
        """How many greedy speculative waves can run on the device before a
        host scheduling event, rounded down to a power of two.  Each wave
        lands 1..spec_len tokens, so the headroom a FULL-acceptance scan
        would consume caps it; overshoot past EOS/max_new is discarded by
        the epilogue."""
        w = self.spec_waves_per_dispatch
        if w <= 1 or self.collect_logits:
            return 1
        if self.queue and any(s is None for s in self.slots):
            return 1
        for i in active:
            slot = self.slots[i]
            req = slot.request
            headroom = min(req.max_new_tokens - len(req.generated),
                           self.capacity - slot.length)
            w = min(w, max(1, -(-headroom // self.spec_len)))
        return max(1, 1 << (max(w, 1).bit_length() - 1))

    def _run_spec_scan(self, active, tokens, lengths, n_waves) -> None:
        """Multi-wave greedy speculative decode: one dispatch runs
        ``n_waves`` x (draft scan + verify + device-side acceptance); the
        host lands each wave, dropping rows as they retire (their device
        continuation wrote only positions past the retained length, which
        attention masks by length)."""
        _, toks, lps, n_land = self._device_spec(tokens, lengths,
                                                 self.spec_len, n_waves)
        live = list(active)
        for w in range(n_waves):
            if not live:
                break
            self._land_wave(live, {i: int(n_land[w, i]) for i in live},
                            toks[w], lps[w], self.spec_stats)
            live = [i for i in live if self.slots[i] is not None]

    def _resolve_ngram_impl(self):
        """Prefer the C++ proposer (native/ngram.cc); fall back to the
        Python twin, whose answers are the same, when the native library
        cannot be loaded or built."""
        if self._ngram_impl is None:
            from ..utils.native_loader import ngram_propose_native
            try:
                ngram_propose_native([0, 0], 1)  # load (or build) now
                self._ngram_impl = ngram_propose_native
            except OSError:
                self._ngram_impl = _ngram_propose
        return self._ngram_impl

    def _lookup_chunk(self, active, tokens, props):
        """(chunk (B, k+1): each row's next input and its proposal,
        proposed (B, k): the proposal with pad positions -1, which can never
        match a real token id)."""
        k = self.prompt_lookup
        chunk = np.zeros((self.max_batch, k + 1), np.int32)
        proposed = np.full((self.max_batch, k), -1, np.int32)
        for i in active:
            chunk[i, 0] = tokens[i]
            p = props[i][:k]
            proposed[i, :len(p)] = p
            chunk[i, 1:1 + len(p)] = p
        return chunk, proposed

    def _run_lookup(self, active, tokens, lengths, props) -> None:
        """Prompt-lookup wave: verify each row's n-gram proposal in one
        multi-token pass; rows with no proposal still land their plain
        greedy token."""
        chunk, proposed = self._lookup_chunk(active, tokens, props)
        greedy, lps = self._device_verify(chunk, lengths)
        self._accept_wave(active, proposed, greedy, lps,
                          self.prompt_lookup + 1, self.lookup_stats)

    def _temps_seeds(self, active):
        temps = np.zeros((self.max_batch,), np.float32)
        seeds = np.zeros((self.max_batch,), np.int32)
        for i in active:
            temps[i] = self.slots[i].request.temperature
            seeds[i] = self._request_seed(self.slots[i].request)
        return temps, seeds

    def _run_lookup_sampled(self, active, tokens, lengths, props) -> None:
        """Prompt-lookup wave under SAMPLING: device-side exact
        accept/residual (:func:`_spec_accept_sampled`); rows with
        temperature 0 take the argmax branch and stay token-identical."""
        chunk, proposed = self._lookup_chunk(active, tokens, props)
        n_acc, toks, lps = self._device_verify_sampled(
            chunk, proposed, lengths, *self._temps_seeds(active))
        self._land_wave(active, {i: int(n_acc[i]) + 1 for i in active},
                        toks, lps, self.lookup_stats)

    def _run_spec_sampled(self, active, tokens, lengths) -> None:
        """Draft-model wave under SAMPLING (see :func:`_spec_accept_sampled`)."""
        n_acc, toks, lps = self._device_spec_sampled(
            tokens, lengths, *self._temps_seeds(active), self.spec_len)
        self._land_wave(active, {i: int(n_acc[i]) + 1 for i in active},
                        toks, lps, self.spec_stats)

    def _accept_wave(self, active, drafts, greedy, lps, width,
                     stats) -> None:
        """Greedy-acceptance epilogue for deterministic speculative waves:
        drafts (B, width-1) proposals; greedy (B, width) target argmaxes;
        lps (B, width) their logprobs.  Accept the proposal prefix the
        target agrees with, plus the target's own next token."""
        n_land = {}
        for i in active:
            n = 1
            while n < width and drafts[i, n - 1] == greedy[i, n - 1]:
                n += 1
            n_land[i] = n
        self._land_wave(active, n_land, greedy, lps, stats)

    def _land_wave(self, active, n_land, toks, lps, stats) -> None:
        """Land ``n_land[i]`` tokens of ``toks[i]`` per row with the shared
        retire/window/page epilogue."""
        for i in active:
            slot = self.slots[i]
            req = slot.request
            stats[0] += n_land[i]
            stats[1] += 1
            retired = False
            for t in range(n_land[i]):
                tok = int(toks[i, t])
                slot.length += 1
                req.generated.append(tok)
                req.token_logprobs.append(float(lps[i, t]))
                slot.next_input = tok
                hit_eos = req.eos_id is not None and tok == req.eos_id
                if (len(req.generated) >= req.max_new_tokens or hit_eos
                        or slot.length >= self.capacity):
                    self._retire(i)
                    retired = True
                    break
            if not retired:
                self._release_behind_window(i)
                if not self._ensure_pages(i, slot.length):
                    req.truncated = True
                    self._retire(i)

    # -- decode ------------------------------------------------------------------

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
        sampled, lps, logits = self._device_decode(
            tokens, lengths, n_steps, self._sampling_arrays(),
            self._penalty_arrays())
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

        if self.draft_model is not None:
            all_greedy = all(self.slots[i].request.temperature == 0
                             for i in active)
            if (all_greedy and self.spec_len >= 2
                    and not self.collect_logits):
                # multi-wave device-side scan: the widest wave count whose
                # pages preallocate, halving on pool pressure
                w = self._spec_scan_waves(active)
                while w > 1 and not self._wave_ready(
                        active, w * self.spec_len):
                    w //= 2
                if w > 1:
                    self._run_spec_scan(active, tokens, lengths, w)
                    return True
            if self._spec_ready(active):
                if all_greedy:
                    self._run_spec(active, tokens, lengths)
                else:
                    self._run_spec_sampled(active, tokens, lengths)
                return True
            for i in active:   # return any stranded speculative prealloc
                self._trim_pages(i)
        elif self.prompt_lookup and not self.collect_logits:
            # _wave_plausible first: the O(history) proposal scans must not
            # run every step for batches that can never take a wave
            props = None
            if self._wave_plausible(active):
                propose = self._resolve_ngram_impl()
                props = {i: propose(
                    self.slots[i].request.prompt
                    + self.slots[i].request.generated,
                    self.prompt_lookup, self.lookup_max_ngram)
                    for i in active}
            if (props and any(props.values())
                    and self._wave_ready(active, self.prompt_lookup + 1,
                                         allow_sampling=True)):
                all_greedy = all(
                    self.slots[i].request.temperature == 0 for i in active)
                if all_greedy:
                    self._run_lookup(active, tokens, lengths, props)
                else:
                    self._run_lookup_sampled(active, tokens, lengths, props)
                return True
            for i in active:   # return any stranded speculative prealloc
                self._trim_pages(i)

        self._run_chunk(active, tokens, lengths,
                        self._decode_chunk_len(active))
        return True
