"""The port's speculative decoding (a draft model, or prompt lookup) against
the JAX engine's and against plain greedy decoding (mirrors
tests/test_speculative.py and the speculative cases of tests/test_serving.py
and tests/test_serving_fuzz.py).

Greedy acceptance makes a speculative engine's output token-for-token the
plain greedy engine's, logprobs included (1e-4); under sampling the exact
accept/residual wave lands the JAX engine's tokens on the same seeds.  The
native n-gram proposer (native/ngram.cc through the port's own loader) and
its Python twin give the same proposals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu.serving import ContinuousBatchingEngine as JaxEngine
from flashattn_tpu.serving import engine as jeng
from flashattn_tpu_torch.serving import engine as teng
from flashattn_tpu_torch.utils import native_loader

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
V = 64


def _pair(seed, n_embd, n_head, n_layer, **kw):
    jm = ft.DecoderLM(V, n_embd, n_head, 512, p_dropout=0.0, n_layer=n_layer,
                      key=jax.random.PRNGKey(seed), **kw).eval()
    tm = pt.DecoderLM(V, n_embd, n_head, 512, p_dropout=0.0, n_layer=n_layer,
                      device="cpu", **kw).eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def target():
    return _pair(0, 32, 4, 2)


@pytest.fixture(scope="module")
def draft():
    # a different (smaller) model: proposals only partly match, so the
    # acceptance logic is exercised
    return _pair(7, 16, 2, 1)


def _run(model, prompts, maxnews, eoss, **kw):
    eng = pt.ContinuousBatchingEngine(model, **kw)
    reqs = [eng.submit(p, m, eos_id=e)
            for p, m, e in zip(prompts, maxnews, eoss)]
    eng.run()
    assert eng.pool.n_free == eng.pool.total
    return {r.uid: (r.generated, r.truncated) for r in reqs}, eng


def _greedy_reference(tm, prompt, n_new, **kw):
    eng = pt.ContinuousBatchingEngine(tm, max_batch=1, page_size=16,
                                      pages_per_seq=8, **kw)
    req = eng.submit(prompt, n_new)
    eng.run()
    return req


# -- against the JAX engine ---------------------------------------------------------

# mode -> (engine settings, requests (prompt, max_new, submit kwargs)); the
# draft modes take the draft pair
JAX_CASES = {
    "draft_scan": (dict(spec_len=3, spec_waves_per_dispatch=2),
                   [([3, 14, 15, 9, 2, 6], 11, {}), ([27, 1, 8], 9, {})]),
    "draft_sampled": (dict(spec_len=3),
                      [([3, 14, 15, 9], 10, dict(temperature=0.8, seed=3)),
                       ([3, 14, 15, 9], 10, {})]),
    "lookup_sampled": (dict(prompt_lookup=3),
                       [(list(range(1, 30)) + list(range(1, 15)), 10, {}),
                        (list(range(1, 30)) + list(range(1, 15)), 10,
                         dict(temperature=0.9, seed=4))]),
}


@pytest.mark.parametrize("mode", list(JAX_CASES))
def test_speculation_matches_jax_engine(target, draft, mode):
    """The same requests through a JAX and a port engine: tokens, logprobs
    and the acceptance counters equal."""
    kw, reqs = JAX_CASES[mode]
    kw = dict(kw, max_batch=2, page_size=8, pages_per_seq=8,
              steps_per_dispatch=1)
    out = []
    for side, cls in ((0, JaxEngine), (1, pt.ContinuousBatchingEngine)):
        extra = dict(draft_model=draft[side]) if "draft" in mode else {}
        eng = cls(target[side], **kw, **extra)
        rs = [eng.submit(p, n, **rk) for p, n, rk in reqs]
        eng.run()
        assert eng.pool.n_free == eng.pool.total
        out.append((rs, eng))
    (want, jeng_), (got, eng) = out
    for g, w in zip(got, want):
        assert g.generated == w.generated
        np.testing.assert_allclose(g.token_logprobs, w.token_logprobs, **TOL)
    assert eng.spec_stats == jeng_.spec_stats
    assert eng.lookup_stats == jeng_.lookup_stats
    assert eng.stats() == jeng_.stats()
    assert max(eng.spec_stats[1], eng.lookup_stats[1]) > 0


# -- draft-model speculation ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_equals_greedy(target, draft, seed):
    """Fuzzed scheduler configurations: a draft-model engine lands exactly
    what the plain per-token engine lands."""
    rng = np.random.default_rng(seed)
    page_size = int(rng.choice([4, 8]))
    pages_per_seq = int(rng.integers(3, 6))
    max_batch = int(rng.integers(1, 4))
    capacity = page_size * pages_per_seq
    total_pages = int(rng.integers(max(3, max_batch),
                                   max_batch * pages_per_seq + 1))
    spec_len = int(rng.choice([2, 3, 4]))
    prompts, maxnews, eoss = [], [], []
    for _ in range(int(rng.integers(3, 7))):
        plen = int(rng.integers(1, capacity - 1))
        if -(-plen // page_size) > total_pages:
            continue
        prompts.append(list(rng.integers(1, 60, size=plen)))
        maxnews.append(int(rng.integers(1, capacity)))
        eoss.append(int(rng.integers(1, 60)) if rng.random() < 0.4 else None)
    kw = dict(max_batch=max_batch, page_size=page_size,
              pages_per_seq=pages_per_seq, total_pages=total_pages)
    plain, _ = _run(target[1], prompts, maxnews, eoss, steps_per_dispatch=1,
                    **kw)
    spec, eng = _run(target[1], prompts, maxnews, eoss, draft_model=draft[1],
                     spec_len=spec_len, **kw)
    assert plain == spec
    assert eng.spec_stats[1] > 0


def test_self_draft_accepts_everything(target):
    """Draft == target: every wave but the last accepts all spec_len
    tokens."""
    tm = target[1]
    eng = pt.ContinuousBatchingEngine(tm, max_batch=2, page_size=8,
                                      pages_per_seq=8, draft_model=tm,
                                      spec_len=4)
    reqs = [eng.submit([3, 14, 15], 17), eng.submit([9, 2], 13)]
    eng.run()
    assert all(r.done for r in reqs)
    acc, waves = eng.spec_stats
    assert waves > 0 and acc / waves > 3.0, eng.spec_stats


def test_speculative_with_rolling_window():
    """A windowed target and draft: speculation, rolling page release and the
    windowed paged attention compose; the output equals plain greedy."""
    wtarget = pt.DecoderLM(V, 32, 4, 512, p_dropout=0.0, n_layer=2, window=8,
                           generator=torch.Generator().manual_seed(1),
                           device="cpu").eval()
    wdraft = pt.DecoderLM(V, 16, 2, 512, p_dropout=0.0, n_layer=1, window=8,
                          generator=torch.Generator().manual_seed(8),
                          device="cpu").eval()
    prompts = [[3, 14, 15, 9, 2, 6], [27, 1, 8]]
    kw = dict(max_batch=2, page_size=4, pages_per_seq=8)
    plain, _ = _run(wtarget, prompts, [20, 24], [None, None],
                    steps_per_dispatch=1, **kw)
    spec, eng = _run(wtarget, prompts, [20, 24], [None, None],
                     draft_model=wdraft, spec_len=3, **kw)
    assert plain == spec
    assert eng.spec_stats[1] > 0


def test_token_logprobs_speculative(target):
    """Accepted tokens carry the target's logprobs, as plain greedy's."""
    tm = target[1]
    eng = pt.ContinuousBatchingEngine(tm, max_batch=1, page_size=16,
                                      pages_per_seq=4, draft_model=tm,
                                      spec_len=4)
    req = eng.submit([5, 9, 2], 10)
    eng.run()
    plain = _greedy_reference(tm, [5, 9, 2], 10)
    assert req.generated == plain.generated
    np.testing.assert_allclose(req.token_logprobs, plain.token_logprobs, **TOL)


def test_draft_spec_sampled_mixed_batch(target, draft):
    """Draft speculation under sampling: the greedy row equals plain greedy,
    the sampled row completes with logprobs in lockstep."""
    rng = np.random.default_rng(21)
    prompt = list(rng.integers(1, 60, size=8))
    want = _greedy_reference(target[1], prompt, 12)
    eng = pt.ContinuousBatchingEngine(target[1], max_batch=2, page_size=16,
                                      pages_per_seq=8, draft_model=draft[1],
                                      spec_len=3)
    r_greedy = eng.submit(list(prompt), 12)
    r_sampled = eng.submit(list(prompt), 12, temperature=0.8)
    eng.run()
    assert r_greedy.generated == want.generated
    assert len(r_sampled.generated) == len(r_sampled.token_logprobs) == 12
    assert eng.spec_stats[1] > 0
    assert eng.pool.n_free == eng.pool.total


def test_engine_fuzz_spec_scan(target):
    """The multi-wave scan (device-side acceptance) against the single-wave
    host loop and the plain engine (seed 0 of the JAX fuzz)."""
    tm = target[1]
    rng = np.random.default_rng(1100)
    max_batch = int(rng.integers(1, 4))
    prompts = []
    for _ in range(int(rng.integers(3, 6))):
        p = list(rng.integers(1, 60, size=int(rng.integers(1, 16))))
        eos = int(rng.integers(1, 60)) if rng.random() < 0.3 else None
        prompts.append((p, int(rng.integers(3, 18)), eos))
    results = []
    for cfg in ({}, dict(draft_model=tm, spec_len=4,
                         spec_waves_per_dispatch=1),
                dict(draft_model=tm, spec_len=4, spec_waves_per_dispatch=4)):
        eng = pt.ContinuousBatchingEngine(tm, max_batch=max_batch,
                                          page_size=8, pages_per_seq=8, **cfg)
        reqs = [eng.submit(p, m, eos_id=e) for p, m, e in prompts]
        eng.run()
        assert eng.pool.n_free == eng.pool.total
        results.append({r.uid: (r.generated,
                                [round(l, 4) for l in r.token_logprobs])
                        for r in reqs})
    assert results[0] == results[1] == results[2]


# -- prompt lookup ---------------------------------------------------------------


def test_ngram_propose_unit():
    for propose in (teng._ngram_propose, native_loader.ngram_propose_native):
        assert propose([7, 8, 9, 10, 3, 7, 8], 2) == [9, 10]
        assert propose([1, 2, 3, 4, 5, 0, 1, 2, 3], 3, max_ngram=3) == [4, 5, 0]
        assert propose([1, 2, 3, 4], 4) == []
        assert propose([7, 8, 9, 10, 3, 7, 8], 1) == [9]
        assert propose([5, 5, 5, 5], 2) == [5]


def test_ngram_proposers_agree():
    """The native proposer, the Python one and JAX's Python one over random
    contexts (small alphabets, so n-grams repeat)."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        ctx = rng.integers(0, int(rng.integers(2, 9)),
                           size=int(rng.integers(0, 60))).tolist()
        k, n = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        want = jeng._ngram_propose(ctx, k, n)
        assert teng._ngram_propose(ctx, k, n) == want
        assert native_loader.ngram_propose_native(ctx, k, n) == want


def test_engine_resolves_native_proposer(target):
    eng = pt.ContinuousBatchingEngine(target[1], max_batch=1, page_size=8,
                                      pages_per_seq=2, prompt_lookup=3)
    assert eng._resolve_ngram_impl() is native_loader.ngram_propose_native


@pytest.mark.parametrize("prompt", [
    [5, 9, 2, 5, 9, 2, 5, 9],                 # strongly repetitive
    [7, 1, 3],                                # no repeats
    list(range(1, 40)) + list(range(1, 20)),  # long, partial repeat
])
def test_prompt_lookup_token_identical_to_greedy(target, prompt):
    tm = target[1]
    want = _greedy_reference(tm, prompt, 12)
    eng = pt.ContinuousBatchingEngine(tm, max_batch=1, page_size=16,
                                      pages_per_seq=8, prompt_lookup=3)
    req = eng.submit(prompt, 12)
    eng.run()
    assert req.generated == want.generated
    np.testing.assert_allclose(req.token_logprobs, want.token_logprobs, **TOL)
    assert eng.pool.n_free == eng.pool.total


def test_prompt_lookup_waves_run(target):
    """A prompt holding every vocab token guarantees an n=1 match, so lookup
    waves run; the output still equals plain greedy."""
    tm = target[1]
    prompt = list(range(V)) + [5, 9, 2]
    want = _greedy_reference(tm, prompt, 12)
    eng = pt.ContinuousBatchingEngine(tm, max_batch=1, page_size=16,
                                      pages_per_seq=8, prompt_lookup=3)
    req = eng.submit(prompt, 12)
    eng.run()
    assert req.generated == want.generated
    np.testing.assert_allclose(req.token_logprobs, want.token_logprobs, **TOL)
    assert eng.lookup_stats[1] > 0
    assert eng.pool.n_free == eng.pool.total


def test_prompt_lookup_batch_mixed(target):
    tm = target[1]
    prompts = [[5, 9, 2, 5, 9, 2], [7, 1, 3], [4, 4, 4, 4, 4],
               [11, 3, 11, 3, 11]]
    wants = [_greedy_reference(tm, p, 10).generated for p in prompts]
    eng = pt.ContinuousBatchingEngine(tm, max_batch=2, page_size=16,
                                      pages_per_seq=8, prompt_lookup=3)
    reqs = [eng.submit(p, 10) for p in prompts]
    eng.run()
    assert [r.generated for r in reqs] == wants
    assert eng.pool.n_free == eng.pool.total


def test_prompt_lookup_rejects_draft_model(target):
    with pytest.raises(ValueError):
        pt.ContinuousBatchingEngine(target[1], draft_model=target[1],
                                    prompt_lookup=3)


def test_prompt_lookup_with_stop_and_eos(target):
    tm = target[1]
    probe = _greedy_reference(tm, [5, 9, 2, 5, 9, 2], 12)
    stop = [probe.generated[3:5]]
    eng = pt.ContinuousBatchingEngine(tm, max_batch=1, page_size=16,
                                      pages_per_seq=8, prompt_lookup=3)
    req = eng.submit([5, 9, 2, 5, 9, 2], 12, stop=stop)
    eng.run()
    assert req.generated == probe.generated[:5]
    assert len(req.token_logprobs) == len(req.generated)


def test_prompt_lookup_sampled_mixed_batch(target):
    tm = target[1]
    prompt = list(range(1, 30)) + list(range(1, 15))
    want = _greedy_reference(tm, prompt, 10)
    eng = pt.ContinuousBatchingEngine(tm, max_batch=2, page_size=16,
                                      pages_per_seq=8, prompt_lookup=3)
    r_greedy = eng.submit(list(prompt), 10)
    r_sampled = eng.submit(list(prompt), 10, temperature=0.9)
    eng.run()
    assert r_greedy.generated == want.generated
    assert len(r_sampled.generated) == len(r_sampled.token_logprobs) == 10
    assert eng.pool.n_free == eng.pool.total
    assert eng.lookup_stats[1] > 0


def test_quantized_pools_compose_with_prompt_lookup(target):
    """An int8 page pool under prompt-lookup waves lands what the plain int8
    engine lands."""
    tm = target[1]
    prompt = [5, 9, 2, 5, 9, 2, 5, 9, 2]
    want = _greedy_reference(tm, prompt, 10, dtype=torch.int8)
    got = _greedy_reference(tm, prompt, 10, dtype=torch.int8,
                            prompt_lookup=3)
    assert got.generated == want.generated


def test_engine_fuzz_prompt_lookup(target):
    """Lookup engine against plain engine over a random request mix (seed 0
    of the JAX fuzz): identical tokens and logprobs."""
    tm = target[1]
    rng = np.random.default_rng(900)
    max_batch = int(rng.integers(1, 4))
    prompts = []
    for _ in range(int(rng.integers(3, 6))):
        if rng.random() < 0.5:
            pat = list(rng.integers(1, 8, size=int(rng.integers(2, 5))))
            p = (pat * 6)[:int(rng.integers(6, 20))]
        else:
            p = list(rng.integers(1, 60, size=int(rng.integers(1, 20))))
        eos = int(rng.integers(1, 60)) if rng.random() < 0.3 else None
        prompts.append((p, int(rng.integers(4, 20)), eos))
    results = []
    for lookup in (0, 3):
        eng = pt.ContinuousBatchingEngine(tm, max_batch=max_batch,
                                          page_size=8, pages_per_seq=6,
                                          prompt_lookup=lookup)
        reqs = [eng.submit(p, m, eos_id=e) for p, m, e in prompts]
        eng.run()
        assert eng.pool.n_free == eng.pool.total
        results.append({r.uid: (r.generated,
                                [round(l, 4) for l in r.token_logprobs])
                        for r in reqs})
    assert results[0] == results[1]


# -- _spec_accept_sampled ----------------------------------------------------------


def _accept_both(logits, proposed, temps, seeds, pos0):
    got = teng._spec_accept_sampled(*(torch.from_numpy(np.ascontiguousarray(a))
                                      for a in (logits, proposed, temps,
                                                seeds, pos0)))
    want = jeng._spec_accept_sampled(*(jnp.asarray(a) for a in
                                       (logits, proposed, temps, seeds, pos0)))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_spec_accept_sampled_exact_marginals():
    """4000 rows of one (logits, proposal): the port lands JAX's tokens, and
    the landed tokens' marginals are the temperature-scaled target's within
    4 sigma (the speculative-sampling theorem for a point-mass draft)."""
    b = 4000
    base = np.float32([[2.0, 1.0, 0.0, -1.0], [0.5, 0.5, 1.5, -0.5],
                       [1.0, 1.0, 1.0, 1.0]])
    logits = np.broadcast_to(base, (b, 3, 4))
    proposed = np.broadcast_to(np.int32([1, 2]), (b, 2))
    (n_acc, toks, lps), want = _accept_both(
        logits, proposed, np.full(b, 0.7, np.float32),
        np.arange(b, dtype=np.int32), np.zeros(b, np.int32))
    np.testing.assert_array_equal(n_acc, want[0])
    np.testing.assert_array_equal(toks, want[1])
    np.testing.assert_allclose(lps, want[2], atol=1e-5)

    def check(sel, pos, row):
        p = np.exp(row / 0.7) / np.exp(row / 0.7).sum()
        for x in range(4):
            emp = float((toks[sel, pos] == x).mean())
            sig = max((p[x] * (1 - p[x]) / max(sel.sum(), 1)) ** 0.5, 1e-4)
            assert abs(emp - p[x]) < 4 * sig + 1e-3, (pos, x, emp, p[x])

    check(np.ones(b, bool), 0, base[0])
    accepted = n_acc >= 1
    assert 0.05 < accepted.mean() < 0.95
    check(accepted, 1, base[1])
    lsm = base[0] - np.log(np.exp(base[0]).sum())
    np.testing.assert_allclose(lps[:, 0], lsm[toks[:, 0]], atol=1e-5)


def test_spec_accept_sampled_greedy_rows_deterministic():
    """Temperature-0 rows take argmax acceptance: a matching proposal is
    accepted whole plus the bonus argmax; a mismatch lands the argmax."""
    row = np.float32([[0, 3, 0, 0], [0, 0, 3, 0], [3, 0, 0, 0]])
    logits = np.stack([row, row])
    (n_acc, toks, _), want = _accept_both(
        logits, np.int32([[1, 2], [3, 2]]), np.zeros(2, np.float32),
        np.arange(2, dtype=np.int32), np.zeros(2, np.int32))
    assert n_acc.tolist() == want[0].tolist() == [2, 0]
    assert toks[0].tolist() == [1, 2, 0] and toks[1, 0] == 1
