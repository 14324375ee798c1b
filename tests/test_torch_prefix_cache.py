"""The port's prefix cache against the JAX engine's and against an uncached
engine (mirrors tests/test_prefix_cache.py).

Full prompt pages are content-addressed and shared read-only across
requests; a request whose prompt prefix was served before attaches to the
cached pages and prefills only the suffix through the chunked path.  The
port must land the same tokens as the JAX engine (and as an uncached
engine), allocate and evict the same pages, and keep the pool's books:
every page is free or held by the cache alone once requests finish.
"""

import jax
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu.serving import ContinuousBatchingEngine as JaxEngine

torch.set_num_threads(1)

V = 64


@pytest.fixture(scope="module")
def models():
    jm = ft.DecoderLM(V, 32, 4, 512, p_dropout=0.0, n_layer=2,
                      key=jax.random.PRNGKey(0)).eval()
    tm = pt.DecoderLM(V, 32, 4, 512, p_dropout=0.0, n_layer=2,
                      device="cpu").eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


def _mkengine(model, cls=pt.ContinuousBatchingEngine, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("pages_per_seq", 8)
    kw.setdefault("enable_prefix_cache", True)
    return cls(model, **kw)


def _nocache_generated(model, prompt, max_new, **kw):
    eng = _mkengine(model, enable_prefix_cache=False, **kw)
    r = eng.submit(list(prompt), max_new)
    eng.run()
    return r.generated


def _books_balance(eng):
    cached = set(eng._prefix_cache.values())
    assert all(eng._page_refs[p] == 1 for p in cached)
    assert eng.pool.n_free + len(cached) == eng.pool.total


def test_prefix_cache_matches_jax_engine(models):
    """One engine of each package serves the same sequence of requests:
    a prompt, the same prompt grown (a hit on its 3 full pages), a prompt
    diverging after 2 pages, and a sampled request on a cached prefix.
    Tokens, logprobs, the cache's pages, the refcounts and stats() agree."""
    jm, tm = models
    rng = np.random.default_rng(0)
    prompt = list(rng.integers(1, 60, 13))
    seq = [(prompt, 5, {}), (prompt + [7, 9], 6, {}),
           (prompt[:8] + [21, 22, 23], 4, {}),
           (prompt + [3], 6, dict(temperature=0.9, seed=11))]
    runs = []
    for cls, model in ((JaxEngine, jm), (pt.ContinuousBatchingEngine, tm)):
        eng = _mkengine(model, cls, max_batch=1, steps_per_dispatch=1)
        reqs = []
        for p, n, kw in seq:
            reqs.append(eng.submit(list(p), n, **kw))
            eng.run()
        runs.append((reqs, eng))
    (want, jeng), (got, eng) = runs
    for g, w in zip(got, want):
        assert g.generated == w.generated
        np.testing.assert_allclose(g.token_logprobs, w.token_logprobs,
                                   atol=1e-4, rtol=1e-4)
    assert eng._prefix_cache == jeng._prefix_cache
    assert eng._page_refs == jeng._page_refs
    assert eng.stats() == jeng.stats()
    assert eng.stats()["prefix_cache_pages"] > 0
    _books_balance(eng)


def test_cache_hit_matches_uncached(models):
    """A second request with the same prompt prefix attaches the cached pages,
    skips their prefill and generates what an uncached engine does."""
    _, tm = models
    rng = np.random.default_rng(0)
    prompt = list(rng.integers(1, 60, 13))           # 3 full pages + tail
    eng = _mkengine(tm)
    r1 = eng.submit(prompt, 5)
    eng.run()
    assert eng._prefix_cache
    n_cached = len(eng._prefix_cache)
    r2 = eng.submit(prompt + [7, 9], 6)
    eng.run()
    assert len(eng._prefix_cache) >= n_cached
    assert r1.generated == _nocache_generated(tm, prompt, 5)
    assert r2.generated == _nocache_generated(tm, prompt + [7, 9], 6)
    _books_balance(eng)


def test_divergent_prefix_shares_only_common_pages(models):
    _, tm = models
    rng = np.random.default_rng(1)
    common = list(rng.integers(1, 60, 8))            # 2 full pages
    eng = _mkengine(tm)
    r1 = eng.submit(common + [11, 12, 13], 4)
    eng.run()
    r2 = eng.submit(common + [21, 22, 23], 4)
    eng.run()
    assert r1.generated == _nocache_generated(tm, common + [11, 12, 13], 4)
    assert r2.generated == _nocache_generated(tm, common + [21, 22, 23], 4)


def test_eviction_under_pressure(models):
    """A full cache must not block admissions: cache-only pages evict LRU and
    the pool's books balance."""
    _, tm = models
    rng = np.random.default_rng(2)
    eng = _mkengine(tm, max_batch=1, pages_per_seq=4, total_pages=6)
    outs = []
    for _ in range(6):
        r = eng.submit(list(rng.integers(1, 60, 9)), 4)
        eng.run()
        outs.append(r)
    assert all(r.done and not r.truncated for r in outs)
    _books_balance(eng)


def test_cache_equals_nocache_outputs(models):
    _, tm = models
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, 60, n)) for n in (13, 13, 9)]

    def run(flag):
        eng = _mkengine(tm, enable_prefix_cache=flag)
        out = []
        for p in prompts:
            r = eng.submit(p, 8)
            eng.run()
            out.append(r.generated)
        return out

    assert run(True) == run(False)


def test_prefix_cache_composes_with_prompt_lookup(models):
    """Cached prefix pages + prompt-lookup waves: the second request attaches
    to the first's pages, lookup waves write only past the shared prefix,
    and the output equals a plain engine's."""
    _, tm = models
    prompt = [5, 9, 2, 5, 9, 2, 5, 9, 2, 5, 9, 2]   # 3 full pages at size 4
    want = _nocache_generated(tm, prompt, 10)
    eng = _mkengine(tm, prompt_lookup=3)
    r1 = eng.submit(list(prompt), 10)
    eng.run()
    r2 = eng.submit(list(prompt), 10)
    eng.run()
    assert r1.generated == want
    assert r2.generated == want


def test_prefix_cache_refusals(models):
    """The prefix cache is off, with a message, under a sliding window or
    collect_logits (as the JAX engine refuses it)."""
    _, tm = models
    assert not pt.ContinuousBatchingEngine(
        tm, enable_prefix_cache=True, collect_logits=True).enable_prefix_cache
    windowed = pt.DecoderLM(V, 32, 4, 64, p_dropout=0.0, n_layer=1, window=8,
                            device="cpu")
    assert not pt.ContinuousBatchingEngine(
        windowed, enable_prefix_cache=True).enable_prefix_cache
