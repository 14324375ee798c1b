"""The port's engine sampling (temperature, top-k, top-p, min-p, seeds and the
repetition / frequency / presence penalties) against the JAX engine's.

The port draws its randomness with JAX's threefry in integer torch ops, so
the uniforms equal ``jax.random.uniform`` bit for bit and the Gumbel noise
equals ``jax.random.gumbel`` to 1e-6 (``log``'s last bit).  Sampled requests
are then token-identical to the JAX engine's on the same weights and seeds;
logprobs agree to 1e-4, and ``stats()`` dicts are equal.  The rest mirrors
tests/test_serving.py and tests/test_serving_fuzz.py on the port alone:
structure (support inside top-k / top-p / min-p), determinism per seed,
batch independence, and the penalties against a dense host loop.
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
from flashattn_tpu_torch.serving import _threefry
from flashattn_tpu_torch.serving import engine as teng

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
V = 64


@pytest.fixture(scope="module")
def models():
    jm = ft.DecoderLM(V, 32, 4, 256, p_dropout=0.0, n_layer=2, n_kv_head=2,
                      key=jax.random.PRNGKey(0)).eval()
    tm = pt.DecoderLM(V, 32, 4, 256, p_dropout=0.0, n_layer=2, n_kv_head=2,
                      device="cpu").eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


# -- threefry --------------------------------------------------------------------


def _jax_key(seed, pos, salt):
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), pos),
                           salt)
    return k, np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("v", [64, 1000])
@pytest.mark.parametrize("seed,pos,salt", [(12345, 77, 0), (0, 0, 1),
                                           (2**31 - 1, 5000, 2), (42, 3, 0)])
def test_threefry_draws_match_jax(seed, pos, salt, v):
    """Keys and uniforms bit for bit, the scalar acceptance uniform too;
    Gumbel noise within 1e-6."""
    jkey, jwords = _jax_key(seed, pos, salt)
    key = teng._row_keys(torch.tensor([seed]), torch.tensor([pos]), salt)
    assert [int(key[0][0]), int(key[1][0])] == jwords.tolist()
    want = np.asarray(jax.random.uniform(jkey, (v,)))
    got = _threefry.uniform(key, v)[0].numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    scalar = np.float32(jax.random.uniform(jkey))
    assert _threefry.uniform(key, 1)[0, 0].item() == scalar
    g_want = np.asarray(jax.random.gumbel(jkey, (v,), jnp.float32))
    g_got = teng._row_gumbel(torch.tensor([seed]), torch.tensor([pos]), salt,
                             v)[0].numpy()
    np.testing.assert_allclose(g_got, g_want, atol=1e-6, rtol=0)


# -- _sample_tokens against JAX's -----------------------------------------------------


def _settings(b, rng, penalties):
    logits = (rng.standard_normal((b, V)) * 3).astype(np.float32)
    s = dict(temps=rng.choice([0.0, 0.7, 1.5], b).astype(np.float32),
             topks=rng.choice([0, 1, 5], b).astype(np.int32),
             topps=rng.choice([0.0, 0.5, 0.9], b).astype(np.float32),
             seeds=rng.integers(0, 2**31 - 1, b).astype(np.int32),
             pos=rng.integers(0, 4096, b).astype(np.int32))
    kw = dict(minps=rng.choice([0.0, 0.05, 0.3], b).astype(np.float32))
    if penalties:
        presence = rng.integers(0, 3, (b, V)) * (rng.random((b, V)) < 0.2)
        kw.update(presence=presence.astype(np.float32),
                  reps=rng.choice([1.0, 1.3, 2.0], b).astype(np.float32),
                  freqs=rng.choice([0.0, 0.5], b).astype(np.float32),
                  press=rng.choice([0.0, 0.4], b).astype(np.float32))
    return logits, s, kw


def _both_samplers(logits, s, kw, greedy_only=False):
    order = ("temps", "topks", "topps", "seeds", "pos")
    want = jeng._sample_tokens(jnp.asarray(logits),
                               *(jnp.asarray(s[n]) for n in order),
                               greedy_only=greedy_only,
                               **{n: jnp.asarray(a) for n, a in kw.items()})
    got = teng._sample_tokens(torch.from_numpy(logits),
                              *(torch.from_numpy(s[n]) for n in order),
                              greedy_only=greedy_only,
                              **{n: torch.from_numpy(a) for n, a in kw.items()})
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("greedy_only", [False, True])
@pytest.mark.parametrize("penalties", [False, True])
def test_sample_tokens_matches_jax(penalties, greedy_only):
    """96 rows of mixed temperature / top-k / top-p / min-p / seed / position
    (and penalties): the same tokens as JAX's sampler."""
    rng = np.random.default_rng(1 + penalties)
    logits, s, kw = _settings(96, rng, penalties)
    got, want = _both_samplers(logits, s, kw, greedy_only)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _draws(logits, temps, topks, topps, n, **kw):
    """n draws per row in one call: row r of draw s sits at position s (the
    loop of the JAX tests, batched), seed 0.  Returns (port, jax) tokens
    (n, B)."""
    b = logits.shape[0]
    rep = lambda a: np.tile(np.asarray(a), (n,) + (1,) * (np.ndim(a) - 1))
    s = dict(temps=rep(temps), topks=rep(topks), topps=rep(topps),
             seeds=np.zeros(n * b, np.int32),
             pos=np.repeat(np.arange(n, dtype=np.int32), b))
    got, want = _both_samplers(rep(logits), s,
                               {k: rep(a) for k, a in kw.items()})
    return got.reshape(n, b), want.reshape(n, b)


def test_sample_tokens_top_p_nucleus():
    """tiny top_p collapses to greedy, top_p 0 is off, top_p 0.95 keeps the
    two dominant tokens only (tests/test_serving.py)."""
    logits = np.tile(np.float32([5.0, 4.9, 0.0, -1.0, -2.0]), (3, 1))
    got, want = _draws(logits, np.ones(3, np.float32), np.zeros(3, np.int32),
                       np.float32([1e-4, 0.0, 0.95]), 200)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == 0).all()
    assert (got[:, 1] >= 1).any()
    assert (got[:, 2] < 2).all() and (got[:, 2] == 1).any()


def test_sample_tokens_top_k_top_p_sequential():
    """top_p over the RENORMALISED top-k survivors: top-2 of [.5 .2 .15 .15]
    renormalise to [.714 .286], so top_p 0.6 keeps token 0 only."""
    logits = np.log(np.float32([[0.50, 0.20, 0.15, 0.15]]))
    got, want = _draws(logits, np.float32([1.0]), np.int32([2]),
                       np.float32([0.6]), 100)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()


def test_sample_tokens_min_p():
    """min_p 0.5 keeps p >= 0.5 p_max: {0, 1} of [.5 .3 .15 .05]; min_p 0
    explores the tail."""
    logits = np.log(np.float32([[0.5, 0.3, 0.15, 0.05]] * 2))
    got, want = _draws(logits, np.ones(2, np.float32), np.zeros(2, np.int32),
                       np.zeros(2, np.float32), 300,
                       minps=np.float32([0.5, 0.0]))
    np.testing.assert_array_equal(got, want)
    assert set(got[:, 0].tolist()) == {0, 1}
    assert len(set(got[:, 1].tolist())) >= 3


def test_sample_tokens_frequency_presence_unit():
    """The additive rule: token 0 carries two counts, 3.0 - 0.4 - 0.3 < 2.5
    moves the argmax to token 1; a zero-penalty row is untouched."""
    logits = np.float32([[3.0, 2.5, 0.0], [3.0, 2.5, 0.0]])
    s = dict(temps=np.zeros(2, np.float32), topks=np.zeros(2, np.int32),
             topps=np.zeros(2, np.float32), seeds=np.zeros(2, np.int32),
             pos=np.zeros(2, np.int32))
    kw = dict(presence=np.float32([[2, 0, 0], [2, 0, 0]]),
              reps=np.ones(2, np.float32), freqs=np.float32([0.2, 0.0]),
              press=np.float32([0.3, 0.0]))
    got, want = _both_samplers(logits, s, kw, greedy_only=True)
    assert got.tolist() == want.tolist() == [1, 0]


# -- the engine against the JAX engine --------------------------------------------

# one engine serves every feature at once (sampling is per request, so each
# request's tokens do not depend on its neighbours): greedy, the engine-seed
# stream, explicit seeds, top-k, top-p, top-k then top-p, min-p, each
# penalty, penalties under sampling, and a prompt over prefill_chunk
MIX = [
    ([3, 9, 27], 10, {}),
    ([3, 9, 27], 10, dict(temperature=1.5)),
    ([3, 9, 27], 10, dict(temperature=1.5, seed=7)),
    ([3, 9, 27], 10, dict(temperature=1.5, top_k=3)),
    ([5, 9, 2], 12, dict(temperature=0.9, top_p=0.8, seed=1)),
    ([5, 9, 2], 12, dict(temperature=0.9, top_k=8, top_p=0.6, seed=2)),
    ([7, 1, 3, 4], 8, dict(temperature=1.0, min_p=0.1, seed=42)),
    ([5, 9, 2], 12, dict(repetition_penalty=1.5)),
    ([5, 9, 2], 12, dict(frequency_penalty=0.8, presence_penalty=0.6)),
    ([11, 30], 10, dict(temperature=1.2, repetition_penalty=1.3,
                        frequency_penalty=0.3, seed=5)),
    ([4, 8, 15, 16, 23, 42, 1, 2, 3, 5, 8, 13, 21], 6,
     dict(temperature=0.8, seed=9)),
]
# one step a dispatch: each of the JAX engine's K-step variants compiles on
# its own, and the port's K-step loop is held to its single step below
# (test_sampled_output_independent_of_batch_composition,
# test_engine_fuzz_chunked_with_penalties)
MIX_ENGINE = dict(max_batch=4, page_size=8, pages_per_seq=4,
                  steps_per_dispatch=1, prefill_chunk=8, seed=777)


def _serve(engine_cls, model, reqs, **kw):
    eng = engine_cls(model, **kw)
    out = [eng.submit(p, n, **rk) for p, n, rk in reqs]
    eng.run()
    assert all(r.done and not r.truncated for r in out)
    assert eng.pool.n_free == eng.pool.total
    return out, eng


@pytest.fixture(scope="module")
def mix_runs(models):
    jm, tm = models
    return (_serve(JaxEngine, jm, MIX, **MIX_ENGINE),
            _serve(pt.ContinuousBatchingEngine, tm, MIX, **MIX_ENGINE))


def test_sampled_engine_matches_jax_engine(mix_runs):
    (want, _), (got, _) = mix_runs
    for g, w in zip(got, want):
        assert g.generated == w.generated, (g.uid, g.temperature)
        np.testing.assert_allclose(g.token_logprobs, w.token_logprobs, **TOL)


def test_engine_stats_snapshot(mix_runs):
    (want, jeng_), (got, eng) = mix_runs
    s = eng.stats()
    assert s == jeng_.stats()
    assert s["finished_requests"] == len(MIX)
    assert s["active_requests"] == 0 and s["queued_requests"] == 0
    assert s["generated_tokens"] == sum(len(r.generated) for r in got)
    assert s["pages_free"] == s["pages_total"]


def _run_one(tm, prompt, n, engine_seed=0, collect_logits=False, **kw):
    eng = pt.ContinuousBatchingEngine(tm, max_batch=2, page_size=16,
                                      pages_per_seq=4, seed=engine_seed,
                                      collect_logits=collect_logits)
    r = eng.submit(prompt, n, **kw)
    eng.run()
    return r


def test_sampling_temperature_and_topk(models):
    """temperature 0 ignores the seed; temperature > 0 is seed-deterministic
    and diverges across seeds; top_k keeps each token inside its step's
    top-k set (tests/test_serving.py)."""
    _, tm = models
    prompt = [3, 9, 27]
    assert _run_one(tm, prompt, 10).generated == _run_one(
        tm, prompt, 10, engine_seed=1).generated
    s1 = _run_one(tm, prompt, 10, temperature=1.5)
    assert s1.generated == _run_one(tm, prompt, 10,
                                    temperature=1.5).generated
    assert _run_one(tm, prompt, 10, engine_seed=7,
                    temperature=1.5).generated != s1.generated
    r = _run_one(tm, prompt, 10, collect_logits=True, temperature=1.5,
                 top_k=3)
    for row, tok in zip(r.logits[len(prompt) - 1:], r.generated):
        assert tok in np.argsort(row)[::-1][:3]


def test_sampled_output_independent_of_batch_composition(models):
    """Randomness is f(request seed, position): alone, beside neighbours at
    another slot, or through the K-step loop, a sampled request lands the
    same tokens."""
    _, tm = models
    prompt, n_new = [5, 9, 2], 12
    alone = _run_one(tm, prompt, n_new, temperature=0.9, seed=42)
    eng = pt.ContinuousBatchingEngine(tm, max_batch=4, page_size=16,
                                      pages_per_seq=4, seed=777)
    eng.submit([7, 1, 3, 4], 8, temperature=0.5)
    batched = eng.submit(prompt, n_new, temperature=0.9, seed=42)
    eng.submit([11, 30], 10)
    eng.run()
    assert batched.generated == alone.generated
    np.testing.assert_allclose(batched.token_logprobs, alone.token_logprobs,
                               **TOL)
    eng2 = pt.ContinuousBatchingEngine(tm, max_batch=2, page_size=16,
                                       pages_per_seq=4, steps_per_dispatch=4)
    chunked = eng2.submit(prompt, n_new, temperature=0.9, seed=42)
    eng2.run()
    assert chunked.generated == alone.generated


def test_sampled_seeds_differ(models):
    _, tm = models
    outs = {tuple(_run_one(tm, [5, 9, 2], 10, temperature=1.5,
                           seed=s).generated) for s in range(4)}
    assert len(outs) >= 2


def _dense_penalised_greedy(tm, prompt, n_new, rule):
    """Greedy decoding by full dense forwards, applying ``rule(logits,
    seen)`` to each step's logits on the host."""
    seen = np.zeros((V,), np.float64)
    np.add.at(seen, prompt, 1.0)
    toks, out = list(prompt), []
    with torch.inference_mode():
        for _ in range(n_new):
            row = tm(torch.tensor([toks]))[0, -1].double().numpy()
            nxt = int(np.argmax(rule(row, seen)))
            out.append(nxt)
            toks.append(nxt)
            seen[nxt] += 1
    return out


@pytest.mark.parametrize("case", ["repetition", "frequency_presence"])
def test_penalty_matches_dense_reference(models, case):
    """Greedy + penalties through the engine (the K-step loop carries the
    presence counts on the device) equal a dense host loop applying the HF
    rule / logits -= f count + p (count > 0); the penalty changes the
    output (tests/test_serving.py)."""
    _, tm = models
    prompt, n_new = [5, 9, 2], 12
    if case == "repetition":
        kw = dict(repetition_penalty=1.5)
        rule = lambda l, s: np.where(
            s > 0, np.where(l > 0, l / 1.5, l * 1.5), l)
    else:
        kw = dict(frequency_penalty=0.8, presence_penalty=0.6)
        rule = lambda l, s: l - 0.8 * s - 0.6 * (s > 0)
    eng = pt.ContinuousBatchingEngine(tm, max_batch=1, page_size=16,
                                      pages_per_seq=4, steps_per_dispatch=4)
    req = eng.submit(prompt, n_new, **kw)
    eng.run()
    expect = _dense_penalised_greedy(tm, prompt, n_new, rule)
    assert req.generated == expect
    assert _run_one(tm, prompt, n_new).generated != expect


# -- tests/test_serving_fuzz.py ------------------------------------------------------


def test_chunked_sampling_topk1_matches_greedy(models):
    """temperature > 0 with top_k 1 is the argmax whatever the key: the
    sampling path through the K-step loop agrees with greedy."""
    _, tm = models
    prompts = [[3, 14, 15, 9], [26, 5], [35, 8, 9, 7, 9, 3]]

    def run(temperature, top_k):
        eng = pt.ContinuousBatchingEngine(tm, max_batch=4, page_size=8,
                                          pages_per_seq=4,
                                          steps_per_dispatch=8, seed=7)
        reqs = [eng.submit(p, 20, temperature=temperature, top_k=top_k)
                for p in prompts]
        eng.run()
        return [r.generated for r in reqs]

    assert run(1.0, 1) == run(0.0, None)


def test_engine_fuzz_chunked_with_penalties(models):
    """K-step decode against per-token decode under random penalty mixes
    (seed 0 of the JAX fuzz): identical tokens and logprobs."""
    _, tm = models
    rng = np.random.default_rng(500)
    max_batch = int(rng.integers(1, 4))
    prompts = []
    for _ in range(int(rng.integers(3, 6))):
        plen = int(rng.integers(1, 20))
        kw = {}
        mode = rng.integers(0, 4)
        if mode == 1:
            kw["repetition_penalty"] = float(rng.uniform(1.1, 2.0))
        elif mode == 2:
            kw["frequency_penalty"] = float(rng.uniform(0.1, 1.0))
            kw["presence_penalty"] = float(rng.uniform(0.0, 1.0))
        elif mode == 3:
            kw["repetition_penalty"] = float(rng.uniform(1.1, 1.5))
            kw["frequency_penalty"] = float(rng.uniform(0.1, 0.5))
        prompts.append((list(rng.integers(1, 60, size=plen)),
                        int(rng.integers(4, 16)), kw))
    results = []
    for spd in (1, 4):
        reqs, _ = _serve(pt.ContinuousBatchingEngine, tm, prompts,
                         max_batch=max_batch, page_size=8, pages_per_seq=4,
                         steps_per_dispatch=spd)
        results.append({r.uid: (r.generated,
                                [round(l, 4) for l in r.token_logprobs])
                        for r in reqs})
    assert results[0] == results[1]


def test_engine_fuzz_random_cancels(models):
    """Random cancels mid-flight (seed 0 of the JAX fuzz), through the
    engine call and the bare flag: pages balance, survivors finish."""
    _, tm = models
    rng = np.random.default_rng(300)
    page_size = int(rng.choice([4, 8, 16]))
    pages_per_seq = int(rng.integers(2, 5))
    max_batch = int(rng.integers(1, 4))
    capacity = page_size * pages_per_seq
    eng = pt.ContinuousBatchingEngine(
        tm, max_batch=max_batch, page_size=page_size,
        pages_per_seq=pages_per_seq,
        steps_per_dispatch=int(rng.choice([1, 4])))
    reqs = []
    for _ in range(int(rng.integers(4, 9))):
        plen = int(rng.integers(1, max(2, capacity - 2)))
        reqs.append(eng.submit(rng.integers(0, 64, size=plen).tolist(),
                               int(rng.integers(1, 8)),
                               on_token=lambda r, new: None))
    cancelled = 0
    for _ in range(200):
        if not eng.step():
            break
        if rng.random() < 0.4 and cancelled < len(reqs):
            victim = reqs[int(rng.integers(0, len(reqs)))]
            if not victim.done:
                if rng.random() < 0.5:
                    eng.cancel(victim)
                else:
                    victim.cancelled = True
                cancelled += 1
    else:
        pytest.fail("engine did not drain in 200 steps")
    assert all(r.done for r in reqs)
    assert eng.pool.n_free == eng.pool.total, "leaked KV pages"
    for r in reqs:
        if r.cancelled:
            assert len(r.generated) <= r.max_new_tokens
        else:
            assert (len(r.generated) == r.max_new_tokens or r.truncated
                    or len(r.prompt) + len(r.generated) >= capacity)
