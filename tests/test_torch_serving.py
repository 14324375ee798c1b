"""The port's ContinuousBatchingEngine against the JAX engine on the same
weights.

Both engines serve the same requests with ``collect_logits=True``; every
consumed position's next-token logits must match to 1e-4 (as
tests/test_serving.py holds the JAX engine to its dense forward), greedy
tokens must be identical over a short horizon (random-init models have
near-ties further out), and every page must return to the pool.
"""

import jax
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu.serving import ContinuousBatchingEngine as JaxEngine

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    jm = ft.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2, n_kv_head=2,
                      key=jax.random.PRNGKey(0)).eval()
    tm = pt.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                      n_kv_head=2, device="cpu").eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


def _serve(engine_cls, model, prompts, max_new, **kw):
    eng = engine_cls(model, **kw)
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    assert all(r.done and not r.truncated for r in reqs)
    assert eng.pool.n_free == eng.pool.total      # every page returned
    return reqs


# name -> (prompt lengths, max_new_tokens, engine settings):
# more requests than slots (mid-flight admission into freed pages) with
# trajectories crossing 8-token pages; prompts longer than prefill_chunk=8
# (chunked prefill through forward_extend_paged)
CASES = {
    "midflight_page_crossing": ([5, 11, 3, 17, 9], 4,
                                dict(max_batch=2, page_size=8,
                                     pages_per_seq=4)),
    "chunked_prefill": ([21, 6, 13], 3,
                        dict(max_batch=3, page_size=4, pages_per_seq=8,
                             prefill_chunk=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine(models, case):
    jm, tm = models
    lens, max_new, kw = CASES[case]
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 64, size=n)) for n in lens]
    want = _serve(JaxEngine, jm, prompts, max_new, collect_logits=True, **kw)
    got = _serve(pt.ContinuousBatchingEngine, tm, prompts, max_new,
                 collect_logits=True, **kw)
    for g, w in zip(got, want):
        assert g.generated == w.generated
        assert len(g.logits) == len(w.logits) == len(g.prompt) + max_new - 1
        np.testing.assert_allclose(np.stack(g.logits), np.stack(w.logits),
                                   **TOL)
        np.testing.assert_allclose(g.token_logprobs, w.token_logprobs, **TOL)


@pytest.fixture(scope="module")
def quantized_models(models):
    """The int8-weight pair: both packages quantize the same weights (their
    payloads are bit-identical, tests/test_torch_quant.py)."""
    from flashattn_tpu.ops.quant import quantize_model_weights

    jm, tm = models
    return (quantize_model_weights(jm, jax.numpy.int8),
            pt.quantize_model_weights(tm, torch.int8))


@pytest.mark.parametrize("pool", ["int8", "fp8"])
@pytest.mark.parametrize("case", list(CASES))
def test_quantized_engine_matches_jax_engine(quantized_models, case, pool):
    """int8 weights over an int8 / fp8 page pool: identical greedy tokens
    and logits to 1e-3 (the pools' payloads round from K/V that the two
    frameworks compute to f32 rounding apart)."""
    jm, tm = quantized_models
    lens, max_new, kw = CASES[case]
    jdt, tdt = ((jax.numpy.int8, torch.int8) if pool == "int8"
                else (jax.numpy.float8_e4m3fn, torch.float8_e4m3fn))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 64, size=n)) for n in lens]
    want = _serve(JaxEngine, jm, prompts, max_new, collect_logits=True,
                  dtype=jdt, **kw)
    got = _serve(pt.ContinuousBatchingEngine, tm, prompts, max_new,
                 collect_logits=True, dtype=tdt, **kw)
    for g, w in zip(got, want):
        assert g.generated == w.generated
        np.testing.assert_allclose(np.stack(g.logits), np.stack(w.logits),
                                   atol=1e-3, rtol=0)


def test_sliding_window_engine_matches_jax_engine():
    """A windowed model releases pages behind the window mid-request (the
    rolling KV buffer) — logits still match and every page returns."""
    jm = ft.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2, window=6,
                      key=jax.random.PRNGKey(1)).eval()
    tm = pt.DecoderLM(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                      window=6, device="cpu").eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, 64, size=n)) for n in (14, 5)]
    kw = dict(max_batch=2, page_size=4, pages_per_seq=8, prefill_chunk=8,
              collect_logits=True)
    want = _serve(JaxEngine, jm, prompts, 9, **kw)
    got = _serve(pt.ContinuousBatchingEngine, tm, prompts, 9, **kw)
    for g, w in zip(got, want):
        assert g.generated == w.generated
        np.testing.assert_allclose(np.stack(g.logits), np.stack(w.logits),
                                   **TOL)


def test_multi_step_decode_matches_jax_engine(models):
    """steps_per_dispatch=8: K decode steps back to back without a host
    sync — same tokens and logprobs as the JAX engine's device scan."""
    jm, tm = models
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, 64, size=n)) for n in (7, 12)]
    kw = dict(max_batch=2, page_size=16, pages_per_seq=2,
              steps_per_dispatch=8)
    want = _serve(JaxEngine, jm, prompts, 6, **kw)
    got = _serve(pt.ContinuousBatchingEngine, tm, prompts, 6, **kw)
    for g, w in zip(got, want):
        assert g.generated == w.generated
        np.testing.assert_allclose(g.token_logprobs, w.token_logprobs, **TOL)


def test_engine_matches_dense_forward(models):
    """Teacher-forced trajectories (the prompt is the whole trajectory): the
    engine's per-position logits equal one dense forward of the port."""
    _, tm = models
    rng = np.random.default_rng(2)
    trajectories = [list(rng.integers(1, 64, size=n)) for n in (9, 30, 4)]
    reqs = _serve(pt.ContinuousBatchingEngine, tm, trajectories, 1,
                  max_batch=2, page_size=8, pages_per_seq=4,
                  collect_logits=True)
    with torch.inference_mode():
        for t, r in zip(trajectories, reqs):
            want = tm(torch.tensor([t]))[0].numpy()
            np.testing.assert_allclose(np.stack(r.logits), want, **TOL)


def test_eos_stop_and_cancel(models):
    _, tm = models
    eng = pt.ContinuousBatchingEngine(tm, max_batch=2, page_size=8,
                                      pages_per_seq=4)
    probe = eng.submit([3, 1, 4], 6)
    eng.run()
    first, second = probe.generated[:2]
    eos = eng.submit([3, 1, 4], 6, eos_id=first)
    stop = eng.submit([3, 1, 4], 6, stop=[[first, second]])
    queued = eng.submit([2, 7], 6)
    assert eng.cancel(queued) and queued.done and not queued.generated
    eng.run()
    assert eos.generated == [first]
    assert stop.generated == [first, second]
    assert eng.pool.n_free == eng.pool.total


def test_unported_engine_options_raise(models):
    """No engine option is left to port: tensor-parallel serving (mesh=,
    A7) shards the model over the mesh instead of raising
    NotImplementedError (its parity with JAX's TP engine:
    tests/test_torch_parallel.py).  A mesh that is not a device mesh is
    refused up front."""
    _, tm = models
    with pytest.raises(TypeError, match="device mesh"):
        pt.ContinuousBatchingEngine(tm, mesh=object())
