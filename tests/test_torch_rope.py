"""The port's rotary position embeddings against the JAX package's: the ops,
a RoPE DecoderLM's dense forward under each attention path, its cached
decode and its paged engine, on the same weights (``load_jax_params``,
dropout off) and numpy-seeded inputs.

Tolerances: f32 rotation within 2e-6 * max |x|; bf16 at least 99% of the
elements bit for bit and every one within one bf16 ulp of its value; model
logits 1e-5 abs (dense forward, cached decode), the engine's tokens
identical and its logits 1e-4 (tests/test_rope.py holds the JAX engine to
its dense forward at 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu.ops import rope as jrope
from flashattn_tpu.serving import ContinuousBatchingEngine as JaxEngine
from flashattn_tpu_torch.ops import rope as trope

torch.set_num_threads(1)

V = 64
POSITIONS = {
    "scalar": lambda rng: 37,
    "seq": lambda rng: np.arange(9, dtype=np.int32) * 113,
    "per_row": lambda rng: rng.integers(0, 5000, (2, 9)).astype(np.int32),
}


def _bf16_bits(a):
    return np.asarray(a, np.float32).view(np.uint32) >> 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(POSITIONS))
def test_apply_rope_matches_jax(case, dtype):
    """Scalar (one decode step), (S,) and (B, k) positions against x of
    (B, H, S, D); the angle tables too, in f32."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 9, 32)) * 4).astype(np.float32)
    pos = POSITIONS[case](rng)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jrope.apply_rope(jx, jnp.asarray(pos), 500.0)
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tpos = pos if np.ndim(pos) == 0 else torch.from_numpy(pos)
    got = trope.apply_rope(tx, tpos, 500.0)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 * np.abs(x).max())
        for g, w in zip(trope.rope_angles(tpos, 32, 500.0),
                        jrope.rope_angles(jnp.asarray(pos), 32, 500.0)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=2e-6)
    else:
        same = (_bf16_bits(got) == _bf16_bits(want)).mean()
        assert same >= 0.99, same
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


def _pair(seed=0, **kw):
    kw = dict(dict(p_dropout=0.0, n_layer=2, pos_encoding="rope"), **kw)
    jm = ft.DecoderLM(V, 32, 4, 256, key=jax.random.PRNGKey(seed),
                      **kw).eval()
    tm = pt.DecoderLM(V, 32, 4, 256, device="cpu", **kw).eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(n_kv_head=2)


def test_rope_model_has_no_position_table(models):
    _, tm = models
    assert not hasattr(tm, "position_embeddings")
    assert not any("position_embeddings" in n for n, _ in tm.named_parameters())


def test_learned_params_refused_by_rope_model():
    """A learned-position JAX model's weights do not load into a RoPE
    port model: the KeyError names the position table."""
    jm = ft.DecoderLM(V, 32, 4, 64, p_dropout=0.0, n_layer=1,
                      key=jax.random.PRNGKey(4))
    tm = pt.DecoderLM(V, 32, 4, 64, p_dropout=0.0, n_layer=1,
                      pos_encoding="rope", device="cpu")
    with pytest.raises(KeyError, match="position_embeddings"):
        pt.load_jax_params(tm, {n: np.asarray(a)
                                for n, a in jm.named_parameters()})


@pytest.mark.parametrize("attn_impl", ["flash", "fused_softmax", "reference"])
def test_rope_forward_matches_jax(attn_impl):
    """The dense forward through each attention path, GQA and a window."""
    jm, tm = _pair(1, attn_impl=attn_impl, n_kv_head=2, window=6)
    toks = np.random.default_rng(1).integers(0, V, (2, 19)).astype(np.int32)
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(toks))),
                               atol=1e-5, rtol=0)


def test_rope_cached_decode_matches_jax(models):
    """Step-by-step cached decode against JAX's and the dense forward."""
    jm, tm = models
    toks = np.random.default_rng(3).integers(0, V, (2, 10)).astype(np.int32)
    step = jax.jit(lambda t, c, i: jm.forward_decode(t, c, i))
    caches, want = jm.init_cache(2, 10), []
    for i in range(10):
        lg, caches = step(jnp.asarray(toks[:, i:i + 1]), caches, i)
        want.append(np.asarray(lg[:, 0]))
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        dense = tm(tt).numpy()
        caches, got = tm.init_cache(2, 10), []
        for i in range(10):
            lg, caches = tm.forward_decode(tt[:, i:i + 1], caches, i)
            got.append(lg[:, 0].numpy())
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.stack(got, 1), dense, atol=1e-5, rtol=0)


def test_rope_paged_engine_matches_jax(models):
    """The engine's paged prefill, chunked extend and decode on a RoPE model
    (positions past the page, a prompt longer than the chunk): the JAX
    engine's tokens and logits."""
    jm, tm = models
    kw = dict(max_batch=2, page_size=8, pages_per_seq=4, prefill_chunk=8,
              collect_logits=True)
    prompts = [[3, 14, 15, 9, 2, 6], [27, 1, 8], list(range(5, 18))]
    out = []
    for cls, model in ((JaxEngine, jm), (pt.ContinuousBatchingEngine, tm)):
        eng = cls(model, **kw)
        reqs = [eng.submit(p, n) for p, n in zip(prompts, (6, 9, 5))]
        eng.run()
        assert eng.pool.n_free == eng.pool.total
        out.append(reqs)
    for w, g in zip(*out):
        assert g.generated == w.generated
        np.testing.assert_allclose(np.stack(g.logits), np.stack(w.logits),
                                   atol=1e-4, rtol=0)
