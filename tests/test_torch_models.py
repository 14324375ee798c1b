"""The port's DecoderLM against the JAX DecoderLM on the same weights.

A JAX model is built from a key, its parameters are copied into the port
through ``convert.load_jax_params``, and both run the dense forward and the
paged serving methods (prefill -> extend -> decode) on the same tokens.
Logits and the pools' valid positions must agree in float32 to atol 1e-4.
Padding positions are not compared: duplicate-index scatter order is
unspecified in both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)

# name -> (DecoderLM args, kwargs): head_dim 128 exercises the JAX pipelined
# paged walk; head_dim 8 with GQA and a sliding window the page-slot grid
CONFIGS = {
    "d128": ((64, 256, 2, 256), dict(n_layer=2)),
    "d8_gqa_window": ((64, 32, 4, 256), dict(n_layer=2, n_kv_head=2,
                                              window=5)),
}


def _pair(name):
    args, kw = CONFIGS[name]
    jm = ft.DecoderLM(*args, p_dropout=0.0, key=jax.random.PRNGKey(0),
                      **kw).eval()
    tm = pt.DecoderLM(*args, p_dropout=0.0, device="cpu", **kw).eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    return _pair(request.param)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_forward_parity(models):
    jm, tm = models
    toks = np.random.default_rng(0).integers(0, 64, (2, 19)).astype(np.int32)
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks))
    _close(got, jm(jnp.asarray(toks)))


def test_plain_layernorm_forward_parity():
    """use_fused_layernorm=False: LayerNorm1d (``weights``/``bias``) in every
    norm slot, weights still transfer by name."""
    kw = dict(p_dropout=0.0, n_layer=1, use_fused_layernorm=False)
    jm = ft.DecoderLM(64, 32, 4, 64, key=jax.random.PRNGKey(2), **kw).eval()
    tm = pt.DecoderLM(64, 32, 4, 64, device="cpu", **kw).eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    toks = np.random.default_rng(3).integers(0, 64, (2, 9)).astype(np.int32)
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks))
    _close(got, jm(jnp.asarray(toks)))


def test_dropout_modes():
    """Identity at eval, with p=0 or without a seed; inverted dropout on
    CPU in training mode."""
    x = torch.ones(64, 64)
    drop = pt.Dropout(0.25)
    assert drop.eval()(x, 0) is x
    assert drop.train()(x) is x
    assert pt.Dropout(0.0)(x, 0) is x
    y = drop(x, 0)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.65 < kept.float().mean() < 0.85


def _valid_slots(table, lengths, page):
    """(page ids, offsets) of every position < length of every row."""
    pages, offs = [], []
    for b, n in enumerate(lengths):
        p = np.arange(n)
        pages.append(table[b, p // page])
        offs.append(p % page)
    return np.concatenate(pages), np.concatenate(offs)


def _close_pools(t_pools, j_pools, table, lengths, page):
    pg, off = _valid_slots(table, lengths, page)
    for tp, jp in zip(t_pools, j_pools):
        for name in ("k", "v"):
            _close(tp[name][:, pg, off], np.asarray(jp[name])[:, pg, off])


def test_paged_prefill_extend_decode_parity(models):
    """Prefill padded prompts, extend by a 3-token chunk, decode one token:
    logits at live positions and the pools' live entries match."""
    jm, tm = models
    page, pps = 8, 4
    total = 2 * pps + 1                       # + a trash page
    table = np.asarray([[0, 2, 4, 6], [1, 3, 5, 8]], np.int32)
    rng = np.random.default_rng(1)
    lens = np.asarray([13, 6], np.int32)
    prompt = rng.integers(0, 64, (2, 16)).astype(np.int32)
    chunk = rng.integers(0, 64, (2, 3)).astype(np.int32)
    nxt = rng.integers(0, 64, (2, 1)).astype(np.int32)

    j_pools = jm.init_page_pools(total, page)
    t_pools = tm.init_page_pools(total, page)
    tt = torch.from_numpy
    with torch.inference_mode():
        j_lg, j_pools = jm.forward_prefill_paged(
            jnp.asarray(prompt), j_pools, jnp.asarray(table), jnp.asarray(lens))
        t_lg, t_pools = tm.forward_prefill_paged(
            tt(prompt), t_pools, tt(table), tt(lens))
        for b, n in enumerate(lens):
            _close(t_lg[b, :n], j_lg[b, :n])
        _close_pools(t_pools, j_pools, table, lens, page)

        j_lg, j_pools = jm.forward_extend_paged(
            jnp.asarray(chunk), j_pools, jnp.asarray(table), jnp.asarray(lens))
        t_lg, t_pools = tm.forward_extend_paged(
            tt(chunk), t_pools, tt(table), tt(lens))
        _close(t_lg, j_lg)
        lens = lens + 3
        _close_pools(t_pools, j_pools, table, lens, page)

        j_lg, j_pools = jm.forward_decode_paged(
            jnp.asarray(nxt), j_pools, jnp.asarray(table), jnp.asarray(lens))
        t_lg, t_pools = tm.forward_decode_paged(
            tt(nxt), t_pools, tt(table), tt(lens))
        _close(t_lg, j_lg)
        _close_pools(t_pools, j_pools, table, lens + 1, page)


def test_load_jax_params_checks_names_and_shapes():
    jm, tm = _pair("d8_gqa_window")
    params = {n: np.asarray(a) for n, a in jm.named_parameters()}
    bad = dict(params)
    bad.pop("ln.gamma")
    with pytest.raises(KeyError):
        pt.load_jax_params(tm, bad)
    with pytest.raises(KeyError):
        pt.load_jax_params(tm, {**params, "ln.extra": params["ln.beta"]})
    with pytest.raises(ValueError):
        pt.load_jax_params(tm, {**params, "ln.gamma": np.zeros(3, np.float32)})


def test_unported_options_raise():
    """Every DecoderLM option of the JAX model is ported, RoPE and MoE
    included; unknown values raise, as JAX's asserts do."""
    with pytest.raises(ValueError):
        pt.DecoderLM(64, 32, 4, 64, pos_encoding="alibi", device="cpu")
    with pytest.raises(ValueError):
        pt.DecoderLM(64, 32, 4, 64, attn_impl="xla", device="cpu")
    with pytest.raises(ValueError):
        pt.DecoderLM(64, 32, 4, 64, n_experts=4, moe_top_k=3, device="cpu")
    pt.DecoderLM(64, 32, 4, 64, pos_encoding="rope", n_experts=4,
                 moe_top_k=1, device="cpu")


# -- attn_impl="fused_softmax": score matmul, fused softmax, matmul with V --

# name -> (MultiHeadAttention kwargs, kv_lengths or None)
FUSED_MHA = {
    "causal_gqa_window": (dict(causal=True, n_kv_head=2, window=4), None),
    "mha_kv_lengths_with_0": (dict(causal=False), [11, 0, 5]),
    "causal_kv_lengths": (dict(causal=True, n_kv_head=1), [11, 3, 0]),
}


@pytest.mark.parametrize("case", list(FUSED_MHA))
def test_fused_softmax_attention_parity(case):
    """MultiHeadAttention(attn_impl="fused_softmax") against the JAX twin on
    the same weights; a kv_lengths row of 0 gives JAX's near-uniform
    weights, not zeros."""
    kw, lengths = FUSED_MHA[case]
    jm = ft.MultiHeadAttention(32, 4, p_dropout=0.0, attn_impl="fused_softmax",
                               key=jax.random.PRNGKey(5), **kw)
    tm = pt.MultiHeadAttention(32, 4, p_dropout=0.0, attn_impl="fused_softmax",
                               **kw)
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    x = np.random.default_rng(6).standard_normal((3, 11, 32)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x),
                 None if lens is None else torch.from_numpy(lens))
    _close(got, jm(jnp.asarray(x),
                   kv_lengths=None if lens is None else jnp.asarray(lens)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_softmax_decoder_parity(name):
    """DecoderLM(attn_impl="fused_softmax") logits against the JAX model's
    and against the port's own flash model on the same weights."""
    args, kw = CONFIGS[name]
    kw = dict(kw, p_dropout=0.0, attn_impl="fused_softmax")
    jm = ft.DecoderLM(*args, key=jax.random.PRNGKey(0), **kw).eval()
    tm = pt.DecoderLM(*args, device="cpu", **kw).eval()
    params = {n: np.asarray(a) for n, a in jm.named_parameters()}
    pt.load_jax_params(tm, params)
    toks = np.random.default_rng(2).integers(0, 64, (2, 19)).astype(np.int32)
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks))
    _close(got, jm(jnp.asarray(toks)))
    flash = pt.DecoderLM(*args, device="cpu", **dict(kw, attn_impl="flash"))
    pt.load_jax_params(flash, params)
    with torch.inference_mode():
        _close(got, flash.eval()(torch.from_numpy(toks)))


def test_fused_softmax_train_step_parity():
    """One make_train_step (Adam, clipping 1.0, f32, p 0) of the
    fused-softmax model against JAX's: the loss and every parameter to atol
    1e-5, as tests/test_torch_training.py holds the flash model."""
    from flashattn_tpu import optim as jopt
    from flashattn_tpu.training import trainer as jtr

    args, kw = (64, 32, 4, 32), dict(n_layer=2, middle_dim=64, n_kv_head=2,
                                     p_dropout=0.0, attn_impl="fused_softmax")
    jm = ft.DecoderLM(*args, key=jax.random.PRNGKey(0), **kw)
    tm = pt.DecoderLM(*args, device="cpu", **kw)
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    rng = np.random.default_rng(12)
    tok = rng.integers(0, 64, (4, 16)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=1)
    msk = (rng.random((4, 16)) < 0.7).astype(np.float32)
    j_opt, t_opt = jopt.Adam(lr=1e-3), pt.Adam(lr=1e-3)
    jm, _, j_loss = jtr.make_train_step(j_opt, grad_clip=1.0, donate=False)(
        jm, j_opt.init(jm), jnp.asarray(tok), jnp.asarray(tgt),
        jnp.asarray(msk), None)
    tm, _, t_loss = pt.make_train_step(t_opt, grad_clip=1.0)(
        tm, t_opt.init(tm), torch.from_numpy(tok), torch.from_numpy(tgt),
        torch.from_numpy(msk))
    np.testing.assert_allclose(np.asarray(t_loss), np.asarray(j_loss),
                               atol=1e-5, rtol=1e-5)
    t_params = dict(tm.named_parameters())
    for name, want in jm.named_parameters():
        np.testing.assert_allclose(t_params[name].detach().numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
def test_quantized_page_pools(dtype):
    """An int8 / fp8 pool: payloads, and per-token f32 scales starting at 1,
    in the JAX pool's layout."""
    tm = pt.DecoderLM(64, 32, 4, 64, n_kv_head=2, device="cpu")
    pools = tm.init_page_pools(3, 4, dtype)
    assert len(pools) == 4
    for pool in pools:
        assert set(pool) == {"k", "v", "ks", "vs"}
        assert pool["k"].dtype == dtype and pool["k"].shape == (2, 3, 4, 8)
        assert pool["ks"].dtype == torch.float32
        assert pool["ks"].shape == (2, 3, 4, 1) and (pool["vs"] == 1).all()


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_paged_parity(dtype):
    """int8-weight model (one layer, GQA, window) over an int8 / fp8 pool,
    prefill -> extend -> decode, against the JAX model: logits at live positions to 1e-4, and
    the pools' live payloads bit for bit with equal scales."""
    from flashattn_tpu.ops.quant import quantize_model_weights

    jdt, tdt = ((jnp.int8, torch.int8) if dtype == "int8"
                else (jnp.float8_e4m3fn, torch.float8_e4m3fn))
    kw = dict(p_dropout=0.0, n_layer=1, n_kv_head=2, window=5)
    jm = ft.DecoderLM(64, 32, 4, 256, key=jax.random.PRNGKey(4), **kw).eval()
    tm = pt.DecoderLM(64, 32, 4, 256, device="cpu", **kw).eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    jm = quantize_model_weights(jm, jnp.int8)
    tm = pt.quantize_model_weights(tm, torch.int8)
    page, table = 8, np.asarray([[0, 2, 4, 6], [1, 3, 5, 8]], np.int32)
    rng = np.random.default_rng(5)
    lens = np.asarray([13, 6], np.int32)
    steps = [("forward_prefill_paged", rng.integers(0, 64, (2, 16))),
             ("forward_extend_paged", rng.integers(0, 64, (2, 3))),
             ("forward_decode_paged", rng.integers(0, 64, (2, 1)))]
    j_pools, t_pools = jm.init_page_pools(9, page, jdt), tm.init_page_pools(
        9, page, tdt)
    tt = torch.from_numpy
    for i, (method, toks) in enumerate(steps):
        toks = toks.astype(np.int32)
        j_lg, j_pools = getattr(jm, method)(
            jnp.asarray(toks), j_pools, jnp.asarray(table), jnp.asarray(lens))
        with torch.inference_mode():
            t_lg, t_pools = getattr(tm, method)(tt(toks), t_pools, tt(table),
                                                tt(lens))
        for b in range(2):
            n = lens[b] if i == 0 else toks.shape[1]
            _close(t_lg[b, :n], j_lg[b, :n])
        lens = lens if i == 0 else lens + toks.shape[1]
        pg, off = _valid_slots(table, lens, page)
        for tp, jp in zip(t_pools, j_pools):
            for name in ("k", "v"):
                got = tp[name][:, pg, off]
                want = np.asarray(jp[name])[:, pg, off]
                if tdt == torch.float8_e4m3fn:
                    got, want = got.view(torch.uint8), want.view(np.uint8)
                np.testing.assert_array_equal(got.numpy(), want)
                # the scales come from K/V that the two frameworks sum in
                # different orders: equal to f32 rounding (measured 3.8e-7)
                np.testing.assert_allclose(
                    tp[name + "s"][:, pg, off].numpy(),
                    np.asarray(jp[name + "s"])[:, pg, off], rtol=2e-6, atol=0)


# C14: ids and positions past an embedding table.  JAX's Embedding is
# jnp.take (an id in [-n, 0) wraps once, any other id outside the table
# gives a NaN row) or, with use_one_hot_matmul, jax.nn.one_hot (a zero row
# for any id outside [0, n)).
EMBED_IDS = {
    "past the table": [[0, 5, 6, 7], [100, 3, 6, 2**20]],
    "negative": [[-1, -6, -7, 2], [-100, 0, -3, 5]],
}


@pytest.mark.parametrize("one_hot", [False, True], ids=["take", "one_hot"])
@pytest.mark.parametrize("case", list(EMBED_IDS))
def test_embedding_ids_outside_table_match_jax(case, one_hot):
    jm = ft.Embedding(6, 8, key=jax.random.PRNGKey(3),
                      use_one_hot_matmul=one_hot)
    tm = pt.Embedding(6, 8, use_one_hot_matmul=one_hot, device="cpu")
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    ids = np.asarray(EMBED_IDS[case], np.int32)
    want = np.asarray(jm(jnp.asarray(ids)))
    got = tm(torch.from_numpy(ids)).detach().numpy()
    assert np.isnan(want).any() != one_hot
    np.testing.assert_array_equal(got, want)   # NaN where JAX has NaN


def test_dense_forward_past_position_table_matches_jax():
    """S 12 over an 8-row position table: JAX's rows past the table are NaN,
    and the op graph's P V (p = 0 times a NaN V row still NaN) carries them
    into every row; the port's logits are NaN where JAX's are, the rest
    equal."""
    jm = ft.DecoderLM(50, 64, 2, 8, n_layer=1, attn_impl="reference",
                      p_dropout=0.0, key=jax.random.PRNGKey(0))
    tm = pt.DecoderLM(50, 64, 2, 8, n_layer=1, attn_impl="reference",
                      p_dropout=0.0, device="cpu")
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    toks = np.random.default_rng(0).integers(0, 50, (2, 12)).astype(np.int32)
    want = np.asarray(jm(jnp.asarray(toks)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks)).numpy()
    assert np.isnan(want).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
