"""The port's cross-attention, encoder-decoder model and seq2seq generation
against the JAX package's, on the same weights.

A JAX module is built from a key, its parameters are copied into the port
by ``convert.load_jax_params`` (dropout off), and both run the same
numpy-seeded inputs on the CPU.  Head dim 32 throughout (E 64, 2 heads), a
width the port's card kernels take.  Tolerances: f32 outputs and logits
1e-5 abs; gradients of the masked ``seq2seq_loss`` 1e-4 in relative L2
norm, but the key-projection biases, whose exact gradient is 0 (softmax
ignores a shift shared by every key), held to 1e-6 of the global gradient
norm in both packages; bf16 cross-attention at least 99.5% of the
elements bit for bit and the rest within one bf16 ulp of the row's
largest, below and at the 1024 keys where JAX's dispatcher leaves the op
graph for its kernels; generated tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu.training import generate as jgen
from flashattn_tpu.training import translation as jtr
from flashattn_tpu_torch.training import generate as tgen
from flashattn_tpu_torch.training import translation as ttr

torch.set_num_threads(1)

V, E, H, P = 50, 64, 2, 64
EOS = 2
IMPLS = ["reference", "flash", "fused_softmax"]


def _params(jm):
    return {n: np.asarray(a) for n, a in jm.named_parameters()}


def _to_dtype(jm, dtype):
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jm)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _s2s_pair(impl="reference", seed=0, layers=2, **kw):
    args = (V, E, H, P)
    kw = dict(p_dropout=0.0, n_encoder_layer=layers, n_decoder_layer=layers,
              middle_dim=64, attn_impl=impl, **kw)
    jm = ft.EncoderDecoderLM(*args, key=jax.random.PRNGKey(seed), **kw)
    tm = pt.EncoderDecoderLM(*args, device="cpu", **kw)
    pt.load_jax_params(tm, _params(jm))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    jm, tm = _s2s_pair()
    return jm.eval(), tm.eval()


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    src = rng.integers(3, V, (3, 12)).astype(np.int32)
    tgt = rng.integers(3, V, (3, 10)).astype(np.int32)
    return src, tgt, np.asarray([12, 7, 1], np.int32)


def _mha_pair(impl, seed=1):
    jm = ft.MultiHeadAttention(E, H, causal=False, p_dropout=0.0,
                               attn_impl=impl, key=jax.random.PRNGKey(seed))
    tm = pt.MultiHeadAttention(E, H, causal=False, p_dropout=0.0,
                               attn_impl=impl)
    pt.load_jax_params(tm, _params(jm))
    return jm, tm


def _cross_inputs(seed, b, n_q, n_kv, lens):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n_q, E)).astype(np.float32)
    mem = rng.standard_normal((b, n_kv, E)).astype(np.float32)
    return x, mem, np.asarray(lens, np.int32)


# -- cross-attention ----------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_mha_cross_attention_f32_matches_jax(impl):
    """``forward(x, kv_lengths, kv=memory)`` at n_q 9 over n_kv 23, ragged
    lengths down to 1, against JAX's ``forward(x, kv=, kv_lengths=)``."""
    jm, tm = _mha_pair(impl)
    x, mem, lens = _cross_inputs(3, 3, 9, 23, [23, 11, 1])
    want = jm(jnp.asarray(x), kv=jnp.asarray(mem),
              kv_lengths=jnp.asarray(lens))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(lens),
                 kv=torch.from_numpy(mem))
        self_attn = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert got.shape == (3, 9, E) and self_attn.shape == (3, 9, E)


def _row_ulp_match(got, want, share=0.995):
    """At least ``share`` of the elements bit for bit and every other one
    within one bf16 ulp of its row's largest magnitude."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    frac = float((g != w).mean())
    row = np.abs(w).max(-1, keepdims=True)
    assert frac <= 1 - share, frac
    assert np.all(np.abs(g - w) <= row * 2.0 ** -7), float(np.abs(g - w).max())


@pytest.mark.parametrize("n_q,n_kv,lens", [(24, 40, [40, 17, 1]),
                                           (64, 1024, [1024, 517, 1])],
                         ids=["op_graph_kv40", "kernel_kv1024"])
def test_mha_cross_attention_bf16_matches_jax(n_q, n_kv, lens):
    """bf16 weights and inputs on both sides, flash impl: below 1024 keys
    JAX runs the op graph, at 1024 its Pallas kernel (interpret mode)."""
    jm, tm = _mha_pair("flash", seed=4)
    jm, tm = _to_dtype(jm, jnp.bfloat16), tm.to(torch.bfloat16)
    x, mem, lens = _cross_inputs(5, 3, n_q, n_kv, lens)
    want = jm(jnp.asarray(x, jnp.bfloat16), kv=jnp.asarray(mem, jnp.bfloat16),
              kv_lengths=jnp.asarray(lens))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).bfloat16(), torch.from_numpy(lens),
                 kv=torch.from_numpy(mem).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _row_ulp_match(got, want)


def test_mha_cross_attention_skips_rope():
    """RoPE rotates self-attention only: with ``kv`` a RoPE module gives
    what the same module without RoPE gives."""
    tm = pt.MultiHeadAttention(E, H, p_dropout=0.0, pos_encoding="rope",
                               device="cpu")
    plain = pt.MultiHeadAttention(E, H, p_dropout=0.0, device="cpu")
    plain.load_state_dict(tm.state_dict())
    x, mem, lens = _cross_inputs(7, 2, 5, 9, [9, 4])
    args = (torch.from_numpy(x), torch.from_numpy(lens))
    with torch.inference_mode():
        got = tm(*args, kv=torch.from_numpy(mem))
        want = plain(*args, kv=torch.from_numpy(mem))
        rotated = tm(torch.from_numpy(x))
        unrotated = plain(torch.from_numpy(x))
    assert torch.equal(got, want)
    assert not torch.allclose(rotated, unrotated)


# -- the encoder-decoder model -------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_decoder_logits_match_jax(impl, batch):
    src, tgt, lens = batch
    jm, tm = _s2s_pair(impl, seed=3, layers=1)
    want = jm.eval()(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(lens))
    with torch.inference_mode():
        got = tm.eval()(*(torch.from_numpy(a) for a in (src, tgt, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_seq2seq_loss_grads_match_jax(remat, batch):
    """Gradients of the app's masked ``seq2seq_loss`` in every parameter
    against ``jax.grad`` (the JAX model with the same ``remat``)."""
    src, tgt, lens = batch
    jm, tm = _s2s_pair("flash", seed=5, remat=remat)
    rng = np.random.default_rng(6)
    labels = rng.integers(0, V, tgt.shape).astype(np.int32)
    mask = (rng.random(tgt.shape) < 0.7).astype(np.float32)
    j_in = {"src": jnp.asarray(src), "src_lens": jnp.asarray(lens),
            "tgt_in": jnp.asarray(tgt)}
    j_loss, j_grads = jax.jit(jax.value_and_grad(jtr.seq2seq_loss))(
        jm, j_in, jnp.asarray(labels), jnp.asarray(mask))
    t_in = {"src": torch.from_numpy(src), "src_lens": torch.from_numpy(lens),
            "tgt_in": torch.from_numpy(tgt)}
    loss = ttr.seq2seq_loss(tm, t_in, torch.from_numpy(labels),
                            torch.from_numpy(mask))
    names, params = zip(*tm.named_parameters())
    got = dict(zip(names, (g.numpy() for g in torch.autograd.grad(loss,
                                                                  params))))
    want = _params(j_grads)
    assert set(got) == set(want)
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5
    total = np.sqrt(sum(np.square(w).sum() for w in want.values()))
    for n in want:
        if n.endswith("k_projection.bias"):
            assert max(np.linalg.norm(got[n]), np.linalg.norm(want[n])) \
                <= 1e-6 * total, n
        else:
            assert _rel(got[n], want[n]) <= 1e-4, (n, _rel(got[n], want[n]))
    assert np.abs(got["decoder_layers.0.cross_attention.q_projection.weights"]
                  ).sum() > 0


def test_encoder_pad_invariance(models, batch):
    """Source positions past each row's length do not reach the logits;
    the valid ones do."""
    _, tm = models
    src, tgt, lens = (torch.from_numpy(a) for a in batch)
    pos = torch.arange(src.shape[1])[None, :]
    garbage = torch.where(pos < lens[:, None], src, (src * 7 + 3) % V)
    with torch.inference_mode():
        base = tm(src, tgt, lens)
        np.testing.assert_allclose(tm(garbage, tgt, lens).numpy(),
                                   base.numpy(), atol=1e-6, rtol=0)
        changed = src.clone()
        changed[:, 0] = (changed[:, 0] + 1) % V
        assert not torch.allclose(tm(changed, tgt, lens), base)


def test_cached_decode_matches_teacher_forcing(models, batch):
    """Step-by-step ``forward_decode`` over one ``encode`` and
    ``precompute_cross``: logits within 1e-5 of the teacher-forced forward
    and of JAX's cached decode; a Python int and a 0-dim tensor index give
    the same step."""
    jm, tm = models
    src, tgt, lens = batch
    b, s = tgt.shape
    mem = jm.encode(jnp.asarray(src), jnp.asarray(lens))
    cross, caches = jm.precompute_cross(mem), jm.init_cache(b, s)
    step = jax.jit(lambda t, c, i: jm.forward_decode(t, c, cross, i,
                                                     jnp.asarray(lens)))
    want = []
    for i in range(s):
        logits, caches = step(jnp.asarray(tgt[:, i:i + 1]), caches,
                              jnp.int32(i))
        want.append(np.asarray(logits[:, 0]))
    want = np.stack(want, 1)
    src_t, tgt_t, lens_t = (torch.from_numpy(a) for a in batch)
    with torch.inference_mode():
        dense = tm(src_t, tgt_t, lens_t).numpy()
        for index in (lambda i: i, torch.tensor):
            mem_t = tm.encode(src_t, lens_t)
            cross_t, caches_t = tm.precompute_cross(mem_t), tm.init_cache(b, s)
            got = []
            for i in range(s):
                logits, caches_t = tm.forward_decode(
                    tgt_t[:, i:i + 1], caches_t, cross_t, index(i), lens_t)
                got.append(logits[:, 0].numpy())
            got = np.stack(got, 1)
            np.testing.assert_allclose(got, dense, atol=1e-5, rtol=0)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_greedy_generate_seq2seq_matches_jax(models, batch):
    """Token-identical to JAX's ``greedy_generate_seq2seq`` in f32, without
    an eos, with an eos the model emits early (every later token of a
    finished row an eos), and with a scalar source length; a model given
    in train mode comes back in train mode."""
    jm, tm = models
    src, _, lens = batch
    free = tgen.greedy_generate_seq2seq(tm, src, lens, 12, bos_id=1).numpy()
    want = np.asarray(jgen.greedy_generate_seq2seq(
        jm, jnp.asarray(src), jnp.asarray(lens), 12, bos_id=1))
    np.testing.assert_array_equal(free, want)
    eos = int(free[0, 2])                        # row 0's third token
    tm.train()
    try:
        got = tgen.greedy_generate_seq2seq(tm, torch.from_numpy(src),
                                           torch.from_numpy(lens), 12,
                                           bos_id=1, eos_id=eos).numpy()
        assert tm.training
    finally:
        tm.eval()
    want = np.asarray(jgen.greedy_generate_seq2seq(
        jm, jnp.asarray(src), jnp.asarray(lens), 12, bos_id=1, eos_id=eos))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 12)
    for row in got:
        hits = np.where(row == eos)[0]
        if hits.size:
            assert (row[hits[0]:] == eos).all()
    assert (got[0, 2:] == eos).all()
    got = tgen.greedy_generate_seq2seq(tm, src, 12, 6, bos_id=1).numpy()
    want = np.asarray(jgen.greedy_generate_seq2seq(jm, jnp.asarray(src), 12,
                                                   6, bos_id=1))
    np.testing.assert_array_equal(got, want)


def test_copy_task_learns():
    """``tests/test_seq2seq.py::test_copy_task_learns`` on both packages from
    the same weights: a 5-token copy task, 61 full-batch Adam steps.  The
    port's loss falls below a fifth of its first, as JAX's does, and
    tracks JAX's step for step (1e-4 relative over the first 20 steps,
    where Adam has not yet amplified the f32 rounding; 2% at the end)."""
    rng = np.random.default_rng(1)
    src = rng.integers(3, 20, (64, 5)).astype(np.int32)
    tgt_in = np.concatenate([np.full((64, 1), 1, np.int32), src[:, :-1]], 1)
    args = (20, 64, 2, 16)
    kw = dict(p_dropout=0.0, n_encoder_layer=1, n_decoder_layer=1,
              middle_dim=64, attn_impl="reference")
    jm = ft.EncoderDecoderLM(*args, key=jax.random.PRNGKey(5), **kw)
    tm = pt.EncoderDecoderLM(*args, device="cpu", **kw)
    pt.load_jax_params(tm, _params(jm))

    jopt = ft.Adam(lr=1e-2)

    @jax.jit
    def jstep(m, s):
        def loss_fn(m):
            logits = m(jnp.asarray(src), jnp.asarray(tgt_in))
            return jnp.mean(ft.F.softmax_loss(logits.reshape(-1, 20),
                                              jnp.asarray(src).reshape(-1)))
        l, g = jax.value_and_grad(loss_fn)(m)
        m, s = jopt.step(m, g, s)
        return m, s, l

    def t_loss(m, tokens, targets, mask=None, generator=None):
        logits = m(tokens["src"], tokens["tgt_in"])
        return pt.F.softmax_loss(logits.reshape(-1, 20),
                                 targets.reshape(-1).long()).mean()

    topt = pt.Adam(lr=1e-2)
    tstep = pt.make_train_step(topt, t_loss)
    js, ts = jopt.init(jm), topt.init(tm)
    tok = {"src": torch.from_numpy(src), "tgt_in": torch.from_numpy(tgt_in)}
    want, got = [], []
    for _ in range(61):
        jm, js, jl = jstep(jm, js)
        tm, ts, tl = tstep(tm, ts, tok, torch.from_numpy(src))
        want.append(float(jl))
        got.append(float(tl))
    want, got = np.asarray(want), np.asarray(got)
    assert got[-1] < got[0] * 0.2 and want[-1] < want[0] * 0.2, (got, want)
    np.testing.assert_allclose(got[:20], want[:20], rtol=1e-4)
    np.testing.assert_allclose(got[-1], want[-1], rtol=2e-2)


def test_train_scan_dict_inputs_equal_steps():
    """``make_train_scan`` over the seq2seq dict of stacked inputs takes
    slice i of every value at step i, as JAX's scan does over a pytree:
    its losses and parameters equal the same steps taken one by one."""
    rng = np.random.default_rng(8)
    n, b = 3, 4
    src = torch.from_numpy(rng.integers(3, V, (n, b, 7)))
    lens = torch.from_numpy(rng.integers(1, 8, (n, b)))
    tgt_in = torch.from_numpy(rng.integers(3, V, (n, b, 6)))
    labels = torch.from_numpy(rng.integers(3, V, (n, b, 6)))
    mask = torch.from_numpy((rng.random((n, b, 6)) < 0.8).astype(np.float32))
    _, scanned = _s2s_pair("flash", seed=9, layers=1)
    stepped = pt.EncoderDecoderLM(V, E, H, P, p_dropout=0.0,
                                  n_encoder_layer=1, n_decoder_layer=1,
                                  middle_dim=64, device="cpu")
    stepped.load_state_dict(scanned.state_dict())
    opt = pt.Adam(lr=1e-3)
    scan = pt.make_train_scan(opt, ttr.seq2seq_loss, grad_clip=1.0)
    step = pt.make_train_step(opt, ttr.seq2seq_loss, grad_clip=1.0)
    tokens = {"src": src, "src_lens": lens, "tgt_in": tgt_in}
    _, _, losses = scan(scanned, opt.init(scanned), tokens, labels, mask)
    state, want = opt.init(stepped), []
    for i in range(n):
        stepped, state, loss = step(
            stepped, state, {k: v[i] for k, v in tokens.items()}, labels[i],
            mask[i])
        want.append(loss)
    assert losses.shape == (n,)
    assert torch.equal(losses, torch.stack(want))
    for (name, p), q in zip(scanned.named_parameters(), stepped.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("arch", ["decoder_only", "seq2seq"])
def test_remat_under_mixed_precision_equals_plain(arch, batch):
    """``remat=True`` under ``make_mixed_precision_loss`` (the MT app's
    ``--remat --mixed-precision``): the loss and every gradient bit for bit
    those of the same step without remat, dropout on, for both policies.
    The backward's recomputation runs on the bf16 casts the forward saw,
    not on the f32 masters the module holds by then."""
    src, tgt, lens = (torch.from_numpy(a) for a in batch)
    if arch == "seq2seq":
        model = pt.EncoderDecoderLM(V, E, H, P, p_dropout=0.1,
                                    n_encoder_layer=2, n_decoder_layer=2,
                                    middle_dim=64, device="cpu")
        loss_fn = pt.make_mixed_precision_loss(ttr.seq2seq_loss)
        inputs = {"src": src, "src_lens": lens, "tgt_in": tgt}
    else:
        model = pt.DecoderLM(V, E, H, P, p_dropout=0.1, n_layer=2,
                             middle_dim=64, device="cpu")
        loss_fn = pt.make_mixed_precision_loss(pt.lm_loss)
        inputs = tgt
    model.train()
    for policy in ("nothing", "dots"):
        out = []
        for remat in (False, True):
            model.remat = remat
            model._remat_context = pt.models.transformer.remat_policy(policy)
            loss = loss_fn(model, inputs, tgt.roll(-1, 1), None,
                           torch.Generator().manual_seed(4))
            grads = torch.autograd.grad(loss, list(model.parameters()))
            out.append((loss.detach(), grads))
        (l0, g0), (l1, g1) = out
        assert torch.equal(l0, l1)
        for a, b in zip(g0, g1):
            assert torch.equal(a, b), policy


def test_positions_past_table_match_jax():
    """C14: over an 8-row position table, ``encode`` at S_src 12 and a
    cached ``forward_decode`` at index 9 raise nothing and give JAX's NaN
    (``jnp.take`` fills a row past the table); decode steps inside the
    table stay equal to JAX's."""
    kw = dict(p_dropout=0.0, n_encoder_layer=1, n_decoder_layer=1,
              middle_dim=64)
    jm = ft.EncoderDecoderLM(V, E, H, 8, key=jax.random.PRNGKey(1), **kw)
    tm = pt.EncoderDecoderLM(V, E, H, 8, device="cpu", **kw)
    pt.load_jax_params(tm, _params(jm))
    rng = np.random.default_rng(0)
    src = rng.integers(3, V, (2, 12)).astype(np.int32)
    lens = np.asarray([12, 5], np.int32)
    want = np.asarray(jm.encode(jnp.asarray(src), jnp.asarray(lens)))
    with torch.inference_mode():
        got = tm.encode(torch.from_numpy(src), torch.from_numpy(lens)).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               atol=1e-5)

    lens = np.asarray([6, 5], np.int32)
    j_mem = jm.encode(jnp.asarray(src[:, :6]), jnp.asarray(lens))
    j_cross, j_cache = jm.precompute_cross(j_mem), jm.init_cache(2)
    tok = np.asarray([[3], [4]], np.int32)
    with torch.inference_mode():
        t_mem = tm.encode(torch.from_numpy(src[:, :6]), torch.from_numpy(lens))
        t_cross, t_cache = tm.precompute_cross(t_mem), tm.init_cache(2, device="cpu")
        for index in (0, 7, 9):
            want, j_cache = jm.forward_decode(jnp.asarray(tok), j_cache, j_cross,
                                              jnp.int32(index), jnp.asarray(lens))
            got, t_cache = tm.forward_decode(torch.from_numpy(tok), t_cache,
                                             t_cross, index, torch.from_numpy(lens))
            want, got = np.asarray(want), got.numpy()
            assert np.isnan(want).all() == (index >= 8)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                                       atol=1e-5)
