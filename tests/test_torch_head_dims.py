"""Head dims other than 32, 64 and 128: the port against the JAX package.

JAX runs attention at any head dim (its ``_pad128`` zero-pads d 16..120 to
128 for the subrow and loop schedules, forward and backward; above 128 it
runs the grid from 1024 keys and the op graph below); the port's kernels,
forward, backward and inference, take every multiple of 8 up to 128, and
its bf16 forward and bf16-q paged kernels up to 256, at tile widths of 32,
64, 128 (and 256) zero-padded as they load.  On the CPU the port runs its
plain versions, so these tests hold the function at d 16, 24, 80 and 96,
and at 160 and 256 (``WIDE_HEAD_DIMS``), to JAX's through the public entry
points, with the same numpy-seeded inputs on both sides and JAX's Pallas
kernels in interpret mode:

* ``flash_attention`` / ``flash_attention_varlen`` /
  ``flash_attention_with_lse`` in bf16 and f32 below 1024 keys (XLA's op
  graph) and at 1024 (causal: ``_pad128``'s subrow; not causal: the grid);
* their gradients (``jax.vjp`` against torch autograd) at the same
  schedules: the op graph's autodiff below 1024 keys, the Pallas backward
  kernels from 1024 (``_pad128``'s subrow backward, its varlen twin, the
  grid backward);
* one ``make_train_step`` of a DecoderLM with heads of 96 (RoPE) against
  JAX's on the same weights;
* ``paged_attention`` over bf16, int8 and fp8 pools (JAX's page-slot grid,
  ``_paged_kernel``, below d 128);
* ``flash_attention_kv_int8`` (the grid route below d 128);
* the plain version of the paged marks (C18: cdiv(d, 32) words of columns
  and the V scale's word after them);
* a DecoderLM with heads of 96 served by ``ContinuousBatchingEngine``
  against JAX's engine on the same weights;
* at d 160 and 256: the flash forward (the op graph at 200 keys with MQA,
  the grid at 1024 keys varlen and not causal), paged attention with bf16
  and f32 q over every pool (a decode, a chunk of 64, and a decode at
  pages of 128, JAX's pipelined page walk), the marks' plain version, and
  a DecoderLM with two heads of 256 and one kv head (RoPE) through both
  engines;
* the head-dim rule of each kernel family
  (``flashattn_tpu_torch.ops._utils.check_head_dim``).

Tolerances are those of the parity tests at d 32, 64 and 128: bf16 at least
99.5% of the elements bit for bit and the rest within one bf16 ulp of the
row's largest (tests/test_torch_faults.py's ``_row_ulp_match``), lse 1e-5;
the bf16 gradients of the kernel schedules each element within one bf16
ulp of its row's largest, at most 2% of dq and of dk differing (the gate
of tests/test_torch_faults.py's ``_check_bwd``) and at most 0.5% of dv
(``_check_bwd`` holds dv bit for bit given JAX's lse and di; here each
package's own forward gives them, which moves a rounding of p now and
then: 0.14%, 0.15% and 0.44% of dv differ in the three bf16 cases); f32
1e-5 (both sides f32, sums in another order); the kv8 route's gates of
``test_kv8_flash_bf16_matches_jax_route``; the engine's logits 1e-4; the
train steps' losses and parameters 1e-5 (tests/test_torch_training.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu.ops import flash_attention as jfa
from flashattn_tpu.ops import paged_attention as jpa
from flashattn_tpu.ops import quant as jq
from flashattn_tpu import optim as jopt
from flashattn_tpu.serving import ContinuousBatchingEngine as JaxEngine
from flashattn_tpu.training import trainer as jtr
from flashattn_tpu_torch.ops import paged_attention as tpa
from flashattn_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

HEAD_DIMS = [16, 24, 80, 96]
# the head dims of the bf16 forward's and bf16-q paged tiles of 256 columns
WIDE_HEAD_DIMS = [160, 256]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
PAYLOADS = {"int8": (jq.quantize_int8, torch.int8),
            "fp8": (jq.quantize_fp8, torch.float8_e4m3fn)}


def _pair(a, name):
    td, jd = DTYPES[name]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _row_ulp_match(got, want, share=0.995):
    """At least ``share`` of the elements bit for bit and every other one
    within one bf16 ulp of its row's largest magnitude (2^-7 of it)."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    frac = float((g != w).mean())
    assert frac <= 1 - share, frac
    row = np.abs(w).max(-1, keepdims=True)
    assert np.all(np.abs(g - w) <= row * 2.0 ** -7), np.abs(g - w).max()


def _check(got, want, name, share=0.995):
    if name == "bfloat16":
        _row_ulp_match(got, want, share)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)


# (b, h, h_kv, n, causal, lengths): below 1024 keys XLA's op graph (GQA; a
# length of 0 in varlen); at 1024 causal JAX's _pad128 subrow (and its
# varlen twin), not causal its grid
FLASH_CASES = {
    "op_graph_gqa_causal_n200": (1, 4, 2, 200, True, None),
    "op_graph_varlen_n130": (2, 2, 2, 130, True, [130, 0]),
    "pad128_subrow_n1024": (1, 1, 1, 1024, True, None),
    "pad128_subrow_varlen_n1024": (2, 1, 1, 1024, True, [1024, 515]),
    "grid_noncausal_n1024": (1, 1, 1, 1024, False, None),
    # above d 128: the op graph with MQA (4 q heads, one kv head), and JAX's
    # grid at 1024 keys for a causal varlen batch (no subrow schedule there)
    "op_graph_mqa_causal_n200": (1, 4, 1, 200, True, None),
    "grid_varlen_n1024": (2, 1, 1, 1024, True, [1024, 515]),
}
# every head dim in both dtypes below and at 1024 keys; the varlen and
# grid functions at two head dims a dtype (JAX's interpret runs cost ~1 s
# a call)
FLASH_PARAMS = (
    [(d, c, n) for c in ("op_graph_gqa_causal_n200", "pad128_subrow_n1024")
     for d in HEAD_DIMS for n in DTYPES]
    + [(80, "op_graph_varlen_n130", "bfloat16"),
       (16, "op_graph_varlen_n130", "float32"),
       (96, "pad128_subrow_varlen_n1024", "bfloat16"),
       (24, "pad128_subrow_varlen_n1024", "float32"),
       (24, "grid_noncausal_n1024", "bfloat16"),
       (80, "grid_noncausal_n1024", "float32")]
    + [(d, "op_graph_mqa_causal_n200", n) for d in WIDE_HEAD_DIMS
       for n in DTYPES]
    + [(160, "grid_varlen_n1024", "bfloat16"),
       (256, "grid_varlen_n1024", "float32"),
       (256, "grid_noncausal_n1024", "bfloat16"),
       (160, "grid_noncausal_n1024", "float32")])


@pytest.mark.parametrize("d, case, name", FLASH_PARAMS)
def test_flash_head_dims_match_jax(d, case, name):
    b, h, h_kv, n, causal, lengths = FLASH_CASES[case]
    rng = np.random.default_rng(1000 + d)
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h_kv, n, d)).astype(np.float32)
            for _ in range(2))
    (qt, qj), (kt, kj), (vt, vj) = (_pair(a, name) for a in (q, k, v))
    if lengths is not None:
        lens = np.asarray(lengths, np.int32)
        got = pt.flash_attention_varlen(qt, kt, vt, torch.from_numpy(lens),
                                        causal)
        want = jfa.flash_attention_varlen(qj, kj, vj, jnp.asarray(lens),
                                          causal)
        assert got.shape == (b, h, n, d)
        _check(got, want, name)
        return
    got = pt.flash_attention_with_lse(qt, kt, vt, causal)
    want = jfa.flash_attention_with_lse(qj, kj, vj, causal)
    _check(got[0], want[0], name)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=0)
    _check(pt.flash_attention(qt, kt, vt, causal), want[0], name)


# the gradients: every head dim in both dtypes below 1024 keys, and each
# Pallas backward schedule at two head dims a dtype
GRAD_PARAMS = (
    [(d, "op_graph_gqa_causal_n200", n) for d in HEAD_DIMS for n in DTYPES]
    + [(96, "pad128_subrow_n1024", "bfloat16"),
       (16, "pad128_subrow_n1024", "float32"),
       (16, "pad128_subrow_varlen_n1024", "bfloat16"),
       (80, "pad128_subrow_varlen_n1024", "float32"),
       (24, "grid_noncausal_n1024", "bfloat16"),
       (96, "grid_noncausal_n1024", "float32")])


@pytest.mark.parametrize("d, case, name", GRAD_PARAMS)
def test_flash_grad_head_dims_match_jax(d, case, name):
    """dq, dk and dv of the public functions: ``jax.vjp`` against torch
    autograd on the same inputs and cotangent.  Below 1024 keys both
    differentiate the op graph (bf16 by ``_row_ulp_match``); from 1024 JAX
    runs its Pallas backward at d padded to 128 (``_pad128``) or the grid
    backward, the port the TPU kernels' formulas at d (bf16: at most 2% of
    dq and of dk and 0.5% of dv differ, each element within one ulp of its
    row's largest)."""
    b, h, h_kv, n, causal, lengths = FLASH_CASES[case]
    rng = np.random.default_rng(2000 + d)
    q, do = (rng.standard_normal((b, h, n, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, h_kv, n, d)).astype(np.float32)
            for _ in range(2))
    (qt, qj), (kt, kj), (vt, vj), (dot, doj) = (_pair(a, name)
                                                for a in (q, k, v, do))
    if lengths is None:
        def jf(*a):
            return jfa.flash_attention(*a, causal)

        def tf(*a):
            return pt.flash_attention(*a, causal)
    else:
        lens = np.asarray(lengths, np.int32)

        def jf(*a):
            return jfa.flash_attention_varlen(*a, jnp.asarray(lens), causal)

        def tf(*a):
            return pt.flash_attention_varlen(*a, torch.from_numpy(lens),
                                             causal)
    _, vjp = jax.vjp(jf, qj, kj, vj)
    ts = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    got = torch.autograd.grad(tf(*ts), ts, dot)
    shares = ((0.995,) * 3 if n < jfa.MIN_KERNEL_KV_LEN
              else (0.98, 0.98, 0.995))
    for g, w, t, share in zip(got, vjp(doj), (qt, kt, vt), shares):
        assert g.dtype == t.dtype and g.shape == t.shape
        _check(g, w, name, share)
    if lengths is not None:
        # keys past a row's length get no gradient
        for bi, n_b in enumerate(lengths):
            assert (got[1][bi, :, n_b:] == 0).all()
            assert (got[2][bi, :, n_b:] == 0).all()


def _paged_inputs(seed, d, chunk, page, hq, hkv, pool, name="bfloat16"):
    """q in ``name`` (bf16 or f32) and pools (in q's dtype for ``pool``
    "bf16", or int8 / fp8 payloads with their scales) for both packages:
    five sequences of three pages (a full table, a mid-page length, the
    chunk itself, 0, a padding length past the table)."""
    rng = np.random.default_rng(seed)
    b, pps, n_pages = 5, 3, 16
    shape = (b, chunk, hq, d) if chunk > 1 else (b, hq, d)
    q = rng.standard_normal(shape).astype(np.float32)
    kp, vp = (rng.standard_normal((hkv, n_pages, page, d)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(n_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    lens = np.asarray([page * pps, page + chunk + 1, chunk, 0,
                       page * pps + 3], np.int32)
    qt, qj = _pair(q, name)
    rest_t = [torch.from_numpy(a) for a in (lens, table)]
    rest_j = [jnp.asarray(a) for a in (lens, table)]
    if pool == "bf16":
        (kt, kj), (vt, vj) = _pair(kp, name), _pair(vp, name)
        return (qt, kt, vt, *rest_t), {}, (qj, kj, vj, *rest_j), {}
    quantize, tdt = PAYLOADS[pool]
    kq, vq = quantize(jnp.asarray(kp), -1), quantize(jnp.asarray(vp), -1)

    def values(t):
        return torch.from_numpy(np.array(t.values.astype(jnp.float32))).to(tdt)

    def scales(t):
        return torch.from_numpy(np.array(t.scales))

    return ((qt, values(kq), values(vq), *rest_t),
            dict(k_scales=scales(kq), v_scales=scales(vq)),
            (qj, kq.values, vq.values, *rest_j),
            dict(k_scales=kq.scales, v_scales=vq.scales))


# (chunk, page, window, hq, hkv): decode with GQA 2, a chunk of 4 with a
# window and GQA 4
PAGED_CASES = {"decode_gqa2": (1, 4, None, 4, 2),
               "chunk4_window6_gqa4": (4, 4, 6, 8, 2)}


@pytest.mark.parametrize("d, case, pool", [
    (d, c, p) for d in HEAD_DIMS
    for c, p in (("decode_gqa2", "bf16"), ("chunk4_window6_gqa4", "int8"),
                 ("chunk4_window6_gqa4" if d % 16 else "decode_gqa2", "fp8"))])
def test_paged_head_dims_match_jax(d, case, pool):
    chunk, page, window, hq, hkv = PAGED_CASES[case]
    args_t, kw_t, args_j, kw_j = _paged_inputs(30 + d, d, chunk, page, hq,
                                               hkv, pool)
    got = pt.paged_attention(*args_t, window=window, **kw_t)
    want = jpa.paged_attention(*args_j, window=window, **kw_j)
    assert got.dtype == torch.bfloat16 and got.shape[-1] == d
    _row_ulp_match(got, want)


# (chunk, page, window, hq, hkv) above d 128: a decode with MQA (4 q heads,
# one kv head), a chunk of 64 (two q heads, one kv head), and a decode at
# pages of 128 (JAX's pipelined page walk for the quantized pools too)
WIDE_PAGED_CASES = {"decode_mqa4": (1, 4, None, 4, 1),
                    "chunk64_mqa2": (64, 16, None, 2, 1),
                    "decode_page128_gqa2": (1, 128, None, 4, 2)}


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("d, case", [
    (160, "decode_mqa4"), (256, "decode_mqa4"), (160, "chunk64_mqa2"),
    (256, "chunk64_mqa2"), (256, "decode_page128_gqa2")])
def test_paged_wide_head_dims_match_jax(d, case, pool, name):
    """bf16 and f32 q (pool "bf16": a pool in q's dtype) at d 160 and 256,
    under the gates of the d-80/96 cases: bf16 by ``_row_ulp_match``, f32
    within 1e-5."""
    chunk, page, window, hq, hkv = WIDE_PAGED_CASES[case]
    args_t, kw_t, args_j, kw_j = _paged_inputs(80 + d + chunk, d, chunk,
                                               page, hq, hkv, pool, name)
    got = pt.paged_attention(*args_t, window=window, **kw_t)
    want = jpa.paged_attention(*args_j, window=window, **kw_j)
    assert got.dtype == DTYPES[name][0] and got.shape[-1] == d
    _check(got, want, name)


def _kv8_inputs(d, payload, name):
    rng = np.random.default_rng(40 + d)
    q = rng.standard_normal((1, 2, 256, d)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((1, 1, 256, d)).astype(np.float32))
            for _ in range(2))
    quantize, tdt = PAYLOADS[payload]
    kq, vq = quantize(k, -1), quantize(v, -1)

    def port(t):
        vals = torch.from_numpy(np.array(t.values.astype(jnp.float32))).to(tdt)
        return tq.QuantizedTensor(vals, torch.from_numpy(np.array(t.scales)))

    qt, qj = _pair(q, name)
    return (qt, port(kq), port(vq)), (qj, kq, vq)


@pytest.mark.parametrize("d, payload, name", [
    (16, "int8", "bfloat16"), (24, "fp8", "bfloat16"), (80, "int8", "bfloat16"),
    (96, "fp8", "bfloat16"), (24, "int8", "float32"), (96, "fp8", "float32")])
def test_kv8_head_dims_match_jax(d, payload, name):
    """Causal GQA 2 at 256 keys, JAX's grid route (``_kv8_fwd_kernel``) at
    every head dim below 128.  bf16: o 99% bit for bit and the rest within
    one ulp of the row's largest, lse 1e-5 (XLA_QSCALE_LSE_GAP, 2e-3, on
    the rows whose int8 q scale XLA:CPU computes by a reciprocal, as in
    tests/test_torch_faults.py); f32: 1e-4."""
    port, ref = _kv8_inputs(d, payload, name)
    assert tq._kv8_route(True, 256, 256, d).name == "grid"
    got = pt.flash_attention_kv_int8(*port, True)
    want = jq.flash_attention_kv_int8(*ref, True)
    if name == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=0)
        return
    q = port[0]
    qp = (q * tq._prescale(q, d ** -0.5)).float()
    am = qp.abs().amax(-1)
    odd = ((am / torch.full_like(am, 127.0))
           != (am * torch.tensor(1 / 127.0))).numpy()
    if payload == "fp8":
        odd[:] = False
    g, w = _f32(got[0]), _f32(want[0])
    assert float((g != w)[~odd].mean()) <= 0.01
    row = np.abs(w).max(-1, keepdims=True)
    assert np.all(np.abs(g - w) <= row * 2.0 ** -7)
    lse_err = np.abs(got[1].numpy() - np.asarray(want[1]))[..., 0]
    assert lse_err[~odd].max() <= 1e-5
    assert lse_err.max() <= 2e-3


def _marks_brute(vp, lens, table, chunk, vs=None):
    """The marks as numpy loops: per (sequence, head, page slot of the
    walk) the columns of V that hold a non-finite value, bit c % 32 of word
    c // 32, and the V scale's flag in word cdiv(d, 32)."""
    h_kv, n_pages, page, d = vp.shape
    b, pps = table.shape
    words = -(-d // 32) + 1
    out = np.zeros((b, h_kv, pps, words), np.int64)
    v = vp.float().numpy()
    for bi in range(b):
        n = min(-(-max(int(lens[bi]), 0) // page), pps)
        for hk in range(h_kv):
            for i in range(n):
                p = int(table[bi, i])
                bad = ~np.isfinite(v[hk, p]).all(axis=0)
                for c in np.flatnonzero(bad):
                    out[bi, hk, i, c // 32] |= 1 << (c % 32)
                if vs is not None and not np.isfinite(vs[hk, p].numpy()).all():
                    out[bi, hk, i, words - 1] |= 1
    return np.where(out >= 2 ** 31, out - 2 ** 32, out).astype(np.int32)


@pytest.mark.parametrize("pool", ["bf16", "fp8"])
@pytest.mark.parametrize("d", [24, 80] + WIDE_HEAD_DIMS)
def test_paged_nonfinite_plain_head_dims(d, pool):
    """C18: at d 24, 80, 160 and 256 the marks hold cdiv(d, 32) words of
    columns and the V scale's flag in the word after them (the parent
    reshaped d into d // 32 words and raised).  A NaN in column d - 1, one in column 0 and
    (fp8) a NaN V scale, each on its own page of the walk."""
    rng = np.random.default_rng(50 + d)
    h_kv, n_pages, page, b, pps = 2, 9, 4, 2, 4
    v = torch.from_numpy(rng.standard_normal((h_kv, n_pages, page, d))
                         .astype(np.float32))
    table = torch.from_numpy(rng.permutation(n_pages)[:b * pps]
                             .reshape(b, pps).astype(np.int32))
    lens = torch.tensor([13, 6], dtype=torch.int32)
    vs = None
    if pool == "bf16":
        vp = v.to(torch.bfloat16)
    else:
        q8 = tq.quantize_fp8(v)
        vp, vs = q8.values.clone(), q8.scales.clone()
        vs[0, table[0, 3], 1] = float("nan")
    vp[1, table[0, 1], 2, d - 1] = float("nan")
    vp[0, table[1, 0], 0, 0] = float("nan" if pool == "fp8" else "inf")
    got = tpa.paged_nonfinite(vp, lens, table, 1, v_scales=vs)
    words = -(-d // 32) + 1
    assert got.shape == (b, h_kv, pps, words) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _marks_brute(vp, lens, table, 1, vs))
    col = (int(got[0, 1, 1, (d - 1) // 32]) >> ((d - 1) % 32)) & 1
    assert col == 1 and int(got[0, 1, 1, -1]) == 0
    if pool == "fp8":
        assert int(got[0, 0, 3, -1]) == 1


@pytest.fixture(scope="module")
def d96_models():
    """A DecoderLM with heads of 96 (E192 H2 L2) in both packages, the
    port's loaded with JAX's weights."""
    jm = ft.DecoderLM(64, 192, 2, 128, p_dropout=0.0, n_layer=2,
                      key=jax.random.PRNGKey(3)).eval()
    tm = pt.DecoderLM(64, 192, 2, 128, p_dropout=0.0, n_layer=2,
                      device="cpu").eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


def _serve(engine_cls, model, prompts, max_new, **kw):
    eng = engine_cls(model, **kw)
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    assert all(r.done and not r.truncated for r in reqs)
    assert eng.pool.n_free == eng.pool.total      # every page returned
    return reqs


def test_engine_d96_matches_jax_engine(d96_models):
    """Heads of 96 through the engines' prefill, chunked prefill (prompts
    past ``prefill_chunk``) and decode: identical greedy tokens and every
    consumed position's logits within 1e-4."""
    jm, tm = d96_models
    rng = np.random.default_rng(60)
    prompts = [list(rng.integers(1, 64, size=n)) for n in (5, 19, 11)]
    kw = dict(max_batch=2, page_size=8, pages_per_seq=6, prefill_chunk=8,
              collect_logits=True)
    want = _serve(JaxEngine, jm, prompts, 4, **kw)
    got = _serve(pt.ContinuousBatchingEngine, tm, prompts, 4, **kw)
    for g, w in zip(got, want):
        assert g.generated == w.generated
        np.testing.assert_allclose(np.stack(g.logits), np.stack(w.logits),
                                   atol=1e-4, rtol=1e-4)


def test_train_step_d96_matches_jax():
    """Three Adam steps (lr 1e-3, grad_clip 1.0, dropout off) of a DecoderLM
    with heads of 96 (E192 H2 L2, RoPE) from the same weights in both
    packages: the loss and every parameter after each step within 1e-5.
    Sixteen positions: the attention's op graph and its autodiff on both
    sides."""
    args = (64, 192, 2, 128)
    kw = dict(p_dropout=0.0, n_layer=2, middle_dim=384, pos_encoding="rope")
    jm = ft.DecoderLM(*args, key=jax.random.PRNGKey(5), **kw)
    tm = pt.DecoderLM(*args, device="cpu", **kw)
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    j_opt, t_opt = jopt.Adam(lr=1e-3), pt.Adam(lr=1e-3)
    j_step = jtr.make_train_step(j_opt, grad_clip=1.0, donate=False)
    t_step = pt.make_train_step(t_opt, grad_clip=1.0)
    j_state, t_state = j_opt.init(jm), t_opt.init(tm)
    for i in range(3):
        rng = np.random.default_rng(70 + i)
        tok = rng.integers(0, 64, (2, 16)).astype(np.int32)
        tgt = np.roll(tok, -1, axis=1)
        msk = (rng.random((2, 16)) < 0.8).astype(np.float32)
        jm, j_state, j_loss = j_step(jm, j_state,
                                     *map(jnp.asarray, (tok, tgt, msk)), None)
        tm, t_state, t_loss = t_step(tm, t_state,
                                     *map(torch.from_numpy, (tok, tgt, msk)))
        np.testing.assert_allclose(float(t_loss), float(j_loss), atol=1e-5,
                                   rtol=1e-5)
        t_params = dict(tm.named_parameters())
        for name, want in jm.named_parameters():
            np.testing.assert_allclose(t_params[name].detach().numpy(),
                                       np.asarray(want), atol=1e-5, rtol=1e-5,
                                       err_msg=f"step {i}: {name}")


@pytest.fixture(scope="module")
def d256_models():
    """A DecoderLM with two heads of 256 and one kv head (E512 L2, RoPE) in
    both packages, the port's loaded with JAX's weights."""
    kw = dict(p_dropout=0.0, n_layer=2, n_kv_head=1, pos_encoding="rope")
    jm = ft.DecoderLM(64, 512, 2, 128, key=jax.random.PRNGKey(7), **kw).eval()
    tm = pt.DecoderLM(64, 512, 2, 128, device="cpu", **kw).eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


def test_engine_d256_matches_jax_engine(d256_models):
    """Heads of 256 with MQA through the engines' prefill, chunked prefill
    and decode, as ``test_engine_d96_matches_jax_engine``: identical greedy
    tokens and every consumed position's logits within 1e-4."""
    jm, tm = d256_models
    rng = np.random.default_rng(61)
    prompts = [list(rng.integers(1, 64, size=n)) for n in (5, 19, 11)]
    kw = dict(max_batch=2, page_size=8, pages_per_seq=6, prefill_chunk=8,
              collect_logits=True)
    want = _serve(JaxEngine, jm, prompts, 4, **kw)
    got = _serve(pt.ContinuousBatchingEngine, tm, prompts, 4, **kw)
    for g, w in zip(got, want):
        assert g.generated == w.generated
        np.testing.assert_allclose(np.stack(g.logits), np.stack(w.logits),
                                   atol=1e-4, rtol=1e-4)


# (family, head dim, the ROADMAP.md item its ValueError names, or None
# where the family takes the head dim)
HEAD_DIM_RULE = [
    ("flash_fwd_bf16", 136, None), ("flash_fwd_bf16", 256, None),
    ("paged_bf16", 160, None), ("paged_bf16", 256, None),
    ("flash_fwd_f32", 128, None), ("flash_fwd_f32", 136, "§B2b"),
    ("flash_fwd_f32", 256, "§B2b"), ("paged_f32", 256, "§B2b"),
    ("kv8_flash", 128, None), ("kv8_flash", 160, "§B2b"),
    ("flash_bwd", 128, None), ("flash_bwd", 136, "§B2c"),
    ("flash_bwd", 256, "§B2c"), ("flash_fwd_bf16", 264, "§B)"),
    ("paged_bf16", 250, "§B3"), ("flash_bwd", 20, "§B3")]


@pytest.mark.parametrize("family, d, item", HEAD_DIM_RULE)
def test_head_dim_rule(family, d, item):
    """Step 1's rule, a shape and dtype rule that never looks at a device:
    the bf16 flash forward and bf16-q paged attention (with the marks) take
    every multiple of 8 up to 256; the f32 forward, f32-q paged attention
    and ``kv8_flash`` stop at 128 (§B2b), the flash backward at 128 (§B2c);
    above 256 and off the multiples of 8 nothing takes it."""
    from flashattn_tpu_torch.ops import _utils

    assert _utils.HEAD_DIM_LIMITS[family][0] == (256 if family in (
        "flash_fwd_bf16", "paged_bf16") else 128)
    if item is None:
        _utils.check_head_dim(d, "kernel", family)
        return
    with pytest.raises(ValueError) as err:
        _utils.check_head_dim(d, "kernel", family)
    assert item in str(err.value)
