"""Faults of the port against the JAX package, each held to the JAX twin on
the CPU with the same numpy-seeded inputs.

* Dropout divides the kept value by ``1.0 - rate`` as JAX does, a weakly
  typed Python scalar that takes the array's dtype (bf16(0.9) = 0.8984375),
  never by multiplying with an f32 reciprocal.  The masks cannot match
  across frameworks, so JAX's formula runs under the port's ``keep_mask``;
  the results must agree bit for bit.
* The res-bias forward rounds as the TPU kernel ``_res_bias_kernel`` does:
  x + b to the input dtype, the quotient to it, then r + it.  The act-bias
  variant and both backwards compute in f32 after rounding x + b to the
  input dtype, as their TPU kernels do.
* GELU's constants take the input's dtype (bf16 literals for bf16 input).
* The bf16 fused softmax (``attn_softmax``, impl "auto") is JAX's op graph:
  each op rounded to bf16, the promoted dtype of a strong f32 mask, and the
  backward JAX's autodiff of the graph with XLA:CPU's windowed bf16 sum,
  bit for bit; ``impl="pallas"`` keeps the Pallas kernels' function (C7).
* Public names of the done slices: ``Embedding(use_one_hot_matmul=)``,
  ``attn_softmax_pallas``, ``mha_attention`` and the engine keywords.
* The bf16 flash attention picks its function by shape, as JAX's
  dispatcher does (C9-C11): the TPU kernels' schedules from 1024 keys up,
  the op graph and its autodiff below, and ``flash_attention_kv_int8``'s
  op-graph fallback where JAX's tiler cannot divide the shape; tested
  through the public functions on both sides, JAX's Pallas kernels in
  interpret mode.
* ``flash_attention_kv_int8`` computes the function of the route JAX's
  dispatcher picks by shape (C16): the grid's running max per key block,
  the loop's and the subrow's V scale folded into p, the subrow's single
  pass against the row's max and its division.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu as ft
import flashattn_tpu_torch as pt
from flashattn_tpu.nn import functional as jF
from flashattn_tpu.ops import dropout as jdr
from flashattn_tpu.ops import flash_attention as jfa
from flashattn_tpu.ops import softmax as jsm
from flashattn_tpu.serving import ContinuousBatchingEngine as JaxEngine
from flashattn_tpu_torch.ops import dropout as dr

torch.set_num_threads(1)

SEED = 0x5EED0F00D
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GELU_C = 0.7978845608028654


def _data(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _pair(a, name):
    """The same values as a torch tensor and a jax array of dtype ``name``."""
    td, jd = DTYPES[name]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _bits(t):
    """Bit patterns of a float32 or bfloat16 tensor / array, as int numpy."""
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.array(jnp.asarray(t).astype(jnp.float32)))
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.contiguous().view(torch.int32).numpy()


def _same_bits(got, want):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape
    differ = int((g != w).sum())
    assert differ == 0, f"{differ} of {g.size} values differ"


def _keep(shape, rate):
    return jnp.asarray(dr.keep_mask(int(np.prod(shape)), rate, SEED)
                       .reshape(shape).numpy())


# -- C1: dropout -----------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("name", list(DTYPES))
def test_dropout_divides_like_jax(name, rate):
    """Forward and backward (dropout is its own adjoint) of fused_dropout
    against ``jnp.where(keep, x, 0) / (1.0 - rate)``; unscaled dropout keeps
    the survivors as they are."""
    x_np = _data((64, 96), 0, 3.0)
    xt, xj = _pair(x_np, name)
    keep = _keep(x_np.shape, rate)
    kept = jnp.where(keep, xj, jnp.zeros_like(xj))
    _same_bits(pt.fused_dropout(xt, rate, SEED), kept / (1.0 - rate))
    _same_bits(pt.F.dropout(xt, rate, seed=SEED, scale=False), kept)
    g_np = _data(x_np.shape, 1, 2.0)
    gt, gj = _pair(g_np, name)
    xg = xt.clone().requires_grad_()
    (dx,) = torch.autograd.grad(pt.fused_dropout(xg, rate, SEED), xg, gt)
    _same_bits(dx, jnp.where(keep, gj, jnp.zeros_like(gj)) / (1.0 - rate))


# -- C2: dropout with bias ---------------------------------------------------------


@pytest.mark.parametrize("name", list(DTYPES))
def test_res_bias_rounds_like_jax(name):
    """``_res_bias_kernel``'s arithmetic in the input dtype, forward bit for
    bit; the backward's dx (f32, ``_mask_colsum_kernel``) bit for bit."""
    rate = 0.1
    x_np, r_np = _data((48, 80), 3, 2.0), _data((48, 80), 4)
    b_np = _data((80,), 5)
    (xt, xj), (rt, rj), (bt, bj) = (_pair(a, name) for a in (x_np, r_np, b_np))
    keep = _keep(x_np.shape, rate)
    y = xj + bj
    y = jnp.where(keep, y, jnp.zeros_like(y)) / (1.0 - rate)
    _same_bits(pt.fused_dropout_res_bias(xt, bt, rt, rate, SEED), rj + y)

    g_np = _data(x_np.shape, 6)
    gt, gj = _pair(g_np, name)
    ts = [t.clone().requires_grad_() for t in (xt, bt, rt)]
    dx, db, dr_ = torch.autograd.grad(
        pt.fused_dropout_res_bias(*ts, rate, SEED), ts, gt)
    want = jnp.where(keep, gj.astype(jnp.float32), 0.0) / (1.0 - rate)
    _same_bits(dx, want.astype(gj.dtype))
    _same_bits(dr_, gj)
    tol = 1e-5 if name == "float32" else 2e-2
    np.testing.assert_allclose(db.float().numpy(),
                               np.asarray(want.sum(0), np.float32),
                               atol=tol * 8, rtol=tol)


def _jax_act_bias(xj, bj, keep, rate, act):
    """The arithmetic of ``_act_bias_kernel`` (flashattn_tpu/ops/dropout.py
    :93-102)."""
    u = (xj + bj).astype(jnp.float32)
    if act == "gelu":
        y = 0.5 * u * (1.0 + jnp.tanh(GELU_C * (u + 0.044715 * u**3)))
    else:
        y = jnp.maximum(u, 0.0)
    return (jnp.where(keep, y, jnp.zeros_like(y)) / (1.0 - rate)).astype(
        xj.dtype)


def _jax_act_bias_dx(gj, xj, bj, keep, rate, act):
    """dx of ``_act_bias_bwd_kernel`` (flashattn_tpu/ops/dropout.py:127-144)."""
    dy = jnp.where(keep, gj.astype(jnp.float32), 0.0) / (1.0 - rate)
    u = (xj + bj).astype(jnp.float32)
    if act == "gelu":
        t = jnp.tanh(GELU_C * (u + 0.044715 * u**3))
        dact = 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * GELU_C * (
            1.0 + 3 * 0.044715 * u * u)
    else:
        dact = (u > 0.0).astype(jnp.float32)
    return (dy * dact).astype(gj.dtype)


@pytest.mark.parametrize("name", list(DTYPES))
def test_act_bias_divides_like_jax(name):
    """ReLU bit for bit; GELU within two ulps of the output dtype and 1e-5
    (torch.tanh and XLA's tanh round differently), forward and the
    backward's dx."""
    rate = 0.3
    x_np, b_np, g_np = _data((40, 72), 7, 2.0), _data((72,), 8), _data((40, 72), 9)
    (xt, xj), (bt, bj), (gt, gj) = (_pair(a, name) for a in (x_np, b_np, g_np))
    keep = _keep(x_np.shape, rate)
    ulp = 2.0 ** -23 if name == "float32" else 2.0 ** -7
    for act in ("relu", "gelu"):
        ts = [t.clone().requires_grad_() for t in (xt, bt)]
        got = pt.fused_dropout_act_bias(*ts, rate, SEED, act)
        dx, _ = torch.autograd.grad(got, ts, gt)
        want = _jax_act_bias(xj, bj, keep, rate, act)
        want_dx = _jax_act_bias_dx(gj, xj, bj, keep, rate, act)
        if act == "relu":
            _same_bits(got, want)
            _same_bits(dx, want_dx)
            continue
        for a, w in ((got, want), (dx, want_dx)):
            w = np.asarray(w.astype(jnp.float32))
            np.testing.assert_allclose(a.detach().float().numpy(), w,
                                       rtol=2 * ulp, atol=1e-5)


# -- C3: GELU constants ------------------------------------------------------------


def test_gelu_bf16_matches_jax_bit_for_bit():
    x_np = _data((4096,), 10, 3.0)
    for name in DTYPES:
        xt, xj = _pair(x_np, name)
        if name == "bfloat16":
            _same_bits(pt.F.GELU(xt), jF.GELU(xj))
        else:
            np.testing.assert_allclose(pt.F.GELU(xt).numpy(), jF.GELU(xj),
                                       atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("rate, seed", [(0.0, SEED), (0.2, None)])
def test_act_bias_gelu_without_dropout_bf16_matches_jax(rate, seed):
    """At rate 0 or without a seed both packages compute GELU(x + b) in the
    input dtype, constants included."""
    (xt, xj), (bt, bj) = (_pair(a, "bfloat16")
                          for a in (_data((24, 40), 11, 2.0), _data((40,), 12)))
    key = None if seed is None else jax.random.PRNGKey(0)
    _same_bits(pt.fused_dropout_act_bias(xt, bt, rate, seed, "gelu"),
               jdr.fused_dropout_act_bias(xj, bj, rate, key, "gelu"))


# -- C4: public names --------------------------------------------------------------


@pytest.mark.parametrize("one_hot", [True, False])
def test_embedding_one_hot_matmul_matches_jax(one_hot):
    jm = ft.Embedding(50, 16, key=jax.random.PRNGKey(3),
                      use_one_hot_matmul=one_hot)
    tm = pt.Embedding(50, 16, use_one_hot_matmul=one_hot)
    assert tm.use_one_hot_matmul is one_hot
    with torch.no_grad():
        tm.weights.copy_(torch.from_numpy(np.array(jm.weights)))
    tok = np.random.default_rng(13).integers(0, 50, (3, 7))
    got = tm(torch.from_numpy(tok))
    np.testing.assert_allclose(got.detach().numpy(), jm(jnp.asarray(tok)),
                               atol=1e-6)
    got.square().sum().backward()
    assert tm.weights.grad is not None and tm.weights.grad.shape == (50, 16)


@pytest.mark.parametrize("causal, masked", [(True, False), (False, True),
                                            (True, True)])
def test_attn_softmax_pallas_matches_jax(causal, masked):
    x_np = _data((2, 3, 9, 20), 14, 2.0)
    mask = None
    if masked:
        mask = np.where(_data((2, 1, 1, 20), 15) > -0.5, 0.0, -1e9).astype(
            np.float32)
    got = pt.attn_softmax_pallas(torch.from_numpy(x_np),
                                 None if mask is None else torch.from_numpy(mask),
                                 causal)
    want = jsm.attn_softmax_pallas(jnp.asarray(x_np),
                                   None if mask is None else jnp.asarray(mask),
                                   causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert "attn_softmax_pallas" in pt.__all__


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_attention_matches_jax(use_flash, causal):
    q, k, v = (_data((2, 2, 16, 32), 16 + i) for i in range(3))
    got = pt.mha_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                           use_flash)
    want = jfa.mha_attention(*(jnp.asarray(a) for a in (q, k, v)), causal,
                             use_flash)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    assert "mha_attention" in pt.__all__


@pytest.fixture(scope="module")
def tiny_pair():
    jm = ft.DecoderLM(64, 32, 4, 64, p_dropout=0.0, n_layer=1,
                      key=jax.random.PRNGKey(5)).eval()
    tm = pt.DecoderLM(64, 32, 4, 64, p_dropout=0.0, n_layer=1,
                      device="cpu").eval()
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    return jm, tm


@pytest.fixture(scope="module")
def tiny_model(tiny_pair):
    return tiny_pair[1]


def test_engine_accepts_jax_keywords_at_defaults(tiny_model):
    eng = pt.ContinuousBatchingEngine(
        tiny_model, max_batch=1, page_size=8, pages_per_seq=2, seed=7,
        head_axis="model", spec_len=4, spec_waves_per_dispatch=4,
        lookup_max_ngram=3)
    assert eng.seed == 7
    assert pt.ContinuousBatchingEngine(tiny_model, max_batch=1, page_size=8,
                                       pages_per_seq=2).seed == 0
    req = eng.submit([1, 2, 3], 2)
    eng.run()
    assert req.done and len(req.generated) == 2


@pytest.mark.parametrize("knob", [dict(spec_len=2),
                                  dict(spec_waves_per_dispatch=1),
                                  dict(lookup_max_ngram=5)])
def test_engine_speculation_knobs_match_jax(tiny_pair, knob):
    """Each speculation knob away from its default serves as the JAX engine
    does: spec_len and spec_waves_per_dispatch under self-draft
    speculation, lookup_max_ngram under prompt lookup.  Same tokens and
    the same acceptance counters."""
    mode = ({"prompt_lookup": 3} if "lookup_max_ngram" in knob
            else {"draft_model": None})
    runs = []
    for cls, model in ((JaxEngine, tiny_pair[0]),
                       (pt.ContinuousBatchingEngine, tiny_pair[1])):
        extra = {k: model if k == "draft_model" else v
                 for k, v in mode.items()}
        eng = cls(model, max_batch=1, page_size=8, pages_per_seq=4,
                  steps_per_dispatch=1, **knob, **extra)
        req = eng.submit([5, 9, 2, 5, 9, 2, 5], 12)
        eng.run()
        runs.append((req.generated, eng.spec_stats, eng.lookup_stats))
    assert runs[0] == runs[1]
    assert max(runs[1][1][1], runs[1][2][1]) > 0


# -- C6: the bf16 flash backward rounds p and dS like JAX ---------------------------


def _differ(got, want):
    """(fraction of elements that differ, max abs difference) between a
    torch tensor and a jax array."""
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape
    diff = np.abs(g.view(np.float32) - w.view(np.float32))
    return float((g != w).mean()), float(diff.max())


def _bf16_inputs(seed, b, h, h_kv, n, d):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, h, n, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, h_kv, n, d)).astype(np.float32)
            for _ in range(2))
    return [_pair(a, "bfloat16") for a in (q, k, v, do)]


def _check_bwd(got, want, h, h_kv):
    """dv bit for bit (to one element in a thousand when a GQA group sums
    f32 partial products in its own order); dq and dk within 2% of their
    elements: the JAX dots' f32 sums run in another order, which moves a
    rounding of ds or of an output now and then.  The unrounded plain
    version differed in ~40% of each."""
    (fq, eq), (fk, ek), (fv, ev) = (_differ(g, w) for g, w in zip(got, want))
    assert fq <= 0.02 and fk <= 0.02, (fq, fk)
    assert fv <= (0.0 if h == h_kv else 1e-3), (fv, ev)
    assert max(eq, ek, ev) <= 2 ** -6


@pytest.mark.parametrize("schedule", ["subrow", "loop"])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2)])
def test_flash_bwd_bf16_rounds_like_jax(schedule, heads):
    """The plain backward (``_reference_bwd``, what the CPU runs and what the
    CUDA kernels are held to) against the TPU dense causal backward
    kernels at b1 n128 d32 bf16, lse and di from JAX's forward."""
    from flashattn_tpu_torch.ops import flash_attention as tfa

    h, h_kv = heads
    (qt, qj), (kt, kj), (vt, vj), (dot, doj) = _bf16_inputs(1, 1, h, h_kv,
                                                            128, 32)
    scale = 32 ** -0.5
    o, lse = jfa._reference_fwd_with_lse(qj, kj, vj, True, scale)
    di = jnp.sum(o.astype(jnp.float32) * doj.astype(jnp.float32), axis=-1,
                 keepdims=True)
    if schedule == "subrow":
        want = jfa._flash_bwd_subrow(qj, kj, vj, lse, di, doj, sm_scale=scale,
                                     sub=64)
    else:
        want = jfa._flash_bwd_loop(qj, kj, vj, lse, di, doj, sm_scale=scale,
                                   block=64)
    got = tfa._reference_bwd(qt, kt, vt, torch.from_numpy(np.array(lse)),
                             torch.from_numpy(np.array(di)), dot, True, scale)
    _check_bwd(got, want, h, h_kv)


@pytest.mark.parametrize("case", ["window", "lengths"])
def test_flash_bwd_bf16_grid_rounds_like_jax(case):
    """Against the grid backward (``_flash_bwd``, blocks of 16): a window of
    12, and kv_lengths with a 0 (that row's dq and its dk / dv are 0)."""
    from flashattn_tpu_torch.ops import flash_attention as tfa

    (qt, qj), (kt, kj), (vt, vj), (dot, doj) = _bf16_inputs(2, 2, 2, 2, 64, 32)
    scale = 32 ** -0.5
    window = 12 if case == "window" else None
    lens = np.array([64, 0] if case == "lengths" else [64, 64], np.int32)
    lens_j = None if case == "window" else jnp.asarray(lens)
    lens_t = None if case == "window" else torch.from_numpy(lens)
    o, lse = jfa._reference_fwd_with_lse(qj, kj, vj, True, scale, lens_j,
                                         window)
    want = jfa._flash_bwd(qj, kj, vj, o, lse, doj, causal=True, sm_scale=scale,
                          block_q=16, block_k=16, kv_lengths=lens_j,
                          window=window)
    di = jnp.sum(o.astype(jnp.float32) * doj.astype(jnp.float32), axis=-1,
                 keepdims=True)
    got = tfa._reference_bwd(qt, kt, vt, torch.from_numpy(np.array(lse)),
                             torch.from_numpy(np.array(di)), dot, True, scale,
                             lens_t, window)
    _check_bwd(got, want, 2, 2)
    if case == "lengths":
        assert all((g[1] == 0).all() for g in got)


# -- C5: bf16 kv8_flash rounds V and P like JAX -----------------------------------


def _kv8_bf16(seed, h, h_kv, n, d, payload):
    from flashattn_tpu.ops import quant as jq
    from flashattn_tpu_torch.ops import quant as tq

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, h, n, d)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((1, h_kv, n, d)).astype(np.float32))
            for _ in range(2))
    quantize = jq.quantize_int8 if payload == "int8" else jq.quantize_fp8
    tdt = torch.int8 if payload == "int8" else torch.float8_e4m3fn

    def port(t):
        vals = torch.from_numpy(np.array(t.values.astype(jnp.float32))).to(tdt)
        return tq.QuantizedTensor(vals, torch.from_numpy(np.array(t.scales)))

    kq, vq = quantize(k, -1), quantize(v, -1)
    qt, qj = _pair(q, "bfloat16")
    return (qt, port(kq), port(vq)), (qj, kq, vq)


def _check_kv8(got, want, max_frac, lse_tol=1e-6):
    """o differing in at most ``max_frac`` of its elements (0: bit for bit;
    the JAX grid walks the keys in blocks whose running max may differ
    from the row's, and sums the row and PV in f32 in another order, which
    moves a rounding now and then in longer rows), lse to ``lse_tol``.  The
    f32-dequantized plain version differed in 47-50% of o."""
    frac, _ = _differ(got[0], want[0])
    assert frac <= max_frac, frac
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=lse_tol, rtol=0)


@pytest.mark.parametrize("payload", ["int8", "fp8"])
@pytest.mark.parametrize("causal", [True, False])
def test_kv8_flash_bf16_rounds_like_jax(payload, causal):
    """b1 h2 n128 d32 bf16 q against ``_kv8_fwd_kernel`` (the JAX grid)."""
    from flashattn_tpu.ops import quant as jq

    port, ref = _kv8_bf16(7, 2, 2, 128, 32, payload)
    _check_kv8(pt.flash_attention_kv_int8(*port, causal),
               jq.flash_attention_kv_int8(*ref, causal), 0.0 if causal else 1e-3)


@pytest.mark.parametrize("payload", ["int8", "fp8"])
def test_kv8_flash_bf16_gqa_rounds_like_jax(payload):
    """GQA 4q/2kv at n 512 d64 causal: the port's grouped call against the
    JAX grid kernel on K/V repeated to every query head (the grid kernel
    reads kv head h; JAX's loop and subrow schedules, which take GQA, fold
    the V scale into p and round p * vs instead of V, another function in
    bf16).  With int8 payloads ten of the 2048 rows' lse differ from the
    interpret-mode grid kernel's by up to 1.5e-3, by as much before the
    repair (so not through V or P); the rest agree to 1e-6.  The grouped
    call must equal the port's own call on the repeated K/V bit for bit."""
    from flashattn_tpu.ops import quant as jq
    from flashattn_tpu_torch.ops import quant as tq

    port, (qj, kq, vq) = _kv8_bf16(8, 4, 2, 512, 64, payload)
    rep_t = [tq.QuantizedTensor(t.values.repeat_interleave(2, dim=1),
                                t.scales.repeat_interleave(2, dim=1))
             for t in port[1:]]
    rep = [jq.QuantizedTensor(jnp.repeat(t.values, 2, axis=1),
                              jnp.repeat(t.scales, 2, axis=1))
           for t in (kq, vq)]
    got = pt.flash_attention_kv_int8(*port, True)
    for g, w in zip(got, pt.flash_attention_kv_int8(port[0], *rep_t, True)):
        assert torch.equal(g, w)
    want = jq.flash_attention_kv_int8(qj, *rep, True)
    lse_ok = np.abs(got[1].numpy() - np.asarray(want[1])) <= 1e-6
    assert lse_ok.mean() >= (0.99 if payload == "int8" else 1.0)
    _check_kv8(got, want, 0.01, 2e-3 if payload == "int8" else 1e-6)


# -- C7: the bf16 fused-softmax path rounds like JAX's op graph -------------------


def _sm_data(shape, seed):
    """bf16 scores ~ 3 N(0, 1) and an upstream gradient, as torch and jax."""
    x_np, g_np = _data(shape, seed, 3.0), _data(shape, seed + 1)
    return _pair(x_np, "bfloat16"), _pair(g_np, "bfloat16")


def _padding_masks(b, t, lengths):
    """The model's (B, 1, 1, T) padding mask: the port's in bf16, JAX's
    weakly typed (Python floats), as ``MultiHeadAttention`` builds them."""
    valid = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    mt = torch.where(torch.from_numpy(valid), 0.0, -1e9).to(torch.bfloat16)
    mj = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return mt[:, None, None, :], mj[:, None, None, :]


def _jax_vjp(x, mask, causal, g, impl="auto"):
    fn = lambda a: jsm.attn_softmax(a, mask, causal, impl=impl)
    return jax.vjp(fn, x)[1](g)[0]


@pytest.mark.parametrize("t", [64, 2048])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_softmax_auto_bf16_matches_jax(t, causal):
    """``attn_softmax`` (impl "auto") on bf16 scores is JAX's op graph bit
    for bit: d = x - max, e = exp(d), w = sum_f32(e) and e / w each rounded
    to bf16.  The f32-inside function (the parent's) differed in 72% of the
    elements non-causal, 36% causal, at T 64."""
    (xt, xj), _ = _sm_data((2, 2, 64, t), 21)
    got = pt.attn_softmax(xt, None, causal)
    assert got.dtype == torch.bfloat16
    _same_bits(got, jsm.attn_softmax(xj, None, causal))


def test_attn_softmax_auto_bf16_weak_mask_with_empty_row():
    """A bf16 padding mask (JAX: weakly typed, so ``s + mask`` stays bf16)
    with a length-0 row, causal and not: bf16 out, bit for bit, forward and
    backward."""
    (xt, xj), (gt, gj) = _sm_data((3, 2, 40, 96), 23)
    mt, mj = _padding_masks(3, 96, [96, 0, 37])
    for causal in (False, True):
        xg = xt.clone().requires_grad_()
        got = pt.attn_softmax(xg, mt, causal)
        assert got.dtype == torch.bfloat16
        _same_bits(got, jsm.attn_softmax(xj, mj, causal))
        (dx,) = torch.autograd.grad(got, xg, gt)
        _same_bits(dx, _jax_vjp(xj, mj, causal, gj))


def test_attn_softmax_auto_strong_f32_mask_promotes_like_jax():
    """A strong f32 mask beside bf16 scores promotes the result to f32 in
    JAX; the port returns f32 too, with JAX's values (f32 arithmetic: exp
    may differ in its last bit, hence 1e-6) and a bf16 gradient."""
    (xt, xj), _ = _sm_data((2, 2, 16, 64), 25)
    m_np = np.where(_data((2, 1, 1, 64), 26) > -0.8, 0.0, -1e9).astype(
        np.float32)
    want = jsm.attn_softmax(xj, jnp.asarray(m_np), True)
    xg = xt.clone().requires_grad_()
    got = pt.attn_softmax(xg, torch.from_numpy(m_np), True)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    got.sum().backward()
    assert xg.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("t", [64, 2048])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_softmax_auto_bf16_backward_matches_jax(t, causal):
    """The bf16 backward against ``jax.vjp`` of JAX's ``attn_softmax``:
    bit for bit (measured: 0 elements differ at T 64 and 2048, causal and
    not).  Its ``reduce_sum`` of (dout / w^2) e is XLA:CPU's bf16 sum:
    windows of 32, each summed in order with a bf16 rounding per add.  The
    f32 formula out (dout - sum(out dout)) differed in 52-86%."""
    (xt, xj), (gt, gj) = _sm_data((2, 2, 64, t), 27)
    xg = xt.clone().requires_grad_()
    (dx,) = torch.autograd.grad(pt.attn_softmax(xg, None, causal), xg, gt)
    _same_bits(dx, _jax_vjp(xj, None, causal, gj))


@pytest.mark.parametrize("causal", [False, True])
def test_attn_softmax_pallas_bf16_matches_jax_kernel(causal):
    """Guard: ``impl="pallas"`` keeps the Pallas kernels' function (f32
    inside, one rounding) against the TPU kernels in interpret mode,
    forward and backward, bf16 with a bf16 padding mask."""
    (xt, xj), (gt, gj) = _sm_data((2, 2, 32, 64), 29)
    mt, mj = _padding_masks(2, 64, [64, 21])
    mj = mj.astype(jnp.bfloat16)
    xg = xt.clone().requires_grad_()
    got = pt.attn_softmax(xg, mt, causal, impl="pallas")
    assert got.dtype == torch.bfloat16
    _same_bits(got, jsm.attn_softmax(xj, mj, causal, impl="pallas"))
    (dx,) = torch.autograd.grad(got, xg, gt)
    frac, err = _differ(dx, _jax_vjp(xj, mj, causal, gj, impl="pallas"))
    assert frac <= 0.01 and err <= 2 ** -8, (frac, err)


@pytest.mark.parametrize("lengths", [None, [11, 0, 5]])
def test_mha_fused_softmax_bf16_matches_jax(lengths):
    """``MultiHeadAttention(attn_impl="fused_softmax")`` in bf16 (weights and
    input cast to bf16 on both sides) against the JAX twin: the output
    within one bf16 ulp of JAX's largest value (2^-8 max |JAX|), and at most
    2% of its elements differ (the score and value products may accumulate
    in f32 in another order; measured: none differs).  The f32-inside
    softmax differed in 32-43% of them."""
    jm = ft.MultiHeadAttention(64, 4, p_dropout=0.0, attn_impl="fused_softmax",
                               causal=lengths is None, key=jax.random.PRNGKey(8))
    tm = pt.MultiHeadAttention(64, 4, p_dropout=0.0, attn_impl="fused_softmax",
                               causal=lengths is None)
    pt.load_jax_params(tm, {n: np.asarray(a) for n, a in jm.named_parameters()})
    jm = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jm)
    tm = tm.to(torch.bfloat16)
    xt, xj = _pair(_data((3, 48, 64), 31), "bfloat16")
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    with torch.inference_mode():
        got = tm(xt, None if lens is None else torch.from_numpy(lens))
    want = jm(xj, kv_lengths=None if lens is None else jnp.asarray(lens))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    frac, err = _differ(got, want)
    scale = float(jnp.abs(want.astype(jnp.float32)).max())
    assert frac <= 0.02 and err <= 2 ** -8 * scale, (frac, err)


# -- C8: bf16 paged attention ----------------------------------------------------

# (d, chunk, page, window, hq, hkv): d 128 takes JAX's pipelined page walk
# (_paged_dma_body), d 32 its page-slot grid (_paged_kernel); GQA groups of
# 2 and 4
PAGED_BF16_CASES = {
    "pipelined_decode": (128, 1, 8, None, 4, 2),
    "pipelined_chunk4": (128, 4, 8, None, 4, 2),
    "pipelined_gqa4_chunk2_window6": (128, 2, 8, 6, 8, 2),
    "grid_decode": (32, 1, 4, None, 4, 2),
    "grid_chunk4_window6": (32, 4, 4, 6, 4, 2),
}
# quantized pools: d 128 at page 128 rides the pipelined quantized walk,
# d 32 the grid
PAGED_QUANT_CASES = {
    "pipelined_decode": (128, 1, 128, None, 4, 2),
    "pipelined_chunk4": (128, 4, 128, None, 4, 2),
    "grid_decode": (32, 1, 4, None, 4, 2),
    "grid_chunk4_window6": (32, 4, 4, 6, 4, 2),
}


def _paged_bf16_inputs(seed, d, chunk, page, hq, hkv, payload=None):
    """bf16 q and pools (or int8 / fp8 pools with their scales) for the port
    and for JAX from the same numpy draws.  Five sequences of three pages:
    a full table, a mid-page length, a length equal to the chunk, a length
    0 and a padding length past the table's capacity."""
    from flashattn_tpu.ops import quant as jq

    rng = np.random.default_rng(seed)
    b, pps, n_pages = 5, 3, 16
    shape = (b, chunk, hq, d) if chunk > 1 else (b, hq, d)
    q = rng.standard_normal(shape).astype(np.float32)
    kp, vp = (rng.standard_normal((hkv, n_pages, page, d)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(n_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    lens = np.asarray([page * pps, page + chunk + 1, chunk, 0,
                       page * pps + 3], np.int32)
    qt, qj = _pair(q, "bfloat16")
    rest_t = [torch.from_numpy(a) for a in (lens, table)]
    rest_j = [jnp.asarray(a) for a in (lens, table)]
    if payload is None:
        (kt, kj), (vt, vj) = _pair(kp, "bfloat16"), _pair(vp, "bfloat16")
        return (qt, kt, vt, *rest_t), {}, (qj, kj, vj, *rest_j), {}
    quantize = jq.quantize_int8 if payload == "int8" else jq.quantize_fp8
    tdt = torch.int8 if payload == "int8" else torch.float8_e4m3fn
    kq, vq = quantize(jnp.asarray(kp), -1), quantize(jnp.asarray(vp), -1)

    def values(t):
        return torch.from_numpy(np.array(t.values.astype(jnp.float32))).to(tdt)

    def scales(t):
        return torch.from_numpy(np.array(t.scales))

    return ((qt, values(kq), values(vq), *rest_t),
            dict(k_scales=scales(kq), v_scales=scales(vq)),
            (qj, kq.values, vq.values, *rest_j),
            dict(k_scales=kq.scales, v_scales=vq.scales))


def _paged_matches(got, want, d, abs_tol=None):
    """Bit for bit at d 32.  At d 128 the f32 sums of the dots (128 products,
    of widened int8 / fp8 payloads up to 127 or 448 in a quantized pool)
    round in XLA's summation order, which PyTorch's matmul does not share
    (XLA's own jit and eager dots disagree in ~0.4% of such scores): there
    at least 99.5% of the elements are equal (0.01-0.12% differ at these
    seeds) and every other one is within one bf16 ulp of JAX's value (and
    ``abs_tol``, if given).  The order the port ran before differed in
    34-51%."""
    frac, err = _differ(got, want)
    if d == 32:
        assert frac == 0, f"{frac:.2e} of the elements differ (max {err:.2e})"
        return
    assert frac <= 5e-3, frac
    want_f = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want_f)
    assert np.all(diff <= np.abs(want_f) * 2.0 ** -7), err
    if abs_tol is not None:
        assert err <= abs_tol, err


@pytest.mark.parametrize("case", list(PAGED_BF16_CASES))
def test_paged_attention_bf16_matches_jax_kernel(case):
    """The port's paged attention on CPU tensors (its plain page walk) is
    JAX's paged_attention in bf16 (tolerance: :func:`_paged_matches`): q
    prescaled in bf16, f32 scores, the softmax page by page in exp2 at a
    -1e30 mask, p rounded to bf16 before the PV dot.  The f32 oracle order
    it ran before differed in 34-45% of the elements."""
    from flashattn_tpu.ops import paged_attention as jpa

    d, chunk, page, window, hq, hkv = PAGED_BF16_CASES[case]
    args_t, _, args_j, _ = _paged_bf16_inputs(11, d, chunk, page, hq, hkv)
    got = pt.paged_attention(*args_t, window=window)
    want = jpa.paged_attention(*args_j, window=window)
    assert got.dtype == torch.bfloat16
    _paged_matches(got, want, d)


@pytest.mark.parametrize("case", list(PAGED_QUANT_CASES))
@pytest.mark.parametrize("payload", ["int8", "fp8"])
def test_paged_attention_quantized_bf16_matches_jax_kernel(payload, case):
    """int8 / fp8 pools with bf16 q: the payload widened to bf16 unscaled,
    the K scale on the scores, p times the V scale rounded to bf16 before
    the PV dot, as the TPU kernels (tolerance: :func:`_paged_matches`,
    int8's other elements within 1e-4 besides).  The f32 dequantized order
    it ran before differed in 35-51%."""
    from flashattn_tpu.ops import paged_attention as jpa

    d, chunk, page, window, hq, hkv = PAGED_QUANT_CASES[case]
    args_t, kw_t, args_j, kw_j = _paged_bf16_inputs(12, d, chunk, page, hq, hkv,
                                                    payload)
    got = pt.paged_attention(*args_t, window=window, **kw_t)
    want = jpa.paged_attention(*args_j, window=window, **kw_j)
    assert got.dtype == torch.bfloat16
    _paged_matches(got, want, d, abs_tol=1e-4 if payload == "int8" else None)


@pytest.mark.parametrize("case", ["pipelined_chunk4", "grid_chunk4_window6"])
def test_paged_attention_reference_bf16_matches_jax_oracle(case):
    """The guard: the port's paged_attention_reference stays the twin of
    JAX's f32 oracle (dense gather, one softmax) in bf16 too."""
    from flashattn_tpu.ops import paged_attention as jpa

    d, chunk, page, window, hq, hkv = PAGED_BF16_CASES[case]
    args_t, _, args_j, _ = _paged_bf16_inputs(13, d, chunk, page, hq, hkv)
    got = pt.paged_attention_reference(*args_t, window=window)
    want = jpa.paged_attention_reference(*args_j, window=window)
    frac, err = _differ(got, want)
    assert frac <= 1e-3 and err <= 2.0 ** -7, (frac, err)


# -- C15: a wave wider than one row tile ----------------------------------------


@pytest.mark.parametrize("case", ["late_page_causal", "early_page_window"])
def test_paged_wide_wave_nan_columns_match_jax(case):
    """A 256-row wave (two of the bf16 extend tile's 128-row tiles) with a
    NaN V row on a page that one tile's own keys never reach: past the
    first tile's last key (causal), or before the last tile's window (window
    40, on the first page the wave's earliest row reaches).  JAX's page walk
    takes every row of the wave at each page it visits, so the NaN columns
    reach every row; the port's plain walk (the card kernels' yardstick)
    gives the same NaN pattern.  The marks of ``paged_nonfinite`` name the
    page and column."""
    from flashattn_tpu.ops import paged_attention as jpa
    from flashattn_tpu_torch.ops import paged_attention as tpa

    rng = np.random.default_rng(15)
    b, chunk, hq, hkv, d, page, pps = 2, 256, 2, 2, 32, 16, 24
    n_pages = b * pps
    q = rng.standard_normal((b, chunk, hq, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((hkv, n_pages, page, d)).astype(np.float32)
              for _ in range(2))
    table = rng.permutation(n_pages).reshape(b, pps).astype(np.int32)
    lens = np.asarray([chunk, chunk + 100], np.int32)
    window = None if case == "late_page_causal" else 40
    # sequence 0: late in its wave (causal) or on its first visited page
    pos = chunk - 3 if window is None else 2
    page_of = table[0, pos // page]
    vp[:, page_of, pos % page, 5] = np.nan
    # sequence 1: a page past its walk, never visited
    vp[:, table[1, -1], 0, 6] = np.nan
    qt, qj = _pair(q, "bfloat16")
    (kt, kj), (vt, vj) = _pair(kp, "bfloat16"), _pair(vp, "bfloat16")
    got = pt.paged_attention(qt, kt, vt, torch.from_numpy(lens),
                             torch.from_numpy(table), window=window)
    want = jpa.paged_attention(qj, kj, vj, jnp.asarray(lens),
                               jnp.asarray(table), window=window)
    want_nan = np.isnan(np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(got.float().isnan().numpy(), want_nan)
    assert want_nan[0, :, :, 5].all() and want_nan.sum() == chunk * hq
    marks = tpa.paged_nonfinite(vt, torch.from_numpy(lens),
                                torch.from_numpy(table), chunk, window=window)
    slot = list(table[0]).index(page_of)
    assert marks.shape == (b, hkv, pps, 2)
    assert marks[0, :, slot, 0].tolist() == [1 << 5] * hkv
    assert int(marks.count_nonzero()) == hkv


# -- C9-C11: the function depends on the shape, as JAX's dispatcher picks it ----


def _row_ulp_match(got, want, share=0.995):
    """At least ``share`` of the elements bit for bit, and every other one
    within one bf16 ulp of its row's largest magnitude (2^-7 of it): the
    f32 dots sum in XLA's order, which PyTorch's matmul does not share, and
    now and then that moves a rounding.  The port before the dispatch
    differed in 50-78% of the elements."""
    frac, err = _differ(got, want)
    assert frac <= 1 - share, (frac, err)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.float().numpy()
    row = np.abs(w).max(-1, keepdims=True)
    assert np.all(np.abs(g - w) <= row * 2.0 ** -7), err


def _attn_inputs(seed, b, h, h_kv, n_q, n_kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n_q, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h_kv, n_kv, d)).astype(np.float32)
            for _ in range(2))
    return [_pair(a, "bfloat16") for a in (q, k, v)]


# (b, h, n, d, causal, window, lengths): JAX's subrow (causal d128 n1024),
# its grid with two 1024-key blocks (d64 non-causal n2048) and with a
# window, its varlen subrow, and the op graph just under the threshold
C9_CASES = {
    "subrow_causal_d128_n1024": (1, 2, 1024, 128, True, None, None),
    "grid_noncausal_d64_n2048": (1, 2, 2048, 64, False, None, None),
    "grid_window256_d64_n1024": (1, 2, 1024, 64, True, 256, None),
    "varlen_subrow_d128_n1024": (2, 1, 1024, 128, True, None, [1024, 515]),
    "op_graph_causal_d64_n1000": (1, 2, 1000, 64, True, None, None),
}


@pytest.mark.parametrize("case", list(C9_CASES))
def test_flash_fwd_bf16_matches_jax_schedule(case):
    """The port's public forward in bf16 against JAX's (its Pallas kernels
    in interpret mode, or XLA's op graph below 1024 keys): the schedule's
    rounding, q prescaled in bf16, p rounded against the schedule's max
    (C9).  lse within 1e-5.  Under 1024 keys the gradients as well: the
    op graph's autodiff (C10)."""
    b, h, n, d, causal, window, lengths = C9_CASES[case]
    (qt, qj), (kt, kj), (vt, vj) = _attn_inputs(21, b, h, h, n, n, d)
    if lengths is not None:
        lens = np.asarray(lengths, np.int32)
        got = pt.flash_attention_varlen(qt, kt, vt, torch.from_numpy(lens),
                                        causal)
        want = jfa.flash_attention_varlen(qj, kj, vj, jnp.asarray(lens),
                                          causal)
        _row_ulp_match(got, want)
        return
    got = pt.flash_attention_with_lse(qt, kt, vt, causal, window=window)
    want = jfa.flash_attention_with_lse(qj, kj, vj, causal, window=window)
    _row_ulp_match(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=0)
    if n < jfa.MIN_KERNEL_KV_LEN:
        # just under the threshold the backward is the op graph's too
        rng = np.random.default_rng(25)
        dot, doj = _pair(rng.standard_normal((b, h, n, d)).astype(np.float32),
                         "bfloat16")
        _, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, causal), qj, kj,
                         vj)
        ts = [t.clone().requires_grad_() for t in (qt, kt, vt)]
        grads = torch.autograd.grad(pt.flash_attention(*ts, causal), ts, dot)
        for g, w in zip(grads, vjp(doj)):
            _row_ulp_match(g, w)


# (h, h_kv, n, d, causal): below 1024 keys, where JAX differentiates its op
# graph
C10_CASES = {
    "causal_n128_d32": (2, 2, 128, 32, True),
    "noncausal_n128_d32": (2, 2, 128, 32, False),
    "gqa4_2_causal_n256_d64": (4, 2, 256, 64, True),
}


@pytest.mark.parametrize("case", list(C10_CASES))
def test_flash_bwd_bf16_below_threshold_matches_jax(case):
    """The vjp of the port's public ``flash_attention`` in bf16 against
    ``jax.vjp`` of JAX's: below 1024 keys both are autodiff of the op graph
    (C10), each gradient by :func:`_row_ulp_match`."""
    h, h_kv, n, d, causal = C10_CASES[case]
    (qt, qj), (kt, kj), (vt, vj) = _attn_inputs(22, 1, h, h_kv, n, n, d)
    rng = np.random.default_rng(23)
    dot, doj = _pair(rng.standard_normal((1, h, n, d)).astype(np.float32),
                     "bfloat16")
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, causal), qj, kj, vj)
    want = vjp(doj)
    ts = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    got = torch.autograd.grad(pt.flash_attention(*ts, causal), ts, dot)
    for g, w in zip(got, want):
        _row_ulp_match(g, w)


@pytest.mark.parametrize("shape", [(1, 40), (7, 200)])
@pytest.mark.parametrize("payload", ["int8", "fp8"])
@pytest.mark.parametrize("causal", [False, True])
def test_kv8_flash_untileable_falls_back_like_jax(causal, payload, shape):
    """``flash_attention_kv_int8`` where JAX's tiler cannot divide n_q (1, 7
    rows): the flash op graph over K and V dequantized to q's dtype, as the
    JAX wrapper falls back (C11); o by :func:`_row_ulp_match`, lse within
    1e-5."""
    from flashattn_tpu.ops import quant as jq
    from flashattn_tpu_torch.ops import quant as tq

    n_q, n_kv = shape
    rng = np.random.default_rng(24)
    q = rng.standard_normal((1, 2, n_q, 32)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((1, 2, n_kv, 32)).astype(np.float32))
            for _ in range(2))
    quantize = jq.quantize_int8 if payload == "int8" else jq.quantize_fp8
    tdt = torch.int8 if payload == "int8" else torch.float8_e4m3fn
    kq, vq = quantize(k, -1), quantize(v, -1)

    def port(t):
        vals = torch.from_numpy(np.array(t.values.astype(jnp.float32))).to(tdt)
        return tq.QuantizedTensor(vals, torch.from_numpy(np.array(t.scales)))

    qt_, qj = _pair(q, "bfloat16")
    got = pt.flash_attention_kv_int8(qt_, port(kq), port(vq), causal)
    want = jq.flash_attention_kv_int8(qj, kq, vq, causal)
    _row_ulp_match(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5, rtol=0)


# -- C16: flash_attention_kv_int8 computes the function of JAX's route -------------

# (h, h_kv, n_q, n_kv, causal) at d 128: JAX's loop (N512: one 512-key
# chunk a query block), its subrow (N1024, GQA 4q/2kv), its grid with two
# 1024-key blocks, and a one-block grid, where the parent already computed
# JAX's function (a control: it passes there too)
C16_CASES = {
    "loop_causal_n512": (2, 2, 512, 512, True),
    "subrow_causal_gqa4_2_n1024": (4, 2, 1024, 1024, True),
    "grid_noncausal_256x2048": (1, 1, 256, 2048, False),
    "grid_one_block_128": (2, 2, 128, 128, False),
}
C16_ROUTES = {"loop_causal_n512": "loop", "subrow_causal_gqa4_2_n1024": "subrow",
              "grid_noncausal_256x2048": "grid", "grid_one_block_128": "grid"}
# JAX's interpret run of its int8 kernels sits up to this far from the
# written function's lse: XLA:CPU compiles the q row scale absmax / 127.0
# as absmax * f32(1 / 127), which rounds differently in ~2% of the rows
# (ROADMAP.md, section C, measured and not queued as a fault)
XLA_QSCALE_LSE_GAP = 2e-3


def _kv8_c16_inputs(case, payload, dtype):
    from flashattn_tpu.ops import quant as jq
    from flashattn_tpu_torch.ops import quant as tq

    h, h_kv, n_q, n_kv, _ = C16_CASES[case]
    rng = np.random.default_rng(26)
    q = rng.standard_normal((1, h, n_q, 128)).astype(np.float32)
    k, v = (jnp.asarray(rng.standard_normal((1, h_kv, n_kv, 128))
                        .astype(np.float32)) for _ in range(2))
    quantize = jq.quantize_int8 if payload == "int8" else jq.quantize_fp8
    tdt = torch.int8 if payload == "int8" else torch.float8_e4m3fn
    kq, vq = quantize(k, -1), quantize(v, -1)

    def port(t):
        vals = torch.from_numpy(np.array(t.values.astype(jnp.float32))).to(tdt)
        return tq.QuantizedTensor(vals, torch.from_numpy(np.array(t.scales)))

    qt_, qj = _pair(q, dtype)
    return (qt_, port(kq), port(vq)), (qj, kq, vq)


def _xla_qscale_rows(q, payload, route):
    """(b, h, n_q) bool: the rows whose int8 q scale XLA:CPU's reciprocal
    multiply rounds otherwise than the division JAX's kernels write (none
    without an int8 q: fp8 payloads off the subrow route)."""
    from flashattn_tpu_torch.ops import quant as tq

    if payload == "fp8" and route != "subrow":
        return np.zeros(q.shape[:3], bool)
    qp = (q * tq._prescale(q, q.shape[-1] ** -0.5)).float()
    am = qp.abs().amax(-1)
    div = am / torch.full_like(am, 127.0)
    mul = am * torch.tensor(1 / 127.0, dtype=torch.float32)
    return (div != mul).numpy()


@pytest.mark.parametrize("payload", ["int8", "fp8"])
@pytest.mark.parametrize("case", list(C16_CASES))
def test_kv8_flash_bf16_matches_jax_route(case, payload):
    """bf16 q through both public functions (JAX's kernels in interpret
    mode): o at least 99% bit for bit and the rest within one bf16 ulp of
    its row's largest element (the flash gate), lse within 1e-5, over the
    rows whose q scale XLA:CPU leaves as written; lse within
    XLA_QSCALE_LSE_GAP and o within the ulp on the others.  The parent's
    single function (the row's max, V rounded at every route) read 45.7% /
    44.7% / 83.8% of o bit for bit at the loop, subrow and two-block grid
    shapes."""
    from flashattn_tpu.ops import quant as jq
    from flashattn_tpu_torch.ops import quant as tq

    port, ref = _kv8_c16_inputs(case, payload, "bfloat16")
    causal = C16_CASES[case][4]
    route = C16_ROUTES[case]
    assert tq._kv8_route(causal, *port[0].shape[2:3],
                         port[1].values.shape[2], 128).name == route
    got = pt.flash_attention_kv_int8(*port, causal)
    want = jq.flash_attention_kv_int8(*ref, causal)
    odd = _xla_qscale_rows(port[0], payload, route)
    assert odd.mean() < 0.05
    g, w = _bits(got[0]), _bits(want[0])
    frac = float((g != w)[~odd].mean())
    assert frac <= 0.01, frac
    wf = np.asarray(jnp.asarray(want[0]).astype(jnp.float32))
    row = np.abs(wf).max(-1, keepdims=True)
    assert np.all(np.abs(got[0].float().numpy() - wf) <= row * 2.0 ** -7)
    lse_err = np.abs(got[1].numpy() - np.asarray(want[1]))[..., 0]
    assert lse_err[~odd].max() <= 1e-5, lse_err[~odd].max()
    assert lse_err.max() <= XLA_QSCALE_LSE_GAP, lse_err.max()


@pytest.mark.parametrize("payload", ["int8", "fp8"])
@pytest.mark.parametrize("case", list(C16_CASES)[:3])
def test_kv8_flash_f32_matches_jax_route(case, payload):
    """f32 q at the loop, subrow and two-block grid shapes: o and lse
    within 1e-4 of JAX's."""
    from flashattn_tpu.ops import quant as jq

    port, ref = _kv8_c16_inputs(case, payload, "float32")
    causal = C16_CASES[case][4]
    got = pt.flash_attention_kv_int8(*port, causal)
    want = jq.flash_attention_kv_int8(*ref, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
