"""The port's quantization (flashattn_tpu_torch.ops.quant, QuantizedLinear,
quantized page pools) against the JAX package's.

The same numpy-seeded inputs go through the JAX function (Pallas kernels in
interpret mode, as tests/test_ops_quant.py runs them) and the port's plain
versions on CPU tensors.  Quantizers: payloads bit-identical (fp8 compared
as uint8 views) and scales equal.  Kernels: float32, atol 1e-4 (the two
frameworks sum in different orders, and the port's quantized-q scores are
sum((q8 qs)(k8 ks)) where the TPU kernels compute sum(q8 k8) qs ks).
Stochastic rounding cannot match JAX bit for bit (its CPU path draws
jax.random noise): scales are compared exactly, payloads structurally.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import flashattn_tpu_torch as pt
from flashattn_tpu.ops import paged_attention as jpa
from flashattn_tpu.ops import quant as jq
from flashattn_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
PAYLOADS = {"int8": (jnp.int8, torch.int8),
            "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), **(tol or TOL))


def _bits(a):
    """A payload as comparable integers: fp8 as its uint8 view."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


def _same_quant(got, want):
    np.testing.assert_array_equal(_bits(got.values), _bits(want.values))
    np.testing.assert_array_equal(got.scales.numpy(),
                                  np.asarray(want.scales, np.float32))


def _qt(q: jq.QuantizedTensor) -> tq.QuantizedTensor:
    """A JAX QuantizedTensor carried into the port exactly."""
    values = np.asarray(q.values)
    if values.dtype == ml_dtypes.float8_e4m3fn:
        t = torch.from_numpy(values.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(values.copy())
    return tq.QuantizedTensor(t, torch.from_numpy(np.asarray(q.scales).copy()))


def _weights(rng):
    """(24, 40) weights with rows and columns whose absmax is exactly
    +-3.5, so that fp8 payloads land on +-448 (3.5 / (3.5 / 448) = 448)."""
    w = _normal(rng, 24, 40) * 1.5
    w[3] = np.clip(w[3], -3.4, 3.4)
    w[3, 7] = -3.5
    w[:, 11] = np.clip(w[:, 11], -3.4, 3.4)
    w[5, 11] = 3.5
    return w


# -- quantizers ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantizers_match_jax(kind, axis, dtype):
    """quantize_int8 computes a bf16 weight's scale in bf16, quantize_fp8
    in f32: payloads bit-identical to JAX's, scales equal, at f32 and bf16."""
    jdt, tdt = DTYPES[dtype]
    w = _weights(np.random.default_rng(0))
    x_t = torch.from_numpy(w).to(tdt)
    x_j = jnp.asarray(w).astype(jdt)
    fn_t, fn_j = ((tq.quantize_int8, jq.quantize_int8) if kind == "int8"
                  else (tq.quantize_fp8, jq.quantize_fp8))
    got, want = fn_t(x_t, axis=axis), fn_j(x_j, axis=axis)
    assert got.values.dtype == PAYLOADS[kind][1]
    assert got.scales.dtype == torch.float32
    _same_quant(got, want)
    if kind == "fp8":
        assert (got.values.float().abs() == 448).any()
    _close(got.dequantize(), want.dequantize(), atol=0, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_kv_and_transcode_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    k, v = (_normal(rng, 2, 3, 17, 32) * 2 for _ in range(2))
    v[0, 1, 4] = 0.0                                  # a zero row: scale 1
    got = tq.quantize_kv(torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt))
    want = jq.quantize_kv(jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt))
    for g, w in zip(got, want):
        _same_quant(g, w)
    assert float(got[1].scales[0, 1, 4, 0]) == 1.0
    f8_t = tq.quantize_fp8(torch.from_numpy(k).to(tdt))
    f8_j = jq.quantize_fp8(jnp.asarray(k).astype(jdt))
    _same_quant(tq.requantize_fp8_to_int8(f8_t), jq.requantize_fp8_to_int8(f8_j))


# -- weight-only matmul --------------------------------------------------------


@pytest.mark.parametrize("payload", list(PAYLOADS))
@pytest.mark.parametrize("mkn", [(256, 512, 256), (33, 48, 17)])
def test_int8_weight_only_matmul_parity(mkn, payload):
    """The JAX kernel (interpret mode) at (256, 512) x (512, 256), its
    x @ dequantize(W) fallback at the ragged (33, 48) x (48, 17), and the
    port's plain version."""
    m, k, n = mkn
    rng = np.random.default_rng(2)
    x, w = _normal(rng, m, k), _normal(rng, k, n)
    quantize = jq.quantize_int8 if payload == "int8" else jq.quantize_fp8
    wq = quantize(jnp.asarray(w), axis=0)
    want = jq.int8_weight_only_matmul(jnp.asarray(x), wq)
    got = pt.int8_weight_only_matmul(torch.from_numpy(x), _qt(wq))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, want)
    _close(got, np.asarray(x @ np.asarray(wq.dequantize())))


def test_int8_weight_only_matmul_bf16_rounds_once():
    """bf16 activations: the product sums in f32 and rounds once to bf16."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_normal(rng, 9, 40)).bfloat16()
    wq = tq.quantize_int8(torch.from_numpy(_normal(rng, 40, 12)), axis=0)
    got = pt.int8_weight_only_matmul(x, wq)
    want = ((x.float() @ wq.values.float()) * wq.scales).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(ValueError):
        pt.int8_weight_only_matmul(x[:, :30], wq)


# -- quantized models ----------------------------------------------------------


def _jax_model(**kw):
    import jax

    import flashattn_tpu as ft

    return ft.DecoderLM(64, 32, 4, 128, p_dropout=0.0, n_layer=2,
                        key=jax.random.PRNGKey(0), **kw).eval()


def _params(jm):
    return {n: np.asarray(a) for n, a in jm.named_parameters()}


@pytest.mark.parametrize("payload", list(PAYLOADS))
def test_quantize_model_weights_parity(payload):
    """A JAX DecoderLM(64, 32, 4, 128, n_layer=2) quantized by both packages
    gives identical payloads and scales; the port loaded from the JAX
    quantized model (load_jax_params) matches its forward to 1e-4."""
    jdt, tdt = PAYLOADS[payload]
    jm = _jax_model()
    tm = pt.DecoderLM(64, 32, 4, 128, p_dropout=0.0, n_layer=2,
                      device="cpu").eval()
    pt.load_jax_params(tm, _params(jm))
    jq_m = jq.quantize_model_weights(jm, jdt)
    tq_m = pt.quantize_model_weights(tm, tdt)
    assert isinstance(tm.lm_head, pt.Linear)          # the original is kept
    lin = tq_m.layers[0].attention.q_projection
    assert isinstance(lin, pt.QuantizedLinear) and lin.values.dtype == tdt
    want = _params(jq_m)
    got = dict(tq_m.named_parameters())
    assert set(got) == set(want)
    for name, a in want.items():
        if name.endswith(".values"):
            np.testing.assert_array_equal(_bits(got[name].detach()), _bits(a))
        else:
            np.testing.assert_array_equal(got[name].detach().numpy(), a)
    loaded = pt.quantize_model_weights(
        pt.DecoderLM(64, 32, 4, 128, p_dropout=0.0, n_layer=2, device="cpu"),
        tdt).eval()
    pt.load_jax_params(loaded, want)
    toks = np.random.default_rng(4).integers(0, 64, (2, 16)).astype(np.int32)
    with torch.inference_mode():
        out = loaded(torch.from_numpy(toks))
    _close(out, jq_m(jnp.asarray(toks)))


def test_quantized_linear_keeps_payload_under_casts():
    """Module.to(dtype) and .half() cast every floating tensor, fp8
    payloads included: QuantizedLinear keeps its payload type and f32
    scales, and casts its bias."""
    rng = np.random.default_rng(5)
    lin = pt.Linear(40, 24, device="cpu")
    for dtype in (torch.float8_e4m3fn, torch.int8):
        ql = pt.quantize_linear(lin, dtype)
        values, scales = ql.values.detach().clone(), ql.scales.detach().clone()
        for cast in (lambda m: m.to(torch.bfloat16), lambda m: m.half(),
                     lambda m: m.float(), lambda m: m.to("cpu", torch.float64)):
            cast(ql)
            assert ql.values.dtype == dtype and ql.scales.dtype == torch.float32
            assert torch.equal(ql.values.view(torch.uint8)
                               if dtype == torch.float8_e4m3fn else ql.values,
                               values.view(torch.uint8)
                               if dtype == torch.float8_e4m3fn else values)
            assert torch.equal(ql.scales, scales)
        assert ql.bias.dtype == torch.float64
        assert not ql.values.requires_grad and not ql.scales.requires_grad
    model = pt.quantize_model_weights(
        pt.DecoderLM(64, 32, 4, 128, p_dropout=0.0, n_layer=1,
                     device="cpu").to(torch.bfloat16), torch.float8_e4m3fn)
    model.to(torch.bfloat16)
    assert model.lm_head.values.dtype == torch.float8_e4m3fn
    assert model.lm_head.scales.dtype == torch.float32
    toks = torch.from_numpy(rng.integers(0, 64, (1, 7)))
    with torch.inference_mode():
        out = model(toks)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    with pytest.raises(TypeError):
        pt.quantize_linear(lin, torch.float16)


def test_load_jax_params_payload_types():
    """A quantized payload takes only an array of its own type."""
    tm = pt.quantize_model_weights(
        pt.DecoderLM(64, 32, 4, 128, p_dropout=0.0, n_layer=1, device="cpu"),
        torch.int8)
    params = {n: p.detach().float().numpy() for n, p in tm.named_parameters()}
    with pytest.raises(TypeError):
        pt.load_jax_params(tm, params)


# -- quantized paged attention -------------------------------------------------

# (d, chunk, page, window), as tests/test_torch_ops.py::PAGED_CASES
PAGED_CASES = {
    "pipelined_decode": (128, 1, 8, None),
    "pipelined_chunk4": (128, 4, 8, None),
    "grid_decode": (32, 1, 4, None),
    "grid_chunk4": (32, 4, 16, None),
    "grid_chunk4_window": (32, 4, 4, 6),
}


def _jax_pipelined(q, kp, vp, lens, table, ks, vs, window):
    """The JAX pipelined page walk (_paged_attention_pipelined, interpret
    mode) with paged_attention's prefold and unfold: the public function
    takes it only at page_size % 128 == 0 for quantized pools."""
    chunked = q.ndim == 4
    q = q if chunked else q[:, None]
    b, chunk, hq, d = q.shape
    hkv = kp.shape[0]
    g = hq // hkv
    qg = q * jnp.asarray(d ** -0.5 * 1.4426950408889634, q.dtype)
    qg = qg.reshape(b, chunk, hkv, g, d).transpose(0, 2, 3, 1, 4)
    qg = qg.reshape(b, hkv, g * chunk, d)
    out = jpa._paged_attention_pipelined(qg, kp, vp, lens, table, window,
                                         chunk, k_scales=ks, v_scales=vs)
    out = out.reshape(b, hkv, g, chunk, d).transpose(0, 3, 1, 2, 4)
    out = out.reshape(b, chunk, hq, d)
    return out if chunked else out[:, 0]


@pytest.mark.parametrize("payload", list(PAYLOADS))
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_attention_quantized_parity(case, payload):
    """int8 / fp8 pools: the port against JAX's grid kernel
    (paged_attention), its pipelined walk (at d 128, the head dim at which
    the JAX dispatcher takes it) and paged_attention_reference."""
    d, chunk, page, window = PAGED_CASES[case]
    rng = np.random.default_rng(6)
    b, hq, hkv, n_pages, pps = 3, 4, 2, 12, 3
    q = _normal(rng, b, chunk, hq, d) if chunk > 1 else _normal(rng, b, hq, d)
    quantize = jq.quantize_int8 if payload == "int8" else jq.quantize_fp8
    kq, vq = (quantize(jnp.asarray(_normal(rng, hkv, n_pages, page, d)), -1)
              for _ in range(2))
    table = rng.permutation(n_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    lens = np.asarray([page * pps, page + chunk + 1, chunk], np.int32)
    args_j = [jnp.asarray(a) for a in (q, lens, table)]
    kw_j = dict(k_scales=kq.scales, v_scales=vq.scales, window=window)
    kt, vt = _qt(kq), _qt(vq)
    got = pt.paged_attention(torch.from_numpy(q), kt.values, vt.values,
                             torch.from_numpy(lens), torch.from_numpy(table),
                             k_scales=kt.scales, v_scales=vt.scales,
                             window=window)
    _close(got, jpa.paged_attention(args_j[0], kq.values, vq.values,
                                    *args_j[1:], **kw_j))
    _close(got, jpa.paged_attention_reference(
        args_j[0], kq.values, vq.values, *args_j[1:], **kw_j))
    if d % 128 == 0:
        _close(got, _jax_pipelined(args_j[0], kq.values, vq.values,
                                   *args_j[1:], kq.scales, vq.scales, window))


# -- flash attention over a quantized KV cache ---------------------------------


def _kv8_inputs(seed, b, hq, hkv, n, d, payload):
    rng = np.random.default_rng(seed)
    q = _normal(rng, b, hq, n, d)
    k, v = (jnp.asarray(_normal(rng, b, hkv, n, d)) for _ in range(2))
    quantize = jq.quantize_int8 if payload == "int8" else jq.quantize_fp8
    return q, quantize(k, -1), quantize(v, -1)


def _kv8_close(got, want):
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("payload", list(PAYLOADS))
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kv_int8_parity(causal, payload):
    """N128 d32 (the JAX grid kernel, _kv8_fwd_kernel): o and lse."""
    q, kq, vq = _kv8_inputs(7, 1, 2, 2, 128, 32, payload)
    want = jq.flash_attention_kv_int8(jnp.asarray(q), kq, vq, causal)
    got = pt.flash_attention_kv_int8(torch.from_numpy(q), _qt(kq), _qt(vq),
                                     causal)
    assert got[1].shape == (1, 2, 128, 1)
    _kv8_close(got, want)


def test_flash_attention_kv_int8_gqa_schedules():
    """GQA 4q/2kv at n 512: the JAX dispatcher (d 128: the loop schedule,
    _kv8_loop_kernel) and, at d 32, the loop schedule with interior chunks
    and the subrow schedule (_kv8_subrow_kernel) called directly."""
    q, kq, vq = _kv8_inputs(8, 1, 4, 2, 512, 128, "int8")
    want = jq.flash_attention_kv_int8(jnp.asarray(q), kq, vq, True)
    _kv8_close(pt.flash_attention_kv_int8(torch.from_numpy(q), _qt(kq),
                                          _qt(vq), True), want)
    q, kq, vq = _kv8_inputs(9, 1, 4, 2, 512, 32, "int8")
    got = pt.flash_attention_kv_int8(torch.from_numpy(q), _qt(kq), _qt(vq),
                                     True)
    _kv8_close(got, jq._kv8_flash_loop(jnp.asarray(q), kq, vq,
                                       sm_scale=32 ** -0.5, block_q=128))
    _kv8_close(got, jq._kv8_flash_subrow(jnp.asarray(q), kq, vq,
                                         sm_scale=32 ** -0.5, sub=128))


def test_flash_attention_kv_fp8_subrow_envelope():
    """fp8 payloads at the subrow envelope (causal, n 1024, d 128): both
    packages transcode to int8 first, then take the int8 route."""
    q, kq, vq = _kv8_inputs(10, 1, 1, 1, 1024, 128, "fp8")
    want = jq.flash_attention_kv_int8(jnp.asarray(q), kq, vq, True)
    got = pt.flash_attention_kv_int8(torch.from_numpy(q), _qt(kq), _qt(vq),
                                     True)
    _kv8_close(got, want)


def test_flash_attention_kv_int8_validation():
    q = torch.zeros(1, 2, 8, 32)
    kq = tq.quantize_kv(torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32))[0]
    with pytest.raises(TypeError):
        pt.flash_attention_kv_int8(q, tq.QuantizedTensor(
            kq.values.float(), kq.scales), kq)
    with pytest.raises(ValueError):
        pt.flash_attention_kv_int8(q, tq.QuantizedTensor(
            kq.values, kq.scales[..., :4, :]), kq)


def test_scales_on_another_device_raise():
    """Scales count in the choice of route: payloads on one device and
    scales on another raise ValueError rather than handing a kernel a
    pointer it cannot read; the launch wrappers refuse CPU tensors alike."""
    q = torch.zeros(1, 2, 8, 32)
    kq = tq.quantize_kv(torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32))[0]
    off = tq.QuantizedTensor(kq.values, kq.scales.to("meta"))
    with pytest.raises(ValueError, match="mixed devices"):
        pt.flash_attention_kv_int8(q, off, off)
    pages8 = torch.zeros(2, 2, 4, 32, dtype=torch.int8)
    scales = torch.ones(2, 2, 4, 1, device="meta")
    with pytest.raises(ValueError, match="mixed devices"):
        pt.paged_attention(torch.zeros(1, 2, 32), pages8, pages8,
                           torch.ones(1, dtype=torch.int32),
                           torch.zeros(1, 2, dtype=torch.int32),
                           k_scales=scales, v_scales=scales)
    w = tq.quantize_int8(torch.ones(32, 8), axis=0)
    with pytest.raises(ValueError, match="CUDA device"):
        tq.wo_matmul(torch.ones(4, 32), w)
    with pytest.raises(ValueError, match="CUDA device"):
        tq.kv8_flash_fwd(q, kq, kq, causal=True, sm_scale=1.0)


# -- stochastic rounding -------------------------------------------------------


def test_quantize_int8_stochastic_scales_and_rounding():
    """Scales equal JAX's; every payload is floor or ceil of x / s, with 654
    rows (no 8-aligned divisor of 256) and a zero row."""
    x = _normal(np.random.default_rng(11), 654, 64) * 2
    x[17] = 0.0
    want = jq.quantize_int8_stochastic(jnp.asarray(x), seed=3)
    got = pt.quantize_int8_stochastic(torch.from_numpy(x), seed=3)
    assert got.values.dtype == torch.int8 and got.scales.shape == (654, 1)
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    scaled = x / got.scales.numpy()
    q = got.values.numpy().astype(np.float64)
    assert ((q == np.floor(scaled)) | (q == np.ceil(scaled))).all()
    assert float(np.abs(got.dequantize().numpy() - x).max()) < 0.1
    assert (got.values[17] == 0).all() and float(got.scales[17]) == 1.0


def test_quantize_int8_stochastic_unbiased_and_seeded():
    """Unbiased in the mean over 8 seeds (as test_ops_quant.py); the plain
    version is a function of the seed: the same seed gives the same bits,
    another seed others; bf16 input gives the f32 input's result."""
    x = torch.full((8, 256), 0.37)
    mean = np.mean([float(pt.quantize_int8_stochastic(x, seed=i)
                          .dequantize().mean()) for i in range(8)])
    np.testing.assert_allclose(mean, 0.37, rtol=0.02)
    y = torch.from_numpy(_normal(np.random.default_rng(12), 33, 100))
    a, b = (pt.quantize_int8_stochastic(y, seed=2**64 - 5) for _ in range(2))
    assert torch.equal(a.values, b.values) and torch.equal(a.scales, b.scales)
    c = pt.quantize_int8_stochastic(y, seed=7)
    assert not torch.equal(a.values, c.values)
    yb = y.bfloat16()
    _same_quant(pt.quantize_int8_stochastic(yb, seed=9),
                tq.quantize_int8_stochastic_reference(yb.float(), seed=9))
    with pytest.raises(ValueError):
        pt.quantize_int8_stochastic(y, seed=-1)


def test_quantize_int8_stochastic_unbiased_between_codes():
    """On the constant above x / s is exactly 127 and every draw rounds to
    it.  Here one 1.0 per row makes s = 1/127 and 0.3 / s = 38.1, between
    two codes: floor and round-to-nearest both give 38/127 (0.26% low); the
    8-seed mean of 16320 unbiased draws has a standard error of 0.006%."""
    x = torch.full((8, 256), 0.3)
    x[:, 0] = 1.0
    draws = [pt.quantize_int8_stochastic(x, seed=i) for i in range(8)]
    assert all(set(d.values[:, 1:].unique().tolist()) == {38, 39}
               for d in draws)
    mean = np.mean([float(d.dequantize()[:, 1:].mean()) for d in draws])
    np.testing.assert_allclose(mean, 0.3, rtol=1e-3)
