"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
elsewhere.  The shapes are small and ragged on purpose (rows not a multiple
of the 64-row tile, pages smaller than the 64-key tile, every head dim and
row-tile size), complementing the serving- and training-shape checks of
chip_smoke.py.  The file imports no jax, so on a machine without it run:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerance: f32 1e-4 abs, bf16 2e-2 abs on unit-variance inputs; gradients
and matmul outputs (sums over rows) against max(1, max |ref|) times those.
Dropout and stochastic quantization are bit-exact: the kernel and its plain
version compute the same Philox bits.  So are the dropout variants with a
residual or a ReLU (the same f32 arithmetic); with GELU (tanhf on the card,
torch.tanh in the plain version) they keep the same positions and hold the
values to the tolerance above.
"""

import math

import pytest
import torch

from flashattn_tpu_torch.ops import dropout as dr
from flashattn_tpu_torch.ops import flash_attention as fa
from flashattn_tpu_torch.ops import layernorm as ln
from flashattn_tpu_torch.ops import paged_attention as pa
from flashattn_tpu_torch.ops import quant as qt
from flashattn_tpu_torch.ops import softmax as sm

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
PAYLOADS = [torch.int8, torch.float8_e4m3fn]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, dtype, dev):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _flash_launches():
    """(forward, backward) launches of the flash kernels, either f32 route
    (fa.f32_route: the wgmma split-precision kernels from fa.F32_TC_MIN_KV
    keys, the warp-level ones below) counted with bf16's."""
    return (fa._kernel.launches + fa._f32_kernel.launches
            + fa._f32_mma_kernel.launches,
            fa._bwd_kernel.launches + fa._f32_bwd_kernel.launches
            + fa._f32_mma_bwd_kernel.launches)


def _rel_err(a, b):
    """max |a - b| over max(1, max |b|): the scale of a sum over rows."""
    return _err(a, b) / max(1.0, float(b.float().abs().max()))


def _paged_launches():
    """(bf16 q, f32 q) launches of the paged kernels: each q dtype has its
    own entry point and count."""
    return pa._kernel.launches, pa._f32_kernel.launches


def _paged_one(dtype):
    """The change of ``_paged_launches()`` one call with q of ``dtype``
    makes: one launch on its own count, none on the other."""
    return (0, 1) if dtype == torch.float32 else (1, 0)


def _paged_delta(before):
    now = _paged_launches()
    return now[0] - before[0], now[1] - before[1]


LN_SHAPES = [(1, 1024), (37, 100), (5, 3, 2049)]
# the 16-byte path's envelope, gated like chip_smoke's train rows: by
# max(1, max |ref|), as over many rows |y| reaches [8, 16), where one bf16
# ulp is 0.0625
LN_VEC_SHAPES = [(3, 8), (70, 64), (4, 1024), (33, 2048), (9, 2056), (5, 4096),
                 (3, 8192), (16384, 2048)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LN_SHAPES + LN_VEC_SHAPES)
def test_layernorm_kernel(dev, dtype, shape):
    """The 16-byte path from h 8 (one masked chunk a row) to 8192 (bf16: 4
    chunks a lane; f32 past the envelope, generic), 2056 (not a multiple of
    256), decode rows (4, 1024) and the train rows; the generic path at h
    100 and 2049 (not whole chunks in bf16)."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = _randn(g, *shape, dtype=dtype, dev=dev) * 2 + 0.5
    gam = _randn(g, shape[-1], dtype=dtype, dev=dev)
    bet = _randn(g, shape[-1], dtype=dtype, dev=dev)
    _ln_fwd_check(x, gam, bet, dtype, scaled=shape in LN_VEC_SHAPES)


@pytest.mark.parametrize("offset", ["row", "element"])
@pytest.mark.parametrize("params", [torch.float32, torch.bfloat16])
def test_layernorm_kernel_params_and_views(dev, params, offset):
    """f32 gamma / beta beside bf16 x (two 16-byte loads of each per chunk)
    and bf16 ones; x one row into a buffer (aligned: the 16-byte path) and
    one element into it (the generic path)."""
    g = torch.Generator(device=dev).manual_seed(1)
    h = 1024
    skip = h if offset == "row" else 1
    x = _randn(g, 70 * h + skip, dtype=torch.bfloat16, dev=dev)[skip:].view(70, h)
    assert (x.data_ptr() % 16 == 0) == (offset == "row")
    gam = _randn(g, h, dtype=params, dev=dev)
    bet = _randn(g, h, dtype=params, dev=dev)
    _ln_fwd_check(x, gam, bet, torch.bfloat16)


def _ln_fwd_check(x, gam, bet, dtype, scaled=False):
    shape = x.shape
    before = ln._kernel.launches
    y, mean, rstd = ln.layernorm_fwd(x, gam, bet)
    assert ln._kernel.launches == before + 1
    assert y.dtype == dtype and mean.shape == (x.numel() // shape[-1], 1)
    err = (_rel_err if scaled else _err)(y, ln.layernorm_reference(x, gam, bet))
    assert err <= TOL[dtype]
    xf = x.float().reshape(-1, shape[-1])
    assert _err(mean[:, 0], xf.mean(-1)) <= 1e-4
    assert _err(rstd[:, 0], torch.rsqrt(xf.var(-1, unbiased=False) + 1e-5)) \
        <= 1e-3


# (b, h, h_kv, n_q, n_kv, d, causal, lengths, window): bf16 runs the
# tensor-core kernel (128-row blocks, 128-key tiles) in the mode of the
# shape's schedule (fa._schedule), f32 the FMA kernel; rows and keys not a
# multiple of either tile, every head dim.  Below 1024 keys and at n_q < 8
# the op graph; subrow at causal n 1024..8192 (n % 512 == 0), also d 32 / 64
# through the zero padding, and varlen; the loop at n 9216; the grid with
# key blocks of 1024 (d 64 non-causal, a window), 512, 64 and 8 (n 1032,
# 3000: two 8-key blocks a 16-key PV chunk)
FLASH_CASES = {
    "ragged_causal_d64": (2, 4, 4, 100, 100, 64, True, None, None),
    "cross_noncausal_d32": (2, 2, 1, 37, 150, 32, False, None, None),
    "varlen_gqa_d128": (3, 8, 2, 130, 130, 128, True, [130, 65, 0], None),
    "varlen_window_d64": (2, 4, 4, 200, 200, 64, True, [200, 77], 33),
    "causal_n517_d32": (1, 2, 2, 517, 517, 32, True, None, None),
    "causal_n1000_d64": (1, 2, 2, 1000, 1000, 64, True, None, None),
    "causal_n3000_d128": (1, 2, 1, 3000, 3000, 128, True, None, None),
    "gqa8_2_varlen_len0_d128": (2, 8, 2, 600, 600, 128, True, [600, 0], None),
    "window256_n1000_d64": (1, 2, 2, 1000, 1000, 64, True, None, 256),
    "window256_varlen_d128": (2, 2, 2, 700, 700, 128, True, [700, 300], 256),
    "cross_1000x2048_d128": (1, 2, 2, 1000, 2048, 128, False, None, None),
    "cross_causal_nq_gt_nkv_d32": (1, 2, 2, 300, 130, 32, True, None, None),
    "varlen_noncausal_d64": (2, 2, 2, 257, 257, 64, False, [129, 257], None),
    "op_graph_nq1_nkv40_d32": (2, 2, 1, 1, 40, 32, False, None, None),
    "op_graph_nq7_causal_d64": (1, 4, 2, 7, 200, 64, True, None, None),
    "subrow_n1024_d128": (1, 2, 2, 1024, 1024, 128, True, None, None),
    "subrow_gqa_n2048_d128": (1, 4, 2, 2048, 2048, 128, True, None, None),
    "subrow_pad_n1536_d32": (1, 2, 2, 1536, 1536, 32, True, None, None),
    "subrow_varlen_len0_n1024_d64": (3, 2, 2, 1024, 1024, 64, True,
                                     [1024, 515, 0], None),
    "loop_n9216_d128": (1, 1, 1, 9216, 9216, 128, True, None, None),
    "grid_noncausal_n2048_d64": (1, 2, 2, 2048, 2048, 64, False, None, None),
    "grid_window256_n2048_d128": (1, 2, 1, 2048, 2048, 128, True, None, 256),
    "grid_span512_1000x2560_d32": (1, 2, 2, 1000, 2560, 32, False, None, None),
    "grid_span64_n1088_d64": (1, 2, 2, 1088, 1088, 64, True, None, None),
    "grid_span8_n1032_varlen_d128": (2, 2, 2, 1032, 1032, 128, True,
                                     [1032, 700], None),
    # head dims other than 32, 64 and 128 (the tiles of 32, 64 and 128
    # columns, zero-padded as they load): each kernel and mode above
    "op_graph_nq7_causal_d16": (1, 4, 2, 7, 100, 16, True, None, None),
    "op_graph_nq1_nkv40_d112": (2, 2, 1, 1, 40, 112, False, None, None),
    "cross_noncausal_d24": (2, 2, 1, 37, 150, 24, False, None, None),
    "varlen_window_d48": (2, 4, 4, 200, 200, 48, True, [200, 77], 33),
    "causal_n517_d80": (1, 2, 2, 517, 517, 80, True, None, None),
    "gqa8_2_varlen_len0_d96": (2, 8, 2, 600, 600, 96, True, [600, 0], None),
    "subrow_pad_n1024_d96": (1, 2, 2, 1024, 1024, 96, True, None, None),
    "subrow_pad_n1536_d112": (1, 2, 2, 1536, 1536, 112, True, None, None),
    "subrow_varlen_n1024_d80": (2, 2, 2, 1024, 1024, 80, True, [1024, 515],
                                None),
    "grid_noncausal_n2048_d120": (1, 2, 2, 2048, 2048, 120, False, None,
                                  None),
    "grid_window256_n2048_d24": (1, 2, 1, 2048, 2048, 24, True, None, 256),
    "grid_span8_n1032_varlen_d96": (2, 2, 2, 1032, 1032, 96, True,
                                    [1032, 700], None),
    "cross_1000x2048_d80": (1, 2, 2, 1000, 2048, 80, False, None, None),
}


def _differ_share(got, want):
    """The share of elements that differ from the plain version's bits."""
    return float((got.float() != want.float()).float().mean())


def _bf16_match(got, want, share=0.99):
    """At least ``share`` of the elements bit for bit, every other one
    within one bf16 ulp of its row's largest magnitude (2^-7 of it): a
    kernel that rounds where the plain version does, its f32 sums in
    another order moving a rounding now and then."""
    g, w = got.float(), want.float()
    differ = _differ_share(got, want)
    print(f"bf16 bit-for-bit share {1 - differ:.5f}")
    assert differ <= 1 - share, differ
    row = w.abs().amax(-1, keepdim=True)
    assert bool(((g - w).abs() <= row * 2.0 ** -7).all()), _err(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernel(dev, dtype, case):
    """Against the plain version of the shape's schedule
    (fa.flash_fwd_plain): bf16 by :func:`_bf16_match`, f32 within TOL."""
    b, h, h_kv, n_q, n_kv, d, causal, lengths, window = FLASH_CASES[case]
    g = torch.Generator(device=dev).manual_seed(1)
    q = _randn(g, b, h, n_q, d, dtype=dtype, dev=dev)
    k = _randn(g, b, h_kv, n_kv, d, dtype=dtype, dev=dev)
    v = _randn(g, b, h_kv, n_kv, d, dtype=dtype, dev=dev)
    lens = None if lengths is None else torch.tensor(lengths, device=dev)
    before = _flash_launches()[0]
    o, lse = fa._flash_fwd_entry(q, k, v, causal, None, "auto", window, lens)
    assert _flash_launches()[0] == before + 1
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, d ** -0.5, lens,
                                        window)
    if dtype == torch.bfloat16:
        _bf16_match(o, o_ref)
    else:
        assert _err(o, o_ref) <= TOL[dtype]
    fin = lse_ref.isfinite()
    assert torch.equal(lse.isfinite(), fin)
    assert _err(lse[fin], lse_ref[fin]) <= (1e-5 if dtype == torch.bfloat16
                                            else TOL[dtype])


# head dims above 128, bf16 only (the forward's 256-column tiles; f32 is
# ROADMAP.md §B2b): (b, h, h_kv, n_q, n_kv, d, causal, lengths, window).  The
# op graph's warp-level kernel (<= 128 keys) and its wgmma walk (129..1023
# keys); from 1024 keys the grid (JAX's schedule at d > 128) with key
# blocks of 1024, 512, 64 (the 64-key tile's width), 32 and 8 (updates
# inside a tile); MQA and GQA, lengths of 0, a window of 256
FLASH_WIDE_CASES = {
    "op_nq7_mqa_d136": (1, 4, 1, 7, 100, 136, True, None, None),
    "op_nq1_nkv40_mqa_d256": (2, 8, 1, 1, 40, 256, False, None, None),
    "op_n128_varlen_len0_mqa_d160": (3, 4, 1, 128, 128, 160, True,
                                     [128, 50, 0], None),
    "op_n517_mqa_d256": (1, 8, 1, 517, 517, 256, True, None, None),
    "op_n1000_varlen_len0_gqa_d160": (2, 8, 2, 1000, 1000, 160, True,
                                      [1000, 0], None),
    "op_window256_varlen_n700_d256": (2, 2, 2, 700, 700, 256, True,
                                      [700, 300], 256),
    "grid_n2048_mqa_varlen_len0_d256": (4, 8, 1, 2048, 2048, 256, True,
                                        [2048, 1536, 0, 517], None),
    "grid_noncausal_n1024_d136": (1, 2, 2, 1024, 1024, 136, False, None,
                                  None),
    "grid_window256_n2048_d256": (1, 2, 1, 2048, 2048, 256, True, None, 256),
    "grid_span512_1000x2560_d160": (1, 2, 2, 1000, 2560, 160, False, None,
                                    None),
    "grid_span64_n1088_d256": (1, 2, 2, 1088, 1088, 256, True, None, None),
    "grid_span32_n1056_mqa_d256": (1, 4, 1, 1056, 1056, 256, True, None,
                                   None),
    "grid_span8_n1032_varlen_d160": (2, 2, 2, 1032, 1032, 160, True,
                                     [1032, 700], None),
    "cross_1000x2048_d256": (1, 2, 2, 1000, 2048, 256, False, None, None),
}


@pytest.mark.parametrize("case", list(FLASH_WIDE_CASES))
def test_flash_kernel_wide_head_dims(dev, case):
    """bf16 at d 136, 160 and 256 against the plain version of the shape's
    schedule under the gate of the d-128 lines (:func:`_bf16_match`, lse
    1e-5), one launch; f32 at the same shape raises ``ValueError`` naming
    §B2b and the backward one naming §B2c, launching nothing."""
    b, h, h_kv, n_q, n_kv, d, causal, lengths, window = FLASH_WIDE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(1)
    q = _randn(g, b, h, n_q, d, dtype=torch.bfloat16, dev=dev)
    k = _randn(g, b, h_kv, n_kv, d, dtype=torch.bfloat16, dev=dev)
    v = _randn(g, b, h_kv, n_kv, d, dtype=torch.bfloat16, dev=dev)
    lens = None if lengths is None else torch.tensor(lengths, device=dev)
    assert fa._schedule(q, k, causal, window, lens is not None).name in (
        "op_graph", "grid")
    before = _flash_launches()
    o, lse = fa._flash_fwd_entry(q, k, v, causal, None, "auto", window, lens)
    assert _flash_launches() == (before[0] + 1, before[1])
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, d ** -0.5, lens,
                                        window)
    _bf16_match(o, o_ref)
    fin = lse_ref.isfinite()
    assert torch.equal(lse.isfinite(), fin)
    assert _err(lse[fin], lse_ref[fin]) <= 1e-5
    before = _flash_launches()
    with pytest.raises(ValueError, match="B2b"):
        fa._flash_fwd_entry(q.float(), k.float(), v.float(), causal, None,
                            "auto", window, lens)
    with pytest.raises(ValueError, match="B2c"):
        fa.flash_bwd(q, k, v, lse, lse, q, causal=causal, sm_scale=d ** -0.5,
                     kv_lengths=lens, window=window)
    assert _flash_launches() == before


# (b, hq, hkv, d, chunk, page, pps, window): small ragged shapes (pages
# smaller than a tile, a chunk of 40 rows)
PAGED_CASES = {
    "decode_page4_d32": (3, 4, 4, 32, 1, 4, 9, None),
    "gqa4_chunk3_page8_d64": (2, 8, 2, 64, 3, 8, 6, None),
    "chunk40_page16_d128": (2, 2, 2, 128, 40, 16, 5, None),
    "chunk5_window_page8_d128": (2, 4, 2, 128, 5, 8, 6, 11),
    # head dims other than 32, 64 and 128: the decode and extend tiles at
    # their tile widths, 8-bit rows of 8 mod 16 bytes (d 24, 120)
    "decode_page4_d16": (3, 4, 4, 16, 1, 4, 9, None),
    "gqa4_chunk3_page8_d24": (2, 8, 2, 24, 3, 8, 6, None),
    "decode_gqa8_page16_d48": (2, 8, 1, 48, 1, 16, 6, None),
    "chunk40_page16_d80": (2, 2, 2, 80, 40, 16, 5, None),
    "chunk5_window_page8_d96": (2, 4, 2, 96, 5, 8, 6, 11),
    "chunk40_page8_gqa2_d112": (2, 4, 2, 112, 40, 8, 9, None),
    "chunk40_page16_d120": (2, 2, 2, 120, 40, 16, 5, None),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_kernel(dev, dtype, case):
    b, hq, hkv, d, chunk, page, pps, window = PAGED_CASES[case]
    g = torch.Generator(device=dev).manual_seed(2)
    n_pages = b * pps + 1
    kp = _randn(g, hkv, n_pages, page, d, dtype=dtype, dev=dev)
    vp = _randn(g, hkv, n_pages, page, d, dtype=dtype, dev=dev)
    table = torch.randperm(n_pages, generator=g, device=dev)[:b * pps]
    table = table.reshape(b, pps).int()
    shape = (b, chunk, hq, d) if chunk > 1 else (b, hq, d)
    q = _randn(g, *shape, dtype=dtype, dev=dev)
    # full table, a mid-page length, and one past the table's capacity
    # (a chunked-prefill wave's padding): the walk stops at the table
    lens = torch.tensor([pps * page, chunk + page + 3][:b], device=dev)
    if b > 2:
        lens = torch.cat([lens, torch.tensor([pps * page + 5], device=dev)])
    before = _paged_launches()
    out = pa.paged_attention(q, kp, vp, lens, table, window=window)
    assert _paged_delta(before) == _paged_one(dtype)
    ref = pa.paged_attention_plain(q, kp, vp, lens, table, window=window)
    assert _paged_err(out, ref) <= TOL[dtype]


# (b, hq, hkv, d, chunk, page, pps, lengths, window): the split-K grid at
# serving sizes.  Page sizes 16, 100 and 128; lengths 0, 1, page +- 1, 8192
# and 16384; chunks 1, 4, 64, 952 and 2048 (rows <= 16 take the decode
# tile, wider waves the wgmma tile in bf16); GQA 1, 4 and 16; window 256;
# lengths shorter than the chunk (rows that see no key) and padding waves
# whose lengths run past the table's capacity.
PAGED_SPLIT_CASES = {
    "decode_gqa4_page16_d128": (6, 8, 2, 128, 1, 16, 1024,
                                [0, 1, 15, 17, 8192, 16384], None),
    "decode_gqa16_page128_d64": (5, 16, 1, 64, 1, 128, 128,
                                 [127, 128, 129, 16384, 0], None),
    "chunk4_gqa4_page100_d32": (5, 8, 2, 32, 4, 100, 82,
                                [0, 1, 99, 101, 8192], None),
    "decode_window256_page16_d128": (4, 4, 4, 128, 1, 16, 512,
                                     [8192, 300, 1, 0], 256),
    "chunk4_window256_page128_d128": (4, 8, 8, 128, 4, 128, 64,
                                      [8192, 300, 4, 2], 256),
    "chunk64_page128_d128": (4, 2, 2, 128, 64, 128, 64,
                             [64, 129, 8192, 2], None),
    "wave952_pad_page128_d128": (4, 2, 2, 128, 952, 128, 16,
                                 [952, 1500, 2548, 0], None),
    "wave952_pad_window256_page100_d64": (3, 4, 2, 64, 952, 100, 20,
                                          [952, 2300, 1000], 256),
    "wave2048_page128_d128": (2, 2, 2, 128, 2048, 128, 32, [2048, 4096],
                              None),
    # head dims other than 32, 64 and 128: the merge's columns past d, a
    # wave of three row tiles (marks and poison) at d 24
    "decode_gqa4_page16_d96": (3, 8, 2, 96, 1, 16, 512, [1, 17, 8192],
                               None),
    "chunk64_page128_d80": (2, 2, 2, 80, 64, 128, 32, [64, 4000], None),
    "wave300_window256_page16_d24": (2, 2, 2, 24, 300, 16, 40, [300, 640],
                                     256),
}
POOLS = ["native", "int8", "fp8"]


def _paged_err(got, want):
    """bf16: max |err| over max |ref| (attention outputs over long random
    histories are averages well under 1); f32: max |err|."""
    err = _err(got, want)
    if want.dtype == torch.bfloat16:
        err /= max(float(want.float().abs().max()), 1e-30)
    return err


def _paged_split_inputs(case, dtype, pool, dev, cases=PAGED_SPLIT_CASES):
    b, hq, hkv, d, chunk, page, pps, lens, window = cases[case]
    g = torch.Generator(device=dev).manual_seed(11)
    n_pages = b * pps + 1
    if pool == "native":
        kp, vp = (_randn(g, hkv, n_pages, page, d, dtype=dtype, dev=dev)
                  for _ in range(2))
        kw = {}
    else:
        payload = torch.int8 if pool == "int8" else torch.float8_e4m3fn
        kq, vq = (_quantize(torch.randn(hkv, n_pages, page, d, generator=g,
                                        device=dev), payload)
                  for _ in range(2))
        kp, vp = kq.values, vq.values
        kw = dict(k_scales=kq.scales, v_scales=vq.scales)
    table = torch.randperm(n_pages, generator=g, device=dev)[:b * pps]
    table = table.reshape(b, pps).int()
    q = _randn(g, b, chunk, hq, d, dtype=dtype, dev=dev)
    return q, kp, vp, torch.tensor(lens, device=dev), table, kw, window


@pytest.mark.parametrize("split", ["auto", "one", "max"])
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
def test_paged_kernel_splits(dev, case, dtype, pool, split, capsys):
    """The split kernels and their merge against paged_attention_plain: the
    planned split count, one split (the block writes o itself) and one
    split per page; two calls equal bit for bit.  Logs the share of
    elements equal to the plain version's bit for bit."""
    _paged_split_check(_paged_split_inputs(case, dtype, pool, dev), case,
                       dtype, pool, split, capsys)


def _paged_split_check(inputs, case, dtype, pool, split, capsys):
    q, kp, vp, lens, table, kw, window = inputs
    split_pages = {"auto": None, "one": table.shape[1], "max": 1}[split]

    def run():
        return pa.paged_attention_fwd(q, kp, vp, lens, table,
                                      sm_scale=q.shape[-1] ** -0.5,
                                      window=window, split_pages=split_pages,
                                      **kw)

    before = _paged_launches()
    out = run()
    assert _paged_delta(before) == _paged_one(dtype)
    again = run()
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(q, kp, vp, lens, table, window=window, **kw)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert torch.equal(out, again)          # fixed merge order, no atomics
    err = _paged_err(out, ref)
    same = float((out == ref).float().mean())
    with capsys.disabled():
        print(f"\n[paged] {case} {str(dtype)[6:]} {pool} split={split}: "
              f"err {err:.3e}, bit for bit {100 * same:.2f}%")
    assert err <= TOL[dtype]


# bf16 q at head dims above 128 (the decode and extend tiles' 256 columns,
# the bf16 merge; f32 q is ROADMAP.md §B2b), as PAGED_SPLIT_CASES: MQA with
# 8 q heads (a Gemma-2B decode: 8 rows a kv head), GQA 4, lengths 0 to
# 8192, pages of 16, 100 and 128, chunks 1, 4, 64, 300 (three row tiles:
# the marks and the poison pass) and 2048, window 256
PAGED_WIDE_CASES = {
    "decode_mqa8_page16_d256": (4, 8, 1, 256, 1, 16, 512,
                                [0, 1, 17, 8192], None),
    "decode_gqa4_page128_d160": (3, 8, 2, 160, 1, 128, 64,
                                 [127, 129, 8192], None),
    "decode_window256_page16_d136": (3, 4, 4, 136, 1, 16, 512,
                                     [8192, 300, 1], 256),
    "chunk4_mqa8_page100_d256": (3, 8, 1, 256, 4, 100, 82, [0, 101, 8192],
                                 None),
    "chunk64_mqa_page128_d256": (2, 8, 1, 256, 64, 128, 64, [64, 8192],
                                 None),
    "chunk64_window256_page128_d160": (2, 2, 2, 160, 64, 128, 32, [129, 4000],
                                       256),
    "wave300_window256_page16_d136": (2, 2, 2, 136, 300, 16, 40, [300, 640],
                                      256),
    "wave2048_page128_d256": (2, 1, 1, 256, 2048, 128, 32, [2048, 4096],
                              None),
}


@pytest.mark.parametrize("split", ["auto", "one", "max"])
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("case", list(PAGED_WIDE_CASES))
def test_paged_kernel_wide_head_dims(dev, case, pool, split, capsys):
    """bf16 q at d 136, 160 and 256 under test_paged_kernel_splits' gates
    (the planned splits, one split, a split a page; two calls bit for bit);
    f32 q over the same pool raises ``ValueError`` naming §B2b and
    launches nothing."""
    inputs = _paged_split_inputs(case, torch.bfloat16, pool, dev,
                                 PAGED_WIDE_CASES)
    _paged_split_check(inputs, case, torch.bfloat16, pool, split, capsys)
    q, kp, vp, lens, table, kw, window = inputs
    if pool == "native":
        kp, vp = kp.float(), vp.float()
    before = _paged_launches()
    with pytest.raises(ValueError, match="B2b"):
        pa.paged_attention(q.float(), kp, vp, lens, table, window=window, **kw)
    assert _paged_launches() == before


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
def test_paged_f32_float64(dev, case, pool, capsys):
    """The f32-q split-precision tiles against a float64 run of the plain
    page walk (f32 pools widened) within 1e-5, where the plain f32 version
    itself is off by its f32 dots' roundings (logged beside)."""
    q, kp, vp, lens, table, kw, window = _paged_split_inputs(
        case, torch.float32, pool, dev)
    out = pa.paged_attention(q, kp, vp, lens, table, window=window, **kw)
    wide = [t.double() if t.dtype == torch.float32 else t for t in (kp, vp)]
    ref64 = pa.paged_attention_plain(q.double(), *wide, lens, table,
                                     window=window, **kw)
    ref = pa.paged_attention_plain(q, kp, vp, lens, table, window=window, **kw)
    err, plain = _err(out, ref64), _err(ref, ref64)
    with capsys.disabled():
        print(f"\n[paged] {case} f32 q {pool}: vs float64 {err:.3e} "
              f"(plain f32 {plain:.3e})")
    assert err <= 1e-5


# (where, value, slot): slot "live" = position 5 (every row of sequence 0
# sees it), "masked" = position 101, past sequence 0's length 100 in the
# last page its walk visits
PAGED_NONFINITE = [(w, v, sl) for w in ("K", "V", "V scale")
                   for v in (math.inf, -math.inf, math.nan)
                   for sl in ("live", "masked")] + [
    ("q", v, "live") for v in (math.inf, -math.inf, math.nan)]


@pytest.mark.parametrize("rows", ["decode", "chunk40", "wave256"])
@pytest.mark.parametrize("where,value,slot", PAGED_NONFINITE)
def test_paged_f32_nonfinite(dev, where, value, slot, rows):
    """f32 q with a +-inf or NaN in K or V (an f32 pool), in a V scale
    (int8 and fp8 pools) or in q (an f32 and an int8 pool): the split tiles
    give the plain page walk's NaN and inf positions exactly and its finite
    values within 1e-4 (decode tile, the extend tile, and a wave of two
    tiles with the poison pass).  The split's b0 keeps the inf and its
    products with the other operand's b1, b2 read it zeroed, so 0 * inf
    appears only where f32 makes it (C17)."""
    chunk, hq, d = {"decode": (1, 4, 128), "chunk40": (40, 2, 64),
                    "wave256": (256, 2, 32)}[rows]
    b, hkv, page, pps = 2, 2, 16, 8 if rows != "wave256" else 24
    g = torch.Generator(device=dev).manual_seed(22)
    n_pages = b * pps + 1
    table = torch.randperm(n_pages, generator=g, device=dev)[:b * pps]
    table = table.reshape(b, pps).int()
    lens = torch.tensor([100, 60] if rows != "wave256" else [300, 256],
                        device=dev)
    q = torch.randn(b, chunk, hq, d, generator=g, device=dev)
    pos = 5 if slot == "live" else int(lens[0]) + 1
    pg, off = int(table[0, pos // page]), pos % page
    pools = {"K": ["native"], "V": ["native"], "V scale": ["int8", "fp8"],
             "q": ["native", "int8"]}[where]
    for pool in pools:
        kv = [torch.randn(hkv, n_pages, page, d, generator=g, device=dev)
              for _ in range(2)]
        kw = {}
        q_ = q.clone()
        if where == "q":
            q_[0, 0, 1, 3] = value
        if pool == "native":
            kp, vp = kv
            if where in ("K", "V"):
                (kp if where == "K" else vp)[0, pg, off, 3] = value
        else:
            payload = torch.int8 if pool == "int8" else torch.float8_e4m3fn
            kq, vq = (_quantize(t, payload) for t in kv)
            kp, vp = kq.values, vq.values
            kw = dict(k_scales=kq.scales, v_scales=vq.scales)
            if where == "V scale":
                kw["v_scales"][0, pg, off] = value
        before = _paged_launches()
        out = pa.paged_attention(q_, kp, vp, lens, table, **kw)
        assert _paged_delta(before) == (0, 1)
        ref = pa.paged_attention_plain(q_, kp, vp, lens, table, **kw)
        torch.cuda.synchronize()
        for pick in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(pick(out), pick(ref)), pick.__name__
        fin = ref.isfinite()
        assert _err(out[fin], ref[fin]) <= TOL[torch.float32]
        if not (where == "K" and slot == "masked"):
            assert not bool(fin[0].all())


def test_kernels_refuse_grad_and_bad_head_dim(dev):
    """Paged attention is inference-only and refuses inputs that require
    grad.  The flash forward and backward compute at d 48 (any multiple of
    8 up to 128): the backward launches the flash backward kernels once and
    matches flash_bwd_plain.  d 136 and d 20 raise ValueError (§B2, §B3),
    in the forward and in the backward, and launch nothing."""
    q = torch.randn(2, 4, 64, device=dev, requires_grad=True)
    pages = torch.randn(4, 3, 8, 64, device=dev)
    table = torch.arange(2, device=dev, dtype=torch.int32).reshape(2, 1)
    with pytest.raises(NotImplementedError):
        pa.paged_attention(q, pages, pages, torch.tensor([5, 8], device=dev),
                           table)
    x, k, v, do = (torch.randn(1, 2, 8, 48, device=dev) for _ in range(4))
    sc = 48 ** -0.5
    o_ref, lse_ref = fa.flash_fwd_plain(x, k, v, True, sc)
    o = fa.flash_attention(x, k, v, True)
    assert _err(o, o_ref) <= TOL[torch.float32]
    ts = [t.clone().requires_grad_() for t in (x, k, v)]
    before = _flash_launches()[1]
    got = torch.autograd.grad(fa.flash_attention(*ts, True), ts, do)
    assert _flash_launches()[1] == before + 1
    di = (o_ref * do).sum(-1, keepdim=True)
    want = fa.flash_bwd_plain(x, k, v, lse_ref, di, do, True, sc)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= TOL[torch.float32]
    for d, item in ((136, "B2"), (20, "B3")):
        y = torch.randn(1, 2, 8, d, device=dev)
        lse = torch.zeros(1, 2, 8, 1, device=dev)
        fwd, bwd = _flash_launches()
        with pytest.raises(ValueError, match=item):
            fa.flash_attention(y, y, y, True)
        with pytest.raises(ValueError, match=item):
            fa.flash_bwd(y, y, y, lse, lse, y, causal=True, sm_scale=d ** -0.5)
        assert _flash_launches() == (fwd, bwd)


def test_wide_head_dims_refused_outside_b2a(dev):
    """At d 256 the kernels without a 256-column tile raise ``ValueError``
    naming their ROADMAP.md item before any launch: the f32 flash forward on
    both routes (40 and 300 keys) and f32-q paged attention (§B2b),
    ``kv8_flash`` in bf16 and f32 over int8 and fp8 payloads (§B2b), the
    marks over an f32 pool (§B2b), and the flash backward reached through
    autograd of the bf16 forward, which itself runs (§B2c)."""
    g = torch.Generator(device=dev).manual_seed(4)
    d = 256
    counts = [fa._kernel, fa._f32_kernel, fa._f32_mma_kernel, fa._bwd_kernel,
              fa._f32_bwd_kernel, fa._f32_mma_bwd_kernel, pa._kernel,
              pa._f32_kernel, pa._nf_kernel, qt._kv8_kernel,
              qt._kv8_f32_kernel]

    def launches():
        return [k.launches for k in counts]

    before = launches()
    for n in (40, 300):
        x = _randn(g, 1, 2, n, d, dtype=torch.float32, dev=dev)
        with pytest.raises(ValueError, match="B2b"):
            fa.flash_attention(x, x, x, True)
    pages = _randn(g, 1, 5, 16, d, dtype=torch.float32, dev=dev)
    table = torch.arange(4, device=dev, dtype=torch.int32).reshape(2, 2)
    lens = torch.tensor([20, 31], device=dev)
    with pytest.raises(ValueError, match="B2b"):
        pa.paged_attention(_randn(g, 2, 4, d, dtype=torch.float32, dev=dev),
                           pages, pages, lens, table)
    with pytest.raises(ValueError, match="B2b"):
        pa.paged_nonfinite(pages, lens, table, 1)
    for payload in PAYLOADS:
        k8, v8 = (_quantize(_randn(g, 1, 1, 256, d, dtype=torch.float32,
                                   dev=dev), payload) for _ in range(2))
        for dtype in DTYPES:
            q = _randn(g, 1, 2, 256, d, dtype=dtype, dev=dev)
            with pytest.raises(ValueError, match="B2b"):
                qt.flash_attention_kv_int8(q, k8, v8, True)
    assert launches() == before
    q, k, v = (_randn(g, 1, 8, 600, d, dtype=torch.bfloat16,
                      dev=dev).requires_grad_() for _ in range(3))
    o = fa.flash_attention(q, k, v, True)
    assert fa._kernel.launches == before[0] + 1
    with pytest.raises(ValueError, match="B2c"):
        o.float().sum().backward()
    assert launches()[1:] == before[1:]


def _ln_bwd_inputs(shape, dtype, dev, offset=None):
    """x, dy, gamma, beta; ``offset`` "row" or "element" makes x and dy
    contiguous views one row or one element into a longer buffer."""
    g = torch.Generator(device=dev).manual_seed(3)
    n, h = torch.Size(shape[:-1]).numel(), shape[-1]
    skip = {None: 0, "row": h, "element": 1}[offset]
    x, dy = (_randn(g, n * h + skip, dtype=dtype, dev=dev)[skip:].view(shape)
             for _ in range(2))
    x.mul_(2).add_(0.5)
    gam = _randn(g, h, dtype=dtype, dev=dev)
    bet = _randn(g, h, dtype=dtype, dev=dev)
    return x, dy, gam, bet


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 32), (37, 100), (130, 200),
                                   (3, 67, 1000), (1, 8), (5, 2056),
                                   (3, 4096), (16384, 2048)])
def test_layernorm_bwd_kernel(dev, dtype, shape):
    """Rows not a multiple of the 64-row block; h of 200 and 1000; the
    16-byte path at h 8 (one masked chunk), 1000 (bf16: 125 chunks, a lane
    with a masked last one), 2056 (not a multiple of 256), 4096 and the
    train shape (16384, 2048); the generic path at h 100 in bf16 (not whole
    16-byte chunks)."""
    _ln_bwd_check(*_ln_bwd_inputs(shape, dtype, dev), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", ["row", "element"])
def test_layernorm_bwd_kernel_offset_views(dev, dtype, offset):
    """x and dy one row into a buffer (still 16-byte aligned: the 16-byte
    path) and one element into it (not aligned: the generic path)."""
    x, dy, gam, bet = _ln_bwd_inputs((70, 1024), dtype, dev, offset)
    assert x.storage_offset() > 0 and x.is_contiguous()
    assert (x.data_ptr() % 16 == 0) == (offset == "row")
    _ln_bwd_check(x, dy, gam, bet, dtype)


def _ln_bwd_check(x, dy, gam, bet, dtype):
    _, mean, rstd = ln.layernorm_fwd(x, gam, bet)
    before = ln._bwd_kernel.launches
    got = ln.layernorm_bwd(x, dy, mean, rstd, gam)
    assert ln._bwd_kernel.launches == before + 1
    want = ln.layernorm_bwd_reference(x, dy, mean, rstd, gam)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel_err(a, b) <= TOL[dtype]


def test_layernorm_autograd_launches_both_kernels(dev):
    x = torch.randn(70, 96, device=dev, requires_grad=True)
    gam = torch.randn(96, device=dev, requires_grad=True)
    bet = torch.randn(96, device=dev, requires_grad=True)
    fwd, bwd = ln._kernel.launches, ln._bwd_kernel.launches
    ln.layernorm(x, gam, bet).square().sum().backward()
    assert (ln._kernel.launches, ln._bwd_kernel.launches) == (fwd + 1, bwd + 1)
    xc, gc, bc = (t.detach().cpu().requires_grad_() for t in (x, gam, bet))
    ln.layernorm(xc, gc, bc).square().sum().backward()
    for t, c in ((x, xc), (gam, gc), (bet, bc)):
        assert _rel_err(t.grad.cpu(), c.grad) <= 1e-4


# (b, h, h_kv, n_q, n_kv, d, causal, lengths, window)
FLASH_BWD_CASES = {
    "ragged_causal_d64": (2, 4, 4, 100, 100, 64, True, None, None),
    "cross_noncausal_d32": (2, 2, 1, 37, 150, 32, False, None, None),
    "cross_causal_nq_gt_nkv_d32": (1, 2, 2, 150, 70, 32, True, None, None),
    "varlen_gqa_len0_d128": (3, 8, 2, 130, 130, 128, True, [130, 65, 0], None),
    "varlen_window_d64": (2, 4, 4, 200, 200, 64, True, [200, 77], 33),
    "window_gqa_d128": (1, 4, 1, 192, 192, 128, True, None, 50),
    # ragged n for the bf16 tensor-core kernels' 64- and 128-row tiles,
    # every head dim, GQA 4, a window, lengths with a 0, cross 1000 x 2048
    "n70_d32": (2, 2, 2, 70, 70, 32, True, None, None),
    "n1000_d64": (1, 4, 4, 1000, 1000, 64, True, None, None),
    "n1001_d128": (1, 2, 2, 1001, 1001, 128, True, None, None),
    "gqa4_n1000_d128": (1, 8, 2, 1000, 1000, 128, True, None, None),
    "window_n1001_d64": (1, 2, 2, 1001, 1001, 64, True, None, 100),
    "len0_gqa4_n1001_d128": (3, 4, 1, 1001, 1001, 128, True, [1001, 0, 517],
                             None),
    "cross_1000x2048_d128": (1, 2, 2, 1000, 2048, 128, False, None, None),
    "cross_70x1001_d32": (2, 4, 2, 70, 1001, 32, False, [1001, 300], None),
    # the op graph's autodiff below 1024 keys and at untileable n_q (7, 3001
    # rows), GQA 4, lengths with a 0, a window
    "op_graph_nq7_gqa4_d64": (2, 8, 2, 7, 200, 64, True, [200, 0], None),
    "op_graph_window_varlen_d128": (2, 4, 4, 517, 517, 128, True, [517, 100],
                                    64),
    "op_graph_n3001_d32": (1, 2, 1, 3001, 3001, 32, True, None, None),
    # the kernel schedules' backward at 1024+ keys: subrow, grid blocks of 8
    "subrow_n1024_d128": (1, 2, 2, 1024, 1024, 128, True, None, None),
    "grid_span8_n1032_gqa_d64": (1, 4, 2, 1032, 1032, 64, True, None, None),
    # head dims other than 32, 64 and 128 (the tiles of 32, 64 and 128
    # columns, zero-padded as they load): each schedule's backward above
    "op_graph_nq7_gqa4_len0_d16": (2, 8, 2, 7, 200, 16, True, [200, 0], None),
    "cross_noncausal_d24": (2, 2, 1, 37, 150, 24, False, None, None),
    "varlen_window_d48": (2, 4, 4, 200, 200, 48, True, [200, 77], 33),
    "n1000_d80": (1, 4, 4, 1000, 1000, 80, True, None, None),
    "gqa4_n1001_d96": (1, 8, 2, 1001, 1001, 96, True, None, None),
    "n70_d112": (2, 2, 2, 70, 70, 112, True, None, None),
    "window_n1001_d120": (1, 2, 2, 1001, 1001, 120, True, None, 100),
    "subrow_pad_n1024_d96": (1, 2, 2, 1024, 1024, 96, True, None, None),
    "subrow_pad_gqa_n2048_d80": (1, 4, 2, 2048, 2048, 80, True, None, None),
    "subrow_varlen_len0_n1024_d48": (3, 2, 2, 1024, 1024, 48, True,
                                     [1024, 515, 0], None),
    "len0_gqa4_n1032_d112": (3, 4, 1, 1032, 1032, 112, True, [1032, 0, 517],
                             None),
    "grid_window256_n2048_d24": (1, 2, 1, 2048, 2048, 24, True, None, 256),
    "cross_1000x2048_d120": (1, 2, 2, 1000, 2048, 120, False, None, None),
    "grid_noncausal_n1032_d16": (1, 2, 2, 1032, 1032, 16, False, None, None),
}


def _flash_inputs(case, dtype, dev):
    b, h, h_kv, n_q, n_kv, d, causal, lengths, window = FLASH_BWD_CASES[case]
    g = torch.Generator(device=dev).manual_seed(4)
    q, do = (_randn(g, b, h, n_q, d, dtype=dtype, dev=dev) for _ in range(2))
    k, v = (_randn(g, b, h_kv, n_kv, d, dtype=dtype, dev=dev) for _ in range(2))
    lens = None if lengths is None else torch.tensor(lengths, device=dev)
    return q, k, v, do, lens, causal, window


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(FLASH_BWD_CASES))
def test_flash_bwd_kernel(dev, dtype, case):
    q, k, v, do, lens, causal, window = _flash_inputs(case, dtype, dev)
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=scale,
                          kv_lengths=lens, window=window)
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    kw = dict(causal=causal, sm_scale=scale, kv_lengths=lens, window=window)
    before = _flash_launches()[1]
    got = fa.flash_bwd(q, k, v, lse, di, do, **kw)
    assert _flash_launches()[1] == before + 1
    want = fa.flash_bwd_plain(q, k, v, lse, di, do, causal, scale, lens,
                              window)
    op_graph = fa._schedule(q, k, causal, window, lens is not None).name \
        == "op_graph"
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        if op_graph and dtype == torch.bfloat16:
            _bf16_match(a, b)      # autograd of the op graph, its roundings
        else:
            assert _rel_err(a, b) <= TOL[dtype]
    for a, b in zip(got, fa.flash_bwd(q, k, v, lse, di, do, **kw)):
        assert torch.equal(a, b)        # no atomics: the same bits every run
    if lens is not None:
        for bi, n in enumerate(lens.tolist()):
            assert (got[1][bi, :, n:] == 0).all() and (got[2][bi, :, n:] == 0).all()
            if n == 0:
                assert (got[0][bi] == 0).all()


def test_flash_autograd_launches_fwd_and_bwd(dev):
    q, k, v, do, lens, causal, window = _flash_inputs(
        "varlen_gqa_len0_d128", torch.float32, dev)
    ts = [t.requires_grad_() for t in (q, k, v)]
    fwd, bwd = _flash_launches()
    out = fa.flash_attention_varlen(*ts, lens, causal)
    got = torch.autograd.grad(out, ts, do)
    assert _flash_launches() == (fwd + 1, bwd + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in ts]
    want = torch.autograd.grad(fa.flash_attention_varlen(*cpu, lens.cpu(),
                                                         causal), cpu, do.cpu())
    for a, b in zip(got, want):
        assert _rel_err(a.cpu(), b) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 3, 7, 8, 9, 4097, 100003, 16384 * 2048])
def test_dropout_kernel_bit_exact(dev, dtype, n):
    """Odd element counts (a partial last Philox block, a scalar tail after
    the 8-element groups, fewer elements than one group) and the train
    shape; the kernel and its plain version agree bit for bit, forward and
    backward."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = _randn(g, n, dtype=dtype, dev=dev)
    _dropout_check(x, dtype, dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [9, 100003])
def test_dropout_kernel_offset_view(dev, dtype, n):
    """x = buf[1:], a base one element past a 16-byte boundary: the
    kernel's scalar head runs up to the first aligned element, then its
    16-byte groups start mid Philox block."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = _randn(g, n + 1, dtype=dtype, dev=dev)[1:]
    assert x.data_ptr() % 16 != 0
    _dropout_check(x, dtype, dev)


def _dropout_check(x, dtype, dev):
    n = x.numel()
    seed = 2**64 - 12345
    before = dr._kernel.launches
    got = dr.dropout(x, 0.1, seed, True)
    assert dr._kernel.launches == before + 1
    want = dr.dropout_reference(x, 0.1, seed, True)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))
    keep = dr.keep_mask(n, 0.1, seed, dev)
    assert not got[~keep].any()
    xg = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad(dr.fused_dropout(xg, 0.1, seed), xg,
                                torch.ones_like(x))
    assert torch.equal(gx != 0, keep)
    if n > 1000:
        assert abs(float(keep.float().mean()) - 0.9) < 0.01


def _quantize(t, payload, axis=-1):
    return (qt.quantize_int8 if payload == torch.int8 else qt.quantize_fp8)(
        t, axis=axis)


def _wo_counts():
    return qt._wo_kernel.launches, qt._wo_f32_kernel.launches


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mkn", [(1, 33, 17), (5, 100, 70), (16, 64, 64),
                                 (17, 7, 130), (130, 256, 1000)])
def test_wo_matmul_kernel(dev, mkn, dtype, payload):
    """Every kernel: the GEMV at M <= 16 (bf16 and f32 x), the tensor-core
    tile at M > 16 (bf16 x with K % 8 == 0; f32 x at any K, in split
    precision, its entry point fa_wo_matmul_f32) and the FMA kernel for
    bf16 x otherwise (K 7); K not a multiple of the tiles' depths, N not a
    multiple of their widths."""
    m, k, n = mkn
    g = torch.Generator(device=dev).manual_seed(6)
    x = _randn(g, m, k, dtype=dtype, dev=dev)
    w = _quantize(torch.randn(k, n, generator=g, device=dev), payload, axis=0)
    bf, f32 = _wo_counts()
    got = qt.int8_weight_only_matmul(x, w)
    assert _wo_counts() == ((bf + 1, f32) if dtype == torch.bfloat16
                            else (bf, f32 + 1))
    want = qt.int8_weight_only_matmul_reference(x, w)
    assert got.dtype == dtype and got.shape == (m, n)
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("k", [1024, 1000, 72, 7])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 100, 300])
def test_wo_matmul_f32_kernels(dev, m, k, payload):
    """f32 x at N 1000 (the lm head's), M on both sides of the GEMV's 16,
    K a multiple of 64, of 8 only (the vectorized split) and of neither
    (the padded split): within 1e-4 of the plain version scaled by
    max(1, max |ref|), through fa_wo_matmul_f32 only (the FMA kernel no
    longer takes f32 x), the same bits on a second call."""
    n = 1000
    g = torch.Generator(device=dev).manual_seed(17)
    x = _randn(g, m, k, dtype=torch.float32, dev=dev)
    w = _quantize(torch.randn(k, n, generator=g, device=dev), payload, axis=0)
    bf, f32 = _wo_counts()
    got = qt.int8_weight_only_matmul(x, w)
    assert _wo_counts() == (bf, f32 + 1)
    want = qt.int8_weight_only_matmul_reference(x, w)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _rel_err(got, want) <= TOL[torch.float32]
    assert torch.equal(got, qt.int8_weight_only_matmul(x, w))


@pytest.mark.parametrize("value", [float("inf"), float("-inf"), float("nan")])
@pytest.mark.parametrize("m", [4, 300])
def test_wo_matmul_f32_nonfinite(dev, m, value):
    """A +-inf or NaN in f32 x reaches the outputs the plain version puts
    it in (the split keeps it in the first piece; 0 * inf gives NaN where
    a weight is 0, as in f32), and only those; the rest within TOL."""
    k, n = 200, 136
    g = torch.Generator(device=dev).manual_seed(18)
    x = _randn(g, m, k, dtype=torch.float32, dev=dev)
    x[1, 5] = value
    w = _quantize(torch.randn(k, n, generator=g, device=dev), torch.int8,
                  axis=0)
    w.values[5, :7] = 0
    got = qt.int8_weight_only_matmul(x, w)
    want = qt.int8_weight_only_matmul_reference(x, w)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert int(want[1].isfinite().sum()) == 0
    fin = want.isfinite()
    assert torch.equal(got[~fin & ~got.isnan()], want[~fin & ~want.isnan()])
    assert _rel_err(got[fin], want[fin]) <= TOL[torch.float32]


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("kn", [(1024, 1024), (1024, 256), (256, 1024),
                                (1024, 1000), (1000, 1004), (72, 1001)])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 100, 4 * 8192])
def test_wo_matmul_bf16_kernels(dev, m, kn, payload):
    """The quantized serving model's Linear shapes (K, N of 1024 and 256, the
    lm head's N 1000, whose 1000-byte weight rows are 8-byte aligned only)
    at the M the GEMV (<= 16) and the tensor-core tile (> 16) branch on,
    ragged M of both, decode and 4 x 8192-token prefill; N 1004 and 1001
    take the 4-byte and the byte-wise weight loads."""
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(16)
    x = _randn(g, m, k, dtype=torch.bfloat16, dev=dev)
    w = _quantize(torch.randn(k, n, generator=g, device=dev), payload, axis=0)
    before = _wo_counts()
    got = qt.int8_weight_only_matmul(x, w)
    assert _wo_counts() == (before[0] + 1, before[1])
    want = qt.int8_weight_only_matmul_reference(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert _rel_err(got, want) <= TOL[torch.bfloat16]
    again = qt.int8_weight_only_matmul(x, w)
    assert torch.equal(got, again)      # no atomics: the same bits every run


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_kernel_quantized(dev, case, dtype, payload):
    b, hq, hkv, d, chunk, page, pps, window = PAGED_CASES[case]
    g = torch.Generator(device=dev).manual_seed(7)
    n_pages = b * pps + 1
    kq, vq = (_quantize(torch.randn(hkv, n_pages, page, d, generator=g,
                                    device=dev), payload) for _ in range(2))
    table = torch.randperm(n_pages, generator=g, device=dev)[:b * pps]
    table = table.reshape(b, pps).int()
    shape = (b, chunk, hq, d) if chunk > 1 else (b, hq, d)
    q = _randn(g, *shape, dtype=dtype, dev=dev)
    lens = torch.tensor([pps * page, chunk + page + 3][:b], device=dev)
    if b > 2:
        lens = torch.cat([lens, torch.tensor([pps * page + 5], device=dev)])
    kw = dict(k_scales=kq.scales, v_scales=vq.scales, window=window)
    before = _paged_launches()
    out = pa.paged_attention(q, kq.values, vq.values, lens, table, **kw)
    assert _paged_delta(before) == _paged_one(dtype)
    ref = pa.paged_attention_plain(q, kq.values, vq.values, lens, table,
                                   **kw)
    assert out.dtype == dtype and _paged_err(out, ref) <= TOL[dtype]


# (b, h, h_kv, n_q, n_kv, d, causal)
KV8_CASES = {
    "ragged_causal_d64": (2, 4, 4, 100, 100, 64, True),
    "cross_noncausal_d32": (2, 2, 1, 37, 150, 32, False),
    "gqa_causal_d128": (1, 8, 2, 130, 130, 128, True),
    "subrow_envelope_d128": (1, 2, 1, 1024, 1024, 128, True),
    # ragged n for the bf16-q tensor-core kernel's 128-row tiles, every
    # head dim, GQA, cross
    "causal_n1000_d32": (1, 2, 2, 1000, 1000, 32, True),
    "causal_gqa2_n1001_d64": (1, 4, 2, 1001, 1001, 64, True),
    "causal_gqa4_n1001_d128": (1, 8, 2, 1001, 1001, 128, True),
    "cross_1000x2048_d128": (1, 2, 2, 1000, 2048, 128, False),
    "cross_70x1001_d64": (2, 4, 2, 70, 1001, 64, False),
    "cross_1001x1000_d32": (1, 2, 1, 1001, 1000, 32, False),
    # head dims other than 32, 64 and 128 (8-bit rows of 8 mod 16 bytes at
    # d 24 and 120)
    "ragged_causal_d16": (2, 4, 4, 100, 100, 16, True),
    "cross_noncausal_d24": (2, 2, 1, 37, 150, 24, False),
    "causal_gqa2_n1001_d48": (1, 4, 2, 1001, 1001, 48, True),
    "cross_1000x2048_d80": (1, 2, 2, 1000, 2048, 80, False),
    "causal_n1000_d96": (1, 2, 2, 1000, 1000, 96, True),
    "gqa_causal_d112": (1, 8, 2, 130, 130, 112, True),
    "cross_70x1001_d120": (2, 4, 2, 70, 1001, 120, False),
}


def _kv8_counts():
    return qt._kv8_kernel.launches, qt._kv8_f32_kernel.launches


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(KV8_CASES))
def test_kv8_flash_kernel(dev, case, dtype, payload):
    """o and lse against the plain version of the shape's route; at the
    subrow envelope fp8 payloads are transcoded to int8 before the launch,
    on both sides.  bf16 q launches fa_kv8_flash, f32 q fa_kv8_flash_f32."""
    b, h, h_kv, n_q, n_kv, d, causal = KV8_CASES[case]
    g = torch.Generator(device=dev).manual_seed(8)
    q = _randn(g, b, h, n_q, d, dtype=dtype, dev=dev)
    k, v = (_quantize(torch.randn(b, h_kv, n_kv, d, generator=g, device=dev),
                      payload) for _ in range(2))
    bf, f32 = _kv8_counts()
    o, lse = qt.flash_attention_kv_int8(q, k, v, causal)
    assert _kv8_counts() == ((bf + 1, f32) if dtype == torch.bfloat16
                             else (bf, f32 + 1))
    if qt._kv8_route(causal, n_q, n_kv, d).name == "subrow":
        k, v = qt.requantize_fp8_to_int8(k), qt.requantize_fp8_to_int8(v)
    o_ref, lse_ref = qt.flash_attention_kv_int8_reference(q, k, v, causal)
    assert o.dtype == dtype and lse.shape == (b, h, n_q, 1)
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(lse, lse_ref) <= TOL[dtype]


# (b, h, h_kv, n_q, n_kv, d, causal, route): each route of JAX's dispatcher
# (ops/quant.py::_kv8_route) and its key block: the loop at N512 (one
# 512-key chunk a query block, GQA), N1152 (128-key chunks: the tile's own
# max) and N1280 (256-key chunks: a max pass over two tiles); the subrow at
# N1024 / 2048 (a max pass over the whole row); the grid with 1024-key
# blocks (256 x 2048), 512-key blocks (cross 256 x 1536), 64-key blocks
# (n 1088: updates inside the tile), 8-key blocks (200 x 3000), and one
# block of every key where n_kv <= 1024 is not a multiple of 128 (576,
# 1000, 384 x 1000); every head dim
C16_KV8_CASES = {
    "loop_n512_gqa4_2": (1, 8, 2, 512, 512, 128, True, "loop"),
    "loop_n1152": (1, 2, 2, 1152, 1152, 128, True, "loop"),
    "loop_n1280_gqa2_1": (1, 2, 1, 1280, 1280, 128, True, "loop"),
    "subrow_n1024_gqa": (1, 4, 2, 1024, 1024, 128, True, "subrow"),
    "subrow_n2048": (1, 2, 1, 2048, 2048, 128, True, "subrow"),
    "grid_256x2048_d128": (1, 2, 2, 256, 2048, 128, False, "grid"),
    "grid_256x1536_d64": (2, 2, 1, 256, 1536, 64, False, "grid"),
    "grid_causal_1088_d32": (1, 2, 2, 1088, 1088, 32, True, "grid"),
    "grid_200x3000_d128": (1, 2, 1, 200, 3000, 128, False, "grid"),
    "grid_causal_576_d32": (1, 4, 2, 576, 576, 32, True, "grid"),
    "grid_causal_1000_d128": (1, 2, 2, 1000, 1000, 128, True, "grid"),
    "grid_384x1000_d64": (1, 2, 2, 384, 1000, 64, False, "grid"),
    "grid_causal_1088_d96": (1, 2, 2, 1088, 1088, 96, True, "grid"),
    "grid_200x3000_d80": (1, 2, 1, 200, 3000, 80, False, "grid"),
    "grid_384x1000_d24": (1, 2, 2, 384, 1000, 24, False, "grid"),
}


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(C16_KV8_CASES))
def test_kv8_flash_routes(dev, case, dtype, payload):
    """The kernel at each route of JAX's dispatcher against the plain
    version of that route (C16): bf16 at least 99% of o bit for bit, the
    rest within one bf16 ulp of its row's largest element, lse within 1e-5
    (the flash gate); f32 (split precision, one function) within 1e-4."""
    b, h, h_kv, n_q, n_kv, d, causal, route = C16_KV8_CASES[case]
    assert qt._kv8_route(causal, n_q, n_kv, d).name == route
    g = torch.Generator(device=dev).manual_seed(19)
    q = _randn(g, b, h, n_q, d, dtype=dtype, dev=dev)
    k, v = (_quantize(torch.randn(b, h_kv, n_kv, d, generator=g, device=dev),
                      payload) for _ in range(2))
    bf, f32 = _kv8_counts()
    o, lse = qt.flash_attention_kv_int8(q, k, v, causal)
    assert _kv8_counts() == ((bf + 1, f32) if dtype == torch.bfloat16
                             else (bf, f32 + 1))
    if route == "subrow":
        k, v = qt.requantize_fp8_to_int8(k), qt.requantize_fp8_to_int8(v)
    o_ref, lse_ref = qt.flash_attention_kv_int8_reference(q, k, v, causal)
    if dtype == torch.bfloat16:
        _bf16_match(o, o_ref)
        assert _err(lse, lse_ref) <= 1e-5
    else:
        assert _err(o, o_ref) <= TOL[dtype]
        assert _err(lse, lse_ref) <= TOL[dtype]


# (b, h, h_kv, n_q, n_kv, d): shapes the JAX tiler cannot divide (n_q 1,
# 7 or 3001), where the function is the flash op graph over K and V
# dequantized to q's dtype: the flash kernel's op-graph mode launches
KV8_FALLBACK_CASES = {
    "nq1_nkv40_d32": (2, 2, 1, 1, 40, 32),
    "nq7_nkv200_gqa_d64": (1, 4, 2, 7, 200, 64),
    "n3001_d128": (1, 2, 2, 3001, 3001, 128),
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(KV8_FALLBACK_CASES))
def test_kv8_flash_fallback(dev, case, dtype, payload, causal):
    b, h, h_kv, n_q, n_kv, d = KV8_FALLBACK_CASES[case]
    g = torch.Generator(device=dev).manual_seed(10)
    q = _randn(g, b, h, n_q, d, dtype=dtype, dev=dev)
    k, v = (_quantize(torch.randn(b, h_kv, n_kv, d, generator=g, device=dev),
                      payload) for _ in range(2))
    before = (_flash_launches()[0], _kv8_counts())
    o, lse = qt.flash_attention_kv_int8(q, k, v, causal)
    assert (_flash_launches()[0], _kv8_counts()) == (before[0] + 1, before[1])
    o_ref, lse_ref = fa._reference_fwd_with_lse(
        q, k.dequantize(dtype), v.dequantize(dtype), causal, d ** -0.5)
    if dtype == torch.bfloat16:
        _bf16_match(o, o_ref)
    else:
        assert _err(o, o_ref) <= TOL[dtype]
    assert _err(lse, lse_ref) <= (1e-5 if dtype == torch.bfloat16
                                  else TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (654, 64), (7, 1027),
                                   (9, 1), (1, 8), (5, 8), (33, 1024),
                                   (1, 1024), (100, 24), (3, 100), (4, 2056),
                                   (1, 8192), (1000, 136)])
def test_stochastic_quant_kernel_bit_exact(dev, dtype, shape):
    """Rows whose Philox blocks straddle two rows (h not a multiple of 4 or
    8: the block-per-row kernel), the warp-per-row 16-byte path from one
    group of 8 (32 rows a warp) to 1024 columns (a row a warp, four groups a
    lane), rows wider than that (a second read), a single row, and a zero
    row; payloads and scales bit for bit."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = _randn(g, *shape, dtype=dtype, dev=dev)
    x[0] = 0
    seed = 2**64 - 77
    before = qt._sq_kernel.launches
    got = qt.quantize_int8_stochastic(x, seed)
    assert qt._sq_kernel.launches == before + 1
    want = qt.quantize_int8_stochastic_reference(x, seed)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.scales, want.scales)


def test_quant_kernels_refuse_grad_and_bad_types(dev):
    x = torch.randn(4, 32, device=dev, requires_grad=True)
    w = qt.quantize_int8(torch.randn(32, 8, device=dev), axis=0)
    with pytest.raises(NotImplementedError):
        qt.int8_weight_only_matmul(x, w)
    with pytest.raises(TypeError):
        qt.int8_weight_only_matmul(x.detach().half(), w)
    with pytest.raises(TypeError):
        qt.int8_weight_only_matmul(x.detach(), qt.QuantizedTensor(
            w.values.to(torch.int16), w.scales))
    with pytest.raises(TypeError):
        qt.quantize_int8_stochastic(x.detach().half(), 0)


def test_quant_kernels_refuse_host_scales(dev):
    """Pages or K/V on the card with their scales on the host raise before
    a launch, and the context stays usable."""
    kq = qt.quantize_int8(torch.randn(2, 4, 8, 32, device=dev), axis=-1)
    host = qt.QuantizedTensor(kq.values, kq.scales.cpu())
    q = torch.randn(2, 4, 8, 32, device=dev)
    before = _kv8_counts()
    with pytest.raises(ValueError):
        qt.flash_attention_kv_int8(q, host, host, True)
    assert _kv8_counts() == before
    lens = torch.tensor([8, 5], device=dev)
    table = torch.tensor([[0], [1]], device=dev)
    before = _paged_launches()
    with pytest.raises(ValueError):
        pa.paged_attention(q[:, :, 0], kq.values, kq.values, lens, table,
                           k_scales=host.scales, v_scales=host.scales)
    assert _paged_launches() == before
    torch.cuda.synchronize()


# (B, H, F, T, mask or None, causal): mask is a broadcast form (B, H, F) of
# random keys, or "window" (a (1,1,F,T) window of 16); T 1, 33 (not whole
# 16-byte chunks: the scalar row path), 64 (several rows a warp), 1000, 2048
# (row groups of 4 warps), 4097 and 8200 (past the register envelope: the
# generic kernels), F != T both ways, every mask form
SOFTMAX_CASES = {
    "t1_causal": (2, 3, 5, 1, None, True),
    "t33_b11t": (2, 3, 17, 33, (1, 0, 0), False),
    "t33_b11t_causal": (2, 3, 17, 33, (1, 0, 0), True),
    "t64_causal": (2, 2, 64, 64, None, True),
    "t1000_11ft_causal": (1, 2, 40, 1000, (0, 0, 1), True),
    "t4097_bhft": (1, 2, 9, 4097, (1, 1, 1), False),
    "t4097_causal_f_lt_t": (1, 2, 9, 4097, None, True),
    "t8200_b11t_causal": (2, 1, 9, 8200, (1, 0, 0), True),
    "f_gt_t_1h1t_causal": (2, 2, 70, 48, (0, 1, 0), True),
    "t2048_causal": (1, 2, 64, 2048, None, True),
    "t2048_b11t_causal": (2, 2, 33, 2048, (1, 0, 0), True),
    "t2048_window_causal": (1, 2, 80, 2048, "window", True),
    "t256_nomask": (2, 2, 16, 256, None, False),
}
SOFTMAX_IMPLS = [(torch.float32, "auto"), (torch.bfloat16, "auto"),
                 (torch.bfloat16, "pallas")]


def _within_bf16_ulp(got, want, slack=0.0):
    """Per element: |got - want| <= 2^-7 |want| + 1e-6 + slack, one bf16
    ulp of the reference (both round an f32 result once)."""
    d = (got.float() - want.float()).abs()
    return bool((d <= want.float().abs() * 2 ** -7 + 1e-6 + slack).all())


def _softmax_ok(got, want, dtype, op_graph=False):
    """bf16: one ulp; the op graph two, as w = sum(e), an f32 sum in another
    order rounded to bf16, may take the neighbouring value (2^-7
    relative), moving the row's outputs by one more ulp."""
    if dtype == torch.bfloat16:
        return _within_bf16_ulp(got, want, want.float().abs() * 2 ** -7
                                if op_graph else 0.0)
    return _err(got, want) <= TOL[dtype]


def _softmax_bwd_ok(got, want, out, dout, dtype, op_graph=False):
    """bf16: one ulp, plus |out| 2^-12 (sum_row |dout out| + |dout|) for the
    f32 rounding of the row sum s and of dout - s, which may cancel.  The op
    graph is the plain version's arithmetic, except in a row whose w (an
    f32 sum in another order, rounded to bf16) takes the neighbouring
    value: dout / w moves by an ulp, s (a bf16 sum rounded at every add) by
    a few ulps of sum_row |dout out|, hence the slack's 2^-4; such rows are
    rare (test_softmax_op_graph_bwd_mostly_bit_exact)."""
    if dtype != torch.bfloat16:
        return _rel_err(got, want) <= TOL[dtype]
    o, g = out.float(), dout.float()
    slack = (o * g).abs().sum(-1, keepdim=True).add(g.abs()) * o.abs()
    return _within_bf16_ulp(got, want, slack * 2 ** (-4 if op_graph else -12))


def _softmax_inputs(case, dtype, dev, offset=False):
    """x (``offset``: a view one element into its buffer), the mask (in x's
    dtype for bf16: the model's, a weakly typed mask in JAX) and causal."""
    b, h, f, t, dims, causal = SOFTMAX_CASES[case]
    g = torch.Generator(device=dev).manual_seed(11)
    n = b * h * f * t
    x = _randn(g, n + int(offset), dtype=dtype, dev=dev)
    x = x.mul_(3)[int(offset):].view(b, h, f, t)
    mask = None
    if dims == "window":
        cols = torch.arange(t, device=dev)
        rows = torch.arange(f, device=dev)
        mask = torch.where(cols[None] > rows[:, None] - 16, 0.0, -1e9)[None, None]
    elif dims is not None:
        shape = tuple(n if k else 1 for n, k in zip((b, h, f), dims)) + (t,)
        keep = torch.rand(shape, generator=g, device=dev) < 0.85
        mask = torch.where(keep, 0.0, -1e9)
        if dims[0] and b > 1:
            mask[1] = -1e9          # a batch row with every key masked
    if mask is not None and dtype == torch.bfloat16:
        mask = mask.to(dtype)
    return x, mask, causal


def _softmax_kernels_check(x, mask, causal, dtype, impl, dev):
    op = dtype == torch.bfloat16 and impl == "auto"
    plain = (sm.attn_softmax_reference if impl == "auto"
             else sm._attn_softmax_pallas_reference)
    before = sm._fwd_kernel.launches
    got = sm.softmax_fwd(x, mask, causal, impl)
    assert sm._fwd_kernel.launches == before + 1
    want = plain(x, mask, causal)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got).all()
    assert _softmax_ok(got, want, dtype, op)
    g = torch.Generator(device=dev).manual_seed(12)
    dout = _randn(g, *x.shape, dtype=dtype, dev=dev)
    before = sm._bwd_kernel.launches
    if op:
        dinp = sm.softmax_bwd(x, dout, mask, causal, impl)
        ref = sm._softmax_bwd_op_graph(x, dout, mask, causal)
    else:
        dinp = sm.softmax_bwd(want, dout)
        ref = sm.softmax_bwd_reference(want, dout)
    assert sm._bwd_kernel.launches == before + 1
    assert dinp.dtype == dtype
    assert _softmax_bwd_ok(dinp, ref, want, dout, dtype, op)


@pytest.mark.parametrize("dtype, impl", SOFTMAX_IMPLS)
@pytest.mark.parametrize("case", list(SOFTMAX_CASES))
def test_softmax_kernels(dev, dtype, impl, case):
    """Both roundings (the op graph is bf16's "auto"; f32 has one function)
    against their plain versions: forward at one bf16 ulp, backward at one
    ulp plus the slack of _softmax_bwd_ok."""
    _softmax_kernels_check(*_softmax_inputs(case, dtype, dev), dtype, impl, dev)


@pytest.mark.parametrize("dtype, impl", SOFTMAX_IMPLS)
@pytest.mark.parametrize("case", ["t33_b11t_causal", "t2048_causal"])
def test_softmax_kernels_offset_view(dev, dtype, impl, case):
    """Scores one element into their buffer: a base off 16 bytes."""
    x, mask, causal = _softmax_inputs(case, dtype, dev, offset=True)
    assert x.storage_offset() == 1
    _softmax_kernels_check(x, mask, causal, dtype, impl, dev)


def test_softmax_op_graph_bwd_mostly_bit_exact(dev):
    """The op graph's backward at T 2048 causal: the kernel's arithmetic is
    the plain version's (XLA's bf16 sum in the same windows), so all but a
    few rows, where the f32 row sum of e rounds w to the other bf16
    neighbour, agree bit for bit."""
    x, mask, causal = _softmax_inputs("t2048_causal", torch.bfloat16, dev)
    dout = torch.randn(x.shape, device=dev).to(torch.bfloat16)
    got = sm.softmax_bwd(x, dout, mask, causal, "auto")
    want = sm._softmax_bwd_op_graph(x, dout, mask, causal)
    assert float((got == want).float().mean()) >= 0.99
    fwd = sm.softmax_fwd(x, mask, causal, "auto")
    same = fwd == sm.attn_softmax_reference(x, mask, causal)
    assert float(same.float().mean()) >= 0.99


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_softmax_autograd_launches_both_kernels(dev, impl):
    """Every call on a CUDA tensor launches the kernels, whatever impl says;
    the gradients match the CPU's plain versions (f32: one function)."""
    x, mask, causal = _softmax_inputs("t33_b11t_causal", torch.float32, dev)
    xg = x.clone().requires_grad_()
    dout = torch.randn_like(x)
    for _ in range(2):
        fwd, bwd = sm._fwd_kernel.launches, sm._bwd_kernel.launches
        out = sm.attn_softmax(xg, mask, causal, impl=impl)
        (got,) = torch.autograd.grad(out, xg, dout)
        assert (sm._fwd_kernel.launches, sm._bwd_kernel.launches) == (
            fwd + 1, bwd + 1)
    xc = x.cpu().requires_grad_()
    out_c = sm.attn_softmax(xc, mask.cpu(), causal, impl=impl)
    (want,) = torch.autograd.grad(out_c, xc, dout.cpu())
    assert _err(out.detach().cpu(), out_c.detach()) <= 1e-5
    assert _rel_err(got.cpu(), want) <= 1e-5


def test_softmax_autograd_bf16_op_graph(dev):
    """bf16 through ``attn_softmax`` ("auto", a bf16 padding mask): the
    forward and the op graph's backward launch once each and hold the CPU's
    plain versions, bit for bit in all but a few rows."""
    x, mask, causal = _softmax_inputs("t2048_b11t_causal", torch.bfloat16, dev)
    xg = x.clone().requires_grad_()
    dout = torch.randn(x.shape, device=dev).to(torch.bfloat16)
    fwd, bwd = sm._fwd_kernel.launches, sm._bwd_kernel.launches
    out = sm.attn_softmax(xg, mask, causal)
    (got,) = torch.autograd.grad(out, xg, dout)
    assert (sm._fwd_kernel.launches, sm._bwd_kernel.launches) == (fwd + 1, bwd + 1)
    assert out.dtype == got.dtype == torch.bfloat16
    xc = x.cpu().requires_grad_()
    out_c = sm.attn_softmax(xc, mask.cpu(), causal)
    (want,) = torch.autograd.grad(out_c, xc, dout.cpu())
    assert float((out.detach().cpu() == out_c.detach()).float().mean()) >= 0.99
    assert float((got.cpu() == want).float().mean()) >= 0.99
    assert _softmax_bwd_ok(got.cpu(), want, out_c.detach(), dout.cpu(),
                           torch.bfloat16, op_graph=True)


# (n, d): one row, d = 1, d not a multiple of 4 or 8 (the element-wise
# walk, Philox blocks straddling rows and groups straddling three blocks),
# the 16-byte path from d = 8 (one column group) up to more columns than one
# block's 256 groups, one row of it, and more rows than the card's lanes
DROPOUT_BIAS_SHAPES = [(1, 7), (5, 6), (3, 13), (70, 130), (130, 1024),
                       (65, 2052), (33, 1), (1, 1), (3, 8), (1, 4096),
                       (17, 2056), (2, 1000), (5000, 24)]


def _bias_inputs(n, d, dtype, dev, seed=13):
    g = torch.Generator(device=dev).manual_seed(seed)
    x, r, gy = (_randn(g, n, d, dtype=dtype, dev=dev) for _ in range(3))
    bias = _randn(g, d, dtype=torch.bfloat16, dev=dev)
    return x, bias, r, gy


def _bits_equal(a, b):
    bits = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a.view(bits), b.view(bits))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", DROPOUT_BIAS_SHAPES)
def test_dropout_res_bias_kernels(dev, dtype, shape):
    n, d = shape
    x, bias, r, gy = _bias_inputs(n, d, dtype, dev)
    seed, rate, scale = 2**64 - 999, 0.1, True
    keep = dr.keep_mask(n * d, rate, seed, dev).reshape(n, d)
    before = dr._res_kernel.launches
    got = dr.dropout_res_bias(x, bias, r, rate, seed, scale)
    assert dr._res_kernel.launches == before + 1
    assert _bits_equal(got, dr.dropout_res_bias_reference(x, bias, r, rate,
                                                          seed, scale))
    assert torch.equal(got[~keep], r[~keep])
    dx, db = dr.dropout_res_bias_bwd(gy, rate, seed, scale)
    assert dr._res_kernel.launches == before + 2
    dx_ref, db_ref = dr.dropout_res_bias_bwd_reference(gy, rate, seed, scale)
    assert _bits_equal(dx, dx_ref)
    assert torch.equal(dx != 0, keep)
    assert db.dtype == torch.float32 and _rel_err(db, db_ref) <= TOL[dtype]


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", DROPOUT_BIAS_SHAPES)
def test_dropout_act_bias_kernels(dev, dtype, shape, act):
    n, d = shape
    x, bias, _, gy = _bias_inputs(n, d, dtype, dev, seed=14)
    seed, rate, scale = 12345, 0.1, True
    keep = dr.keep_mask(n * d, rate, seed, dev).reshape(n, d)
    before = dr._act_kernel.launches
    got = dr.dropout_act_bias(x, bias, rate, seed, scale, act)
    assert dr._act_kernel.launches == before + 1
    want = dr.dropout_act_bias_reference(x, bias, rate, seed, scale, act)
    assert not got[~keep].any()
    if act == "relu":
        assert _bits_equal(got, want)
    assert _rel_err(got, want) <= TOL[dtype]
    dx, db = dr.dropout_act_bias_bwd(gy, x, bias, rate, seed, scale, act)
    assert dr._act_kernel.launches == before + 2
    dx_ref, db_ref = dr.dropout_act_bias_bwd_reference(gy, x, bias, rate, seed,
                                                       scale, act)
    assert not dx[~keep].any()
    assert _rel_err(dx, dx_ref) <= TOL[dtype]
    assert _rel_err(db, db_ref) <= TOL[dtype]


def test_dropout_bias_autograd_launches_both_directions(dev):
    """The public entry points launch a kernel forward and backward on every
    call; gradients match the CPU's (the plain versions)."""
    x, bias, r, gy = _bias_inputs(37, 100, torch.float32, dev, seed=15)
    ts = [t.float().clone().requires_grad_() for t in (x, bias, r)]
    for _ in range(2):
        before = (dr._res_kernel.launches, dr._act_kernel.launches)
        res = dr.fused_dropout_res_bias(*ts, 0.2, 7)
        act = dr.fused_dropout_act_bias(ts[0], ts[1], 0.2, 7, "gelu")
        got = torch.autograd.grad((res * gy).sum() + (act * gy).sum(), ts)
        assert (dr._res_kernel.launches, dr._act_kernel.launches) == (
            before[0] + 2, before[1] + 2)
    cs = [t.detach().cpu().requires_grad_() for t in ts]
    res_c = dr.fused_dropout_res_bias(*cs, 0.2, 7)
    act_c = dr.fused_dropout_act_bias(cs[0], cs[1], 0.2, 7, "gelu")
    want = torch.autograd.grad((res_c * gy.cpu()).sum()
                               + (act_c * gy.cpu()).sum(), cs)
    assert _err(res.detach().cpu(), res_c.detach()) == 0
    assert _err(act.detach().cpu(), act_c.detach()) <= 1e-5
    for a, b in zip(got, want):
        assert _rel_err(a.cpu(), b) <= 1e-5


# -- serving features: the engine's draws and speculative verify waves ----------


@pytest.mark.parametrize("v", [1000, 16384])
def test_threefry_cuda_equals_cpu(dev, v):
    """The engine's threefry keys and uniforms are integer ops: the card's
    words equal the CPU's bit for bit (B 16)."""
    from flashattn_tpu_torch.serving import _threefry, engine as eng

    g = torch.Generator().manual_seed(3)
    seeds = torch.randint(0, 2**31 - 1, (16,), generator=g, dtype=torch.int32)
    pos = torch.randint(0, 16384, (16,), generator=g, dtype=torch.int32)
    key_c = eng._row_keys(seeds, pos, eng._SALT_RESIDUAL)
    key_g = eng._row_keys(seeds.to(dev), pos.to(dev), eng._SALT_RESIDUAL)
    for a, b in zip(key_g, key_c):
        assert torch.equal(a.cpu(), b)
    u_c, u_g = _threefry.uniform(key_c, v), _threefry.uniform(key_g, v)
    assert torch.equal(u_g.cpu().view(torch.int32), u_c.view(torch.int32))


def _near_tie(scores, got, want):
    """Rows where the card's token differs from the CPU's must be ties of the
    CPU's perturbed scores to 1e-5 relative (the Gumbel noise's log may
    round to the neighbouring float on the card)."""
    rows = (got != want).nonzero().flatten()
    for r in rows.tolist():
        a, c = scores[r, got[r]], scores[r, want[r]]
        assert abs(float(a - c)) <= 1e-5 * max(1.0, abs(float(c))), r
    return len(rows)


def test_sample_tokens_cuda_equals_cpu(dev):
    """_sample_tokens on the card's logits lands the CPU's tokens: 64 rows of
    mixed temperature, top-k, top-p, min-p and penalties at V 1000."""
    from flashattn_tpu_torch.serving import engine as eng

    g = torch.Generator().manual_seed(4)
    b, v = 64, 1000
    logits = torch.randn(b, v, generator=g) * 3
    temps = torch.tensor([0.0, 0.7, 1.5, 1.0]).repeat(16)
    topks = torch.tensor([0, 0, 50, 1, 0, 5, 0, 0], dtype=torch.int32).repeat(8)
    topps = torch.tensor([0.0, 0.9, 0.0, 0.5], dtype=torch.float32).repeat(16)
    minps = torch.tensor([0.0, 0.0, 0.05, 0.0, 0.3, 0.0, 0.0, 0.0]).repeat(8)
    seeds = torch.randint(0, 2**31 - 1, (b,), generator=g, dtype=torch.int32)
    pos = torch.randint(0, 4096, (b,), generator=g, dtype=torch.int32)
    presence = (torch.rand(b, v, generator=g) < 0.05).float() * 2
    pen = dict(presence=presence, reps=torch.tensor([1.0, 1.2]).repeat(32),
               freqs=torch.tensor([0.0, 0.0, 0.3, 0.0]).repeat(16),
               press=torch.tensor([0.0, 0.5]).repeat(32), minps=minps)
    args = (logits, temps, topks, topps, seeds, pos)
    want = eng._sample_tokens(*args, **pen)
    got = eng._sample_tokens(*(t.to(dev) for t in args),
                             **{k: t.to(dev) for k, t in pen.items()}).cpu()
    # the CPU's perturbed scores, for the near-tie check
    adj = torch.where(logits > 0, logits / pen["reps"][:, None],
                      logits * pen["reps"][:, None])
    pl = torch.where((presence > 0) & (pen["reps"][:, None] != 1), adj, logits)
    pl = pl - (pen["freqs"][:, None] * presence
               + pen["press"][:, None] * (presence > 0))
    scores = (pl / temps.clamp_min(1e-6)[:, None]
              + eng._row_gumbel(seeds, pos, eng._SALT_SAMPLE, v))
    assert _near_tie(scores, got, want) <= 2


def test_spec_accept_sampled_cuda_equals_cpu(dev):
    """The accept/residual wave on the card's logits: the CPU's accepted
    counts, tokens and logprobs (B 64, k+1 = 5, V 1000)."""
    from flashattn_tpu_torch.serving import engine as eng

    g = torch.Generator().manual_seed(5)
    b, n, v = 64, 5, 1000
    logits = torch.randn(b, n, v, generator=g) * 2
    proposed = logits[:, :-1].argmax(-1).int()
    proposed[::3, 1] = torch.randint(0, v, (22,), generator=g).int()
    proposed[::5, 2:] = -1
    temps = torch.tensor([0.0, 0.8, 1.2, 0.5]).repeat(16)
    seeds = torch.randint(0, 2**31 - 1, (b,), generator=g, dtype=torch.int32)
    pos0 = torch.randint(0, 4096, (b,), generator=g, dtype=torch.int32)
    args = (logits, proposed, temps, seeds, pos0)
    n_c, t_c, l_c = eng._spec_accept_sampled(*args)
    n_g, t_g, l_g = (t.cpu() for t in eng._spec_accept_sampled(
        *(t.to(dev) for t in args)))
    assert torch.equal(n_g, n_c)
    rows = torch.arange(b)
    logp = torch.log_softmax(logits / temps.clamp_min(1e-6)[:, None, None], -1)
    scores = logp[rows, n_c] + eng._row_gumbel(seeds, pos0 + n_c,
                                                eng._SALT_RESIDUAL, v)
    last_g, last_c = t_g[rows, n_c].long(), t_c[rows, n_c].long()
    assert torch.equal(t_g[rows[:, None], torch.arange(n)] * (
        torch.arange(n) < n_c[:, None]), t_c * (torch.arange(n) < n_c[:, None]))
    assert _near_tie(scores, last_g, last_c) <= 2
    same = t_g == t_c
    assert _err(l_g[same], l_c[same]) <= 1e-5


# (b, hq, hkv, d, page, pps, bases): speculative verify waves of k+1 = 5
# rows a sequence at bases that cross a page, the north-star heads (8 q / 8
# kv: 5 rows a kv head, the decode tile) and GQA (20 rows, the wgmma tile)
VERIFY_CASES = {
    "north_star_heads_page16_d128": (4, 8, 8, 128, 16, 8, [14, 30, 45, 0]),
    "gqa4_page128_d128": (3, 8, 2, 128, 128, 4, [126, 253, 3]),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(VERIFY_CASES))
def test_paged_verify_wave(dev, dtype, case):
    """A verify wave of k+1 rows at base ``lengths`` against
    paged_attention_plain under the paged gates; the pages past each row's
    length (a speculative scan's rejected writes) and the neighbours'
    lengths leave a row's output bit for bit unchanged."""
    b, hq, hkv, d, page, pps, bases = VERIFY_CASES[case]
    k1 = 5
    g = torch.Generator(device=dev).manual_seed(12)
    n_pages = b * pps + 1
    kp = _randn(g, hkv, n_pages, page, d, dtype=dtype, dev=dev)
    vp = _randn(g, hkv, n_pages, page, d, dtype=dtype, dev=dev)
    table = torch.randperm(n_pages, generator=g, device=dev)[:b * pps]
    table = table.reshape(b, pps).int()
    q = _randn(g, b, k1, hq, d, dtype=dtype, dev=dev)
    lens = torch.tensor(bases, device=dev) + k1
    before = _paged_launches()
    out = pa.paged_attention(q, kp, vp, lens, table)
    assert _paged_delta(before) == _paged_one(dtype)
    ref = pa.paged_attention_plain(q, kp, vp, lens, table)
    assert _paged_err(out, ref) <= TOL[dtype]
    # overwrite every position at or past each row's length
    kp2, vp2 = kp.clone(), vp.clone()
    for r in range(b):
        for col in range(pps):
            start = max(0, int(lens[r]) - col * page)
            if start < page:
                kp2[:, table[r, col], start:] = 7.0
                vp2[:, table[r, col], start:] = -7.0
    assert torch.equal(pa.paged_attention(q, kp2, vp2, lens, table), out)
    # a neighbour's length does not move row 0
    lens2 = lens.clone()
    lens2[1:] = torch.clamp(lens2[1:] + page + 1, max=pps * page)
    assert torch.equal(pa.paged_attention(q, kp, vp, lens2, table)[0], out[0])


def _card_and_host_models(dev, **kw):
    """An f32 DecoderLM on the card (TF32 off: the dev fixture) and its CPU
    copy, which runs the plain versions of the kernels."""
    import copy

    import flashattn_tpu_torch as pt

    card = pt.DecoderLM(64, 256, 2, 512, p_dropout=0.0, device=dev,
                        generator=torch.Generator().manual_seed(3),
                        **kw).eval()
    return card, copy.deepcopy(card).to("cpu")


def test_rope_paged_paths_match_plain(dev):
    """A RoPE model's paged prefill (ragged prompts, an idle row), a 3-token
    extend at per-row bases and one decode step on the card, against the
    same calls on a CPU copy (paged_attention_plain, the plain flash
    version): logits within 1e-4, the flash and paged kernels launched."""
    card, host = _card_and_host_models(dev, n_layer=2, n_kv_head=1,
                                       pos_encoding="rope")
    page, pps = 16, 6
    table = torch.arange(3 * pps, dtype=torch.int32).reshape(3, pps)
    lens = torch.tensor([37, 5, 0])
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, 64, (3, 40), generator=g)
    chunk = torch.randint(0, 64, (3, 3), generator=g)
    nxt = torch.randint(0, 64, (3, 1), generator=g)
    out = []
    before = _flash_launches()[0], pa._f32_kernel.launches
    for model, d in ((card, dev), (host, torch.device("cpu"))):
        pools = model.init_page_pools(3 * pps + 1, page, device=d)
        t, ln = table.to(d), lens.to(d)
        with torch.inference_mode():
            pre, pools = model.forward_prefill_paged(prompt.to(d), pools, t,
                                                     ln)
            ext, pools = model.forward_extend_paged(chunk.to(d), pools, t, ln)
            dec, pools = model.forward_decode_paged(nxt.to(d), pools, t,
                                                    ln + 3)
        out.append([x.cpu() for x in (pre, ext, dec)])
    assert _flash_launches()[0] > before[0]          # the card's prefill
    assert pa._f32_kernel.launches >= before[1] + 4   # 2 layers x extend, decode
    (pre, ext, dec), (pre_h, ext_h, dec_h) = out
    for r, n in enumerate(lens.tolist()[:2]):      # row 2 is idle
        assert _err(pre[r, :n], pre_h[r, :n]) <= 1e-4
    assert _err(ext[:2], ext_h[:2]) <= 1e-4
    assert _err(dec[:2], dec_h[:2]) <= 1e-4


def test_moe_cached_decode_routes_as_dense_forward(dev):
    """An MoE + RoPE model in eval mode on the card: every token's experts
    in each layer during the cached decode equal those of one dense forward
    over the same tokens, and the logits agree within 1e-3."""
    card, _ = _card_and_host_models(dev, n_layer=2, n_experts=8,
                                    moe_top_k=2, pos_encoding="rope")
    toks = torch.randint(0, 64, (3, 41), generator=torch.Generator()
                         .manual_seed(5)).to(dev)
    seen = []

    def record(layer):
        route = layer.ff._route

        def wrapped(xt):
            probs, combine, top_mask = route(xt)
            seen.append((layer, top_mask))
            return probs, combine, top_mask

        layer.ff._route = wrapped

    for layer in card.layers:
        record(layer)
    with torch.inference_mode():
        dense = card(toks)
        dense_routes = {id(l): m.reshape(3, 41, -1) for l, m in seen}
        seen.clear()
        caches, steps = card.init_cache(3, 41), []
        for i in range(41):
            lg, caches = card.forward_decode(toks[:, i:i + 1], caches,
                                             torch.tensor(i, device=dev))
            steps.append(lg[:, 0])
    for i, (layer, mask) in enumerate(seen):
        s = i // len(card.layers)
        assert torch.equal(mask, dense_routes[id(layer)][:, s]), (s, i)
    assert _err(torch.stack(steps, 1), dense) <= 1e-3


def test_beam_search_cuda_equals_cpu(dev):
    """Beam 3 over ragged prompts with an eos: the card's hypotheses equal
    the CPU's and the final beam scores agree within 1e-4 (f32); greedy
    likewise."""
    from flashattn_tpu_torch.training import generate as gen

    card, host = _card_and_host_models(dev, n_layer=2, n_kv_head=1)
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(3, 64, (3, 9), generator=g)
    plen = torch.tensor([9, 4, 1])
    out = []
    for model in (card, host):
        d = next(model.parameters()).device
        buf, pl, _ = gen._buffer(model, prompt, plen, 12, repeat=3)
        with torch.inference_mode():
            best, scores = gen._beam_search(model.eval(), buf, pl, 3, 1, 0.6)
        greedy = gen.greedy_generate(model, prompt.to(d), plen.to(d), 12,
                                     eos_id=1)
        out.append((best.cpu(), scores.cpu(), greedy.cpu()))
    (b_c, s_c, g_c), (b_h, s_h, g_h) = out
    assert torch.equal(b_c, b_h)
    assert _err(s_c, s_h) <= 1e-4
    assert torch.equal(g_c, g_h)


# the machine-translation shapes, head dim 32, batch cut from 128 to 6:
# (n_q, n_kv, causal, lengths) of the encoder's varlen self-attention, the
# decoder's causal self-attention, the cross-attention (n_q != n_kv too),
# and generation's cross-attention at n_q 1; lengths ragged down to 1
MT_ATTN_CASES = {
    "encoder_40x40_varlen": (40, 40, False, [40, 33, 17, 9, 2, 1]),
    "decoder_40x40_causal": (40, 40, True, None),
    "cross_40x40_varlen": (40, 40, False, [40, 1, 25, 7, 40, 13]),
    "cross_31x40_varlen": (31, 40, False, [40, 1, 25, 7, 40, 13]),
    "generate_cross_1x40_varlen": (1, 40, False, [40, 1, 25, 7, 40, 13]),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(MT_ATTN_CASES))
def test_flash_op_graph_mt_shapes(dev, dtype, case):
    """The op graph's forward and backward kernels at the MT app's shapes
    (B6 H8 d32) against flash_fwd_plain / flash_bwd_plain: bf16 by
    :func:`_bf16_match`, f32 within TOL."""
    n_q, n_kv, causal, lengths = MT_ATTN_CASES[case]
    g = torch.Generator(device=dev).manual_seed(7)
    q, do = (_randn(g, 6, 8, n_q, 32, dtype=dtype, dev=dev) for _ in range(2))
    k, v = (_randn(g, 6, 8, n_kv, 32, dtype=dtype, dev=dev) for _ in range(2))
    lens = None if lengths is None else torch.tensor(lengths, device=dev)
    assert fa._schedule(q, k, causal, None, lens is not None).name == "op_graph"
    o, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=32 ** -0.5,
                          kv_lengths=lens)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, 32 ** -0.5, lens)
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    got = fa.flash_bwd(q, k, v, lse, di, do, causal=causal,
                       sm_scale=32 ** -0.5, kv_lengths=lens)
    want = fa.flash_bwd_plain(q, k, v, lse, di, do, causal, 32 ** -0.5, lens)
    for a, b, grad in [(o, o_ref, False)] + [(a, b, True)
                                             for a, b in zip(got, want)]:
        if dtype == torch.bfloat16:
            _bf16_match(a, b)
        else:
            assert (_rel_err(a, b) if grad else _err(a, b)) <= TOL[dtype]
    assert _err(lse, lse_ref) <= 1e-5


def test_encoder_decoder_cuda_equals_cpu(dev):
    """An f32 EncoderDecoderLM (E 256, 8 heads of 32, the MT app's width)
    on the card against its CPU copy: teacher-forced logits within 1e-4;
    one seq2seq_loss step's loss within 1e-5 relative and every gradient
    within 1e-4 in relative L2 norm (the key biases, whose exact gradient
    is 0, within 1e-4 of the global norm); the launch counts of the
    forward and backward kernels grow."""
    import copy

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.training.translation import seq2seq_loss

    card = pt.EncoderDecoderLM(500, 256, 8, 40, p_dropout=0.0,
                               n_encoder_layer=2, n_decoder_layer=2,
                               device=dev,
                               generator=torch.Generator().manual_seed(9))
    host = copy.deepcopy(card).to("cpu")
    g = torch.Generator().manual_seed(10)
    src = torch.randint(3, 500, (4, 40), generator=g)
    tgt = torch.randint(3, 500, (4, 37), generator=g)
    lens = torch.tensor([40, 1, 23, 9])
    labels = torch.randint(3, 500, (4, 37), generator=g)
    mask = (torch.rand(4, 37, generator=g) < 0.8).float()
    before = _flash_launches()
    out = []
    for model in (card, host):
        d = next(model.parameters()).device
        with torch.inference_mode():
            logits = model(src.to(d), tgt.to(d), lens.to(d))
        inputs = {"src": src.to(d), "src_lens": lens.to(d),
                  "tgt_in": tgt.to(d)}
        loss = seq2seq_loss(model, inputs, labels.to(d), mask.to(d))
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        out.append((logits.cpu(), float(loss.detach()),
                    {n: gr.cpu() for n, gr in zip(names, grads)}))
    after = _flash_launches()
    assert after[0] > before[0] and after[1] > before[1]
    (lc, l_c, g_c), (lh, l_h, g_h) = out
    assert _err(lc, lh) <= 1e-4
    assert abs(l_c - l_h) <= 1e-5 * abs(l_h)
    total = float(sum(gr.double().square().sum() for gr in g_h.values())) ** 0.5
    for n in g_h:
        diff = float((g_c[n].double() - g_h[n].double()).norm())
        if n.endswith("k_projection.bias"):
            assert max(float(g_c[n].norm()), float(g_h[n].norm())) \
                <= 1e-4 * total, n
        else:
            assert diff <= 1e-4 * float(g_h[n].double().norm()), n


# the op graph's kernels at the edges of their tiles: keys 1, 40, 64, 127,
# 128, 129, 512 and 1023 (one key tile of 128 at d 32 / 64 or 64 at d 128,
# then the two-pass walk; the dQ kernel's 64-key tiles, the dK/dV kernel's
# 64- or 32-row query tiles), query rows 1, 16, 17 and 40 (blocks of
# cdiv(n_q, 16) warps, a warp past the last row), b * h odd, GQA 3 and 4,
# a length-0 row, a window and varlen:
# (b, h, h_kv, n_q, n_kv, d, causal, lengths, window)
OP_EDGE_CASES = {
    "nq1_nkv1_d32": (3, 3, 3, 1, 1, 32, False, None, None),
    "nq16_nkv40_gqa3_d64": (3, 3, 1, 16, 40, 64, False, None, None),
    "nq17_nkv64_causal_d128": (1, 5, 5, 17, 64, 128, True, None, None),
    "nq40_nkv127_len0_d32": (3, 2, 2, 40, 127, 32, False, [127, 0, 50], None),
    "nq128_nkv128_causal_d64": (3, 2, 2, 128, 128, 64, True, None, None),
    "nq40_nkv129_gqa4_varlen_d64": (2, 8, 2, 40, 129, 64, False, [129, 64],
                                    None),
    "nq512_causal_d128": (1, 3, 3, 512, 512, 128, True, None, None),
    "nq1023_window_varlen_d32": (2, 2, 2, 1023, 1023, 32, True, [1023, 500],
                                 100),
    "nq17_nkv1023_gqa4_len0_d128": (2, 4, 1, 17, 1023, 128, False, [1023, 0],
                                    None),
}


@pytest.mark.parametrize("case", list(OP_EDGE_CASES))
def test_flash_op_graph_edges(dev, case):
    """The bf16 op graph's forward (o, lse) and backward kernels against
    flash_fwd_plain / flash_bwd_plain by :func:`_bf16_match`; the backward
    twice bit for bit; keys past a length get dk = dv = 0 and a row with no
    key dq = 0."""
    b, h, h_kv, n_q, n_kv, d, causal, lengths, window = OP_EDGE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    q, do = (_randn(g, b, h, n_q, d, dtype=bf, dev=dev) for _ in range(2))
    k, v = (_randn(g, b, h_kv, n_kv, d, dtype=bf, dev=dev) for _ in range(2))
    lens = None if lengths is None else torch.tensor(lengths, device=dev)
    assert fa._schedule(q, k, causal, window, lens is not None).name == "op_graph"
    sc = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc, kv_lengths=lens,
                          window=window)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, sc, lens, window)
    _bf16_match(o, o_ref)
    fin = lse_ref.isfinite()
    assert torch.equal(lse.isfinite(), fin)
    assert _err(lse[fin], lse_ref[fin]) <= 1e-5
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    kw = dict(causal=causal, sm_scale=sc, kv_lengths=lens, window=window)
    got = fa.flash_bwd(q, k, v, lse, di, do, **kw)
    want = fa.flash_bwd_plain(q, k, v, lse, di, do, causal, sc, lens, window)
    for a, w in zip(got, want):
        assert a.shape == w.shape and torch.isfinite(a).all()
        _bf16_match(a, w)
    for a, w in zip(got, fa.flash_bwd(q, k, v, lse, di, do, **kw)):
        assert torch.equal(a, w)
    if lens is not None:
        for bi, n in enumerate(lens.tolist()):
            assert (got[1][bi, :, n:] == 0).all() and (got[2][bi, :, n:] == 0).all()
            if n == 0:
                assert (got[0][bi] == 0).all()


# C14: a page pool that holds NaN rows (a model's positions past its table)
# in slots that a row does not see: JAX's page walk multiplies a visited
# page's every V row by its p, 0 for such a slot, so the NaN reaches the
# output (0 * NaN); a page the walk does not visit adds nothing.
# (chunk, window): the decode tile, a bf16 extend wave of 40 rows, a window
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk, window", [(1, None), (40, None), (1, 20)])
def test_paged_kernel_nan_in_masked_slots(dev, dtype, chunk, window):
    g = torch.Generator(device=dev).manual_seed(3)
    b, hq, hkv, d, page, pps = 4, 4, 2, 64, 16, 6
    n_pages = b * pps + 1
    kp, vp = (_randn(g, hkv, n_pages, page, d, dtype=dtype, dev=dev)
              for _ in range(2))
    table = torch.arange(b * pps, device=dev).reshape(b, pps).int()
    lens = torch.tensor([50, 64, 80, 50], device=dev)
    # row 0: NaN past its length on its last page (visited, masked); row 1:
    # NaN on a page past its walk; row 2: NaN in a live slot; row 3 none
    for bi, pos in ((0, 55), (1, 70), (2, 60)):
        p, s = table[bi, pos // page], pos % page
        kp[:, p, s] = float("nan")
        vp[:, p, s] = float("nan")
    q = _randn(g, b, chunk, hq, d, dtype=dtype, dev=dev)
    out = pa.paged_attention(q, kp, vp, lens, table, window=window)
    ref = pa.paged_attention_plain(q, kp, vp, lens, table, window=window)
    assert torch.equal(out.isnan(), ref.isnan())
    assert ref[0].isnan().all() and ref[2].isnan().all()
    assert not ref[1].isnan().any() and not ref[3].isnan().any()
    assert _paged_err(out[1::2], ref[1::2]) <= TOL[dtype]


# C15: a wave wider than one row tile (bf16 q: 128 rows, f32 q: 64).  JAX's
# walk takes every row of the wave at each page it visits, so a non-finite V
# value in any visited page makes its column NaN for every row of the wave,
# a non-finite V scale every column; the kernels' row tiles read only their
# own hull of pages, and the marks (paged_nonfinite) and the poison pass
# give the rest.  NaN V rows sit before a late tile's window, inside the
# hulls, past an early tile's last key, past a length in its last page and
# on a page past the walk (which must add nothing); with a quantized pool
# NaN V scales in the last sequence.
C15_WAVES = {   # (chunk, hq, hkv): rows = hq / hkv * chunk a kv head
    "rows256": (256, 2, 2),
    "rows256_gqa4_chunk64": (64, 8, 2),
    "rows2048": (2048, 2, 2),
}


def c15_inputs(g, dev, dtype, pool, chunk, hq, hkv, d=128, page=128):
    """q, pools (with their scales) and a table for three sequences whose
    waves start at 0, at 300 and at 700, with non-finite V values placed as
    above; a page of each table past its walk holds one too."""
    b = 3
    lens = [chunk, chunk + 300, chunk + 700]
    pps = -(-max(lens) // page) + 1
    n_pages = b * pps + 1
    table = torch.randperm(n_pages, generator=g, device=dev)[:b * pps]
    table = table.reshape(b, pps).int()
    kv = [torch.randn(hkv, n_pages, page, d, generator=g, device=dev)
          for _ in range(2)]
    if pool == "native":
        kp, vp = (t.to(dtype) for t in kv)
        kw = {}
    else:
        payload = torch.int8 if pool == "int8" else torch.float8_e4m3fn
        kq, vq = (_quantize(t, payload) for t in kv)
        kp, vp = kq.values, vq.values
        kw = dict(k_scales=kq.scales, v_scales=vq.scales)

    def at(bi, pos):
        return table[bi, pos // page], pos % page

    for bi, n in enumerate(lens):
        # column c marks where: 1 the first page, 2 the wave's middle, 3
        # its last key, 4 past the length in the last page, 5 a page past
        # the walk (not visited: no NaN)
        for col, pos in ((1, 3), (2, n - chunk // 2), (3, n - 1),
                         (4, -(-n // page) * page - 1),
                         (5, -(-n // page) * page + 5)):
            if pool != "int8" and pos // page < pps:
                p, s = at(bi, pos)
                vp[:, p, s, (col + 8 * bi) % d] = float("nan")
    if pool != "native":
        for pos in (10, lens[2] - 3):
            p, s = at(2, pos)
            kw["v_scales"][:, p, s] = float("nan")
    q = _randn(g, b, chunk, hq, d, dtype=dtype, dev=dev)
    return q, kp, vp, torch.tensor(lens, device=dev), table, kw


def _c15_check(out, ref, dtype):
    """The NaN pattern equal, the finite elements under the paged gates."""
    assert torch.equal(out.isnan(), ref.isnan())
    fin = ~ref.isnan()
    assert _paged_err(torch.where(fin, out, 0), torch.where(fin, ref, 0)) \
        <= TOL[dtype]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("wave", list(C15_WAVES))
def test_paged_kernel_c15_wide_wave(dev, wave, window, pool):
    g = torch.Generator(device=dev).manual_seed(15)
    chunk, hq, hkv = C15_WAVES[wave]
    q, kp, vp, lens, table, kw = c15_inputs(g, dev, torch.bfloat16, pool,
                                            chunk, hq, hkv)
    out = pa.paged_attention(q, kp, vp, lens, table, window=window, **kw)
    ref = pa.paged_attention_plain(q, kp, vp, lens, table, window=window, **kw)
    _c15_check(out, ref, torch.bfloat16)
    # every sequence's visited NaN columns reach every row of its wave
    if pool != "int8":
        assert ref[0, :, :, 1:5].isnan().all()
        assert not ref[0, :, :, 5].isnan().any()
    if pool != "native":
        assert ref[2].isnan().all()


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("window", [None, 256])
def test_paged_kernel_c15_f32_q(dev, window, pool):
    """f32 q at 256 rows: two of the f32 extend tile's 128-row tiles."""
    g = torch.Generator(device=dev).manual_seed(16)
    q, kp, vp, lens, table, kw = c15_inputs(g, dev, torch.float32, pool,
                                            256, 2, 2)
    out = pa.paged_attention(q, kp, vp, lens, table, window=window, **kw)
    ref = pa.paged_attention_plain(q, kp, vp, lens, table, window=window, **kw)
    _c15_check(out, ref, torch.float32)


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("window", [None, 256])
def test_paged_nonfinite_kernel(dev, window, pool):
    """The marks kernel against its plain version, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(17)
    dtype = torch.bfloat16
    for d in (32, 64, 128):
        q, kp, vp, lens, table, kw = c15_inputs(g, dev, dtype, pool, 256, 2,
                                                2, d=d, page=16)
        vs = kw.get("v_scales")
        got = pa.paged_nonfinite(vp, lens, table, 256, v_scales=vs,
                                 window=window)
        want = pa.paged_nonfinite_plain(vp, lens, table, 256, v_scales=vs,
                                        window=window)
        assert torch.equal(got, want)
        assert bool(want.any())


# the head dims other than 32, 64 and 128 that the forward and inference
# kernels take (multiples of 8 up to 128), and those of bf16 q's 256-column
# tiles (136 to 256: the marks at five to eight words of columns)
HEAD_DIMS_NEW = [16, 24, 48, 80, 96, 112, 120]
HEAD_DIMS_WIDE = [136, 160, 256]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("d", HEAD_DIMS_NEW + HEAD_DIMS_WIDE)
def test_paged_marks_poison_head_dims(dev, d, pool):
    """C18 on the card: the marks kernel bit for bit against its plain
    version at cdiv(d, 32) + 1 words, and a 256-row bf16 wave (two extend
    tiles, the poison pass) with a NaN in V's column d - 1 at sequence 1's
    last key, which only the second row tile's pages hold: the first
    tile's rows get it from the marks' bit d - 1, not from the scale word
    after it."""
    g = torch.Generator(device=dev).manual_seed(23)
    q, kp, vp, lens, table, kw = c15_inputs(g, dev, torch.bfloat16, pool,
                                            256, 2, 2, d=d, page=16)
    last = int(lens[1]) - 1
    if pool != "int8":
        vp[:, table[1, last // 16], last % 16, d - 1] = float("nan")
    vs = kw.get("v_scales")
    got = pa.paged_nonfinite(vp, lens, table, 256, v_scales=vs)
    want = pa.paged_nonfinite_plain(vp, lens, table, 256, v_scales=vs)
    assert got.shape == (3, 2, table.shape[1], -(-d // 32) + 1)
    assert torch.equal(got, want)
    out = pa.paged_attention(q, kp, vp, lens, table, **kw)
    ref = pa.paged_attention_plain(q, kp, vp, lens, table, **kw)
    _c15_check(out, ref, torch.bfloat16)
    if pool != "int8":
        word = int(want[1, 0, last // 16, (d - 1) // 32])
        assert (word >> ((d - 1) % 32)) & 1
        assert ref[1, :, :, d - 1].isnan().all()


# -- parallelism (A7): the ring's pairs, a one-rank NCCL group -----------------
# (B, H, N, d, causal): the ring's pair shapes below the kernels' 1024 keys
GRID_BWD_CASES = {"n16": (2, 4, 16, 64, True), "n100": (1, 2, 100, 128, False),
                  "n512": (2, 4, 512, 128, True), "n512nc": (1, 4, 512, 64, False),
                  "n70x300": (1, 2, 70, 32, False),
                  # head dims other than 32, 64 and 128
                  "n16_d16": (2, 4, 16, 16, True), "n100_d24": (1, 2, 100, 24, False),
                  "n512nc_d48": (1, 4, 512, 48, False), "n512_d80": (2, 4, 512, 80, True),
                  "n512_d96": (2, 4, 512, 96, True), "n100_d112": (1, 2, 100, 112, True),
                  "n70x300_d120": (1, 2, 70, 120, False)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(GRID_BWD_CASES))
def test_flash_bwd_grid_mode_at_op_graph_shapes(dev, dtype, case):
    """flash_bwd(grid=True), the function of the ring's backward pairs (the
    TPU grid backward's, JAX's ``_flash_bwd``) where the dispatcher would
    take the op graph: against fa._reference_bwd within TOL, the same bits
    every run."""
    b, h, n, d, causal = GRID_BWD_CASES[case]
    n_kv = 300 if case.startswith("n70x300") else n
    g = torch.Generator(device=dev).manual_seed(9)
    q, do = (_randn(g, b, h, n, d, dtype=dtype, dev=dev) for _ in range(2))
    k, v = (_randn(g, b, h, n_kv, d, dtype=dtype, dev=dev) for _ in range(2))
    sc = d ** -0.5
    assert fa._schedule(q, k, causal, None).name == "op_graph"
    o, lse = fa.flash_fwd_plain(q, k, v, causal, sc)
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    got = fa.flash_bwd(q, k, v, lse, di, do, causal=causal, sm_scale=sc,
                       grid=True)
    want = fa._reference_bwd(q, k, v, lse, di, do, causal, sc)
    for a, w in zip(got, want):
        assert a.shape == w.shape and torch.isfinite(a).all()
        assert _rel_err(a, w) <= TOL[dtype]
    again = fa.flash_bwd(q, k, v, lse, di, do, causal=causal, sm_scale=sc,
                         grid=True)
    for a, w in zip(got, again):
        assert torch.equal(a, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_in_process_of_4(dev, dtype, causal):
    """The ring's per-step functions for 4 ranks in one process (64-key
    shards: op-graph forward pairs, grid backward pairs, the merge) against
    the unsharded flash forward and backward at 256 keys."""
    from flashattn_tpu_torch.parallel.sharded_attention import (
        _ring_in_process)

    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, do = (_randn(g, 2, 4, 256, 64, dtype=dtype, dev=dev)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o_ref, lse_ref = fa.flash_attention_with_lse(*leaves, causal)
    o_ref.backward(do)
    with torch.no_grad():
        o, lse, *grads = _ring_in_process(q, k, v, do, causal, 4)
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(lse, lse_ref) <= 1e-4
    for a, leaf in zip(grads, leaves):
        assert a.dtype == dtype and _rel_err(a, leaf.grad) <= TOL[dtype]


def test_parallel_one_rank_nccl(dev, tmp_path):
    """A one-rank NCCL group: the TP model's forward, ShardedTrainer (plain
    and ZeRO) and ring_flash_attention over one-rank axes equal the
    unsharded port's on the card (f32)."""
    import torch.distributed as dist

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.parallel import (apply_mesh, create_mesh,
                                              init_distributed,
                                              ring_flash_attention,
                                              shard_model)
    from flashattn_tpu_torch.training import ShardedTrainer

    init_distributed(0, 1, f"file://{tmp_path}/store", device="cuda")
    try:
        cfg = dict(n_vocab=64, n_embd=128, n_head=4, n_positions=64,
                   n_layer=2, p_dropout=0.1)
        build = lambda: pt.DecoderLM(
            **cfg, generator=torch.Generator().manual_seed(0), device=dev)
        mesh = create_mesh((1, 1), ("data", "model"))
        model = build().eval()
        tok = torch.randint(0, 64, (4, 33), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
        sharded = shard_model(apply_mesh(model, mesh), mesh)
        with torch.no_grad():
            assert _err(sharded(tok), model(tok)) <= 1e-5
        ref = build().train()
        opt = pt.Adam(lr=1e-3)
        state = opt.init(ref)
        step = pt.make_train_step(opt, grad_clip=1.0)
        gens = [torch.Generator().manual_seed(2) for _ in range(3)]
        trainers = [ShardedTrainer(build().train(), pt.Adam(lr=1e-3), mesh,
                                   zero=z, grad_clip=1.0) for z in (False, True)]
        for _ in range(2):
            ref, state, want = step(ref, state, tok[:, :-1], tok[:, 1:], None,
                                    gens[0])
            for t, gen in zip(trainers, gens[1:]):
                got = t.step(tok[:, :-1], tok[:, 1:], None, gen)
                assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
        for t in trainers:
            for (n, a), (_, b) in zip(t.model.named_parameters(),
                                      ref.named_parameters()):
                assert _err(a, b) <= 1e-5, n
        seq = create_mesh((1,), ("seq",))
        g = torch.Generator(device=dev).manual_seed(3)
        q, k, v = (_randn(g, 2, 4, 128, 64, dtype=torch.float32, dev=dev)
                   for _ in range(3))
        got = ring_flash_attention(q, k, v, True, mesh=seq)
        assert _err(got, fa.flash_attention(q, k, v, True)) <= 1e-5
    finally:
        dist.destroy_process_group()


# one rank of a world of two, both on cuda:0: argv rank, store, backend, op
_TWO_RANKS = r"""
import sys, datetime, torch, torch.distributed as dist
rank, store, backend, what = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.cuda.set_device(0)
dist.init_process_group(backend, init_method="file://" + store, rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=30))
x = torch.full((4,), float(rank + 1), device="cuda:0")
try:
    if what == "all_reduce":
        dist.all_reduce(x)
    elif what == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        x = torch.cat(parts)
    elif rank == 0:
        dist.send(x, 1)
    else:
        dist.recv(x, 0)
    torch.cuda.synchronize()
    print("RESULT ok", x.tolist(), flush=True)
except Exception as e:
    print("RESULT error", type(e).__name__, str(e).splitlines()[0][:200],
          flush=True)
dist.destroy_process_group()
"""


def _two_ranks(tmp_path, backend: str, what: str,
               deadline: float = 60.0) -> str:
    """Rank 0's outcome of ``what`` between two ``backend`` ranks on cuda:0
    (``ok ...``, the error, or a hang killed at the deadline)."""
    import subprocess
    import sys
    import time

    store = str(tmp_path / f"{backend}-{what}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_RANKS, str(r), store, backend, what],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    end = time.monotonic() + deadline
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, end - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        return f"no result within {deadline:.0f} s"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT")]
    if lines:
        return lines[-1][len("RESULT "):]
    tail = [ln for ln in outs[0].splitlines() if ln.strip()][-1:]
    return f"exit {procs[0].returncode}: {tail[0][:200] if tail else ''}"


def test_two_ranks_on_one_card(dev, tmp_path):
    """Why every card run of the parallel package has one rank: on a
    machine with one card, NCCL refuses two ranks on one device, and gloo
    carries CUDA tensors for all_reduce / all_gather but not for send /
    recv, which the ring and the pipeline need.  Each outcome is printed
    (``-s``)."""
    got = {(b, w): _two_ranks(tmp_path, b, w)
           for b, w in (("nccl", "all_reduce"), ("gloo", "all_reduce"),
                        ("gloo", "all_gather"), ("gloo", "send_recv"))}
    for (b, w), res in got.items():
        print(f"two {b} ranks on cuda:0, {w} of a CUDA tensor: {res}")
    assert got[("gloo", "all_reduce")] == "ok [3.0, 3.0, 3.0, 3.0]"
    assert got[("gloo", "all_gather")].startswith("ok [1.0, 1.0, 1.0, 1.0, "
                                                  "2.0")
    assert not got[("nccl", "all_reduce")].startswith("ok")
    assert not got[("gloo", "send_recv")].startswith("ok")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [0, 3, 4096, 12288])
def test_dropout_kernel_at_offset(dev, dtype, offset):
    """A rank's block of a batch split: dropout at an element offset takes
    the whole tensor's mask there (the padded kernel launch), bit for bit
    with the plain version and with a slice of the whole dropout."""
    g = torch.Generator(device=dev).manual_seed(6)
    whole = _randn(g, 4, 4096 + offset // 4096 * 4096 + 8, dtype=dtype,
                   dev=dev).reshape(-1)
    x = whole[offset:offset + 4096 * 2].reshape(2, 4096)
    got = dr.dropout(x, 0.1, 2**40 + 7, offset=offset)
    assert torch.equal(got, dr.dropout_reference(x, 0.1, 2**40 + 7,
                                                 offset=offset))
    full = dr.dropout(whole, 0.1, 2**40 + 7)
    assert torch.equal(got.reshape(-1), full[offset:offset + x.numel()])


# f32 on the tensor cores in split precision, on the route fa.f32_route
# names: the wgmma kernels (fa._f32_kernel, fa._f32_bwd_kernel) from
# fa.F32_TC_MIN_KV keys, the warp-level ones (fa._f32_mma_kernel,
# fa._f32_mma_bwd_kernel) below; against the plain versions, at each
# schedule's shapes and on both sides of the dispatcher's thresholds: the
# op graph at the MT model's 40 keys and at 255 / 256 keys, subrow at 1024,
# the loop at 2048, the grid with a window, GQA 16q/4kv, varlen with a
# length-0 row, d 32 and 64, cross 1000 x 2048 and ragged lengths.  (b, h,
# h_kv, n_q, n_kv, d, causal, lengths, window)
F32_CASES = {
    "op_graph_mt_40x40_d32": (16, 8, 8, 40, 40, 32, True, None, None),
    "op_graph_n255_d64": (2, 4, 4, 255, 255, 64, True, None, None),
    "op_graph_n256_d64": (2, 4, 4, 256, 256, 64, True, None, None),
    "op_graph_17x1000_d128": (2, 4, 2, 17, 1000, 128, False, None, None),
    "subrow_n1024_d128": (1, 4, 4, 1024, 1024, 128, True, None, None),
    "loop_n2048_d128": (2, 4, 4, 2048, 2048, 128, True, None, None),
    "noncausal_n1024_d64": (2, 4, 2, 1024, 1024, 64, False, None, None),
    "grid_window256_n2048_d128": (1, 4, 4, 2048, 2048, 128, True, None, 256),
    "gqa16_4_n2048_d128": (1, 16, 4, 2048, 2048, 128, True, None, None),
    "varlen_len0_n1024_d128": (3, 2, 2, 1024, 1024, 128, True,
                               [1024, 0, 515], None),
    "d32_n1536_causal": (1, 4, 4, 1536, 1536, 32, True, None, None),
    "d64_n2048_noncausal": (1, 4, 4, 2048, 2048, 64, False, None, None),
    "cross_1000x2048_d128": (1, 4, 4, 1000, 2048, 128, False, None, None),
    "ragged_70x3001_varlen_d64": (2, 4, 2, 70, 3001, 64, False, [3001, 1111],
                                  None),
    "ragged_causal_n1001_d128": (1, 2, 2, 1001, 1001, 128, True, None, None),
    # head dims other than 32, 64 and 128, zero-padded to the tile's width
    "d16_n1536_causal": (1, 4, 4, 1536, 1536, 16, True, None, None),
    "ragged_70x3001_varlen_d24": (2, 4, 2, 70, 3001, 24, False, [3001, 1111],
                                  None),
    "grid_window256_n2048_d48": (1, 4, 4, 2048, 2048, 48, True, None, 256),
    "varlen_len0_n1024_d80": (3, 2, 2, 1024, 1024, 80, True, [1024, 0, 515],
                              None),
    "subrow_pad_n1024_d96": (1, 4, 4, 1024, 1024, 96, True, None, None),
    "noncausal_gqa_n1024_d96": (2, 4, 2, 1024, 1024, 96, False, None, None),
    "ragged_causal_n1001_d112": (1, 2, 2, 1001, 1001, 112, True, None, None),
    "cross_1000x2048_d120": (1, 4, 4, 1000, 2048, 120, False, None, None),
}
# f32-grade: the split keeps 24 bits of each operand and drops products
# below 2^-23 of their terms; the CUDA-core kernels read ~2e-6 at these
# shapes (o and lse absolute, gradients over max(1, max |ref|))
F32_GRADE = 1e-5


def _f32_inputs(case, dev, magnitude=1.0):
    """Unit-normal inputs; at ``magnitude`` m, q, v and dO scaled by m and k
    by 1 / m: operands far from 1 on both sides whose scores stay those of
    unit inputs (scores of m^2 would make the softmax one-hot, where a
    near-tie turns any score rounding into an error of the output's size)."""
    b, h, h_kv, n_q, n_kv, d, causal, lengths, window = F32_CASES[case]
    g = torch.Generator(device=dev).manual_seed(12)
    q, do = (torch.randn(b, h, n_q, d, generator=g, device=dev) * magnitude
             for _ in range(2))
    k, v = (torch.randn(b, h_kv, n_kv, d, generator=g, device=dev)
            for _ in range(2))
    k, v = k / magnitude, v * magnitude
    lens = None if lengths is None else torch.tensor(lengths, device=dev)
    return q, k, v, do, lens, causal, window


def _f32_counts():
    return [c.launches for c in (fa._kernel, fa._bwd_kernel, fa._f32_kernel,
                                 fa._f32_bwd_kernel, fa._f32_mma_kernel,
                                 fa._f32_mma_bwd_kernel)]


def _f32_route_delta(n_kv):
    """The counts one forward and one backward add on fa.f32_route's route
    (the order of _f32_counts)."""
    return [0, 0, 1, 1, 0, 0] if fa.f32_route(n_kv) == "wgmma" else \
        [0, 0, 0, 0, 1, 1]


@pytest.mark.parametrize("magnitude", [1.0, 1e3])
@pytest.mark.parametrize("case", list(F32_CASES))
def test_flash_f32_split_kernels(dev, case, magnitude):
    """Forward and backward against flash_fwd_plain / flash_bwd_plain at
    F32_GRADE (o relative to max |ref| at magnitude 1e3: see _f32_inputs),
    the launch on the route fa.f32_route names: the wgmma kernels from
    F32_TC_MIN_KV keys, the warp-level ones below; the backward twice bit
    for bit."""
    q, k, v, do, lens, causal, window = _f32_inputs(case, dev, magnitude)
    n_kv, sc = k.shape[2], q.shape[-1] ** -0.5
    kw = dict(causal=causal, sm_scale=sc, kv_lengths=lens, window=window)
    counts = _f32_counts()
    o, lse = fa.flash_fwd(q, k, v, **kw)
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    got = fa.flash_bwd(q, k, v, lse, di, do, **kw)
    assert [a - b for a, b in zip(_f32_counts(), counts)] == \
        _f32_route_delta(n_kv)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, sc, lens, window)
    fin = lse_ref.isfinite()
    assert torch.equal(lse.isfinite(), fin)
    assert _err(o, o_ref) <= F32_GRADE * magnitude
    assert _err(lse[fin], lse_ref[fin]) <= F32_GRADE
    want = fa.flash_bwd_plain(q, k, v, lse, di, do, causal, sc, lens, window)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel_err(a, b) <= F32_GRADE
    for a, b in zip(got, fa.flash_bwd(q, k, v, lse, di, do, **kw)):
        assert torch.equal(a, b)


# the warp-level kernels' shapes: keys 1 to the threshold (one 16-key
# chunk, partial chunks, one and two 64-key tiles), rows 1 to 255 (one to
# four warps, several row blocks), every head dim, GQA, a window, varlen
# with a length-0 row, cross attention, causal and not.  (b, h, h_kv, n_q,
# n_kv, d, causal, lengths, window)
F32_MMA_CASES = {
    "q1_kv1_d32": (4, 2, 2, 1, 1, 32, False, None, None),
    "q16_kv17_causal_d64": (2, 4, 4, 16, 17, 64, True, None, None),
    "q17_kv40_gqa4_2_d128": (2, 4, 2, 17, 40, 128, False, None, None),
    "mt_decoder_40x40_causal_d32": (8, 8, 8, 40, 40, 32, True, None, None),
    "mt_encoder_40x40_varlen_len0_d32": (4, 8, 8, 40, 40, 32, False,
                                         [40, 0, 1, 23], None),
    "mt_cross_31x40_d32": (4, 8, 8, 31, 40, 32, False, None, None),
    "q65_kv63_d64": (2, 4, 4, 65, 63, 64, False, None, None),
    "q40_kv64_gqa8_2_d32": (2, 8, 2, 40, 64, 32, False, None, None),
    "q65_kv65_causal_d128": (2, 2, 2, 65, 65, 128, True, None, None),
    "distill_128x128_causal_d64": (4, 2, 2, 128, 128, 64, True, None, None),
    "q128_kv128_window6_d64": (2, 4, 4, 128, 128, 64, True, None, 6),
    "q1_kv255_d128": (4, 4, 4, 1, 255, 128, False, None, None),
    "q255_kv255_causal_varlen_d32": (3, 2, 2, 255, 255, 32, True,
                                     [255, 0, 100], None),
    "q40_below_threshold_d64": (2, 4, 4, 40, fa.F32_TC_MIN_KV - 1, 64, False,
                                None, None),
    # head dims other than 32, 64 and 128, zero-padded to the tile's width
    "q1_kv1_d16": (4, 2, 2, 1, 1, 16, False, None, None),
    "q17_kv40_gqa4_2_d24": (2, 4, 2, 17, 40, 24, False, None, None),
    "q65_kv63_d48": (2, 4, 4, 65, 63, 48, False, None, None),
    "mt_encoder_40x40_varlen_len0_d80": (4, 8, 8, 40, 40, 80, False,
                                         [40, 0, 1, 23], None),
    "q128_kv128_window6_d96": (2, 4, 4, 128, 128, 96, True, None, 6),
    "q200_kv200_causal_varlen_d96": (3, 2, 2, 200, 200, 96, True,
                                     [200, 0, 100], None),
    "q65_kv65_causal_d112": (2, 2, 2, 65, 65, 112, True, None, None),
    "q1_kv255_d120": (4, 4, 4, 1, 255, 120, False, None, None),
}


def _f64_attention(q, k, v, do, causal, scale, lens=None, window=None):
    """(o, lse, dq, dk, dv) in float64 of the function every f32 route
    computes (GQA, masks, a row with no live key: o = 0, lse = -inf and no
    gradient), dq, dk, dv by the explicit formulas from the float64 lse."""
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    kr, vr = (t.double() for t in fa.repeat_kv(k, v, h))
    qd, dod = q.double(), do.double()
    s = qd @ kr.transpose(-1, -2) * scale
    keep = fa._keep_mask(n_q, n_kv, causal, window, lens, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, -math.inf)
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.where(lse.isfinite(), torch.exp(s - lse), torch.zeros_like(s))
    o = p @ vr
    di = (o * dod).sum(-1, keepdim=True)
    ds = p * (dod @ vr.transpose(-1, -2) - di) * scale
    dq = ds @ kr
    dk, dv = ds.transpose(-1, -2) @ qd, p.transpose(-1, -2) @ dod
    if h != h_kv:
        dk = dk.reshape(b, h_kv, h // h_kv, n_kv, d).sum(2)
        dv = dv.reshape(b, h_kv, h // h_kv, n_kv, d).sum(2)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("case", list(F32_MMA_CASES))
def test_flash_f32_mma_kernels(dev, case):
    """The warp-level kernels (every f32 call below F32_TC_MIN_KV keys):
    one launch each of fa._f32_mma_kernel and fa._f32_mma_bwd_kernel and
    none of another flash kernel; o, lse and the gradients within TOL of
    the plain versions and within F32_GRADE of float64 (o and lse absolute,
    gradients over max(1, max |ref|), the backward given its own forward's
    lse and di); the backward twice bit for bit; keys past a length get no
    gradient."""
    b, h, h_kv, n_q, n_kv, d, causal, lengths, window = F32_MMA_CASES[case]
    assert fa.f32_route(n_kv) == "mma"
    g = torch.Generator(device=dev).manual_seed(21)
    q, do = (torch.randn(b, h, n_q, d, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(b, h_kv, n_kv, d, generator=g, device=dev) for _ in range(2))
    lens = None if lengths is None else torch.tensor(lengths, device=dev)
    sc = d ** -0.5
    kw = dict(causal=causal, sm_scale=sc, kv_lengths=lens, window=window)
    counts = _f32_counts()
    o, lse = fa.flash_fwd(q, k, v, **kw)
    di = (o * do).sum(-1, keepdim=True)
    got = fa.flash_bwd(q, k, v, lse, di, do, **kw)
    assert [a - c for a, c in zip(_f32_counts(), counts)] == [0, 0, 0, 0, 1, 1]
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, sc, lens, window)
    fin = lse_ref.isfinite()
    assert torch.equal(lse.isfinite(), fin)
    assert _err(o, o_ref) <= TOL[torch.float32]
    assert _err(lse[fin], lse_ref[fin]) <= TOL[torch.float32]
    want = fa.flash_bwd_plain(q, k, v, lse, di, do, causal, sc, lens, window)
    for a, c in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel_err(a, c) <= TOL[torch.float32]
    exact = _f64_attention(q, k, v, do, causal, sc, lens, window)
    assert _err(o, exact[0]) <= F32_GRADE
    assert _err(lse[fin], exact[1][fin]) <= F32_GRADE
    for a, c in zip(got, exact[2:]):
        assert _rel_err(a, c) <= F32_GRADE
    for a, c in zip(got, fa.flash_bwd(q, k, v, lse, di, do, **kw)):
        assert torch.equal(a, c)
    if lens is not None:
        for bi, n in enumerate(lens.tolist()):
            assert (got[1][bi, :, n:] == 0).all() and (got[2][bi, :, n:] == 0).all()
            if n == 0:
                assert (o[bi] == 0).all() and (got[0][bi] == 0).all()


def _same_class_close(a, b, scale, what):
    """NaN, +inf and -inf at the same places, the finite elements within
    F32_GRADE * scale."""
    for pick in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(pick(a), pick(b)), (what, pick.__name__)
    fin = b.isfinite()
    if bool(fin.any()):
        assert _err(a[fin], b[fin]) <= F32_GRADE * scale, what


@pytest.mark.parametrize("value", [float("inf"), float("-inf")])
@pytest.mark.parametrize("where", ["q", "k", "v", "do"])
@pytest.mark.parametrize("case", ["noncausal_n1024_d64", "cross_1000x2048_d128",
                                  "noncausal_gqa_n1024_d96"])
def test_flash_f32_split_inf_forward_backward(dev, case, where, value):
    """The f32 split flash forward and backward (from F32_TC_MIN_KV keys)
    with a +-inf in q, K, V or dO (element [0, 0, 5, 3]) against the
    warp-level kernels (forced by moving the threshold past n_kv) and
    against the plain versions: the NaN and inf positions of o, lse, dq,
    dk and dv equal, the finite elements within F32_GRADE (gradients over
    max(1, max |ref|)).  A piece's 0 * inf gives NaN where f32 gives +-inf
    (C17): a +-inf input takes the warp-level kernels behind the wgmma
    ones, so the wgmma route's results equal the forced route's bit for
    bit (the same kernels compute both; with dO's +-inf the backward's,
    given the same lse and di).  Not causal: every query tile
    meets every key tile, so the tiled walk and the plain versions' dense
    products make their 0 * inf at the same places (a causal walk skips
    tiles that the dense product multiplies by p = 0).  dv is held to the
    plain version only where every lse is finite: the plain version zeroes
    p on a row whose lse is not finite, where the kernels (as JAX's
    backward kernels, p = exp2(s - lse)) give NaN (ROADMAP §C).  The
    backward takes the forward's lse and di, as the autograd Function
    does."""
    q, k, v, do, lens, causal, window = _f32_inputs(case, dev)
    {"q": q, "k": k, "v": v, "do": do}[where][0, 0, 5, 3] = value
    sc = q.shape[-1] ** -0.5
    kw = dict(causal=causal, sm_scale=sc, kv_lengths=lens, window=window)

    def run(lse=None, di=None):
        """The forward, then the backward given (lse, di), by default the
        forward's."""
        o, lse_ = fa.flash_fwd(q, k, v, **kw)
        if lse is None:
            lse, di = lse_, (o.float() * do.float()).sum(-1, keepdim=True)
        return (o, lse_, *fa.flash_bwd(q, k, v, lse, di, do, **kw)), lse, di

    counts = _f32_counts()
    got, lse, di = run()
    assert [a - b for a, b in zip(_f32_counts(), counts)] == [0, 0, 1, 1, 0, 0]
    keep = fa.F32_TC_MIN_KV
    fa.F32_TC_MIN_KV = 1 << 30   # the warp-level route on the same inputs
    try:
        counts = _f32_counts()
        mma, _, _ = run(lse, di)
        assert [a - b for a, b in zip(_f32_counts(), counts)] == \
            [0, 0, 0, 0, 1, 1]
    finally:
        fa.F32_TC_MIN_KV = keep
    plain = (*fa.flash_fwd_plain(q, k, v, causal, sc, lens, window),
             *fa.flash_bwd_plain(q, k, v, lse, di, do, causal, sc, lens, window))
    # a +-inf in dO reaches the backward alone: the forward stays wgmma's
    same = ("dq", "dk", "dv") if where == "do" else ("o", "lse", "dq", "dk", "dv")
    for name, a, c, b in zip(("o", "lse", "dq", "dk", "dv"), got, mma, plain):
        if name in same:
            assert torch.equal(a.view(torch.int32), c.view(torch.int32)), \
                f"{name}: the wgmma route's +-inf call is not the warp-level kernels'"
        fin = b[b.isfinite()]
        scale = 1.0 if name in ("o", "lse") or fin.numel() == 0 else max(
            1.0, float(fin.abs().max()))
        if name != "dv" or bool(lse.isfinite().all()):
            _same_class_close(a, b, scale, f"{name} against the plain version")


@pytest.mark.parametrize("value", [float("inf"), float("-inf"), float("nan")])
@pytest.mark.parametrize("where", ["q", "k", "v", "do"])
@pytest.mark.parametrize("case", ["mt_40x40_d32", "distill_128x128_d64"])
def test_flash_f32_mma_nonfinite(dev, case, where, value):
    """The warp-level kernels with a +-inf or a NaN in q, K, V or dO
    (element [0, 0, 5, 3]), not causal (every row's walk reads every key,
    as the op graph's dense products do): o's and lse's NaN and inf
    positions equal flash_fwd_plain's, the gradients' equal those of the
    TPU kernels' explicit formulas (fa._reference_bwd, which the kernels
    compute; below 1024 keys flash_bwd_plain is autograd of the op graph,
    equal to them to f32 rounding on finite inputs, whose inf - inf falls
    elsewhere), the finite elements within F32_GRADE; dv only where every
    lse is finite, as test_flash_f32_split_inf_forward_backward."""
    b, h, n, d = {"mt_40x40_d32": (2, 4, 40, 32),
                  "distill_128x128_d64": (2, 2, 128, 64)}[case]
    g = torch.Generator(device=dev).manual_seed(22)
    q, k, v, do = (torch.randn(b, h, n, d, generator=g, device=dev)
                   for _ in range(4))
    {"q": q, "k": k, "v": v, "do": do}[where][0, 0, 5, 3] = value
    sc = d ** -0.5
    counts = _f32_counts()
    o, lse = fa.flash_fwd(q, k, v, causal=False, sm_scale=sc)
    di = (o * do).sum(-1, keepdim=True)
    got = (o, lse, *fa.flash_bwd(q, k, v, lse, di, do, causal=False,
                                 sm_scale=sc))
    assert [a - c for a, c in zip(_f32_counts(), counts)] == [0, 0, 0, 0, 1, 1]
    want = (*fa.flash_fwd_plain(q, k, v, False, sc),
            *fa._reference_bwd(q, k, v, lse, di, do, False, sc))
    for name, a, c in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        fin = c[c.isfinite()]
        scale = 1.0 if name in ("o", "lse") or fin.numel() == 0 else max(
            1.0, float(fin.abs().max()))
        if name != "dv" or bool(lse.isfinite().all()):
            _same_class_close(a, c, scale, f"{name} against the plain version")
    assert not all(bool(t.isfinite().all()) for t in got)   # it reached them


@pytest.mark.parametrize("value", [float("inf"), float("nan")])
@pytest.mark.parametrize("where", ["k", "v"])
@pytest.mark.parametrize("case", ["loop_n2048_d128", "op_graph_mt_40x40_d32"])
def test_flash_f32_nonfinite_inputs(dev, case, where, value):
    """An inf or a NaN in K or V on a key every row's walk visits (key 5 of
    head 0, column 3): o's and lse's NaN and inf positions equal the plain
    version's, the finite elements within F32_GRADE.  An inf in K gives
    the rows that see it a score of +-inf (a NaN row, or the key dropped);
    in V, +inf where p > 0 and 0 * inf = NaN where p = 0; a NaN reaches
    every row whose walk reads the key.  The split keeps the inf in the hi
    piece and zeroes it before the lower pieces' products, so no 0 * inf
    appears that the f32 product would not make."""
    q, k, v, do, lens, causal, window = _f32_inputs(case, dev)
    (k if where == "k" else v)[0, 0, 5, 3] = value
    sc = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, sc)
    for got, want in ((o, o_ref), (lse, lse_ref)):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.isinf(), want.isinf())
        assert torch.equal(got[got.isinf()], want[want.isinf()])
        fin = want.isfinite()
        assert _err(got[fin], want[fin]) <= F32_GRADE
    assert bool(o_ref[0, 0].isnan().any() or o_ref[0, 0].isinf().any())
