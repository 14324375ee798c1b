"""f32 flash attention over short walks (below ``F32_TC_MIN_KV`` keys)
through the port's public entry points against the JAX package's.

On the card these shapes take the warp-level split-precision kernels
(``fa_flash_fwd_f32_mma`` / ``fa_flash_bwd_f32_mma``); on CPU tensors the
port runs their plain versions, below 1024 keys JAX's op graph and its
autograd, which is what JAX computes there (``jax.vjp`` of its op graph).
The shapes are the MT model's (B2 H8 d32: the encoder's varlen 40 x 40
with lengths 1 and 0, the decoder's causal 40 x 40, the cross 31 x 40,
generation's n_q 1), the distill draft's 128 x 128 causal d64, GQA 8q/2kv,
a window of 6, 255 keys and d 128.  Inputs and cotangents are numpy draws
from a seed.  Tolerance: o, lse, dq, dk and dv within 1e-4 (f32, the two
frameworks summing in different orders).  With a +-inf or a NaN in q, K
or V the forward's NaN / inf positions equal JAX's.  The route each shape
takes on the card is a pure shape rule (``f32_route``), checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu_torch as pt
from flashattn_tpu.ops import flash_attention as jfa
from flashattn_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)

# (b, h, h_kv, n_q, n_kv, d, causal, lengths, window)
CASES = {
    "mt_encoder_40x40_varlen_len1_len0_d32": (2, 8, 8, 40, 40, 32, False,
                                              [1, 0], None),
    "mt_decoder_40x40_causal_d32": (2, 8, 8, 40, 40, 32, True, None, None),
    "mt_cross_31x40_d32": (2, 8, 8, 31, 40, 32, False, None, None),
    "mt_generate_1x40_varlen_d32": (2, 8, 8, 1, 40, 32, False, [40, 17],
                                    None),
    "distill_128x128_causal_d64": (2, 2, 2, 128, 128, 64, True, None, None),
    "gqa8_2_40x40_causal_d32": (2, 8, 2, 40, 40, 32, True, None, None),
    "window6_64x64_causal_d32": (2, 2, 2, 64, 64, 32, True, None, 6),
    "n_kv255_17x255_d64": (1, 2, 2, 17, 255, 64, False, None, None),
    "d128_40x40_causal": (1, 2, 2, 40, 40, 128, True, None, None),
}


def _inputs(case, seed=0):
    b, h, h_kv, n_q, n_kv, d, causal, lengths, window = CASES[case]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, h, n_q, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, h_kv, n_kv, d)).astype(np.float32)
            for _ in range(2))
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    return q, k, v, do, lens, causal, window


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_f32_short_walk_forward_backward_parity(case):
    """o (and lse, where JAX's API returns it) and the gradients of q, k
    and v through the port's public functions with autograd, against
    JAX's flash_attention (or its varlen twin) and jax.vjp."""
    q, k, v, do, lens, causal, window = _inputs(case)
    assert tfa.f32_route(k.shape[2]) == "mma"
    if lens is None:
        jf = lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, causal,
                                                    window=window)
    else:
        jl = jnp.asarray(lens)
        jf = lambda q_, k_, v_: jfa.flash_attention_varlen(
            q_, k_, v_, jl, causal, window=window)
    o_j, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if lens is None:
        o_t, lse_t = pt.flash_attention_with_lse(*ts, causal, window=window)
        _, lse_j = jfa.flash_attention_with_lse(*map(jnp.asarray, (q, k, v)),
                                                causal, window=window)
        _close(lse_t.detach(), lse_j)
        o_plain = pt.flash_attention(*ts, causal, window=window)
        assert torch.equal(o_plain, o_t)
    else:
        o_t = pt.flash_attention_varlen(*ts, torch.from_numpy(lens), causal,
                                        window=window)
    got = torch.autograd.grad(o_t, ts, torch.from_numpy(do))
    _close(o_t.detach(), o_j)
    for g, w in zip(got, want):
        _close(g, w)
    if lens is not None:
        for bi, n in enumerate(lens.tolist()):
            assert (got[1][bi, :, n:] == 0).all()
            assert (got[2][bi, :, n:] == 0).all()
            if n == 0:
                assert (o_t[bi] == 0).all() and (got[0][bi] == 0).all()


@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("where", ["q", "k", "v"])
@pytest.mark.parametrize("case", ["mt_decoder_40x40_causal_d32",
                                  "distill_128x128_causal_d64"])
def test_f32_short_walk_nonfinite_pattern(case, where, value):
    """A +-inf or a NaN at element [0, 0, 5, 3] of q, K or V: o's and lse's
    NaN / +inf / -inf positions equal JAX's, the finite elements within
    1e-4."""
    q, k, v, do, lens, causal, window = _inputs(case, seed=1)
    {"q": q, "k": k, "v": v}[where][0, 0, 5, 3] = value
    o_t, lse_t = pt.flash_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), causal, window=window)
    o_j, lse_j = jfa.flash_attention_with_lse(*map(jnp.asarray, (q, k, v)),
                                              causal, window=window)
    for got, want in ((o_t.numpy(), np.asarray(o_j)),
                      (lse_t.numpy(), np.asarray(lse_j))):
        for pick in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(pick(got), pick(want))
        fin = np.isfinite(want)
        _close(got[fin], want[fin])
    assert not np.isfinite(np.asarray(o_j)).all()   # the value reached o


def test_f32_route_is_a_shape_rule():
    """The f32 kernels a CUDA call launches depend on the number of keys
    alone: the warp-level kernels below F32_TC_MIN_KV, the wgmma ones from
    it on; moving the threshold moves the route."""
    for n_kv in [c[4] for c in CASES.values()] + [1, 17, 64, 65]:
        assert tfa.f32_route(n_kv) == "mma"
    assert tfa.f32_route(tfa.F32_TC_MIN_KV - 1) == "mma"
    for n_kv in (tfa.F32_TC_MIN_KV, 1024, 2048, 16384):
        assert tfa.f32_route(n_kv) == "wgmma"
    keep = tfa.F32_TC_MIN_KV
    try:
        tfa.F32_TC_MIN_KV = 1 << 30
        assert tfa.f32_route(2048) == "mma"
        tfa.F32_TC_MIN_KV = 0
        assert tfa.f32_route(1) == "wgmma"
    finally:
        tfa.F32_TC_MIN_KV = keep
