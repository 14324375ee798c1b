"""Gradients of the port's ops against the JAX package's, and the port's
fused dropout.

On CPU tensors the port differentiates through its autograd Functions,
whose backward runs the plain versions that the CUDA kernels are held to
on the card (``layernorm_bwd_reference``; for flash attention, below 1024
keys autograd of the op graph, as JAX differentiates its op graph there,
and from 1024 keys the explicit formulas ``_reference_bwd``).  The JAX side runs its Pallas backward kernels in interpret mode: the
grid kernels (``_bwd_dkv_kernel``/``_bwd_dq_kernel``), the fused subrow
kernel and the split loop kernels.  Inputs and cotangents come from a numpy
seed.  Tolerance: float32, atol 1e-5 (the frameworks sum in different
orders).  Dropout masks cannot match the TPU's bits, so dropout is checked
by its own properties: the Philox4x32-10 known answers, seeding, keep
fraction, scaling and the backward's mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu_torch as pt
from flashattn_tpu.ops import flash_attention as jfa
from flashattn_tpu.ops import layernorm as jln
from flashattn_tpu_torch.ops import dropout as tdr
from flashattn_tpu_torch.ops import flash_attention as tfa
from flashattn_tpu_torch.ops import layernorm as tln

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _torch_grads(fn, arrays, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(cot))


# -- flash attention -----------------------------------------------------------


# (n_q, n_kv, h, h_kv, causal, window, lengths): the grid backward at 16 x 16
# blocks; lengths select flash_attention_varlen
GRID_CASES = {
    "causal": (64, 64, 2, 2, True, None, None),
    "noncausal_cross": (48, 64, 2, 2, False, None, None),
    "window": (64, 64, 2, 2, True, 12, None),
    "gqa": (64, 64, 4, 2, True, None, None),
    "varlen_len0": (64, 64, 2, 1, True, None, [64, 0]),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_flash_grad_grid_parity(case):
    n_q, n_kv, h, h_kv, causal, window, lengths = GRID_CASES[case]
    rng = np.random.default_rng(0)
    q = _normal(rng, 2, h, n_q, 32)
    k, v = (_normal(rng, 2, h_kv, n_kv, 32) for _ in range(2))
    do = _normal(rng, 2, h, n_q, 32)
    kw = dict(impl="pallas", block_q=16, block_k=16, window=window)
    if lengths is None:
        jf = lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, causal, **kw)
        tf = lambda q_, k_, v_: pt.flash_attention(q_, k_, v_, causal,
                                                   window=window)
    else:
        lens = np.asarray(lengths, np.int32)
        jf = lambda q_, k_, v_: jfa.flash_attention_varlen(
            q_, k_, v_, jnp.asarray(lens), causal, **kw)
        tf = lambda q_, k_, v_: pt.flash_attention_varlen(
            q_, k_, v_, torch.from_numpy(lens), causal, window=window)
    o_j, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    o_t, got = _torch_grads(tf, (q, k, v), do)
    _close(o_t.detach(), o_j)
    for g, w in zip(got, want):
        _close(g, w)
    if lengths is not None:
        # keys past a row's length, and every key of a len-0 row, get no
        # gradient; the len-0 row's queries neither
        assert (got[1][1] == 0).all() and (got[2][1] == 0).all()
        assert (got[0][1] == 0).all()


def _jax_residuals(q, k, v, do, scale):
    o, lse = jfa._reference_fwd_with_lse(*map(jnp.asarray, (q, k, v)), True,
                                         scale)
    di = jnp.sum(o * jnp.asarray(do), axis=-1, keepdims=True)
    return lse, di


@pytest.mark.parametrize("schedule", ["subrow", "loop"])
def test_flash_grad_dense_causal_kernels_parity(schedule):
    """The TPU training schedules' backward kernels (fused subrow, sub 64;
    split loop, block 64) at b1 h4 h_kv2 n128 d32 vs the port."""
    rng = np.random.default_rng(1)
    q, do = (_normal(rng, 1, 4, 128, 32) for _ in range(2))
    k, v = (_normal(rng, 1, 2, 128, 32) for _ in range(2))
    scale = 32 ** -0.5
    lse, di = _jax_residuals(q, k, v, do, scale)
    args = (*map(jnp.asarray, (q, k, v)), lse, di, jnp.asarray(do))
    if schedule == "subrow":
        want = jfa._flash_bwd_subrow(*args, sm_scale=scale, sub=64)
    else:
        want = jfa._flash_bwd_loop(*args, sm_scale=scale, block=64)
    _, got = _torch_grads(lambda *t: pt.flash_attention(*t, True), (q, k, v),
                          do)
    for g, w in zip(got, want):
        _close(g, w)


# (causal, n_q, n_kv, h_kv, lengths, window)
PLAIN_CASES = {
    "dense_causal_gqa": (True, 40, 40, 2, None, None),
    "cross_noncausal": (False, 24, 40, 4, None, None),
    "varlen_window_len0": (True, 40, 40, 2, [40, 0, 17], 7),
}


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_flash_plain_bwd_matches_autograd(case):
    """The explicit backward formula (the CUDA kernel's plain version) vs
    autograd of the plain forward."""
    causal, n_q, n_kv, h_kv, lengths, window = PLAIN_CASES[case]
    rng = np.random.default_rng(2)
    b = 3 if lengths else 2
    q, do = (_normal(rng, b, 4, n_q, 32) for _ in range(2))
    k, v = (_normal(rng, b, h_kv, n_kv, 32) for _ in range(2))
    lens = None if lengths is None else torch.tensor(lengths)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = tfa._reference_fwd_with_lse(*ts, causal, 0.2, lens, window)
    want = torch.autograd.grad(o, ts, torch.from_numpy(do))
    o, lse = o.detach(), lse.detach()
    di = (o * torch.from_numpy(do)).sum(-1, keepdim=True)
    got = tfa._reference_bwd(*map(torch.from_numpy, (q, k, v)), lse, di,
                             torch.from_numpy(do), causal, 0.2, lens, window)
    for g, w in zip(got, want):
        _close(g, w)


def test_flash_with_lse_refuses_lse_gradient():
    q = torch.randn(1, 2, 8, 32, requires_grad=True)
    o, lse = pt.flash_attention_with_lse(q, q, q, True)
    (gq,) = torch.autograd.grad(o.sum(), q)        # lse unused: fine
    assert torch.isfinite(gq).all()
    o, lse = pt.flash_attention_with_lse(q, q, q, True)
    with pytest.raises(NotImplementedError):
        (o.sum() + lse.sum()).backward()


# -- layernorm -----------------------------------------------------------------


@pytest.mark.parametrize("h", [32, 200])
def test_layernorm_grad_parity(h):
    """300 rows: a ragged last block for the JAX kernels' 256-row block."""
    rng = np.random.default_rng(3)
    x = _normal(rng, 3, 100, h) * 2 + 0.5
    g, b = _normal(rng, h), _normal(rng, h)
    dy = _normal(rng, 3, 100, h)
    y_j, vjp = jax.vjp(jln.layernorm, *map(jnp.asarray, (x, g, b)))
    want = vjp(jnp.asarray(dy))
    y_t, got = _torch_grads(pt.layernorm, (x, g, b), dy)
    _close(y_t.detach(), y_j)
    for gt, w in zip(got, want):
        _close(gt, w, atol=2e-5, rtol=1e-5)


def test_layernorm_bwd_reference_is_the_backward():
    """On CPU the autograd backward is the plain bwd formula, which the
    CUDA kernel is held to on the card; mean/rstd are the forward's."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_normal(rng, 7, 48))
    g, b = (torch.from_numpy(_normal(rng, 48)) for _ in range(2))
    dy = torch.from_numpy(_normal(rng, 7, 48))
    y, mean, rstd = tln._layernorm_fwd_reference(x, g, b, 1e-5)
    assert mean.shape == rstd.shape == (7, 1)
    want = tln.layernorm_bwd_reference(x, dy, mean, rstd, g)
    _, got = _torch_grads(pt.layernorm, (x.numpy(), g.numpy(), b.numpy()),
                          dy.numpy())
    for gt, w in zip(got, want):
        _close(gt, w, atol=0, rtol=0)


# -- dropout -------------------------------------------------------------------


@pytest.mark.parametrize("key, counter, want", [
    ((0, 0), (0, 0, 0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 4,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
])
def test_philox_known_answers(key, counter, want):
    got = tdr.philox4x32(torch.tensor([counter], dtype=torch.int64), key)
    assert tuple(got[0].tolist()) == want


def test_dropout_mask_seeding_and_rate():
    n, rate = 40001, 0.1
    m1 = tdr.keep_mask(n, rate, 2**63 + 12345)
    assert torch.equal(m1, tdr.keep_mask(n, rate, 2**63 + 12345))
    # both seed words count: a change in the high word changes the mask
    assert not torch.equal(m1, tdr.keep_mask(n, rate, 12345))
    assert not torch.equal(m1, tdr.keep_mask(n, rate, 2**63 + 12346))
    # bits depend on the element index only: a prefix keeps its mask
    assert torch.equal(tdr.keep_mask(1001, rate, 7), tdr.keep_mask(n, rate, 7)[:1001])
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(m1.float().mean()) - (1 - rate)) < 5 * sigma


def test_dropout_scaling_and_gradient_mask():
    x = torch.randn(37, 53, requires_grad=True)
    y = pt.fused_dropout(x, 0.25, 99)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=1e-6, atol=0)
    (gx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert torch.equal(gx != 0, kept)
    torch.testing.assert_close(gx[kept], torch.full_like(gx[kept], 1 / 0.75))
    unscaled = pt.F.dropout(x, 0.25, seed=99, scale=False)
    assert torch.equal(unscaled[kept], x[kept])


def test_dropout_identity_cases():
    x = torch.randn(8, 8)
    assert pt.fused_dropout(x, 0.0, 5) is x
    assert pt.fused_dropout(x, 0.3, None) is x
    assert pt.F.dropout(x, 0.3, seed=5, ignore=True) is x
    drop = pt.Dropout(0.3)
    assert drop.eval()(x, 5) is x
    assert drop.train()(x) is x
    with pytest.raises(ValueError):
        pt.fused_dropout(x, 1.0, 5)
