"""The port's fused attention softmax against the JAX package's, on the CPU.

The same numpy inputs go to the port's ``attn_softmax`` (a CPU tensor runs
the plain forward and the plain version of the backward kernel), to JAX
``attn_softmax_reference`` and to JAX ``attn_softmax(..., impl="pallas")``,
the Pallas kernels in interpret mode: in f32 the op graph (``impl="auto"``)
and the Pallas function are one function.  bf16, where they differ, is held
bit for bit in tests/test_torch_faults.py.  Tolerances are those of the JAX
package's own tests (tests/test_ops_softmax.py): forward atol 1e-6 /
rtol 1e-5, backward atol 1e-5 / rtol 1e-4, float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu_torch as pt
from flashattn_tpu import attn_softmax as j_attn_softmax
from flashattn_tpu import attn_softmax_reference as j_reference

torch.set_num_threads(1)

j_pallas = functools.partial(j_attn_softmax, impl="pallas")
FWD = dict(atol=1e-6, rtol=1e-5)
BWD = dict(atol=1e-5, rtol=1e-4)

# (B, H, F, T): ragged F and T, F > T, and T past the reference's 1024 cap
SHAPES = [(1, 2, 8, 16), (2, 4, 64, 96), (1, 1, 17, 33), (2, 2, 40, 24),
          (1, 2, 24, 1100)]
# every broadcast form of the additive mask (B|1, H|1, F|1, T)
MASKS = {"none": None, "b11t": (1, 0, 0), "11ft": (0, 0, 1),
         "1h1t": (0, 1, 0), "bhft": (1, 1, 1)}


def _inputs(shape, mask_form, seed=0):
    """x ~ 3 N(0, 1) and an additive 0 / -1e9 mask keeping 85% of keys."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    dims = MASKS[mask_form]
    if dims is None:
        return x, None
    mshape = tuple(s if keep else 1 for s, keep in zip(shape[:3], dims)) + (
        shape[3],)
    mask = np.where(rng.random(mshape) < 0.85, 0.0, -1e9).astype(np.float32)
    return x, mask


def _port(x, mask, causal):
    t = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        return pt.attn_softmax(t(x), t(mask), causal).numpy()


def _jax(fn, x, mask, causal):
    return np.asarray(fn(jnp.asarray(x), None if mask is None
                         else jnp.asarray(mask), causal))


@pytest.mark.parametrize("mask_form", list(MASKS))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_parity(shape, causal, mask_form):
    x, mask = _inputs(shape, mask_form)
    got = _port(x, mask, causal)
    np.testing.assert_allclose(got, _jax(j_reference, x, mask, causal), **FWD)
    np.testing.assert_allclose(got, _jax(j_pallas, x, mask, causal), **FWD)


def _grads(x, mask, dy, causal):
    """(port dinp, JAX reference dinp, JAX Pallas dinp) of sum(out * dy)."""
    xt = torch.from_numpy(x).requires_grad_()
    mt = None if mask is None else torch.from_numpy(mask)
    (got,) = torch.autograd.grad(pt.attn_softmax(xt, mt, causal),
                                 xt, torch.from_numpy(dy))
    jm = None if mask is None else jnp.asarray(mask)
    want = [np.asarray(jax.grad(lambda a: jnp.sum(fn(a, jm, causal) * dy))(
        jnp.asarray(x))) for fn in (j_reference, j_pallas)]
    return got.numpy(), *want


@pytest.mark.parametrize("mask_form", ["none", "b11t", "11ft"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 32, 48), (1, 2, 20, 1100)])
def test_backward_parity(shape, causal, mask_form):
    x, mask = _inputs(shape, mask_form, seed=7)
    dy = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    got, ref, pallas = _grads(x, mask, dy, causal)
    np.testing.assert_allclose(got, ref, **BWD)
    np.testing.assert_allclose(got, pallas, **BWD)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row(causal):
    """A batch row whose keys are all masked by -1e9 (kv_lengths 0 on the
    fused path) gives the JAX answer: a near-uniform softmax over the keys
    the causal mask leaves, not zeros as the flash path gives."""
    x, _ = _inputs((2, 2, 6, 9), "none", seed=3)
    mask = np.zeros((2, 1, 1, 9), np.float32)
    mask[1] = -1e9
    got = _port(x, mask, causal)
    np.testing.assert_allclose(got, _jax(j_reference, x, mask, causal), **FWD)
    np.testing.assert_allclose(got, _jax(j_pallas, x, mask, causal), **FWD)
    live = np.minimum(np.arange(6) + 1, 9) if causal else np.full(6, 9)
    np.testing.assert_allclose(got[1].sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got[1].max(-1),
                               np.broadcast_to(1.0 / live, (2, 6)), rtol=1e-6)


def test_causal_replaces_the_mask():
    """causal REPLACES future entries by DEFAULT_MASK_VALUE: a large
    positive additive mask there changes nothing."""
    x, _ = _inputs((1, 1, 5, 5), "none", seed=4)
    big = np.triu(np.full((5, 5), 1e6, np.float32), k=1)[None, None]
    np.testing.assert_array_equal(_port(x, big, True), _port(x, None, True))
    np.testing.assert_allclose(_port(x, big, True),
                               _jax(j_reference, x, big, True), **FWD)


def test_rows_sum_to_one_and_dtype():
    """bf16 scores beside a strong f32 mask: ``impl="auto"`` takes JAX's
    promoted dtype, f32, with JAX's values; ``impl="pallas"`` keeps the
    scores' dtype, as the Pallas kernel does."""
    x, mask = _inputs((1, 2, 16, 64), "b11t", seed=11)
    xb, mt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask)
    out = pt.attn_softmax(xb, mt, True)
    want = j_attn_softmax(jnp.asarray(x).astype(jnp.bfloat16),
                          jnp.asarray(mask), True)
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD)
    pal = pt.attn_softmax(xb, mt, True, impl="pallas")
    assert pal.dtype == torch.bfloat16
    np.testing.assert_allclose(pal.float().sum(-1).numpy(), 1.0, atol=1e-2)
    ref = pt.attn_softmax_reference(torch.from_numpy(x), mt, True)
    np.testing.assert_allclose(pal.float().numpy(), ref.numpy(), atol=4e-3)


def test_impl_and_mask_shape_checks():
    x = torch.zeros(1, 2, 3, 4)
    for impl in ("auto", "pallas"):
        assert pt.attn_softmax(x, None, False, impl=impl).shape == x.shape
    with pytest.raises(ValueError):
        pt.attn_softmax(x, None, False, impl="xla")
    with pytest.raises(ValueError):
        pt.attn_softmax(x, torch.zeros(1, 2, 3, 5))
    with pytest.raises(ValueError):
        pt.attn_softmax(x, torch.zeros(1, 3, 1, 4))
    with pytest.raises(ValueError):
        pt.attn_softmax(x[0])
