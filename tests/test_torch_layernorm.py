"""The port's LayerNorm plain versions against the JAX package's kernels.

The CUDA kernels of ``csrc/layernorm.cu`` are held on the card to the
plain versions ``_layernorm_fwd_reference`` and ``layernorm_bwd_reference``
(tests/test_torch_cuda.py, chip_smoke.py).  Here those plain versions,
reached through ``flashattn_tpu_torch.layernorm`` and its autograd backward
on CPU tensors, are held to ``jax.vjp`` of
``flashattn_tpu.ops.layernorm.layernorm``, whose Pallas forward and backward
kernels run in interpret mode.  The inputs come from a numpy seed and are
rounded to the working dtype on both sides alike.

Shapes: 300 rows (a ragged last block for the JAX kernels' 256-row block)
at the train width h 2048, h 1000, and h 100 (not a multiple of 8, the
port's generic kernel path on the card).

Tolerances: in bf16 the two sides compute the same f32 formulas and round
once, so y, dx, dgamma and dbeta may differ only where f32 sums taken in
another order round to the other neighbour: at most one bf16 ulp, in at
most 0.1% of the elements.  Near zero, where dx cancels terms of the
row's scale, bf16 resolves finer than that f32 noise, so an element also
passes within 2^-20 of the tensor's largest magnitude (at (300, 2048) two
dx values of ~1e-7 differ by 9 ulps, 4e-9 apart; one of the 2048 dgamma
columns differs by one ulp).  In f32, the sum order alone: 2e-5 abs plus
1e-5 relative (dgamma and dbeta are sums over up to 300 rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu_torch as pt
from flashattn_tpu.ops import layernorm as jln

torch.set_num_threads(1)

SHAPES = [(300, 2048), (64, 1000), (37, 100)]
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    h = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    dy = rng.standard_normal(shape).astype(np.float32)
    gamma, beta = (rng.standard_normal(h).astype(np.float32) for _ in range(2))
    return x, gamma, beta, dy


def _as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulps(got, want) -> np.ndarray:
    """Distance in bf16 ulps, element by element (values exact in bf16)."""
    def ordered(a):
        bits = (_as_f32(a).view(np.int32) >> 16).astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(ordered(got) - ordered(want))


def _check(got, want, name, what):
    assert tuple(got.shape) == tuple(want.shape), what
    if name == "bfloat16":
        assert got.dtype == torch.bfloat16, what
        ulps = _bf16_ulps(got, want)
        noise = (np.abs(_as_f32(got) - _as_f32(want))
                 <= 2.0**-20 * np.abs(_as_f32(want)).max())
        assert ((ulps <= 1) | noise).all(), f"{what}: {ulps.max()} ulps"
        assert (ulps > 0).mean() <= 1e-3, f"{what}: {(ulps > 0).mean():.2e}"
    else:
        np.testing.assert_allclose(_as_f32(got), _as_f32(want), atol=2e-5,
                                   rtol=1e-5, err_msg=what)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_layernorm_plain_versions_match_jax(shape, name):
    td, jd = DTYPES[name]
    x, gamma, beta, dy = _inputs(shape, seed=sum(shape))
    jargs = [jnp.asarray(a).astype(jd) for a in (x, gamma, beta)]
    y_j, vjp = jax.vjp(jln.layernorm, *jargs)
    want = vjp(jnp.asarray(dy).astype(jd))

    targs = [torch.from_numpy(a).to(td).requires_grad_()
             for a in (x, gamma, beta)]
    y_t = pt.layernorm(*targs)
    got = torch.autograd.grad(y_t, targs, torch.from_numpy(dy).to(td))

    _check(y_t, y_j, name, "y")
    for g, w, what in zip(got, want, ("dx", "dgamma", "dbeta")):
        _check(g, w, name, what)
