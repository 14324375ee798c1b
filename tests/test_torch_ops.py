"""The port's ops (flashattn_tpu_torch.ops) against the JAX package's.

Each port op runs on CPU tensors (its plain PyTorch version) and is held to
the JAX Pallas kernel in interpret mode and to the JAX ``*_reference``, on
the same inputs made from a numpy seed.  Tolerance: float32, atol 2e-5,
rtol 1e-4 (the two frameworks sum in different orders).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu_torch as pt
from flashattn_tpu.ops import flash_attention as jfa
from flashattn_tpu.ops import layernorm as jln
from flashattn_tpu.ops import paged_attention as jpa
from flashattn_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=1e-4)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


# -- flash attention -----------------------------------------------------------


def test_flash_subrow_varlen_kernel_parity():
    """The TPU batched-prefill kernel (_flash_fwd_subrow_varlen, interpret
    mode) at b1 h2 n1024 d128 vs the port's forward, o and lse."""
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, 1, 2, 1024, 128) for _ in range(3))
    lens = np.asarray([700], np.int32)
    scale = 1.0 / 128**0.5
    o_j, lse_j = jfa._flash_fwd_subrow_varlen(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        sm_scale=scale, sub=256)
    o_t, lse_t = tfa._flash_fwd_entry(
        *map(torch.from_numpy, (q, k, v)), True, scale,
        kv_lengths=torch.from_numpy(lens))
    _close(o_t, o_j)
    _close(lse_t, lse_j)


# (h, h_kv, lengths, window): GQA, sliding window, a len-0 row, plain causal
GRID_CASES = {
    "gqa": (4, 2, [64, 40, 17], None),
    "window": (2, 2, [64, 50, 9], 12),
    "len0": (2, 1, [64, 0, 33], None),
    "causal": (2, 2, [64, 64, 64], None),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_flash_varlen_grid_kernel_parity(case):
    """The TPU grid kernel (_fwd_kernel via flash_attention_varlen,
    impl="pallas", 16x16 blocks, interpret mode) at n=64 vs the port."""
    h, h_kv, lengths, window = GRID_CASES[case]
    rng = np.random.default_rng(1)
    q = _normal(rng, 3, h, 64, 32)
    k, v = (_normal(rng, 3, h_kv, 64, 32) for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    args_j = [jnp.asarray(a) for a in (q, k, v, lens)]
    args_t = [torch.from_numpy(a) for a in (q, k, v, lens)]
    o_j = jfa.flash_attention_varlen(*args_j, True, impl="pallas",
                                     block_q=16, block_k=16, window=window)
    o_ref = jfa.flash_attention_reference(*args_j[:3], True,
                                          kv_lengths=args_j[3], window=window)
    o_t, lse_t = tfa._flash_fwd_entry(
        *args_t[:3], True, None, window=window, kv_lengths=args_t[3])
    _close(o_t, o_j)
    _close(o_t, o_ref)
    _, lse_j = jfa._flash_fwd(*args_j[:3], causal=True, sm_scale=32**-0.5,
                              block_q=16, block_k=16, kv_lengths=args_j[3],
                              window=window)
    # the grid kernel leaves a finite lse on a row with no live key, where
    # the port (like the JAX oracle) writes -inf: compare live rows
    live = np.isfinite(lse_t.numpy())
    _close(lse_t.numpy()[live], np.asarray(lse_j)[live])
    if case == "len0":
        assert not live[1].any() and (o_t[1] == 0).all()


# (causal, n_q, n_kv, lengths, window)
REF_CASES = {
    "dense_causal": (True, 48, 48, None, None),
    "cross_noncausal": (False, 24, 40, None, None),
    "varlen_window": (True, 40, 40, [40, 23], 7),
}


@pytest.mark.parametrize("case", list(REF_CASES))
def test_flash_reference_parity(case):
    """The port's plain forward vs the JAX oracle, o and lse."""
    causal, n_q, n_kv, lengths, window = REF_CASES[case]
    rng = np.random.default_rng(2)
    q = _normal(rng, 2, 4, n_q, 64)
    k, v = (_normal(rng, 2, 2, n_kv, 64) for _ in range(2))
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    o_j, lse_j = jfa._reference_fwd_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 0.125,
        None if lens is None else jnp.asarray(lens), window)
    o_t, lse_t = tfa._reference_fwd_with_lse(
        *map(torch.from_numpy, (q, k, v)), causal, 0.125,
        None if lens is None else torch.from_numpy(lens), window)
    _close(o_t, o_j)
    _close(lse_t, lse_j)
    if not causal:
        _close(pt.flash_attention(*map(torch.from_numpy, (q, k, v))),
               jfa.flash_attention_reference(*map(jnp.asarray, (q, k, v))))


def test_flash_impl_and_window_validation():
    t = torch.zeros(1, 1, 8, 32)
    with pytest.raises(ValueError):
        pt.flash_attention(t, t, t, False, window=4)
    with pytest.raises(ValueError):
        pt.flash_attention(t, t, t, True, impl="pallas")


# -- paged attention -----------------------------------------------------------


# (d, chunk, page, window): d=128 rides the JAX pipelined page walk,
# d=32 the page-slot grid
PAGED_CASES = {
    "pipelined_decode": (128, 1, 8, None),
    "pipelined_chunk4": (128, 4, 8, None),
    "grid_decode": (32, 1, 4, None),
    "grid_chunk4": (32, 4, 16, None),
    "grid_chunk4_window": (32, 4, 4, 6),
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_attention_parity(case):
    d, chunk, page, window = PAGED_CASES[case]
    rng = np.random.default_rng(3)
    b, hq, hkv, n_pages, pps = 3, 4, 2, 12, 3
    q = _normal(rng, b, chunk, hq, d) if chunk > 1 else _normal(rng, b, hq, d)
    kp, vp = (_normal(rng, hkv, n_pages, page, d) for _ in range(2))
    table = rng.permutation(n_pages)[:b * pps].reshape(b, pps).astype(np.int32)
    lens = np.asarray([page * pps, page + chunk + 1, chunk], np.int32)
    args_j = [jnp.asarray(a) for a in (q, kp, vp, lens, table)]
    args_t = [torch.from_numpy(a) for a in (q, kp, vp, lens, table)]
    got = pt.paged_attention(*args_t, window=window)
    _close(got, jpa.paged_attention(*args_j, window=window))
    _close(got, jpa.paged_attention_reference(*args_j, window=window))


def test_paged_attention_rejects_quantized_pools():
    """A quantized pool is int8 / fp8 pages with f32 (Hkv, n_pages, page, 1)
    scales for K and V; incoherent pools raise (tests/test_torch_quant.py
    holds coherent ones against JAX)."""
    t = torch.zeros(1, 2, 32)
    lens, table = torch.ones(1, dtype=torch.int32), torch.zeros(
        1, 2, dtype=torch.int32)
    pages = torch.zeros(2, 2, 4, 32)
    pages8 = pages.to(torch.int8)
    ones = torch.ones(2, 2, 4, 1)
    bad = [
        (TypeError, (pages, pages), dict(k_scales=ones, v_scales=ones)),
        (TypeError, (pages8, pages8), {}),
        (TypeError, (pages8, pages8.to(torch.float8_e4m3fn)),
         dict(k_scales=ones, v_scales=ones)),
        (TypeError, (pages8, pages8), dict(k_scales=ones.double(),
                                           v_scales=ones.double())),
        (ValueError, (pages8, pages8), dict(k_scales=ones)),
        (ValueError, (pages8, pages8), dict(k_scales=ones[:, :1],
                                            v_scales=ones[:, :1])),
    ]
    for err, (kp, vp), kw in bad:
        with pytest.raises(err):
            pt.paged_attention(t, kp, vp, lens, table, **kw)
    out = pt.paged_attention(t, pages8, pages8, lens, table, k_scales=ones,
                             v_scales=ones)
    assert out.shape == t.shape and not out.any()


# -- layernorm -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 128), (3, 5, 100)])
def test_layernorm_parity(shape):
    """Any hidden size: the JAX Pallas kernel (interpret) and oracle vs the
    port."""
    rng = np.random.default_rng(4)
    x = _normal(rng, *shape) * 3 + 1
    g = _normal(rng, shape[-1])
    bt = _normal(rng, shape[-1])
    got = pt.layernorm(*map(torch.from_numpy, (x, g, bt)))
    args_j = [jnp.asarray(a) for a in (x, g, bt)]
    _close(got, jln.layernorm(*args_j))
    _close(got, jln.layernorm_reference(*args_j))


def test_functional_parity():
    """GELU (tanh form) and one_hot against the JAX package's."""
    from flashattn_tpu.nn import functional as jF

    x = _normal(np.random.default_rng(5), 4, 33) * 3
    _close(pt.F.GELU(torch.from_numpy(x)), jF.GELU(jnp.asarray(x)))
    idx = np.asarray([[0, 3, 9], [2, 2, 1]], np.int32)
    _close(pt.F.one_hot(torch.from_numpy(idx), 10),
           jF.one_hot(jnp.asarray(idx), 10))


def test_import_leaves_jax_out():
    """The port imports torch and never jax, nor any module of the JAX
    package (A6d's modules keep their own copies); the MT app's tokenizer, BLEU,
    progress-bar and dataset packages only inside the functions that use
    them (torch itself may import tqdm first, which is allowed)."""
    code = ("import sys, torch; before = set(sys.modules); "
            "import flashattn_tpu_torch, flashattn_tpu_torch.serving; "
            "import flashattn_tpu_torch.serving._threefry; "
            "import flashattn_tpu_torch.training.generate; "
            "import flashattn_tpu_torch.models.seq2seq; "
            "import flashattn_tpu_torch.training.translation; "
            "import flashattn_tpu_torch.training.deen_fixture; "
            "import flashattn_tpu_torch.utils.checkpoint; "
            "import flashattn_tpu_torch.operators, flashattn_tpu_torch.scalar; "
            "import flashattn_tpu_torch.testing, flashattn_tpu_torch.autodiff; "
            "import flashattn_tpu_torch.module, flashattn_tpu_torch.ops.conv; "
            "import flashattn_tpu_torch.utils.datasets; "
            "import flashattn_tpu_torch.utils.debug; "
            "import flashattn_tpu_torch.utils.timing; "
            "import flashattn_tpu_torch.training.classifier; "
            "import flashattn_tpu_torch.parallel; "
            "import flashattn_tpu_torch.parallel.pipeline; "
            "import flashattn_tpu_torch.parallel.sharded_attention; "
            "from flashattn_tpu_torch.training import ShardedTrainer; "
            "from flashattn_tpu_torch.utils import native_loader; "
            "native_loader.ngram_propose_native([1, 2, 1], 1); "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'flashattn_tpu' not in sys.modules; "
            "new = [m for m in ('tokenizers', 'transformers', 'sacrebleu', "
            "'tqdm', 'datasets') if m in sys.modules and m not in before]; "
            "assert not new, new")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
