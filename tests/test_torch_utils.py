"""The port's conv, toy datasets, checkpoints, debug and timing utilities
against the JAX package's (mirrors tests/test_conv_and_utils.py,
test_debug.py and test_timing.py).

Inputs come from numpy (or JAX's seeded draws as numpy) and go to both
packages.  Gates: conv forward and its vector-Jacobian product within 1e-5
of JAX's (f32, another summation order); the toy datasets' points and
labels equal exactly (the same numpy draws); a NaN in any output leaf of
a timed function reaches ``make_timing_loop``'s result (the port's
counterpart of the JAX tests' jaxpr inspection: nothing is elided).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu_torch as pt
from flashattn_tpu.ops import conv as jconv
from flashattn_tpu.utils import datasets as jtoy
from flashattn_tpu_torch.autodiff import grad_check
from flashattn_tpu_torch.ops.conv import conv1d, conv2d
from flashattn_tpu_torch.utils import datasets as toy
from flashattn_tpu_torch.utils.debug import (
    assert_finite,
    check_2norm,
    checkify_errors,
    enable_nan_debugging,
    find_nonfinite,
    tensor_stats,
)
from flashattn_tpu_torch.utils.timing import device_loop_time, make_timing_loop


def _naive_conv1d(x, w):
    b, ic, width = x.shape
    oc, _, kw = w.shape
    out = np.zeros((b, oc, width), np.float32)
    for bi in range(b):
        for o in range(oc):
            for p in range(width):
                for i in range(ic):
                    for k in range(kw):
                        if p + k < width:
                            out[bi, o, p] += x[bi, i, p + k] * w[o, i, k]
    return out


def _naive_conv2d(x, w):
    b, ic, h, width = x.shape
    oc, _, kh, kw = w.shape
    out = np.zeros((b, oc, h, width), np.float32)
    for bi in range(b):
        for o in range(oc):
            for ph in range(h):
                for pw in range(width):
                    for i in range(ic):
                        for dh in range(kh):
                            for dw in range(kw):
                                if ph + dh < h and pw + dw < width:
                                    out[bi, o, ph, pw] += (
                                        x[bi, i, ph + dh, pw + dw] * w[o, i, dh, dw])
    return out


def _normal(seed, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


def _vjp_parity(fn, jfn, x, w, seed):
    """Forward and vector-Jacobian product against JAX's, 1e-5."""
    out_shape = fn(torch.from_numpy(x), torch.from_numpy(w)).shape
    g = np.random.default_rng(seed).standard_normal(tuple(out_shape)).astype(np.float32)
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    out = fn(xt, wt)
    gx, gw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(g))
    jout, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    for a, b in ((out, jout), (gx, jgx), (gw, jgw)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


# -- test_conv_and_utils.py -----------------------------------------------------


def test_conv1d_matches_naive():
    x, w = _normal(0, (2, 3, 10)), _normal(1, (4, 3, 3))
    np.testing.assert_allclose(conv1d(torch.from_numpy(x), torch.from_numpy(w)),
                               _naive_conv1d(x, w), atol=1e-4, rtol=1e-4)
    _vjp_parity(conv1d, jconv.conv1d, x, w, 0)


def test_conv2d_matches_naive():
    x, w = _normal(2, (2, 2, 6, 7)), _normal(3, (3, 2, 2, 3))
    np.testing.assert_allclose(conv2d(torch.from_numpy(x), torch.from_numpy(w)),
                               _naive_conv2d(x, w), atol=1e-4, rtol=1e-4)
    _vjp_parity(conv2d, jconv.conv2d, x, w, 1)


def test_conv_grads():
    x, w = _normal(4, (1, 2, 6)), _normal(5, (2, 2, 3))
    grad_check(conv1d, torch.from_numpy(x), torch.from_numpy(w), n_samples=5,
               tol=2e-2, epsilon=1e-3)
    grad_check(conv2d, torch.from_numpy(_normal(6, (1, 2, 4, 5))),
               torch.from_numpy(_normal(7, (2, 2, 2, 3))), n_samples=5,
               tol=2e-2, epsilon=1e-3)


def test_toy_datasets():
    for name, fn in toy.datasets.items():
        g = fn(20)
        assert g.N == 20 and len(g.X) == 20 and len(g.y) == 20
        assert set(g.y) <= {0, 1}
        for n, seed in ((20, 0), (37, 5)):
            mine, theirs = fn(n, seed=seed), jtoy.datasets[name](n, seed=seed)
            assert (mine.N, mine.X, mine.y) == (theirs.N, theirs.X, theirs.y)
    assert list(toy.datasets) == list(jtoy.datasets)
    assert toy.simple(10).y == [1 if x < 0.5 else 0 for x, _ in toy.simple(10).X]
    assert toy.xor(10).y[0] in (0, 1)


def _model():
    return pt.DecoderLM(32, 16, 2, 8, p_dropout=0.0, n_layer=1,
                        attn_impl="reference",
                        generator=torch.Generator().manual_seed(0), device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    from flashattn_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    model = _model()
    opt = pt.Adam(lr=1e-2)
    state = opt.init(model)
    save_checkpoint(str(tmp_path / "ckpt"), model, state, step=7)
    template = pt.DecoderLM(32, 16, 2, 8, p_dropout=0.0, n_layer=1,
                            attn_impl="reference",
                            generator=torch.Generator().manual_seed(99),
                            device="cpu")
    restored, rstate, step = restore_checkpoint(str(tmp_path / "ckpt"), template,
                                                opt.init(template))
    assert step == 7
    idx = torch.randint(0, 32, (2, 8), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(model(idx), restored(idx), rtol=0, atol=1e-6)
    assert rstate.step == state.step


def test_kernel_bench_harness_runs_on_cpu():
    from flashattn_tpu_torch import layernorm, layernorm_reference
    from flashattn_tpu_torch.utils.timing import KernelBench

    kt = KernelBench(ntest=1, iters=2, max_batch_tokens=64, max_seq_len=16)

    @kt.case(name="ln")
    def _case(kt):
        bs, seq = kt.bs_sl()
        x = torch.from_numpy(_normal(0, (bs * seq, 64)))
        g, b = torch.ones(64), torch.zeros(64)
        return (lambda x, g, b: layernorm(x, g, b)), (
            lambda x, g, b: layernorm_reference(x, g, b)), (x, g, b)

    results = kt.run("ln")
    assert len(results) == 1 and results[0].custom_ms > 0


def test_async_checkpoint_roundtrip(tmp_path):
    from flashattn_tpu_torch.utils.checkpoint import (AsyncCheckpointManager,
                                                      restore_checkpoint)

    model = _model()
    opt = pt.Adam(lr=1e-2)
    state = opt.init(model)
    mgr = AsyncCheckpointManager()
    mgr.save(str(tmp_path / "ackpt"), model, state, step=3)
    mgr.wait()
    template = pt.DecoderLM(32, 16, 2, 8, p_dropout=0.0, n_layer=1,
                            attn_impl="reference",
                            generator=torch.Generator().manual_seed(9),
                            device="cpu")
    restored, rstate, step = restore_checkpoint(str(tmp_path / "ackpt"), template,
                                                opt.init(template))
    assert step == 3
    idx = torch.randint(0, 32, (2, 8), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(model(idx), restored(idx), rtol=0, atol=1e-6)
    mgr.close()


# -- test_debug.py --------------------------------------------------------------


def test_assert_finite_passes_clean():
    @checkify_errors
    def f(x):
        return torch.sum(assert_finite(x, "x") * 2.0)

    assert float(f(torch.ones(4))) == 8.0


def test_assert_finite_raises_on_nan():
    @checkify_errors
    def f(x):
        return torch.sum(assert_finite(torch.log(x), "logx"))

    with pytest.raises(FloatingPointError, match="logx contains NaN/Inf"):
        f(torch.tensor([-1.0, 2.0]))  # log(-1) = nan
    with pytest.raises(FloatingPointError, match="y contains NaN/Inf"):
        assert_finite(torch.tensor([0.0]) / 0.0, "y")   # outside: at once


def test_assert_finite_inside_jit():
    """The port's counterpart of a check inside jit: inside
    ``checkify_errors`` a failed check is only recorded, the function runs
    on, and the first failed check raises after it returns."""
    ran = []

    @checkify_errors
    def f(x):
        y = assert_finite(x / x, "ratio")     # 0/0 = nan: recorded
        ran.append(True)
        assert_finite(x - 1e30 * x, "later")
        return torch.sum(y)

    with pytest.raises(FloatingPointError, match="ratio contains NaN/Inf"):
        f(torch.tensor([0.0, 1.0]))
    assert ran == [True]
    assert float(f(torch.tensor([1.0, 2.0]))) == 2.0


def test_check_2norm_identity(capsys):
    x = torch.tensor([3.0, 4.0])
    assert check_2norm(x, "x") is x
    assert "x 2-norm: 5.0" in capsys.readouterr().out


def test_tensor_stats():
    s = tensor_stats(torch.tensor([1.0, -2.0, float("nan")]))
    assert s["nan"] == 1 and s["shape"] == (3,)
    assert s["max"] == 1.0 and s["min"] == -2.0
    from flashattn_tpu.utils.debug import tensor_stats as jstats

    a = np.array([1.0, -2.0, np.nan, 0.5], np.float32)
    mine, theirs = tensor_stats(torch.from_numpy(a)), jstats(jnp.asarray(a))
    assert mine.pop("l2") is not None and np.isnan(theirs.pop("l2"))
    assert mine == theirs


def test_find_nonfinite_pytree():
    tree = {"ok": torch.ones(2), "bad": torch.tensor([1.0, float("inf")]),
            "ints": torch.tensor([1, 2])}
    bad = find_nonfinite(tree)
    assert len(bad) == 1
    (path, counts), = bad.items()
    assert path == "bad" and counts == {"nan": 0, "inf": 1}
    model = pt.Linear(3, 2, device="cpu")
    with torch.no_grad():
        model.bias[1] = float("nan")
    assert find_nonfinite({"m": [model]}, "p:") == {"p:m.0.bias": {"nan": 1, "inf": 0}}
    enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


# -- test_timing.py -------------------------------------------------------------


def _nan_reaches(fn, *args, length=3):
    return bool(torch.isnan(make_timing_loop(fn, length)(*args)))


def test_second_output_not_elided():
    """A NaN in a two-output function's second output reaches the result."""
    x, w = torch.ones(64, 64), torch.ones(64, 64)

    def two_out(a, w_):
        return a @ w_ * 1e-3, (a * 2.0) @ w_.T * float("nan")

    assert not _nan_reaches(lambda a, w_: (a @ w_ * 1e-3, a @ w_.T), x, w)
    assert _nan_reaches(two_out, x, w)


def test_tuple_and_dict_leaves_all_folded():
    """Every leaf of a nested output reaches the result."""
    x = torch.ones(32, 32) * 1e-3
    for bad in ("o", "sin", "cos"):
        def fn(a, bad=bad):
            o, s, c = a @ a, torch.sin(a) @ a, torch.cos(a) @ a
            out = {"o": o, "sin": s, "cos": c}
            out[bad] = out[bad] * float("nan")
            return {"o": out["o"], "aux": (out["sin"], out["cos"])}

        assert _nan_reaches(fn, x), bad


def test_shape_changing_output_folds_into_carry():
    """An output shaped unlike the carry is reduced and folded, not dropped;
    an int carry keeps its dtype."""
    x = torch.ones(16, 16)
    assert _nan_reaches(lambda a: torch.sum(a @ a, dim=0) * float("nan"), x)
    out = make_timing_loop(lambda a: torch.sum(a @ a, dim=0), 2)(x)
    assert torch.isfinite(out)
    ints = torch.arange(6)
    assert make_timing_loop(lambda a: a.float() * 2.0, 2)(ints).dtype == torch.float32


def test_device_loop_time_runs():
    """The two-point slope returns a positive per-call time."""
    x = torch.ones(64, 64)
    assert device_loop_time(lambda a: (a @ a, a + 1.0), (x,), iters=2, repeats=1) > 0
