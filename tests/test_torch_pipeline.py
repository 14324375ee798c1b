"""The port's GPipe pipeline (flashattn_tpu_torch.parallel.pipeline)
against the JAX package's on the CPU.

JAX runs its pipelines in this process over the conftest's virtual CPU
devices; the port runs as 4 gloo ranks (stage meshes of 4 and 2, a
(2, 2) data x stage mesh whose data axis the 2-stage pipeline leaves
alone) and as 8 ranks (8 stages, and the (2, 2, 2) data x stage x model
mesh), each spawn started before JAX computes (tests/test_torch_parallel_
ranks.py).  Gates (float32): values 1e-5 abs / 1e-5 rel, losses 1e-5 rel,
gradients 1e-5 abs / 1e-4 rel (JAX's own test's), the real-layer Megatron
pipeline's logits 2e-5 abs / 2e-4 rel and its gradients 1e-4 / 1e-3
against ``jax.grad`` of JAX's unsharded model.  The pipeline sums the
gradients over its data axis itself; the rank bodies read them as they
come.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import flashattn_tpu as ft
from flashattn_tpu.parallel.mesh import create_mesh
from flashattn_tpu.parallel.pipeline import (STAGE_AXIS, pipeline_apply,
                                             scan_stage_fn,
                                             split_layers_into_stages,
                                             stack_stage_params)

from test_torch_parallel_ranks import Ranks, pipeline_ranks

VALUES = dict(atol=1e-5, rtol=1e-5)
GRADS = dict(atol=1e-5, rtol=1e-4)
SEQUENTIAL = {"4-8-8": (4, 8, 8), "8-8-16": (8, 8, 16), "2-6-4": (2, 6, 4)}


def _mlp_layer_params(key, d):
    k1, k2 = jax.random.split(key)
    return {"w": jax.random.normal(k1, (d, d)) * (1.0 / np.sqrt(d)),
            "b": jax.random.normal(k2, (d,)) * 0.01}


def _mlp_layer(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def _build(n_layers, d, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n_layers)
    return [_mlp_layer_params(k, d) for k in keys]


def _sequential(layers, x):
    for p in layers:
        x = _mlp_layer(p, x)
    return x


def _np_layers(layers):
    return [{k: np.asarray(v) for k, v in p.items()} for p in layers]


def _flat(stacked):
    return {k: np.asarray(v) for k, v in stacked.items()}


def _inputs_and_refs():
    inp, ref = {"sequential": {}}, {"sequential": {}}
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 16))
    for key, (n_stages, n_layers, n_mb) in SEQUENTIAL.items():
        layers = _build(n_layers, 16)
        inp["sequential"][key] = (n_stages, _np_layers(layers), np.asarray(x),
                                  n_mb)
    # the grad case
    layers = _build(4, 8, seed=2)
    xg = jax.random.normal(jax.random.PRNGKey(3), (16, 8))
    tgt = jax.random.normal(jax.random.PRNGKey(4), (16, 8))
    inp["grad"] = (_np_layers(layers), np.asarray(xg), np.asarray(tgt))
    # composed DP x PP x TP
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    tp_layers = []
    for k in keys:
        k1, k2 = jax.random.split(k)
        tp_layers.append({"w1": jax.random.normal(k1, (8, 16)) / np.sqrt(8),
                          "w2": jax.random.normal(k2, (16, 8)) / np.sqrt(16)})
    xc = jax.random.normal(jax.random.PRNGKey(8), (16, 8))
    tc = jax.random.normal(jax.random.PRNGKey(9), (16, 8))
    inp["composed"] = (_np_layers(tp_layers), np.asarray(xc), np.asarray(tc),
                       4)
    # real layers
    cfg = dict(n_vocab=64, n_embd=32, n_head=4, n_positions=16,
               p_dropout=0.0, n_layer=4, attn_impl="flash")
    model = ft.DecoderLM(key=jax.random.PRNGKey(0), **cfg)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                           64))
    inp["megatron"] = (cfg, {n: np.asarray(a)
                             for n, a in model.named_parameters()}, tokens)
    return inp, (layers, xg, tgt), (tp_layers, xc, tc), (model, tokens)


def _jax_refs(inp, grad_case, composed_case, megatron_case):
    ref = {"sequential": {}}
    for key, (n_stages, layers, x, n_mb) in inp["sequential"].items():
        mesh = (create_mesh((n_stages,), (STAGE_AXIS,)) if n_stages != 2 else
                create_mesh((2, 2), ("data", STAGE_AXIS)))
        layers = [{k: jnp.asarray(v) for k, v in p.items()} for p in layers]
        stacked = stack_stage_params(split_layers_into_stages(layers,
                                                              n_stages))
        out = pipeline_apply(scan_stage_fn(_mlp_layer), stacked,
                             jnp.asarray(x), mesh, n_microbatches=n_mb)
        ref["sequential"][key] = (np.asarray(out),
                                  np.asarray(_sequential(layers, x)))

    layers, x, tgt = grad_case
    mesh = create_mesh((4,), (STAGE_AXIS,))
    stacked = stack_stage_params(split_layers_into_stages(layers, 4))

    @jax.jit
    def loss_pipe(params, x):
        out = pipeline_apply(scan_stage_fn(_mlp_layer), params, x, mesh,
                             n_microbatches=8)
        return jnp.mean((out - tgt) ** 2)

    ref["grad"] = (float(loss_pipe(stacked, x)),
                   _flat(jax.grad(loss_pipe)(stacked, x)),
                   np.asarray(jax.grad(loss_pipe, argnums=1)(stacked, x)),
                   float(jnp.mean((_sequential(layers, x) - tgt) ** 2)))

    tp_layers, xc, tc = composed_case
    mesh = create_mesh((2, 2, 2), ("data", STAGE_AXIS, "model"))
    stacked = stack_stage_params(split_layers_into_stages(tp_layers, 2))
    specs = {"w1": JP(STAGE_AXIS, None, None, "model"),
             "w2": JP(STAGE_AXIS, None, "model", None)}

    def tp_layer(p, x):
        return x + jax.lax.psum(jnp.tanh(x @ p["w1"]) @ p["w2"], "model")

    @jax.jit
    def loss_composed(params, x):
        out = pipeline_apply(scan_stage_fn(tp_layer), params, x, mesh,
                             n_microbatches=4, data_axis="data",
                             param_specs=specs)
        return jnp.mean((out - tc) ** 2)

    ref["composed"] = (float(loss_composed(stacked, xc)),
                       _flat(jax.grad(loss_composed)(stacked, xc)))

    model, tokens = megatron_case
    tokens = jnp.asarray(tokens)
    ref["megatron"] = np.asarray(jax.jit(model.forward)(tokens))
    # the layers' gradients of sum(logits ** 2), stacked as the pipeline's
    g = jax.jit(jax.grad(lambda m: jnp.sum(m.forward(tokens) ** 2)))(model)
    ref["megatron_grads"] = _flat(stack_stage_params(split_layers_into_stages(
        [dict(layer.named_parameters()) for layer in g.layers], 2)))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp, grad_case, composed_case, megatron_case = _inputs_and_refs()
    four = Ranks(pipeline_ranks, 4, tmp_path_factory.mktemp("pipe4"), inp)
    eight = Ranks(pipeline_ranks, 8, tmp_path_factory.mktemp("pipe8"), inp)
    ref = _jax_refs(inp, grad_case, composed_case, megatron_case)
    return ref, four.results()[0], eight.results()[0]


def _case(res, name):
    out = res[name]
    if (isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], str)
            and out[0] == "error"):
        pytest.fail(f"case {name} failed on rank 0:\n{out[1]}")
    return out


@pytest.mark.parametrize("key", list(SEQUENTIAL))
def test_pipeline_matches_sequential(runs, key):
    ref, four, eight = runs
    got = _case(eight if key.startswith("8-") else four, "sequential")[key]
    want, seq = ref["sequential"][key]
    np.testing.assert_allclose(got, want, **VALUES)
    np.testing.assert_allclose(got, seq, **VALUES)


def test_pipeline_under_grad(runs):
    loss, grads, gx = _case(runs[1], "grad")
    want_loss, want, want_gx, seq_loss = runs[0]["grad"]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(loss, seq_loss, rtol=1e-5)
    for n in want:
        np.testing.assert_allclose(grads[n], want[n], err_msg=n, **GRADS)
    np.testing.assert_allclose(gx, want_gx, **GRADS)


def test_pipeline_composed_dp_pp_tp(runs):
    loss, grads = _case(runs[2], "composed")
    want_loss, want = runs[0]["composed"]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for n in want:
        np.testing.assert_allclose(grads[n], want[n], err_msg=n, **GRADS)


def test_pipeline_rejects_bad_microbatch(runs):
    msg = _case(runs[1], "sequential")["bad_microbatch"]
    assert msg is not None and "not divisible" in msg


def test_pipeline_real_transformer_layers_megatron(runs):
    got, grads = _case(runs[2], "megatron")
    np.testing.assert_allclose(got, runs[0]["megatron"], rtol=2e-4,
                               atol=2e-5)
    want = runs[0]["megatron_grads"]
    assert grads.keys() == want.keys()
    for n in want:
        assert np.isfinite(grads[n]).all(), n
        np.testing.assert_allclose(grads[n], want[n], atol=1e-4, rtol=1e-3,
                                   err_msg=n)
