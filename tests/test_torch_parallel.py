"""The port's parallelism (flashattn_tpu_torch.parallel, ShardedTrainer and
tensor-parallel serving) against the JAX package's on the CPU.

JAX runs its sharded programs in this process over the conftest's virtual
CPU devices; the port runs as 4 gloo ranks (tests/test_torch_parallel_ranks
.py), started once for the module while JAX computes, each rank holding its
shard, over meshes of the same shapes and names.  The ranks' results,
gathered over the mesh, are held against JAX's on the same inputs and
converted weights.  Gates (float32): forwards 1e-5 abs / 1e-4 rel;
gradients 1e-4 / 1e-3; engine logits 1e-4; speculation under TP token
for token equal to plain greedy; partition specs equal entry for entry;
trainer losses 1e-4 abs / 1e-4 rel and parameters after the updates 1e-4 /
1e-3 (Adam and Adafactor divide by running second moments, which turn
gradient summation-order noise into larger update noise than a forward's),
ZeRO losses within 1e-4 of plain TP's, as JAX's test asks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as JP

import flashattn_tpu as ft
from flashattn_tpu.ops.quant import quantize_model_weights as jquantize
from flashattn_tpu.parallel import (apply_mesh as japply_mesh,
                                    create_mesh as jcreate_mesh,
                                    ring_flash_attention as jring,
                                    shard_model as jshard_model,
                                    sharded_flash_attention as jsharded,
                                    tp_spec_for as jtp_spec_for)
from flashattn_tpu.parallel.mesh import batch_sharding as jbatch_sharding
from flashattn_tpu.parallel.mesh import default_mesh as jdefault_mesh
from flashattn_tpu.parallel.mesh import replicated as jreplicated
from flashattn_tpu.parallel.sharding import _path_to_str as jpath
from flashattn_tpu.parallel.sharding import (
    fsdp_sharding_tree as jfsdp_sharding_tree,
    fsdp_spec_for as jfsdp_spec_for, sharding_tree as jsharding_tree)
from flashattn_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from flashattn_tpu.training import ShardedTrainer as JShardedTrainer
from flashattn_tpu.models.moe import MoEFeedForward as JMoE
from flashattn_tpu.module import map_module_tree as jmap_module_tree
from flashattn_tpu.training import lm_loss as jlm_loss
from flashattn_tpu.training import make_moe_loss as jmake_moe_loss

import flashattn_tpu_torch.parallel as tpar
from test_torch_parallel_ranks import Ranks, parallel_ranks

FWD = dict(atol=1e-5, rtol=1e-4)
GRAD = dict(atol=1e-4, rtol=1e-3)
LOSS = dict(atol=1e-4, rtol=1e-4)
PARAMS = dict(atol=1e-4, rtol=1e-3)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg,
                               **tol)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, np.float32) for _ in range(3))


def _params(jm):
    return {n: np.asarray(a) for n, a in jm.named_parameters()}


def _cfg(n_vocab, n_embd, n_head, n_positions, **kw):
    return dict(n_vocab=n_vocab, n_embd=n_embd, n_head=n_head,
                n_positions=n_positions, **kw)


_MODELS = {}


def _jmodel(cfg, seed):
    """A JAX DecoderLM, built once a (config, seed) and copied a call (the
    JAX trainers donate their models' buffers)."""
    key = (tuple(sorted(cfg.items())), seed)
    if key not in _MODELS:
        _MODELS[key] = ft.DecoderLM(key=jax.random.PRNGKey(seed), **cfg)
    return jax.tree_util.tree_map(jnp.copy, _MODELS[key])


SMALL = _cfg(64, 32, 4, 16, p_dropout=0.0, n_layer=1, attn_impl="flash")
TRAINERS = {
    "small": (SMALL, 3),
    "zero": (_cfg(256, 128, 4, 16, p_dropout=0.0, n_layer=1,
                  attn_impl="flash"), 3),
    "pair": (_cfg(128, 64, 4, 16, p_dropout=0.0, n_layer=2,
                  attn_impl="flash"), 7),
    "dropout": (dict(SMALL, p_dropout=0.1), 3),
    "moe": (dict(SMALL, n_experts=4, moe_top_k=2, middle_dim=32), 5),
}
# the MoE trainer's capacity factor: an expert takes 32 of the global
# batch's 256 choices, so that the drops depend on the global token order
MOE_CAPACITY = 0.5
FSDP_CASES = [("layers.0.ff.linear_in.weights", (64, 256), 2**14),
              ("layers.0.attention.out_projection.weights", (256, 64), 2**14),
              ("some.other.weights", (128, 512), 2**14),
              ("layers.0.ln_1.gamma", (64,), 2**14),
              ("odd.weights", (130, 254), 1),
              ("odd.weights", (131, 255), 1),
              ("lm_head.bias", (4096,), 1),
              ("ff.experts_in", (8, 64, 128), 1)]
TP_PATHS = [s for s, _ in __import__(
    "flashattn_tpu.parallel.sharding", fromlist=["_TP_RULES"])._TP_RULES] + [
    "layers.0.ln_1.gamma", "layers.3.attention.q_projection.weights",
    "ln.beta", "layers.0.ff.router.weights", "other"]


def _inputs():
    inp = {"fsdp_cases": FSDP_CASES}
    jsmall = _jmodel(SMALL, 0)
    inp["small_cfg"], inp["small_params"] = SMALL, _params(jsmall)
    inp["small_qparams"] = _params(jquantize(jsmall))
    inp["small_idx"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(12), (4, 16), 0, 64))
    inp["flash_qkv"] = _qkv((4, 8, 64, 32), 1)
    inp["flash_grad_qkv"] = _qkv((2, 4, 32, 16), 2)
    inp["ring_qkv"] = _qkv((1, 2, 4 * 16, 16), 3)
    inp["ring_tp_qkv"] = _qkv((1, 4, 4 * 16, 16), 11)
    # shards of 512 keys: the forward pairs take the op graph, the backward
    # pairs the grid function, where the unsharded 2048 takes the kernels
    inp["ring_long_qkv"] = _qkv((1, 1, 2048, 16), 13)
    fwd_cfg = _cfg(64, 32, 4, 16, p_dropout=0.0, n_layer=2, attn_impl="flash")
    inp["fwd_cfg"], inp["fwd_params"] = fwd_cfg, _params(_jmodel(fwd_cfg, 1))
    inp["fwd_idx"] = np.asarray(jax.random.randint(jax.random.PRNGKey(2),
                                                   (4, 16), 0, 64))
    inp["sp_models"] = {}
    for pos in ("learned", "rope"):
        cfg = _cfg(64, 32, 4, 128, p_dropout=0.0, n_layer=2,
                   attn_impl="flash", pos_encoding=pos)
        inp["sp_models"][pos] = (cfg, _params(_jmodel(cfg, 3)))
    data = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (2, 129), 0,
                                         64))
    inp["sp_data"] = (data[:, :-1], data[:, 1:])
    inp["trainer_models"] = {k: (cfg, _params(_jmodel(cfg, seed)))
                             for k, (cfg, seed) in TRAINERS.items()}
    rnd = lambda seed, shape, v: np.asarray(jax.random.randint(
        jax.random.PRNGKey(seed), shape, 0, v))
    small = rnd(4, (8, 17), 64)
    inp["trainer_data"] = {"small": small,
                           "small3": np.stack([small] * 3),
                           "zero": rnd(4, (8, 17), 256),
                           "pair": rnd(8, (8, 17), 128)}
    # the first data rank's rows count one position each, the second's all
    mask = np.ones((8, 16), np.float32)
    mask[:4, 1:] = 0.0
    inp["uneven_mask"] = mask
    inp["moe_capacity"] = MOE_CAPACITY
    serve = _cfg(64, 32, 4, 256, p_dropout=0.0, n_layer=2,
                 attn_impl="reference")
    inp["serve_model"] = (serve, _params(_jmodel(serve, 0)))
    rng = np.random.default_rng(5)
    inp["serve_prompts"] = [[int(x) for x in rng.integers(1, 60, size=7)]
                            for _ in range(2)]
    target = _cfg(64, 32, 4, 512, p_dropout=0.0, n_layer=2,
                  attn_impl="reference")
    draft = _cfg(64, 16, 2, 512, p_dropout=0.0, n_layer=1,
                 attn_impl="reference")
    inp["spec_models"] = ((target, _params(_jmodel(target, 0))),
                          (draft, _params(_jmodel(draft, 7))))
    rng = np.random.default_rng(11)
    inp["spec_prompts"] = ([[int(x) for x in rng.integers(1, 60, size=n)]
                            for n in (5, 12, 1)], [10, 6, 8])
    return inp


def _jtrainer(key, mesh, **kw):
    cfg, seed = TRAINERS[key]
    model = _jmodel(cfg, seed)
    if key == "moe":
        model = jmap_module_tree(model, lambda m: m.replace(
            capacity_factor=MOE_CAPACITY) if isinstance(m, JMoE) else m)
    return JShardedTrainer(model, kw.pop("opt", None) or ft.Adam(lr=5e-3),
                           mesh, **kw)


def _jsteps(t, data, n, mask=None):
    mask = None if mask is None else jnp.asarray(mask)
    return [float(t.step(data[:, :-1], data[:, 1:], mask)) for _ in range(n)]


def _jax_refs(inp):
    dm = jcreate_mesh((2, 2), ("data", "model"))
    sm = jcreate_mesh((4,), ("seq",))
    stm = jcreate_mesh((2, 2), ("seq", "model"))
    ref = {}
    ref["fsdp"] = [tuple(jfsdp_spec_for(p, s, dm, min_size=ms))
                   for p, s, ms in FSDP_CASES]
    jsmall = _jmodel(SMALL, 0)
    ref["specs"] = {n: tuple(a.sharding.spec) for n, a in
                    jshard_model(jsmall, dm).named_parameters()}
    dflt = jdefault_mesh(4)
    ref["default_mesh"] = (tuple(dflt.devices.shape), tuple(dflt.axis_names),
                           tuple(jbatch_sharding(dm).spec),
                           tuple(jreplicated(dm).spec))
    x = jax.device_put(jnp.arange(8 * 6, dtype=jnp.float32).reshape(8, 6),
                       NamedSharding(dm, JP(("data", "model"))))
    flat = list(dm.devices.flat)
    ref["tuple_blocks"] = {flat.index(sh.device): np.asarray(sh.data)
                           for sh in x.addressable_shards}
    leaves = jax.tree_util.tree_leaves_with_path
    ref["tree"] = {jpath(p): tuple(s.spec) for p, s in
                   leaves(jsharding_tree(jsmall, dm))}
    ref["fsdp_tree"] = {jpath(p): tuple(s.spec) for p, s in leaves(
        jfsdp_sharding_tree(jsmall, dm, min_size=64))}
    jq = jquantize(jsmall)
    ref["qspecs"] = {n: tuple(a.sharding.spec) for n, a in
                     jshard_model(jq, dm).named_parameters()}
    ref["qlogits"] = np.asarray(jq(jnp.asarray(inp["small_idx"])))
    mqa = ft.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1, n_kv_head=1,
                       attn_impl="flash", key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="n_kv_head=1"):
        japply_mesh(mqa, dm)

    for causal in (False, True):
        q, k, v = inp["flash_qkv"]
        ref[f"flash{int(causal)}"] = np.asarray(jax.jit(
            lambda q, k, v: jsharded(q, k, v, causal, mesh=dm))(q, k, v))
    ref["flash_grads"] = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(jsharded(q, k, v, True, mesh=dm) ** 2),
        argnums=(0, 1, 2)))(*inp["flash_grad_qkv"])

    def ring(mesh, qkv, causal, **kw):
        f = lambda q, k, v: jring(q, k, v, causal, mesh=mesh, **kw)
        out = jax.jit(f)(*qkv)
        grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) ** 2),
                                 argnums=(0, 1, 2)))(*qkv)
        return np.asarray(out), [np.asarray(g) for g in grads]

    for causal in (False, True):
        ref[f"seq{int(causal)}"] = ring(sm, inp["ring_qkv"], causal)
        ref[f"tp{int(causal)}"] = ring(stm, inp["ring_tp_qkv"], causal,
                                       head_axis="model")
    ref["boundary"] = ring(sm, inp["ring_long_qkv"], True)

    jfwd = _jmodel(inp["fwd_cfg"], 1)
    sharded = jshard_model(japply_mesh(jfwd, dm), dm)
    idx = jax.device_put(jnp.asarray(inp["fwd_idx"]),
                         NamedSharding(dm, JP("data")))
    ref["model_forward"] = np.asarray(jax.jit(lambda m, i: m(i))(sharded, idx))
    ref["model_single"] = np.asarray(jfwd(jnp.asarray(inp["fwd_idx"])))

    tok, tgt = (jnp.asarray(a) for a in inp["sp_data"])
    ref["sp"] = {}
    for pos, (cfg, _) in inp["sp_models"].items():
        sp = japply_mesh(_jmodel(cfg, 3), sm, batch_axis=None, head_axis=None,
                         seq_axis="seq")
        loss, grads = jax.jit(jax.value_and_grad(jlm_loss))(sp, tok, tgt)
        ref["sp"][pos] = (float(loss), {n: np.asarray(g)
                                        for n, g in grads.named_parameters()})

    d = {k: jnp.asarray(v) for k, v in inp["trainer_data"].items()}
    t = _jtrainer("small", dm)
    first = _jsteps(t, d["small"], 3)
    ref["scan_params"] = _params(t.model)
    ref["e2e"] = (first + _jsteps(t, d["small"], 7), _params(t.model))
    t = _jtrainer("zero", dm, zero=True)
    ref["zero"] = _jsteps(t, d["zero"], 10)
    ref["pair"] = _jsteps(_jtrainer("pair", dm), d["pair"], 5)
    t = _jtrainer("small", dm)
    ref["mask"] = (_jsteps(t, d["small"], 2, inp["uneven_mask"]),
                   _params(t.model))
    t = _jtrainer("small", dm, grad_clip=0.05)
    ref["clip"] = (_jsteps(t, d["small"], 2), _params(t.model))
    t = _jtrainer("small", dm, opt=ft.Adafactor())
    ref["adafactor"] = (_jsteps(t, d["small"], 2), _params(t.model))
    t = _jtrainer("moe", dm, loss_fn=jmake_moe_loss(0.01))
    ref["moe"] = (_jsteps(t, d["small"], 2), _params(t.model))

    serve_cfg, _ = inp["serve_model"]
    jserve = _jmodel(serve_cfg, 0).eval()
    ref["dense_logits"] = [np.asarray(jserve(jnp.asarray([p], jnp.int32))[0])
                           for p in inp["serve_prompts"]]
    (tcfg, _), _ = inp["spec_models"]
    eng = JEngine(
        _jmodel(tcfg, 0).eval(), max_batch=3, page_size=8, pages_per_seq=4,
        steps_per_dispatch=1)
    prompts, maxnews = inp["spec_prompts"]
    reqs = [eng.submit(p, n) for p, n in zip(prompts, maxnews)]
    eng.run()
    ref["greedy"] = [list(map(int, r.generated)) for r in reqs]
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = _inputs()
    ranks = Ranks(parallel_ranks, 4, tmp_path_factory.mktemp("parallel"), inp)
    ref = _jax_refs(inp)
    got = ranks.results()
    return inp, ref, got


def _case(runs, name):
    res = runs[2][0][name]
    if isinstance(res, tuple) and len(res) == 2 and res[0] == "error":
        pytest.fail(f"case {name} failed on rank 0:\n{res[1]}")
    return res


def test_tp_rules_match_jax():
    for path in TP_PATHS:
        assert tuple(tpar.tp_spec_for(path)) == tuple(jtp_spec_for(path)), path
        assert tuple(tpar.tp_spec_for(path, "mp")) \
            == tuple(jtp_spec_for(path, "mp")), path


def test_fsdp_spec_composes_with_tp(runs):
    """fsdp_spec_for over a (2, 2) data x model mesh: the specs JAX's gives
    (column- and row-parallel weights, a TP-replicated weight, a small and
    an indivisible parameter)."""
    assert _case(runs, "specs")["fsdp"] == runs[1]["fsdp"]


def test_default_mesh_shape(runs):
    """default_mesh(4): the (data, model) shape JAX's picks, and the batch
    and replicated placements."""
    assert _case(runs, "specs")["default_mesh"] == runs[1]["default_mesh"]


def test_local_shard_over_two_axes(runs):
    """A dim split over ("data", "model") (data major): each rank holds the
    block JAX's device_put puts on its device, and unshard gives the
    tensor back."""
    for rank, res in enumerate(runs[2]):
        block, round_trip = res["specs"]["tuple_block"]
        np.testing.assert_array_equal(block, runs[1]["tuple_blocks"][rank])
        assert round_trip


def test_sharding_trees_match_jax(runs):
    """sharding_tree and fsdp_sharding_tree (min_size 64, so that the data
    axis splits the larger weights) give JAX's spec a parameter."""
    res, ref = _case(runs, "specs"), runs[1]
    assert res["tree"] == ref["tree"]
    assert res["fsdp_tree"] == ref["fsdp_tree"]
    assert any("data" in s for s in res["fsdp_tree"].values())


def test_shard_model_places_params(runs):
    res, ref = _case(runs, "specs"), runs[1]
    assert res["specs"] == ref["specs"]
    assert res["module_spec"] == (None, "model")
    assert res["shapes"]["layers.0.attention.q_projection.weights"] \
        == (32, 16)
    assert res["shapes"]["layers.0.ln_1.gamma"] == (32,)


def test_shard_quantized_model_places_params(runs):
    """QuantizedLinear's values and scales shard like JAX's; the int8
    payloads gathered are JAX's; the TP forward of the quantized model
    (the weight-only matmul on the local blocks) gives JAX's logits."""
    res, ref = _case(runs, "specs"), runs[1]
    assert res["qspecs"] == ref["qspecs"]
    assert res["qspecs"]["layers.0.attention.q_projection.scales"] \
        == (None, "model")
    for n, a in runs[0]["small_qparams"].items():
        np.testing.assert_array_equal(
            res["qvalues"][n], a.astype(np.float32), err_msg=n)
    _close(res["qlogits"], ref["qlogits"], dict(atol=1e-4, rtol=1e-4))


def test_apply_mesh_rejects_unshardable_kv_heads(runs):
    msg = _case(runs, "specs")["mqa"]
    assert msg is not None and "n_kv_head=1" in msg


@pytest.mark.parametrize("causal", [False, True])
def test_sharded_flash_attention_matches_jax(runs, causal):
    got = _case(runs, "sharded_flash")[f"fwd{int(causal)}"]
    _close(got, runs[1][f"flash{int(causal)}"], FWD)


def test_sharded_flash_attention_grads(runs):
    for g, r, name in zip(_case(runs, "sharded_flash")["grads"],
                          runs[1]["flash_grads"], "qkv"):
        _close(g, r, GRAD, f"d{name}")


def _check_ring(got, ref):
    _close(got["out"], ref[0], FWD)
    for g, r, name in zip(got["grads"], ref[1], "qkv"):
        _close(g, r, GRAD, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_attention_and_grads(runs, causal):
    """The ring over a (4,) seq mesh, 16 keys a shard: forward and the
    reverse ring's gradients."""
    _check_ring(_case(runs, "ring")[f"seq{int(causal)}"],
                runs[1][f"seq{int(causal)}"])


@pytest.mark.parametrize("causal", [False, True])
def test_ring_over_tp_sharded_heads(runs, causal):
    _check_ring(_case(runs, "ring")[f"tp{int(causal)}"],
                runs[1][f"tp{int(causal)}"])


def test_ring_across_op_graph_grid_boundary(runs):
    """N 2048 over 4 ranks: 512-key shards, whose forward pairs take the op
    graph and whose backward pairs take the grid backward's function with
    the global (o, lse)."""
    _check_ring(_case(runs, "ring")["boundary"], runs[1]["boundary"])


def test_sharded_model_forward_matches_jax(runs):
    got = _case(runs, "model_forward")
    _close(got, runs[1]["model_forward"], FWD)
    _close(got, runs[1]["model_single"], dict(atol=1e-4, rtol=1e-4))


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_sequence_parallel_model_training(runs, pos):
    loss, grads = _case(runs, "sequence_parallel")[pos]
    want_loss, want = runs[1]["sp"][pos]
    _close(loss, want_loss, FWD)
    assert grads.keys() == want.keys()
    for n in grads:
        _close(grads[n], want[n], GRAD, n)


def _check_params(got, want):
    assert got.keys() == want.keys()
    for n in got:
        _close(got[n], want[n], PARAMS, n)


def test_sharded_trainer_end_to_end(runs):
    losses, params, spec = _case(runs, "trainers")["e2e"]
    want_losses, want_params = runs[1]["e2e"]
    assert losses[-1] < losses[0]
    _close(losses, want_losses, LOSS)
    _check_params(params, want_params)
    assert spec == (None, "model")


def test_sharded_trainer_scan_steps_matches_sequential(runs):
    """scan_steps (with ZeRO) over three stacked batches (one batch, three
    times) equals three step() calls (plain TP) and JAX's first three
    steps on that batch."""
    seq, scan, p_seq, p_scan = _case(runs, "trainers")["scan"]
    _close(scan, seq, dict(atol=1e-5, rtol=1e-5))
    _close(seq, runs[1]["e2e"][0][:3], LOSS)
    for n in p_seq:
        _close(p_scan[n], p_seq[n], dict(atol=1e-5, rtol=1e-5), n)
    _check_params(p_seq, runs[1]["scan_params"])


def test_zero_trainer_shards_params_and_moments_over_data(runs):
    spec, n_shard, n_moments, losses, spec_after, n_after = \
        _case(runs, "trainers")["zero"]
    assert spec == ("data", "model")
    # the model's parameter is its dp * tp = 4 times smaller block, and so
    # is each Adam moment
    assert n_shard * 4 == 128 * 256
    assert n_moments == [n_shard, n_shard]
    assert losses[-1] < losses[0]
    _close(losses, runs[1]["zero"], LOSS)
    # the updated parameter keeps its FSDP block between steps
    assert spec_after == ("data", "model") and n_after == n_shard


def test_zero_trainer_matches_plain_tp_losses(runs):
    plain, zero = _case(runs, "trainers")["zero_vs_tp"]
    for lp, lz in zip(plain, zero):
        assert abs(lp - lz) < 1e-4, (lp, lz)
    _close(plain, runs[1]["pair"], LOSS)


def test_loss_mask_uneven_across_data_ranks(runs):
    """One data rank's rows count 4 positions, the other's 64: the loss is
    the global masked mean (not the mean of the two ranks' means), and the
    update JAX's."""
    losses, params = _case(runs, "trainers")["mask"]
    want_losses, want_params = runs[1]["mask"]
    _close(losses, want_losses, LOSS)
    _check_params(params, want_params)


def test_grad_clip_under_tp(runs):
    """grad_clip=0.05 clips every step: the norm sums each split
    gradient's squares over its blocks once and a replicated one once."""
    losses, params = _case(runs, "trainers")["clip"]
    want_losses, want_params = runs[1]["clip"]
    _close(losses, want_losses, LOSS)
    _check_params(params, want_params)


def test_adafactor_under_tp(runs):
    """Adafactor's factored row / column means and RMS clipping span the
    split dims of the column- and row-parallel weights (every parameter
    but the key bias held to JAX's after two updates)."""
    losses, params = _case(runs, "trainers")["adafactor"]
    want_losses, want_params = runs[1]["adafactor"]
    _close(losses, want_losses, LOSS)
    # the key bias takes no gradient (softmax ignores a per-row constant):
    # its gradient is rounding noise of ~1e-9, which Adafactor (eps1 1e-30)
    # scales to a full-size step of either sign in either package, as in
    # tests/test_torch_adafactor.py
    noise = [n for n in params if n.endswith("k_projection.bias")]
    for n in noise:
        assert np.isfinite(params.pop(n)).all()
        want_params.pop(n)
    assert noise
    _check_params(params, want_params)


def test_moe_expert_parallel_under_data_split(runs):
    """A top-2 MoE model with its experts split over the model axis and the
    batch over the data axis (make_moe_loss, capacity factor 0.5): the
    routing's order and capacity and the load-balancing statistics are the
    global batch's, so two updates give JAX's."""
    losses, params = _case(runs, "trainers")["moe"]
    want_losses, want_params = runs[1]["moe"]
    _close(losses, want_losses, LOSS)
    _check_params(params, want_params)


def test_dropout_masks_under_tp_equal_unsharded_port(runs):
    """p 0.1 over a (2, 2) data x model mesh: each rank draws the unsharded
    port's masks at its global positions, so that two steps give the
    unsharded step's losses and parameters (the same generator seed)."""
    sharded, plain, p_sharded, p_plain = _case(runs, "trainers")["dropout"]
    _close(sharded, plain, LOSS)
    _check_params(p_sharded, p_plain)


def test_engine_tp_sharded(runs):
    """TP serving over a (4,) model mesh: logits equal JAX's dense forward,
    as JAX's TP engine's do."""
    got = _case(runs, "engines")["tp_logits"]
    for g, want in zip(got, runs[1]["dense_logits"]):
        _close(g, want, dict(atol=1e-4, rtol=1e-4))


def test_speculative_with_tp_serving(runs):
    """Draft-model speculation with the target and the draft split over the
    model axis of a (2, 2) mesh: tokens equal plain greedy, the port's and
    JAX's."""
    plain, spec, waves = _case(runs, "engines")["spec"]
    assert spec == plain
    assert plain == runs[1]["greedy"]
    assert waves > 0
