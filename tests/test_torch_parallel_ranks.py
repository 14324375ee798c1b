"""Rank bodies and the process launcher of the port's multi-rank tests
(tests/test_torch_parallel.py, tests/test_torch_pipeline.py).

Each rank is a process of its own (``torch.multiprocessing``'s spawn
context) in a gloo group over a ``file://`` store: it builds the port's
objects from numpy inputs, runs its shard and returns numpy results.  This
module holds no test and imports no JAX, so that the ranks do not load it.
:func:`run_ranks` joins the ranks against a deadline and kills any that
outlive it, so that a rank stuck in a collective fails its test instead of
hanging the suite.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np

DEADLINE_S = 150.0


def _rank_main(fn, rank, world, store, out_dir, args):
    import torch

    torch.set_num_threads(1)
    result = None
    try:
        from flashattn_tpu_torch.parallel import init_distributed

        init_distributed(rank, world, f"file://{store}", device="cpu")
        result = ("ok", fn(rank, world, *args))
    except Exception:  # noqa: BLE001 - the parent reports it
        result = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    try:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass


class Ranks:
    """``fn(rank, world, *args)`` running in ``world`` processes, started at
    construction, so that the caller can work meanwhile; :meth:`results`
    joins them against the deadline."""

    def __init__(self, fn, world: int, tmp_path, *args,
                 deadline: float = DEADLINE_S):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.name, self.world = fn.__name__, world
        self.out_dir = str(tmp_path)
        store = os.path.join(self.out_dir,
                             f"store_{fn.__name__}_{time.time_ns()}")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, r, world, store, self.out_dir,
                                        args))
                      for r in range(world)]
        self.end = time.monotonic() + deadline
        self.deadline = deadline
        for p in self.procs:
            p.start()

    def results(self) -> list:
        """The ranks' results in rank order; raises if a rank failed or
        outlived the deadline (every rank is then killed)."""
        try:
            for p in self.procs:
                p.join(max(0.0, self.end - time.monotonic()))
        finally:
            alive = [p for p in self.procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in alive:
                p.join(10)
        if alive:
            raise AssertionError(f"{len(alive)} of {self.world} ranks of "
                                 f"{self.name} outlived "
                                 f"{self.deadline:.0f} s")
        results = []
        for r in range(self.world):
            path = os.path.join(self.out_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise AssertionError(f"rank {r} of {self.name} exited "
                                     f"({self.procs[r].exitcode}) with no "
                                     f"result")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            os.remove(path)
            if status != "ok":
                raise AssertionError(f"rank {r} of {self.name} failed:\n"
                                     f"{value}")
            results.append(value)
        return results


def run_ranks(fn, world: int, tmp_path, *args, deadline: float = DEADLINE_S):
    """Run ``fn(rank, world, *args)`` in ``world`` processes and return
    their results in rank order (see :class:`Ranks`)."""
    return Ranks(fn, world, tmp_path, *args, deadline=deadline).results()


def _np(t):
    return t.detach().float().cpu().numpy()


def _model(cfg, params, dtype=None):
    """A port DecoderLM on the CPU with ``params`` (numpy, by JAX's names)."""
    import flashattn_tpu_torch as pt

    m = pt.DecoderLM(**cfg, device="cpu")
    pt.load_jax_params(m, params)
    return m


def _gathered_params(model, mesh):
    """``{name: numpy}`` of the model's global parameters (each block
    gathered by its spec)."""
    from flashattn_tpu_torch.parallel import unshard

    return {n: _np(unshard(p, mesh, getattr(p, "spec", ())))
            for n, p in model.named_parameters()}


def _cases(rank, world, names, inp, table):
    """Run the cases ``names`` of ``table`` in order; each case's result
    (or its traceback, as ``("error", text)``) by name."""
    out = {}
    for name in names:
        try:
            out[name] = table[name](inp)
        except Exception:  # noqa: BLE001 - reported by the test of the case
            out[name] = ("error", traceback.format_exc())
    return out


# -- test_torch_parallel.py ----------------------------------------------------


def _meshes():
    from flashattn_tpu_torch.parallel import create_mesh

    return (create_mesh((2, 2), ("data", "model"), "cpu"),
            create_mesh((4,), ("seq",), "cpu"),
            create_mesh((2, 2), ("seq", "model"), "cpu"),
            create_mesh((4,), ("model",), "cpu"))


def case_specs(inp):
    import torch

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.parallel import (P, apply_mesh, batch_sharding,
                                              default_mesh, local_shard,
                                              fsdp_sharding_tree,
                                              fsdp_spec_for, replicated,
                                              shard_model, sharding_tree,
                                              unshard)

    dm = _meshes()[0]
    out = {"fsdp": [tuple(fsdp_spec_for(path, shape, dm, min_size=ms))
                    for path, shape, ms in inp["fsdp_cases"]]}
    m = _model(inp["small_cfg"], inp["small_params"])
    dflt = default_mesh(4, devices="cpu")
    out["default_mesh"] = (tuple(dflt.shape), tuple(dflt.mesh_dim_names),
                           tuple(batch_sharding(dm)), tuple(replicated(dm)))
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    block = local_shard(x, dm, P(("data", "model")))
    out["tuple_block"] = (_np(block),
                          bool(torch.equal(unshard(block, dm,
                                                   P(("data", "model"))), x)))
    out["tree"] = {n: tuple(s) for n, s in sharding_tree(m, dm).items()}
    out["fsdp_tree"] = {n: tuple(s) for n, s in
                        fsdp_sharding_tree(m, dm, min_size=64).items()}
    sm = shard_model(m, dm)
    out["specs"] = {n: tuple(p.spec) for n, p in sm.named_parameters()}
    out["shapes"] = {n: tuple(p.shape) for n, p in sm.named_parameters()}
    out["module_spec"] = tuple(
        sm.layers[0].attention.q_projection.param_specs["weights"])
    qm = pt.quantize_model_weights(m)
    pt.load_jax_params(qm, inp["small_qparams"])
    sq = shard_model(qm, dm)
    out["qspecs"] = {n: tuple(p.spec) for n, p in sq.named_parameters()}
    out["qvalues"] = {n: _np(unshard(p, dm, p.spec))
                      for n, p in sq.named_parameters()}
    mqa = pt.DecoderLM(64, 32, 4, 16, p_dropout=0.0, n_layer=1, n_kv_head=1,
                       attn_impl="flash", device="cpu")
    try:
        apply_mesh(mqa, dm)
        out["mqa"] = None
    except ValueError as e:
        out["mqa"] = str(e)
    # the same model through the quantized TP forward (wo_matmul's plain
    # version on the local blocks)
    idx = torch.from_numpy(inp["small_idx"])
    with torch.no_grad():
        out["qlogits"] = _np(sq(idx))
    return out


def _grads_of(fn, *tensors):
    leaves = [t.detach().clone().requires_grad_() for t in tensors]
    out = fn(*leaves)
    (out.float() ** 2).sum().backward()
    return out, [t.grad for t in leaves]


def case_sharded_flash(inp):
    import torch

    from flashattn_tpu_torch.parallel import (P, local_shard,
                                              sharded_flash_attention,
                                              unshard)

    dm = _meshes()[0]
    spec = P("data", "model")
    out = {}
    for causal in (False, True):
        q, k, v = (local_shard(torch.from_numpy(a), dm, spec)
                   for a in inp["flash_qkv"])
        o = sharded_flash_attention(q, k, v, causal, mesh=dm)
        out[f"fwd{int(causal)}"] = _np(unshard(o, dm, spec))
    q, k, v = (local_shard(torch.from_numpy(a), dm, spec)
               for a in inp["flash_grad_qkv"])
    _, grads = _grads_of(lambda q, k, v: sharded_flash_attention(
        q, k, v, True, mesh=dm), q, k, v)
    out["grads"] = [_np(unshard(g, dm, spec)) for g in grads]
    return out


def _ring_case(mesh, spec, qkv, causal, head_axis=None):
    import torch

    from flashattn_tpu_torch.parallel import (local_shard,
                                              ring_flash_attention, unshard)

    q, k, v = (local_shard(torch.from_numpy(a), mesh, spec) for a in qkv)
    o, grads = _grads_of(lambda q, k, v: ring_flash_attention(
        q, k, v, causal, mesh=mesh, head_axis=head_axis), q, k, v)
    return {"out": _np(unshard(o, mesh, spec)),
            "grads": [_np(unshard(g, mesh, spec)) for g in grads]}


def case_ring(inp):
    from flashattn_tpu_torch.parallel import P

    _, sm, stm, _ = _meshes()
    out = {}
    for causal in (False, True):
        out[f"seq{int(causal)}"] = _ring_case(sm, P(None, None, "seq"),
                                              inp["ring_qkv"], causal)
        out[f"tp{int(causal)}"] = _ring_case(stm, P(None, "model", "seq"),
                                             inp["ring_tp_qkv"], causal,
                                             head_axis="model")
    out["boundary"] = _ring_case(sm, P(None, None, "seq"),
                                 inp["ring_long_qkv"], True)
    return out


def case_model_forward(inp):
    import torch

    from flashattn_tpu_torch.parallel import (P, apply_mesh, local_shard,
                                              shard_model, unshard)

    dm = _meshes()[0]
    m = _model(inp["fwd_cfg"], inp["fwd_params"])
    sm = shard_model(apply_mesh(m, dm), dm)
    idx = local_shard(torch.from_numpy(inp["fwd_idx"]), dm, P("data"))
    with torch.no_grad():
        return _np(unshard(sm(idx), dm, P("data")))


def case_sequence_parallel(inp):
    import torch

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.parallel import apply_mesh

    sm = _meshes()[1]
    tok, tgt = (torch.from_numpy(a) for a in inp["sp_data"])
    out = {}
    for pos, (cfg, params) in inp["sp_models"].items():
        m = apply_mesh(_model(cfg, params), sm, batch_axis=None,
                       head_axis=None, seq_axis="seq")
        names, ps = zip(*m.named_parameters())
        loss = pt.lm_loss(m, tok, tgt)
        grads = torch.autograd.grad(loss, ps)
        out[pos] = (loss.item(), {n: _np(g) for n, g in zip(names, grads)})
    return out


def _trainer(inp, key, mesh, **kw):
    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.training import ShardedTrainer

    cfg, params = inp["trainer_models"][key]
    model = _model(cfg, params)
    capacity = kw.pop("capacity_factor", None)
    if capacity is not None:
        for layer in model.layers:
            layer.ff.capacity_factor = capacity
    return ShardedTrainer(model, kw.pop("opt", None) or pt.Adam(lr=5e-3),
                          mesh, **kw)


def _steps(trainer, data, n, mask=None, gen=None):
    return [float(trainer.step(data[:, :-1], data[:, 1:], mask, gen))
            for _ in range(n)]


def case_trainers(inp):
    import torch

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.training import ShardedTrainer

    dm = _meshes()[0]
    d = inp["trainer_data"]
    out = {}
    t = _trainer(inp, "small", dm)
    out["e2e"] = (_steps(t, d["small"], 10), _gathered_params(t.model, dm),
                  tuple(t.model.layers[0].ff.linear_in.weights.spec))

    t_seq = _trainer(inp, "small", dm)
    t_scan = _trainer(inp, "small", dm, zero=True)
    stacked = d["small3"]
    seq = [float(t_seq.step(stacked[i, :, :-1], stacked[i, :, 1:]))
           for i in range(3)]
    scan = [float(x) for x in t_scan.scan_steps(stacked[:, :, :-1],
                                                stacked[:, :, 1:])]
    out["scan"] = (seq, scan, _gathered_params(t_seq.model, dm),
                   _gathered_params(t_scan.model, dm))

    tz = _trainer(inp, "zero", dm, zero=True)
    w = tz.model.layers[0].ff.linear_in.weights
    moments = [tz.opt_state.exp_avg["layers.0.ff.linear_in.weights"],
               tz.opt_state.exp_avg_sq["layers.0.ff.linear_in.weights"]]
    before = (tuple(w.spec), w.numel(), [m.numel() for m in moments])
    losses = _steps(tz, d["zero"], 10)
    w2 = tz.model.layers[0].ff.linear_in.weights
    out["zero"] = before + (losses, tuple(w2.spec), w2.numel())

    tp_, tz_ = (_trainer(inp, "pair", dm), _trainer(inp, "pair", dm, zero=True))
    out["zero_vs_tp"] = (_steps(tp_, d["pair"], 5), _steps(tz_, d["pair"], 5))

    tm = _trainer(inp, "small", dm)
    out["mask"] = (_steps(tm, d["small"], 2, inp["uneven_mask"]),
                   _gathered_params(tm.model, dm))
    tc = _trainer(inp, "small", dm, grad_clip=0.05)
    out["clip"] = (_steps(tc, d["small"], 2), _gathered_params(tc.model, dm))
    ta = _trainer(inp, "small", dm, opt=pt.Adafactor())
    out["adafactor"] = (_steps(ta, d["small"], 2),
                        _gathered_params(ta.model, dm))
    tmoe = _trainer(inp, "moe", dm, loss_fn=pt.make_moe_loss(0.01),
                    capacity_factor=inp["moe_capacity"])
    out["moe"] = (_steps(tmoe, d["small"], 2),
                  _gathered_params(tmoe.model, dm))

    # dropout under the split: the unsharded port's masks at each position
    cfg, params = inp["trainer_models"]["dropout"]
    td = ShardedTrainer(_model(cfg, params).train(), pt.Adam(lr=5e-3), dm)
    gen = torch.Generator().manual_seed(3)
    sharded = _steps(td, d["small"], 2, gen=gen)
    plain_m = _model(cfg, params).train()
    opt = pt.Adam(lr=5e-3)
    state = opt.init(plain_m)
    step = pt.make_train_step(opt)
    gen = torch.Generator().manual_seed(3)
    tok, tgt = (torch.from_numpy(a) for a in (d["small"][:, :-1],
                                               d["small"][:, 1:]))
    plain = []
    for _ in range(2):
        plain_m, state, loss = step(plain_m, state, tok, tgt, None, gen)
        plain.append(float(loss))
    out["dropout"] = (sharded, plain, _gathered_params(td.model, dm),
                      {n: _np(p) for n, p in plain_m.named_parameters()})
    return out


def case_engines(inp):
    import flashattn_tpu_torch as pt

    dm, _, _, mm = _meshes()
    out = {}
    cfg, params = inp["serve_model"]
    eng = pt.ContinuousBatchingEngine(_model(cfg, params), max_batch=2,
                                      page_size=16, pages_per_seq=3,
                                      mesh=mm, collect_logits=True)
    reqs = [eng.submit(t, 1) for t in inp["serve_prompts"]]
    eng.run()
    out["tp_logits"] = [np.stack([np.asarray(x) for x in r.logits])
                        for r in reqs]

    (tcfg, tparams), (dcfg, dparams) = inp["spec_models"]
    prompts, maxnews = inp["spec_prompts"]
    kw = dict(max_batch=3, page_size=8, pages_per_seq=4)

    def run(**extra):
        e = pt.ContinuousBatchingEngine(_model(tcfg, tparams).eval(), **kw,
                                        **extra)
        rs = [e.submit(p, n) for p, n in zip(prompts, maxnews)]
        e.run()
        assert e.pool.n_free == e.pool.total
        return [list(r.generated) for r in rs], e

    plain, _ = run(steps_per_dispatch=1)
    spec, e = run(draft_model=_model(dcfg, dparams).eval(), spec_len=3,
                  mesh=dm)
    out["spec"] = (plain, spec, e.spec_stats[1])
    return out


PARALLEL_CASES = {
    "specs": case_specs,
    "sharded_flash": case_sharded_flash,
    "ring": case_ring,
    "model_forward": case_model_forward,
    "sequence_parallel": case_sequence_parallel,
    "trainers": case_trainers,
    "engines": case_engines,
}


def parallel_ranks(rank, world, inp):
    return _cases(rank, world, list(PARALLEL_CASES), inp, PARALLEL_CASES)


# -- test_torch_pipeline.py ------------------------------------------------------


def _mlp_layer(p, x):
    import torch

    return x + torch.tanh(x @ p["w"] + p["b"])


def _torch_layers(layers):
    import torch

    return [{k: torch.from_numpy(v) for k, v in p.items()} for p in layers]


def _pipe_grads(pipe, mesh, specs):
    """The pipeline's local parameter gradients gathered to the stacked
    global shapes."""
    from flashattn_tpu_torch.parallel import unshard

    return {n: _np(unshard(p.grad, mesh, specs[n])) for n, p in pipe.items()}


def _mb_block(t, mesh, n_mb, data_axis):
    """This rank's rows of a global (batch, ...) tensor in the pipeline's
    microbatch layout (dim 1 of (M, mb, ...) split over ``data_axis``)."""
    from flashattn_tpu_torch.parallel import P, local_shard

    mb = t.reshape((n_mb, -1) + tuple(t.shape[1:]))
    return local_shard(mb, mesh, P(None, data_axis)).reshape(
        (-1,) + tuple(t.shape[1:]))


def _mb_gather(t, mesh, n_mb, data_axis):
    from flashattn_tpu_torch.parallel import P, unshard

    mb = t.reshape((n_mb, -1) + tuple(t.shape[1:]))
    return unshard(mb, mesh, P(None, data_axis)).reshape(
        (-1,) + tuple(t.shape[1:]))


def case_pipeline_sequential(inp):
    import torch

    from flashattn_tpu_torch.parallel import (P, create_mesh, pipeline_apply,
                                              scan_stage_fn,
                                              shard_stage_params,
                                              split_layers_into_stages,
                                              stack_stage_params)

    world = torch.distributed.get_world_size()
    out = {}
    for key, (n_stages, layers, x, n_mb) in inp["sequential"].items():
        if world == 8 and n_stages != 8 or world == 4 and n_stages == 8:
            continue
        mesh = (create_mesh((n_stages,), ("stage",), "cpu")
                if n_stages == world else
                create_mesh((world // n_stages, n_stages), ("data", "stage"),
                            "cpu"))
        stacked = stack_stage_params(split_layers_into_stages(
            _torch_layers(layers), n_stages))
        local = shard_stage_params(stacked, mesh)
        with torch.no_grad():
            y = pipeline_apply(scan_stage_fn(_mlp_layer), local,
                               torch.from_numpy(x), mesh,
                               n_microbatches=n_mb)
        out[key] = _np(y)
    if world == 4:
        try:
            mesh = create_mesh((4,), ("stage",), "cpu")
            stacked = stack_stage_params(split_layers_into_stages(
                _torch_layers(inp["grad"][0]), 2))
            pipeline_apply(scan_stage_fn(_mlp_layer), stacked,
                           torch.zeros(10, 4), mesh, n_microbatches=3)
            out["bad_microbatch"] = None
        except ValueError as e:
            out["bad_microbatch"] = str(e)
    return out


def case_pipeline_grad(inp):
    import torch

    from flashattn_tpu_torch.parallel import (P, create_mesh, pipeline_apply,
                                              scan_stage_fn,
                                              shard_stage_params,
                                              split_layers_into_stages,
                                              stack_stage_params)

    layers, x, tgt = inp["grad"]
    mesh = create_mesh((4,), ("stage",), "cpu")
    stacked = stack_stage_params(split_layers_into_stages(
        _torch_layers(layers), 4))
    local = shard_stage_params(stacked, mesh)
    xt = torch.from_numpy(x).requires_grad_()
    out = pipeline_apply(scan_stage_fn(_mlp_layer), local, xt, mesh,
                         n_microbatches=8)
    loss = ((out - torch.from_numpy(tgt)) ** 2).mean()
    loss.backward()
    return (loss.item(), _pipe_grads(local, mesh, {n: P("stage")
                                                   for n in local}),
            _np(xt.grad))


def case_pipeline_composed(inp):
    import torch

    from flashattn_tpu_torch.parallel import (P, create_mesh, pipeline_apply,
                                              scan_stage_fn,
                                              shard_stage_params,
                                              split_layers_into_stages,
                                              stack_stage_params)
    from flashattn_tpu_torch.parallel.comm import (copy_to_group,
                                                   reduce_from_group)
    from flashattn_tpu_torch.parallel.mesh import axis_group

    layers, x, tgt, n_mb = inp["composed"]
    mesh = create_mesh((2, 2, 2), ("data", "stage", "model"), "cpu")
    tp = axis_group(mesh, "model")

    def tp_mlp(p, h):
        u = torch.tanh(copy_to_group(h, tp) @ p["w1"])
        return h + reduce_from_group(u @ p["w2"], tp)

    specs = {"w1": P("stage", None, None, "model"),
             "w2": P("stage", None, "model", None)}
    stacked = stack_stage_params(split_layers_into_stages(
        _torch_layers(layers), 2))
    local = shard_stage_params(stacked, mesh, "stage", specs)
    xl = _mb_block(torch.from_numpy(x), mesh, n_mb, "data")
    tl = _mb_block(torch.from_numpy(tgt), mesh, n_mb, "data")
    out = pipeline_apply(scan_stage_fn(tp_mlp), local, xl, mesh,
                         n_microbatches=n_mb, data_axis="data",
                         param_specs=specs)
    sq = reduce_from_group(((out - tl) ** 2).sum(), axis_group(mesh, "data"))
    loss = sq / tgt.size
    loss.backward()
    return loss.item(), _pipe_grads(local, mesh, specs)


def case_pipeline_megatron(inp):
    import torch

    from flashattn_tpu_torch.parallel import (create_mesh,
                                              megatron_layer_fn,
                                              megatron_stage_specs,
                                              pipeline_apply, scan_stage_fn,
                                              shard_stage_params,
                                              split_layers_into_stages,
                                              stack_stage_params)

    cfg, params, tokens = inp["megatron"]
    model = _model(cfg, params)
    mesh = create_mesh((2, 2, 2), ("data", "stage", "model"), "cpu")
    stacked = stack_stage_params(split_layers_into_stages(model.layers, 2))
    specs = megatron_stage_specs(model.layers[0], "stage", "model")
    local = shard_stage_params(stacked, mesh, "stage", specs)
    layer_fn = megatron_layer_fn(model.layers[0], "model")
    tok = torch.from_numpy(tokens)
    pos = torch.arange(tok.shape[1])[None, :]
    x = _mb_block(model._embed(tok, pos), mesh, 4, "data")
    h = pipeline_apply(scan_stage_fn(layer_fn), local, x, mesh,
                       n_microbatches=4, data_axis="data", param_specs=specs)
    logits = model.lm_head(model.ln(h))
    (logits ** 2).sum().backward()
    got = _np(_mb_gather(logits.detach(), mesh, 4, "data"))
    return got, _pipe_grads(local, mesh, specs)


PIPELINE4_CASES = {"sequential": case_pipeline_sequential,
                   "grad": case_pipeline_grad}
PIPELINE8_CASES = {"sequential": case_pipeline_sequential,
                   "composed": case_pipeline_composed,
                   "megatron": case_pipeline_megatron}


def pipeline_ranks(rank, world, inp):
    table = PIPELINE4_CASES if world == 4 else PIPELINE8_CASES
    return _cases(rank, world, list(table), inp, table)
