#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flashattn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: requires CUDA (there is no CPU path); TF32 off; prints the card's
   name and power limit as nvidia-smi reports them.
2. build: compiles ``flashattn_tpu_torch/csrc/*.cu`` with nvcc for sm_90a.
3. kernels: every kernel of the serving path against its plain PyTorch
   version at the serving shapes, bf16 and f32 (tolerance: f32 1e-4 abs,
   bf16 2e-2 abs on unit-variance inputs, compared in f32), with kernel and
   plain times (CUDA events, median of 15 runs).
4. serve: the north-star serving model (E1024, 8 heads of 128, 4 layers,
   vocab 1000, middle 256) in bf16 with seeded random weights, driven
   through ContinuousBatchingEngine.submit()/step(): five greedy requests,
   four sharing one batched varlen prefill (2048/1536/1024/517 tokens) and
   a fifth of 3000 tokens admitted when a slot frees (chunked prefill).
   Every kernel's launch count is zeroed just before and must grow.
5. consistency: the same model in f32; engine logits along two ~600-token
   trajectories (one batched, one chunked prefill) against one dense
   DecoderLM.forward, to 1e-3 abs.

Prints one ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the north-star serving model (kernel_bench/bench_serving.py:112-115)
MODEL = dict(n_vocab=1000, n_embd=1024, n_head=8, n_positions=4096,
             n_layer=4, p_dropout=0.0, attn_impl="flash")
ENGINE = dict(max_batch=4, page_size=128, pages_per_seq=32,
              prefill_chunk=2048, steps_per_dispatch=8)
PROMPTS = (2048, 1536, 1024, 517, 3000)
NEW_TOKENS = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 15) -> float:
    """Median of ``reps`` CUDA-event timings of fn(), after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Phases:
    """Kernel-vs-plain checks: one printed line per phase, and the main-shape
    numbers per kernel for the ``kernels`` line."""

    def __init__(self):
        self.main = {}

    def check(self, kernel: str, label: str, dtype, run_kernel, run_plain,
              main: bool = False, compare=None):
        import torch

        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err = (compare or _max_err)(got, want)
        ms, plain_ms = time_ms(run_kernel), time_ms(run_plain)
        name = str(dtype).replace("torch.", "")
        ok = err <= TOL[name]
        log(f"[kernel] {kernel:14s} {label:34s} {name:8s} max_abs_err={err:.3e}"
            f" ms={ms:.4f} plain_ms={plain_ms:.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} {label} {name}: max |err| {err} "
                                 f"over tolerance {TOL[name]}")
        if main:
            self.main[kernel] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _lse_err(got, want) -> float:
    """max |err| over (o, lse); -inf lse entries must coincide."""
    (o, lse), (o_ref, lse_ref) = got, want
    fin = lse_ref.isfinite()
    if not bool((lse.isfinite() == fin).all()):
        return math.inf
    return max(_max_err(o, o_ref), _max_err(lse[fin], lse_ref[fin]))


def kernel_phases(torch, dev) -> Phases:
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.ops import layernorm as ln
    from flashattn_tpu_torch.ops import paged_attention as pa

    ph = Phases()
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        # fused LayerNorm at the serving rows x width
        x = randn(8192, 1024, dtype=dtype)
        gam, bet = randn(1024, dtype=dtype), randn(1024, dtype=dtype)
        ph.check("layernorm_fwd", "rows 8192 h 1024", dtype,
                 lambda: ln.layernorm_fwd(x, gam, bet)[0],
                 lambda: ln.layernorm_reference(x, gam, bet), main=main)

        # flash: batched varlen prefill B4 H8 N2048 D128
        lens = torch.tensor([2048, 1536, 1024, 517], device=dev)
        q, k, v = (randn(4, 8, 2048, 128, dtype=dtype) for _ in range(3))
        scale = 128 ** -0.5
        ph.check("flash_fwd", "B4 H8 N2048 D128 causal varlen", dtype,
                 lambda: fa.flash_fwd(q, k, v, causal=True, sm_scale=scale,
                                      kv_lengths=lens),
                 lambda: fa._reference_fwd_with_lse(q, k, v, True, scale, lens),
                 main=main, compare=_lse_err)

        # paged decode: B4, 8 kv heads, d128, page 128, histories <= 2048
        n_pages, pps = 4 * 16 + 1, 16
        kp, vp = (randn(8, n_pages, 128, 128, dtype=dtype) for _ in range(2))
        table = torch.randperm(n_pages, generator=g, device=dev)[:4 * pps]
        table = table.reshape(4, pps).int()
        qd = randn(4, 8, 128, dtype=dtype)
        ph.check("paged_attention", "decode B4 Hkv8 d128 page128", dtype,
                 lambda: pa.paged_attention(qd, kp, vp, lens, table),
                 lambda: pa.paged_attention_reference(qd, kp, vp, lens, table),
                 main=main)

    bf = torch.bfloat16
    # flash variants at the prefill shape
    q, k, v = (randn(4, 8, 2048, 128, dtype=bf) for _ in range(3))
    k2, v2 = (randn(4, 2, 2048, 128, dtype=bf) for _ in range(2))
    lens = torch.tensor([2048, 1536, 1024, 517], device=dev)
    lens0 = torch.tensor([2048, 0, 1024, 517], device=dev)
    q32, k32, v32 = (randn(4, 8, 2048, 32, dtype=bf) for _ in range(3))
    variants = [
        ("GQA 8q/2kv varlen", (q, k2, v2), dict(kv_lengths=lens)),
        ("window 256 varlen", (q, k, v), dict(kv_lengths=lens, window=256)),
        ("D32 varlen", (q32, k32, v32), dict(kv_lengths=lens)),
        ("len=0 row", (q, k, v), dict(kv_lengths=lens0)),
        ("dense causal, no lengths", (q, k, v), {}),
    ]
    for label, (a, b_, c), kw in variants:
        sc = a.shape[-1] ** -0.5
        ph.check("flash_fwd", label, bf,
                 lambda: fa.flash_fwd(a, b_, c, causal=True, sm_scale=sc, **kw),
                 lambda: fa._reference_fwd_with_lse(
                     a, b_, c, True, sc, kw.get("kv_lengths"), kw.get("window")),
                 compare=_lse_err)

    # paged: chunk 64, GQA group 4, and the 2048-token chunked-prefill wave
    n_pages, pps = 4 * 16 + 1, 16
    kp, vp = (randn(8, n_pages, 128, 128, dtype=bf) for _ in range(2))
    table = torch.randperm(n_pages, generator=g, device=dev)[:4 * pps]
    table = table.reshape(4, pps).int()
    # (lengths count the chunk, so a 2048-token wave from base 0 has 2048)
    wave = torch.full((4,), 2048, device=dev)
    for label, q_, ln_ in [
            ("chunk 64", randn(4, 64, 8, 128, dtype=bf), lens),
            ("decode GQA group 4", randn(4, 32, 128, dtype=bf), lens),
            ("extend wave chunk 2048", randn(4, 2048, 8, 128, dtype=bf), wave)]:
        ph.check("paged_attention", label, bf,
                 lambda: pa.paged_attention(q_, kp, vp, ln_, table),
                 lambda: pa.paged_attention_reference(q_, kp, vp, ln_, table))
    return ph


def kernel_counters():
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.ops import layernorm as ln
    from flashattn_tpu_torch.ops import paged_attention as pa

    return {"layernorm_fwd": ln._kernel, "flash_fwd": fa._kernel,
            "paged_attention": pa._kernel}


def serve_phase(torch, model, dev) -> dict:
    import numpy as np

    from flashattn_tpu_torch import ContinuousBatchingEngine

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, MODEL["n_vocab"], n).tolist() for n in PROMPTS]

    # warm-up on the same paths (batched prefill, chunked prefill, decode)
    warm = ContinuousBatchingEngine(model, dtype=torch.bfloat16, **ENGINE)
    warm.submit(prompts[3][:300], 9)
    warm.run()
    warm.submit(prompts[4][:2100], 9)
    warm.run()
    del warm

    eng = ContinuousBatchingEngine(model, dtype=torch.bfloat16, **ENGINE)
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    counters = kernel_counters()
    for kern in counters.values():
        kern.launches = 0
    prompt_tok = decode_tok = 0
    prefill_s = decode_s = 0.0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    while True:
        queued = {id(r) for r in eng.queue}
        gen_before = sum(len(r.generated) for r in reqs)
        t0 = time.perf_counter()
        progressed = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not progressed:
            break
        admitted = [r for r in reqs if id(r) in queued and r not in eng.queue]
        if admitted:
            prefill_s += dt
            prompt_tok += sum(len(r.prompt) for r in admitted)
        else:
            decode_s += dt
            decode_tok += sum(len(r.generated) for r in reqs) - gen_before
    wall_ms = (time.perf_counter() - t_start) * 1e3
    launches = {name: kern.launches for name, kern in counters.items()}

    for r in reqs:
        assert r.done and not r.truncated, f"request {r.uid} did not finish"
        assert len(r.generated) == NEW_TOKENS, (r.uid, len(r.generated))
        assert all(0 <= t < MODEL["n_vocab"] for t in r.generated)
        assert all(math.isfinite(lp) and lp <= 0 for lp in r.token_logprobs)
    assert eng.pool.n_free == eng.pool.total, "pages leaked"
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the serving path"
    out = dict(prompt_tok_s=prompt_tok / prefill_s,
               decode_tok_s=decode_tok / decode_s, wall_ms=wall_ms,
               prompt_tokens=prompt_tok, decode_tokens=decode_tok,
               launches=launches)
    log(f"[serve] {torch.cuda.get_device_name(0)} bf16 E1024 8x128 L4: "
        f"prompt {prompt_tok} tok in {prefill_s * 1e3:.1f} ms "
        f"({out['prompt_tok_s']:.1f} tok/s), decode {decode_tok} tok in "
        f"{decode_s * 1e3:.1f} ms ({out['decode_tok_s']:.1f} tok/s), "
        f"wall {wall_ms:.1f} ms, launches {launches}")
    return out


def consistency_phase(torch, model, dev) -> float:
    import numpy as np

    from flashattn_tpu_torch import ContinuousBatchingEngine

    rng = np.random.default_rng(SEED + 1)
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=128,
                                   pages_per_seq=8, prefill_chunk=512,
                                   collect_logits=True)
    # 500-token prompt: batched prefill; 600-token prompt: chunked prefill
    reqs = [eng.submit(rng.integers(0, MODEL["n_vocab"], 500).tolist(), 100),
            eng.submit(rng.integers(0, MODEL["n_vocab"], 600).tolist(), 8)]
    eng.run()
    err = 0.0
    with torch.inference_mode():
        for r in reqs:
            traj = r.prompt + r.generated[:-1]
            dense = model(torch.tensor([traj], device=dev))[0].float().cpu()
            got = torch.from_numpy(np.stack(r.logits))
            assert got.shape == dense.shape, (got.shape, dense.shape)
            err = max(err, float((got - dense).abs().max()))
    log(f"[consistency] f32 engine vs dense forward over "
        f"{[len(r.prompt) + len(r.generated) - 1 for r in reqs]} positions: "
        f"max_abs_err={err:.3e}")
    if not err <= 1e-3:
        raise AssertionError(f"engine logits differ from dense by {err}")
    return err


SOURCES = {
    "layernorm_fwd": ("flashattn_tpu_torch/csrc/layernorm.cu",
                      ["flashattn_tpu/ops/layernorm.py:47"]),
    "flash_fwd": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                  ["flashattn_tpu/ops/flash_attention.py:627",
                   "flashattn_tpu/ops/flash_attention.py:79"]),
    "paged_attention": ("flashattn_tpu_torch/csrc/paged_attention.cu",
                        ["flashattn_tpu/ops/paged_attention.py:119",
                         "flashattn_tpu/ops/paged_attention.py:34"]),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    if not (REPO / "flashattn_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: flashattn_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"[device] {smi.stdout.strip().splitlines()[0]}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    from flashattn_tpu_torch import DecoderLM
    from flashattn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[build] {lib.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")

    phases = kernel_phases(torch, dev)

    model = DecoderLM(**MODEL, generator=torch.Generator().manual_seed(SEED),
                      device=dev).eval()
    serve = serve_phase(torch, copy.deepcopy(model).to(torch.bfloat16), dev)
    consistency_phase(torch, model, dev)

    kernels = []
    for name, (src, tpu) in SOURCES.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=tpu[0], counterparts=tpu,
                            launches=serve["launches"][name],
                            **phases.main[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
