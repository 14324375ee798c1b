"""Compare checkouts of the port on one card, alternately, in one run.

    python3 tools/ab_chip_smoke.py [--phases wo,flash,serve_quant,train] ROOT_A ROOT_B ...

Each ROOT is a directory holding a ``flashattn_tpu_torch/`` package (a
``git archive`` of another commit, say).  The roots are built in parallel
(each into its own ``_build/``), then run in the order A B ... B A, each in
a process of its own that imports that root's package and this repo's
``chip_smoke.py`` phases:

* ``wo``: ``wo_matmul`` (bf16 x, int8 and fp8 payloads) at the quantized
  serving model's decode and prefill shapes: device ms (CUDA-graph replay
  for M <= 16, CUDA events above), eager ms with the host's launch
  overhead, and ``x @ W_bf16`` beside both;
* ``flash``: the bf16 flash forward at the train step's dense causal
  shape, the varlen prefill and N 16384, with SDPA beside;
* ``serve_quant``: chip_smoke's serve_quant phase (three variants, prompt
  and decode throughput, one profiled decode dispatch each);
* ``train``: chip_smoke's flash train phase (step time, peak memory, one
  profiled step), alone in its process.

Each process's full output goes to ``<log-dir>/ab_<n>_<root>.log``
(default ``workdir_ab/logs``, git-ignored); the summary lines (``[ab]``,
``[serve_quant]``, ``[train]``, the profiler's busy share) are printed.  Compare numbers only within one run: the host's clock moves
decode rates between runs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WO_SHAPES = [(4, 1024, 1024), (4, 1024, 256), (4, 256, 1024), (4, 1024, 1000),
             (16, 1024, 1024), (32768, 1024, 1024), (32768, 1024, 256),
             (32768, 256, 1024), (32768, 1024, 1000)]


def _wo(torch, cs, dev):
    from flashattn_tpu_torch.ops import quant as qt

    g = torch.Generator(device=dev).manual_seed(0)
    for payload, quantize in (("int8", qt.quantize_int8),
                              ("fp8", qt.quantize_fp8)):
        for m, k, n in WO_SHAPES:
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            w = quantize(torch.randn(k, n, generator=g, device=dev), axis=0)
            w_full = w.dequantize(torch.bfloat16)
            timer = cs.graph_ms if m <= 16 else cs.time_ms
            ms, lib = timer(lambda: qt.wo_matmul(x, w)), timer(lambda: x @ w_full)
            eager = cs.time_ms(lambda: qt.wo_matmul(x, w), host=True)
            print(f"[ab] wo_matmul {payload} ({m}, {k}) x ({k}, {n}): ms "
                  f"{ms:.4f} ({'graph' if m <= 16 else 'events'}), eager "
                  f"{eager:.4f}, x @ W_bf16 {lib:.4f}", flush=True)


FLASH_SHAPES = [("train B4 H16 N2048 D128 causal", (4, 16, 2048), None),
                ("varlen B4 H8 N2048 D128", (4, 8, 2048), [2048, 1536, 1024, 517]),
                ("B1 H2 N16384 D128 causal", (1, 2, 16384), None)]


def _flash(torch, cs, dev):
    from flashattn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    for label, (b, h, n), lens in FLASH_SHAPES:
        q, k, v = (torch.randn(b, h, n, 128, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        lens = None if lens is None else torch.tensor(lens, device=dev)
        lib, args = cs._sdpa(torch, q, k, v, True, None, lens)
        ms = cs.time_ms(lambda: fa.flash_fwd(q, k, v, causal=True,
                                             sm_scale=128 ** -0.5, kv_lengths=lens))
        print(f"[ab] flash_fwd {label}: ms {ms:.4f}, SDPA {cs.time_ms(lambda: lib(*args)):.4f}",
              flush=True)


def child(root: str, phases: list[str]) -> None:
    sys.path.insert(0, root)
    import torch

    import flashattn_tpu_torch as pt

    here = Path(pt.__file__).resolve()
    assert Path(root).resolve() in here.parents, f"imported {here}"
    sys.path.insert(1, str(REPO))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    pt.ops._build.library()
    print(f"[ab] root {root}: {here}", flush=True)
    if "wo" in phases:
        _wo(torch, cs, dev)
    if "flash" in phases:
        _flash(torch, cs, dev)
    if "train" in phases:
        cs.train_phase(torch, dev, torch.cuda.get_device_name(0))
    if "serve_quant" in phases:
        res = cs.serve_quant_phase(torch, dev)
        print("[ab] serve_quant " + json.dumps(
            {k: {m: round(v[m], 1) for m in ("prompt_tok_s", "decode_tok_s")}
             for k, v in res.items()}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--phases", default="wo,flash,serve_quant")
    ap.add_argument("--log-dir", default=str(REPO / "workdir_ab" / "logs"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")
    if args.child:
        child(args.roots[0], phases)
        return 0
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from flashattn_tpu_torch.ops import _build; _build.build()", root])
        for root in args.roots]
    if any(p.wait() for p in builds):
        print("[ab] a build failed", file=sys.stderr)
        return 1
    out = Path(args.log_dir)
    out.mkdir(parents=True, exist_ok=True)
    order = args.roots + args.roots[::-1]
    for i, root in enumerate(order):
        log = out / f"ab_{i}_{Path(root).name}.log"
        print(f"[ab] run {i}: {root}", flush=True)
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, __file__, "--child",
                                 "--phases", args.phases, root],
                                stdout=f, stderr=subprocess.STDOUT).returncode
        for line in log.read_text().splitlines():
            if line.startswith(("[ab]", "[serve_quant]", "[train]")) or "device busy" in line:
                print(line, flush=True)
        if rc != 0:
            print(f"[ab] run {i} failed (rc {rc}); see {log}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
