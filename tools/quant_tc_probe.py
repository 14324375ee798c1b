"""The quantized kernels' tensor-core routes on the card: registers and
spills, and where the f32 weight-only matmul's time goes.

    python3 tools/quant_tc_probe.py [--ptxas] [--split]

* ``--ptxas``: compiles ``kv8_flash.cu`` and ``wo_matmul.cu`` with
  ``-Xptxas -v`` and prints each kernel's registers, spills and shared
  memory;
* ``--split``: ``int8_weight_only_matmul`` with f32 x at the serving
  model's prefill shapes under torch.profiler: the device ms of the split
  pass (x's three bf16 pieces) and of the tensor-core tile a call.  The
  kernels' times against the library calls: ``tools/ab_chip_smoke.py
  --phases kv8,wo`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

WO_PREFILL = [(32768, 1024, 1024), (32768, 1024, 1000), (32768, 256, 1024)]


def ptxas() -> None:
    from ptxas_report import report

    if report(["kv8_flash.cu", "wo_matmul.cu"], None):
        raise SystemExit("nvcc failed")


def split() -> None:
    import torch

    from flashattn_tpu_torch.ops import quant as qt

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in WO_PREFILL:
        x = torch.randn(m, k, generator=g, device=dev)
        w = qt.quantize_int8(torch.randn(k, n, generator=g, device=dev), axis=0)
        print(f"[probe] wo_matmul f32 int8 ({m}, {k}) x ({k}, {n}):", flush=True)
        _profile(torch, lambda: qt.wo_matmul(x, w))


def _profile(torch, fn, calls: int = 5) -> None:
    """Device ms a call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in by_name.items():
        short = name.split("(anonymous namespace)::", 1)[-1]
        print(f"[probe]   {short[:70]}: {us / calls / 1e3:.4f} ms a call", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    if args.ptxas:
        ptxas()
    if args.split:
        split()
    return 0


if __name__ == "__main__":
    sys.exit(main())
