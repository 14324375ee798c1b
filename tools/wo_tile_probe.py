"""Where the time of ``wo_matmul``'s tensor-core tile goes, on the card.

    python3 tools/wo_tile_probe.py

Builds ``csrc/wo_matmul.cu`` several times, each time with parts of the
tensor-core tile (bf16 x, M > 16) compiled out, and times each build's
``fa_wo_matmul`` at the quantized serving model's prefill shapes beside
``x @ W_bf16`` (CUDA events: the mean of two medians of 20, the builds
taken in turn forward, then backward).  The parts:

* ``x``: the TMA loads of the x tile and the waits for them;
* ``wload``: the cp.async loads of the weight bytes;
* ``convert``: the conversion of the weight bytes to the bf16 B tile;
* ``wgmma``: the products;
* ``store``: the epilogue's stores of y (from shared memory to device
  memory).

A build without a part computes garbage, fast or slow; only its time means
anything.  Needs nvcc and one H100; prints one line per shape.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "flashattn_tpu_torch" / "csrc"
# the source text each part spans in the tile kernel
PARTS = {
    "x": ["""      if (tid == 0) {
        const uint32_t bar = hop::smem_u32(&bars[s]);
        hop::mbar_expect_tx(bar, X_TILE);
        hop::tma_load_2d(hop::smem_u32(xs + s * X_TILE), &xmap, bar, t * TC_BK, m0);
      }
""", """    hop::mbar_wait(hop::smem_u32(&bars[s]), (t / TC_STAGES) & 1);
"""],
    "wload": ["""      load_w_tile<VEC>(ws + s * W_TILE, w, t * TC_BK, n0, K, N);
"""],
    "convert": ["""      convert_w_tile<W>(ws + ((t + 1) % TC_STAGES) * W_TILE, bs + ((t + 1) % TC_BUFS) * B_TILE);
"""],
    "wgmma": ["""#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      const uint64_t b = hop::desc<128>(b0 + ks * 16 * 128, B_REGION, 1024);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        hop::wgmma_ss<1>(acc[hf], hop::desc<128>(a0 + hf * 64 * 128 + ks * 32, 16, 1024), b,
                         1);
    }
"""],
    "store": ["""    if (N % 8 == 0) {
      *reinterpret_cast<uint4*>(out) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int q = 0; q < 8 && col + q < N; ++q) out[q] = e[q];
    }
"""],
}
BUILDS = {"full": [], "-wgmma": ["wgmma"], "-store": ["store"],
          "-wload-convert": ["wload", "convert"], "-x": ["x"],
          "-x-wload-convert": ["x", "wload", "convert"],
          "-x-wload-convert-wgmma": ["x", "wload", "convert", "wgmma"]}
SHAPES = [(32768, 1024, 1024), (32768, 256, 1024), (32768, 1024, 256)]


def variant(src: str, off: list[str]) -> str:
    for part in off:
        for text in PARTS[part]:
            if src.count(text) != 1:
                raise SystemExit(f"part {part!r}: its text is not in wo_matmul.cu "
                                 f"exactly once; update PARTS")
            src = src.replace(text, f"#if 0  // probe: no {part}\n{text}#endif\n")
    return src


def build(tmp: Path, name: str, off: list[str]) -> Path:
    cu, lib = tmp / f"wo{name}.cu", tmp / f"wo{name}.so"
    cu.write_text(variant((CSRC / "wo_matmul.cu").read_text(), off))
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", str(CSRC),
                    str(cu), "-o", str(lib)], check=True)
    return lib


def time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wo_tile_probe: needs a CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(BUILDS)) as ex:
            libs = dict(zip(BUILDS, ex.map(lambda kv: build(Path(tmp), *kv), BUILDS.items())))
        fns = {}
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).fa_wo_matmul
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fns[name] = fn
        g = torch.Generator(device="cuda").manual_seed(0)
        for m, k, n in SHAPES:
            x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
            w = torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
            s = torch.rand(n, generator=g, device="cuda")
            y = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
            w_bf16 = w.to(torch.bfloat16)
            st = torch.cuda.current_stream().cuda_stream
            ms = {name: [] for name in fns}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    call = lambda f=fns[name]: f(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                                                 y.data_ptr(), m, n, k, 1, 2, st)
                    if call() != 0:
                        raise SystemExit(f"{name}: launch failed")
                    ms[name].append(time_ms(call))
            print(f"[probe] ({m}, {k}) x ({k}, {n}) int8: x @ W_bf16 "
                  f"{time_ms(lambda: x @ w_bf16):.4f} ms; "
                  + "; ".join(f"{name} {statistics.mean(v):.4f}" for name, v in ms.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
