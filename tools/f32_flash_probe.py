"""The f32 flash kernels on the card, both split-precision routes: the wgmma
kernels behind a split pass (from ``F32_TC_MIN_KV`` keys) and the
warp-level mma.sync kernels sized to the rows (below it, and behind the
wgmma kernels where an input holds a +-inf).

    python3 tools/f32_flash_probe.py [--ptxas] [--check] [--time] [--diag] [--inf]

* ``--ptxas``: compiles ``flash_fwd.cu`` and ``flash_bwd_f32.cu`` with
  ``-Xptxas -v`` and prints the registers, spills and shared memory of
  their f32 kernels;
* ``--check``: the forward and backward of both routes against their plain
  versions (``flash_fwd_plain``, ``flash_bwd_plain``) at ragged shapes,
  each launch counted on the route's own counter;
* ``--time``: device ms of the forward and backward of both routes, with
  SDPA's f32 call (and its backward) beside, from the MT model's 40 keys to
  the train shape's 2048: the crossover behind ``F32_TC_MIN_KV``; the two
  routes' calls alternate (wgmma, mma, mma, wgmma) and each time is the
  mean of its pair;
* ``--inf``: both routes with a +-inf in q, K, V or dO against the plain
  versions, the NaN / inf counts of o, lse, dq, dk and dv and where they
  differ.

The route is forced through ``F32_TC_MIN_KV`` (0: every shape on the wgmma
kernels; a huge value: every shape on the warp-level kernels).
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(1, str(REPO / "tools"))

# (label, (b, h, h_kv, n_q, n_kv, d), causal, lengths, window)
CHECKS = [
    ("loop B1 H2 N2048 D128 causal", (1, 2, 2, 2048, 2048, 128), True, None, None),
    ("subrow B1 H2 N1024 D128 causal", (1, 2, 2, 1024, 1024, 128), True, None, None),
    ("ragged N130 D64 causal", (2, 4, 4, 130, 130, 64), True, None, None),
    ("varlen GQA 8/2 len-0 N600 D128", (2, 8, 2, 600, 600, 128), True, [600, 0], None),
    ("window 256 N1000 D64", (1, 2, 2, 1000, 1000, 64), True, None, 256),
    ("cross 1000 x 2048 D128", (1, 2, 2, 1000, 2048, 128), False, None, None),
    ("cross 37 x 150 D32", (2, 2, 1, 37, 150, 32), False, None, None),
]
# (label, (b, h, n, d), causal)
TIMES = [
    ("MT B128 H8 N40 D32 causal", (128, 8, 40, 32), True),
    ("B64 H8 N128 D32 causal", (64, 8, 128, 32), True),
    ("distill B16 H2 N128 D64 causal", (16, 2, 128, 64), True),
    ("B32 H8 N256 D64 causal", (32, 8, 256, 64), True),
    ("B16 H16 N512 D128 causal", (16, 16, 512, 128), True),
    ("B4 H16 N1024 D128 causal", (4, 16, 1024, 128), True),
    ("train B4 H16 N2048 D128 causal", (4, 16, 2048, 128), True),
]


def ptxas() -> None:
    from flashattn_tpu_torch.ops import _build

    csrc = REPO / "flashattn_tpu_torch" / "csrc"
    failed = []
    for src in ("flash_fwd.cu", "flash_bwd_f32.cu"):
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc),
             "-c", str(csrc / src), "-o", "/dev/null"],
            capture_output=True, text=True)
        keep = False
        for line in (res.stdout + res.stderr).splitlines():
            if "Compiling entry function" in line:
                keep = any(n in line for n in ("f32_kernel", "split_kernel", "f32_mma"))
            if keep:
                print(f"[ptxas] {line.strip()}", flush=True)
        if res.returncode:
            print(res.stderr[-6000:], flush=True)
            failed.append(src)
    if failed:
        raise SystemExit(f"nvcc failed on {failed}")


def _inputs(torch, dev, g, b, h, h_kv, n_q, n_kv, d):
    q, do = (torch.randn(b, h, n_q, d, generator=g, device=dev) for _ in range(2))
    k, v = (torch.randn(b, h_kv, n_kv, d, generator=g, device=dev) for _ in range(2))
    return q, k, v, do


def check(torch, dev) -> None:
    from flashattn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    keep = fa.F32_TC_MIN_KV
    for label, (b, h, h_kv, n_q, n_kv, d), causal, lens, window in CHECKS:
        q, k, v, do = _inputs(torch, dev, g, b, h, h_kv, n_q, n_kv, d)
        lens = None if lens is None else torch.tensor(lens, device=dev)
        sc = d ** -0.5
        kw = dict(causal=causal, sm_scale=sc, kv_lengths=lens, window=window)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, sc, lens, window)
        for route, min_kv in (("wgmma", 0), ("mma", 1 << 30)):
            fa.F32_TC_MIN_KV = min_kv
            counts = [c.launches for c in (fa._f32_mma_kernel, fa._f32_kernel,
                                           fa._f32_mma_bwd_kernel, fa._f32_bwd_kernel)]
            o, lse = fa.flash_fwd(q, k, v, **kw)
            di = (o.float() * do.float()).sum(-1, keepdim=True)
            got = fa.flash_bwd(q, k, v, lse, di, do, **kw)
            torch.cuda.synchronize()
            want = fa.flash_bwd_plain(q, k, v, lse, di, do, causal, sc, lens, window)
            fin = lse_ref.isfinite()
            e_o = float((o - o_ref).abs().max())
            e_lse = float((lse[fin] - lse_ref[fin]).abs().max())
            e_g = [float((a - w).abs().max()) for a, w in zip(got, want)]
            delta = [c.launches - n for c, n in zip(
                (fa._f32_mma_kernel, fa._f32_kernel, fa._f32_mma_bwd_kernel,
                 fa._f32_bwd_kernel), counts)]
            print(f"[check] {label} {route}: o {e_o:.3e} lse {e_lse:.3e} "
                  f"dq {e_g[0]:.3e} dk {e_g[1]:.3e} dv {e_g[2]:.3e}; launches "
                  f"(mma fwd, wgmma fwd, mma bwd, wgmma bwd) {delta}; finite "
                  f"{bool(torch.isfinite(o).all())} "
                  f"{all(bool(torch.isfinite(t).all()) for t in got)}", flush=True)
    fa.F32_TC_MIN_KV = keep


def times(torch, dev) -> None:
    import chip_smoke as cs
    from flashattn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(1)
    keep = fa.F32_TC_MIN_KV
    for label, (b, h, n, d), causal in TIMES:
        q, k, v, do = _inputs(torch, dev, g, b, h, h, n, n, d)
        sc = d ** -0.5
        line = f"[time] {label}:"
        got = {"wgmma": [], "mma": []}
        for route in ("wgmma", "mma", "mma", "wgmma"):
            fa.F32_TC_MIN_KV = 0 if route == "wgmma" else 1 << 30
            o, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc)
            di = (o.float() * do.float()).sum(-1, keepdim=True)
            fwd = cs.time_ms(lambda: fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc))
            bwd = cs.time_ms(lambda: fa.flash_bwd(q, k, v, lse, di, do, causal=causal,
                                                  sm_scale=sc))
            got[route].append((fwd, bwd))
        for route, ((f1, b1), (f2, b2)) in got.items():
            line += (f" {route} fwd {(f1 + f2) / 2:.4f} ({f1:.4f} {f2:.4f}) bwd "
                     f"{(b1 + b2) / 2:.4f} ({b1:.4f} {b2:.4f});")
        lib, args = cs._sdpa(torch, q, k, v, causal, None, None)
        line += (f" SDPA fwd {cs.time_ms(lambda: lib(*args)):.4f} bwd "
                 f"{cs.time_ms(cs._sdpa_bwd(torch, q, k, v, do, causal, None, None)):.4f}")
        for tag, bwd_ in (("fwd", False), ("bwd", True)):
            b_ms, b_by = cs.bound_ms(*cs._flash_cost(q, k, causal, None, None, bwd_),
                                     "float32")
            line += f"; {tag} bound {b_ms:.4f} ({b_by})"
        print(line, flush=True)
        if label.startswith("train"):
            import ab_chip_smoke as ab

            fa.F32_TC_MIN_KV = 0
            print(f"[time] {label} wgmma by kernel, fwd: " + ab._kernel_split(
                torch, lambda: fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc))
                + "; bwd: " + ab._kernel_split(torch, lambda: fa.flash_bwd(
                    q, k, v, lse, di, do, causal=causal, sm_scale=sc)), flush=True)
        del q, k, v, do
    fa.F32_TC_MIN_KV = keep


def diag(torch, dev) -> None:
    """Where the split kernels' error comes from, at the loop shape B1 H2
    N2048 D128 causal: each route against a float64 evaluation of the same
    formulas, the backward given its forward's lse and di and given the
    float64 ones."""
    import chip_smoke as cs
    from flashattn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = _inputs(torch, dev, g, 1, 2, 2, 2048, 2048, 128)
    sc = 128 ** -0.5
    o64, lse64, *exact = cs._f64_flash(torch, q[0], k[0], v[0], do[0], True)
    o64, lse64, exact = o64[None], lse64[None], [t[None] for t in exact]
    di64 = (o64 * do.double()).sum(-1, keepdim=True)
    keep_min = fa.F32_TC_MIN_KV
    for route, min_kv in (("wgmma", 0), ("mma", 1 << 30)):
        fa.F32_TC_MIN_KV = min_kv
        o, lse = fa.flash_fwd(q, k, v, causal=True, sm_scale=sc)
        di = (o.float() * do.float()).sum(-1, keepdim=True)
        line = (f"[diag] {route}: o {float((o - o64).abs().max()):.3e} lse "
                f"{float((lse - lse64).abs().max()):.3e} (mean "
                f"{float((lse - lse64).mean()):+.3e})")
        for tag, l_, d_ in (("own lse", lse, di), ("f64 lse", lse64.float(),
                                                    di64.float())):
            got = fa.flash_bwd(q, k, v, l_, d_, do, causal=True, sm_scale=sc)
            line += f"; bwd with {tag}: " + " ".join(
                f"{n} {float((a - e).abs().max()):.3e}"
                for n, a, e in zip(("dq", "dk", "dv"), got, exact))
        print(line, flush=True)
    fa.F32_TC_MIN_KV = keep_min


def nonfinite(torch, dev) -> None:
    """Both routes with a +-inf in q, K, V or dO (element [0, 0, 5, 3]) at
    B2 H4 N2048 D128, not causal (every query tile meets every key tile, so
    the kernels' tiled walk and the plain versions' dense products make
    their 0 * inf at the same places): for o, lse, dq, dk and dv, the NaN /
    +inf / -inf counts of the route and of the plain versions and the
    elements whose class differs."""
    from flashattn_tpu_torch.ops import flash_attention as fa

    keep = fa.F32_TC_MIN_KV
    sc = 128 ** -0.5
    for where in ("q", "k", "v", "do"):
        for value in (math.inf, -math.inf):
            g = torch.Generator(device=dev).manual_seed(12)
            q, k, v, do = _inputs(torch, dev, g, 2, 4, 4, 2048, 2048, 128)
            {"q": q, "k": k, "v": v, "do": do}[where][0, 0, 5, 3] = value
            for route, min_kv in (("wgmma", 0), ("mma", 1 << 30)):
                fa.F32_TC_MIN_KV = min_kv
                o, lse = fa.flash_fwd(q, k, v, causal=False, sm_scale=sc)
                di = (o.float() * do.float()).sum(-1, keepdim=True)
                got = (o, lse, *fa.flash_bwd(q, k, v, lse, di, do, causal=False, sm_scale=sc))
                want = (*fa.flash_fwd_plain(q, k, v, False, sc),
                        *fa.flash_bwd_plain(q, k, v, lse, di, do, False, sc))
                torch.cuda.synchronize()
                parts = []
                for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
                    cls = [(torch.isnan(t), torch.isposinf(t), torch.isneginf(t))
                           for t in (a, b)]
                    counts = "/".join(f"{int(x.sum())}:{int(y.sum())}"
                                      for x, y in zip(*cls))
                    differ = int(sum(((x != y).sum() for x, y in zip(*cls)), torch.tensor(0, device=dev)))
                    fin = torch.isfinite(a) & torch.isfinite(b)
                    err = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
                    parts.append(f"{name} nan/+inf/-inf {counts} differ {differ} err {err:.2e}")
                print(f"[inf] {where}={value} {route}: " + "; ".join(parts), flush=True)
    fa.F32_TC_MIN_KV = keep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--diag", action="store_true")
    ap.add_argument("--inf", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("f32_flash_probe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    if args.ptxas:
        ptxas()
    from flashattn_tpu_torch.ops import _build

    _build.library()
    print(f"[probe] {torch.cuda.get_device_name(0)}", flush=True)
    if args.check:
        check(torch, dev)
    if args.diag:
        diag(torch, dev)
    if args.time:
        times(torch, dev)
    if args.inf:
        nonfinite(torch, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
