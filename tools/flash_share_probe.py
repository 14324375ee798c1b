"""Where the bf16 flash forward's disagreement with its plain version comes
from, at the dense causal d 128 shapes of the subrow and loop schedules.

    python3 tools/flash_share_probe.py [--lengths 2048,9216,16384]

Needs one CUDA card; builds the port's kernels first.  For each length n
(B1 H2, numpy-free inputs from a seeded torch generator on the card) it
computes o of the schedule's function (``flash_attention._schedule``) five
ways:

* ``kernel``: ``flash_fwd``, the card kernel;
* ``plain``: ``flash_fwd_plain``, its plain version (f32 scores, l and
  P V sums);
* ``s64``: the plain version with each score summed in f64 and rounded to
  f32 once (a correctly rounded dot), nothing else changed;
* ``l64``: the plain version with each block's l summed in f64;
* ``pv64``: the plain version with each block's P V summed in f64.

and prints, for the pairs (plain, s64), (plain, l64), (plain, pv64),
(kernel, plain) and (kernel, s64), the share of o bit for bit and the
largest difference in bf16 ulps of its row's largest |o| (chip_smoke's
``_row_ulp_share``).  For (plain, s64) it also counts the probabilities
p = exp2(s - m) whose bf16 rounding flips: the keys a row sees grow with
n, and with them the chances that a one-ulp change of a score moves a p
across a bf16 rounding boundary.  Each line ends with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _variant(torch, fa, q, k, v, sched, s_dt, l_dt, pv_dt, want_p=False):
    """``_kernel_fwd_plain`` at a dense causal shape with the scores, l and
    the P V products summed in the given dtypes (each rounded to f32 once);
    with ``want_p`` also the bf16 p of every live pair, in key order."""
    c = torch.tensor(fa.LOG2E * q.shape[-1] ** -0.5, dtype=q.dtype,
                     device=q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", (q * c).to(s_dt), k.to(s_dt)).float()
    n = s.shape[-1]
    keep = fa._keep_mask(n, n, True, None, None, q.device)
    s = s.masked_fill(~keep, fa.DEFAULT_MASK_VALUE)
    span = n if sched.name == "subrow" else sched.span
    m = torch.full_like(s[..., :1], -math.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(*s.shape[:-1], v.shape[-1], device=s.device)
    ps = []
    for c0 in range(0, n, span):
        sb = s[..., c0:c0 + span]
        m_new = torch.maximum(m, sb.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sb - m_new)
        pb = p.to(v.dtype)
        if want_p:
            ps.append(pb)
        l = alpha * l + p.to(l_dt).sum(-1, keepdim=True).float()
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", pb.to(pv_dt), v[:, :, c0:c0 + span].to(pv_dt)
        ).float()
        m = m_new
    o = acc / l if sched.name == "subrow" else acc * (1.0 / l)
    o = o.to(q.dtype)
    if want_p:
        return o, torch.cat(ps, -1).masked_select(keep)
    return o


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lengths", default="2048,9216,16384")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("flash_share_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from flashattn_tpu_torch.ops import _build
    from flashattn_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.library()
    dev = torch.device("cuda:0")
    f32, f64 = torch.float32, torch.float64
    for n in (int(x) for x in args.lengths.split(",")):
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(1, 2, n, 128, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        sched = fa._schedule(q, k, True, None)
        kern = fa.flash_fwd(q, k, v, causal=True, sm_scale=128 ** -0.5)[0]
        plain = fa.flash_fwd_plain(q, k, v, True, 128 ** -0.5)[0]
        base, p32 = _variant(torch, fa, q, k, v, sched, f32, f32, f32, True)
        if not torch.equal(base, plain):
            print(f"flash_share_probe: the f32 variant is not flash_fwd_plain "
                  f"at n {n}", file=sys.stderr)
            return 1
        s64, p64 = _variant(torch, fa, q, k, v, sched, f64, f32, f32, True)
        flips = int((p32 != p64).sum())
        del p32, p64
        out = {"s64": s64,
               "l64": _variant(torch, fa, q, k, v, sched, f32, f64, f32),
               "pv64": _variant(torch, fa, q, k, v, sched, f32, f32, f64)}
        rows = q.shape[0] * q.shape[1] * n
        pairs = rows * (n + 1) // 2
        for a, b, x, y in (("plain", "s64", plain, out["s64"]),
                           ("plain", "l64", plain, out["l64"]),
                           ("plain", "pv64", plain, out["pv64"]),
                           ("kernel", "plain", kern, plain),
                           ("kernel", "s64", kern, out["s64"])):
            share, ulp, _ = cs._row_ulp_share(x, y)
            print(f"[probe] N{n} ({sched.name}, span {sched.span}) {a} vs {b}: "
                  f"{100 * share:.3f}% of o bit for bit, max {ulp:.3f} ulp of "
                  f"the row's largest [{card}]", flush=True)
        print(f"[probe] N{n}: f64 scores flip the bf16 rounding of {flips} of "
              f"{pairs} live p ({100 * flips / pairs:.4f}%, {flips / rows:.3f} "
              f"a row) [{card}]", flush=True)
        del q, k, v, kern, plain, base, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
