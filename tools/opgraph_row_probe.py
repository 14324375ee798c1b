"""Where the bf16 op graph's backward leaves one bf16 ulp of a row, on the card.

    python3 tools/opgraph_row_probe.py [--d 80]

Runs ``chip_smoke.py``'s head-dim kernel phase at one head dim, with the
inputs it draws there, up to its first bf16 op-graph backward line
(B4 H32 N512 causal); there, instead of the gated check, it computes the
kernel's and the plain version's (dq, dk, dv), and for the first elements
of each whose error exceeds one bf16 ulp of its row's largest reference
magnitude prints both values, the float64 gradient of the same (b, h)
slice (autograd of softmax(q k^T sm_scale) v in float64 over the bf16
inputs) and each row's error against it, then stops.  It also checks that
two kernel calls give the same bits.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def f64_grads(torch, q, k, v, do, sc, causal):
    qg, kg, vg = (t.double().requires_grad_() for t in (q, k, v))
    s = (qg @ kg.transpose(-1, -2)) * sc
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, -float("inf"))
    o = torch.softmax(s, -1) @ vg
    return torch.autograd.grad(o, (qg, kg, vg), do.double())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=80)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from flashattn_tpu_torch.ops import _build

    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    checked = cs._flash_bwd_check

    def probe(torch_, ph, fa, label, dtype, q, k, v, do, causal, window, lens,
              main=False):
        if "op graph" not in label or dtype != torch.bfloat16:
            return checked(torch_, ph, fa, label, dtype, q, k, v, do, causal,
                           window, lens, main)
        sc = q.shape[-1] ** -0.5
        kw = dict(causal=causal, sm_scale=sc, kv_lengths=lens, window=window)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        di = (o.float() * do.float()).sum(-1, keepdim=True)
        got = fa.flash_bwd(q, k, v, lse, di, do, **kw)
        want = fa.flash_bwd_plain(q, k, v, lse, di, do, causal, sc, lens, window)
        again = fa.flash_bwd(q, k, v, lse, di, do, **kw)
        print(f"{label}: two kernel calls bit for bit: "
              f"{all(torch.equal(a, b) for a, b in zip(got, again))}", flush=True)
        for i, (name, gt, wt) in enumerate(zip(("dq", "dk", "dv"), got, want)):
            gf, wf = gt.float(), wt.float()
            diff = (gf - wf).abs()
            rowm = wf.abs().amax(-1, keepdim=True)
            ratio = torch.where(diff == 0, torch.zeros_like(diff),
                                diff / (rowm * 2 ** -7))
            bad = (ratio > 1).nonzero()
            print(f"{name}: {bad.shape[0]} elements over one ulp of their row's "
                  f"largest; worst {float(ratio.max()):.4g}; the tensor's largest "
                  f"{float(wf.abs().max()):.4g}", flush=True)
            for b, h, r, c in bad[:4].tolist():
                e = f64_grads(torch, *(t[b:b + 1, h:h + 1] for t in (q, k, v, do)),
                              sc, causal)[i][0, 0]
                print(f"  b{b} h{h} row {r} col {c}: kernel {float(gf[b, h, r, c]):.6g}"
                      f" plain {float(wf[b, h, r, c]):.6g} float64 {float(e[r, c]):.6g};"
                      f" row's largest: plain {float(rowm[b, h, r]):.4g}, kernel "
                      f"{float(gf[b, h, r].abs().max()):.4g}, float64 "
                      f"{float(e[r].abs().max()):.4g}; row's max error against "
                      f"float64: kernel {float((gf[b, h, r] - e[r]).abs().max()):.3g},"
                      f" plain {float((wf[b, h, r] - e[r]).abs().max()):.3g}",
                      flush=True)
        raise SystemExit(0)

    cs._flash_bwd_check = probe
    cs.HEAD_DIM_LINES = (args.d,)
    cs.head_dim_kernel_phases(torch, torch.device("cuda"), cs.Phases())
    return 0


if __name__ == "__main__":
    sys.exit(main())
