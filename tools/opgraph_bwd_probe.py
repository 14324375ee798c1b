"""The bf16 op graph's backward at ``chip_smoke.py``'s "op graph B4 H16 N512
D128 causal" line, on the inputs its kernel phases draw there.

    python3 tools/opgraph_bwd_probe.py [--shifted]

Runs ``chip_smoke.py``'s serving, c15 and training kernel phases with their
timings skipped (the same random draws) up to that line, then compares the
kernels (``flash_bwd``'s op-graph mode) and the plain version (autograd of
the bf16 op graph) with an unrounded run of the graph (q, k, v and dO in
float64 through ``_reference_fwd_with_lse``, which forms the scores and
the softmax in f32): for dq, dk and dv
the share of elements bit for bit, and at the element farthest from the
plain version in units of one bf16 ulp of its row's largest |value|
(``chip_smoke._row_ulp_err``'s measure) the kernel's, the plain version's
and the unrounded run's values.

``chip_smoke.py`` draws its f32-pool paged lines from a generator of their
own; ``--shifted`` draws them from the shared stream instead, as an
earlier version of the script did, which moved this line's inputs to ones
where one dq element of both the kernel and the plain version sits about
half a percent from the unrounded value, ten bf16 ulps of its row's
largest apart.
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LABEL = "op graph B4 H16 N512 D128 causal"


class _Stop(Exception):
    pass


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("opgraph_bwd_probe: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flashattn_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    seen = {}
    check = cs._flash_bwd_check

    def grab(torch_, ph, fa_, label, dtype, q, k, v, do, *args, **kw):
        if label == LABEL:
            seen.update(q=q, k=k, v=v, do=do)
            raise _Stop
        return check(torch_, ph, fa_, label, dtype, q, k, v, do, *args, **kw)

    cs._flash_bwd_check = grab
    cs.time_ms = lambda fn, reps=15, host=False: (fn(), 0.0)[1]
    cs.graph_ms = lambda fn, calls=20, reps=15: (fn(), 0.0)[1]
    cs.log = lambda msg: None
    ph = cs.Phases()
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    if "--shifted" in sys.argv:
        # the three f32-pool paged lines' draws in the shared stream, as
        # before they had a generator of their own
        serving = cs.serving_kernel_phases

        def shifted(torch_, dev_, ph_, randn_):
            serving(torch_, dev_, ph_, randn_)
            for shape in ((8, 65, 128, 128), (8, 65, 128, 128), (4, 64, 8, 128),
                          (4, 32, 128), (4, 2048, 8, 128)):
                randn_(*shape, dtype=torch.float32)

        cs.serving_kernel_phases = shifted
    try:
        cs.serving_kernel_phases(torch, dev, ph, randn)
        cs.c15_kernel_phases(torch, dev, ph, randn)
        cs.training_kernel_phases(torch, dev, ph, randn)
    except _Stop:
        pass
    q, k, v, do = (seen[n] for n in ("q", "k", "v", "do"))
    sc = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=True, sm_scale=sc)
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    got = fa.flash_bwd(q, k, v, lse, di, do, causal=True, sm_scale=sc)
    want = fa.flash_bwd_plain(q, k, v, lse, di, do, True, sc)
    with torch.enable_grad():
        q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
        o64 = fa._reference_fwd_with_lse(q64, k64, v64, True, sc)[0]
        exact = torch.autograd.grad(o64, (q64, k64, v64), do.double())
    for name, a, b, e in zip(("dq", "dk", "dv"), got, want, exact):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        row = b.abs().amax(-1, keepdim=True) * 2.0 ** -7
        ratio = torch.where(d == 0, torch.zeros_like(d), d / row)
        i = int(ratio.argmax())
        idx = torch.unravel_index(torch.tensor(i), ratio.shape)
        at = tuple(int(x) for x in idx)
        print(f"[opgraph] {name}: {100 * float((a == b).float().mean()):.3f}% bit for bit, "
              f"worst {float(ratio.max()):.2f} row-ulps at {at}: kernel {float(a[at]):.6e}, "
              f"plain {float(b[at]):.6e}, unrounded {float(e[at]):.6e}, row max "
              f"{float(b[at[:-1]].abs().max()):.3e}; max |kernel - unrounded| "
              f"{float((a.double() - e).abs().max()):.3e}, max |plain - unrounded| "
              f"{float((b.double() - e).abs().max()):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
