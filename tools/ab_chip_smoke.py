"""Compare checkouts of the port on one card, alternately, in one run.

    python3 tools/ab_chip_smoke.py [--phases wo,flash,share,bwd,f32,opgraph,kv8,ln,drop,bias,sq,softmax,paged,headdim,serve_quant,train,train_fused,train_f32,mt_step] ROOT_A ROOT_B ...

Each ROOT is a directory holding a ``flashattn_tpu_torch/`` package (a
``git archive`` of another commit, say).  The roots are built one after the
other (each into its own ``_build/``), then run in the order A B ... B A, each in
a process of its own that imports that root's package and this repo's
``chip_smoke.py`` phases:

* ``wo``: ``wo_matmul`` (bf16 and f32 x, int8 and fp8 payloads) at the
  quantized serving model's decode and prefill shapes: device ms
  (CUDA-graph replay for M <= 16, CUDA events above), eager ms with the
  host's launch overhead, and ``x @ W`` in x's dtype beside both;
* ``flash``: the bf16 flash forward at the train step's dense causal
  shape, the varlen prefill, N 16384, d64 non-causal N2048, window 256
  and causal N517 (below 1024 keys: JAX's op graph), with SDPA beside;
* ``bwd``: the bf16 flash backward (``flash_bwd``) at the train step's
  head shape B4 H16 N2048 D128 causal, cross 1000 x 2048 non-causal and
  causal N512 (the op graph's autodiff), with SDPA's backward beside;
* ``f32``: every f32 flash line of ``chip_smoke.py``'s kernel phases,
  forward and backward where it has one: the varlen prefill B4 H8 N2048
  D128, the train shape B4 H16 N2048 D128 causal (the loop schedule), the
  MT model's B128 H8 D32 40-key shapes (encoder varlen, decoder causal,
  cross varlen, generate 1 x 40) and the distill draft's B16 H2 128 x 128
  D64 causal, each named by its route's kernels (chip_smoke's
  ``_flash_name``), with SDPA's f32 call and its backward and the bound
  beside;
* ``opgraph``: the op graph (``flash_fwd`` mode 0 and ``flash_bwd``'s
  op-graph mode) at the MT model's attention shapes (B128 H8 D32 over 40
  keys: the encoder's varlen and the decoder's causal self-attention,
  forward and backward, and generation's n_q 1, forward; bf16 and f32),
  at B4 H16 N512 D128 causal (forward and backward), N517, N1000 D64,
  the distill draft's B16 H2 N128 D64 and the quantized-KV fallback's
  7 x 200, bf16, with SDPA and its backward
  beside, the backward's device ms by kernel (torch.profiler), and in
  bf16 the share of o (and dq, dk, dv) bit for bit against the plain
  versions;
* ``kv8``: ``kv8_flash_fwd`` (the kernel call itself, so fp8 is not
  transcoded) with bf16 and f32 q at B4 H8 N2048 D128 causal, N512
  causal and cross 1000 x 2048 (int8 and fp8 payloads) and GQA 8q/2kv
  N2048 (int8), with SDPA on the dequantized cache beside;
* ``ln``: ``layernorm_fwd`` and ``layernorm_bwd`` at the train step's rows
  (16384, 2048), bf16 and f32, with ``F.layer_norm`` and its autograd
  backward beside, and the bounds;
* ``drop``: ``dropout`` at (16384, 2048), p 0.1, bf16 and f32, with
  ``F.dropout`` beside, and the bound;
* ``share``: the bf16 flash forward's share of o bit for bit against its
  plain version (``flash_fwd_plain``) and its time, at the loop schedule's
  B1 H2 N16384 and N9216 and the train shape, d 128 causal;
* ``bias``: the dropout-bias kernels at the training FFN's shapes, p 0.1:
  act-bias GELU and ReLU at (16384, 8192) and res-bias at (16384, 2048),
  forward and backward, bf16 (and GELU in f32), with the bound;
* ``sq``: stochastic int8 quantization at (32768, 1024) bf16 and f32,
  with the bound;
* ``softmax``: ``softmax_fwd`` and ``softmax_bwd`` at the fused step's
  shape (8, 16, 2048, 2048) causal and at T 33 (F 2048), bf16 in both
  roundings (a root whose kernels take no ``impl`` has the Pallas
  function's alone) and f32, with ``torch.softmax`` and its backward
  beside, and the bounds;
* ``paged``: ``paged_attention`` at the serving shapes (B4 Hkv8 d128,
  page 128: decode over histories <= 2048 and <= 8192 with bf16, int8 and
  fp8 pools, chunk 64 and GQA group 4 over a bf16 pool at <= 2048 and an
  int8 pool at <= 8192, the 2048-row extend wave; B1 Hkv8 decode at 16384
  positions), then f32 q (an f32 pool at <= 2048, int8 / fp8 at <= 8192,
  B1 at 16384, chunk 64, GQA 4, window 256, the 2048-row wave), with the
  plain version (where the root has ``paged_attention_plain``) and the
  bound beside (f32 q: the split-precision bound);
* ``headdim``: the attention kernels at serve_d96's and train_d96's
  shapes (B4, 32 heads) at head dims 32, 64, 80, 96, 112 and 128: the
  bf16 flash forward's subrow and grid, the f32 flash forward, paged
  decode and chunk 64 over a bf16 pool, int8 ``kv8_flash``, and the flash
  backward (bf16 subrow B4 H32 N2048 causal, the grid B1 H32/8 GQA
  non-causal, the op graph B4 H32 N512 causal; f32 split B4 H32 N2048
  causal), with the bound at the real d; a root whose kernels refuse a
  head dim prints "refused";
* ``serve_quant``: chip_smoke's serve_quant phase (three variants, prompt
  and decode throughput, one profiled decode dispatch each);
* ``train``: chip_smoke's flash train phase (step time, peak memory, one
  profiled step);
* ``train_fused``: the same with ``attn_impl="fused_softmax"``;
* ``train_f32``: the same step in f32 (no mixed-precision wrapper);
* ``mt_step``: chip_smoke's seq2seq_train phase in f32, then in
  bf16-mixed with remat (the MT model's 64 steps, ms/step, one profiled
  dispatch with the attention's and the op graph's device ms and share).

Each process's full output goes to ``<log-dir>/ab_<n>_<root>.log``
(default ``workdir_ab/logs``, git-ignored); the summary lines (``[ab]``,
``[serve_quant]``, ``[train...]``, the profiler's busy share) are printed.  Compare numbers only within one run: the host's clock moves
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
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            for m, k, n in WO_SHAPES:
                x = torch.randn(m, k, generator=g, device=dev).to(dtype)
                w = quantize(torch.randn(k, n, generator=g, device=dev), axis=0)
                w_full = w.dequantize(dtype)
                timer = cs.graph_ms if m <= 16 else cs.time_ms
                ms, lib = timer(lambda: qt.wo_matmul(x, w)), timer(lambda: x @ w_full)
                eager = cs.time_ms(lambda: qt.wo_matmul(x, w), host=True)
                print(f"[ab] wo_matmul {name} {payload} ({m}, {k}) x ({k}, {n}): ms "
                      f"{ms:.4f} ({'graph' if m <= 16 else 'events'}), eager "
                      f"{eager:.4f}, x @ W_{name} {lib:.4f}", flush=True)


# (label, (b, h, n, d), lengths, causal, window)
FLASH_SHAPES = [
    ("train B4 H16 N2048 D128 causal", (4, 16, 2048, 128), None, True, None),
    ("varlen B4 H8 N2048 D128", (4, 8, 2048, 128), [2048, 1536, 1024, 517], True,
     None),
    ("B1 H2 N16384 D128 causal", (1, 2, 16384, 128), None, True, None),
    ("B4 H8 N2048 D64 non-causal", (4, 8, 2048, 64), None, False, None),
    ("B4 H8 N2048 D128 window 256", (4, 8, 2048, 128), None, True, 256),
    ("B4 H8 N517 D128 causal", (4, 8, 517, 128), None, True, None)]


def _flash(torch, cs, dev):
    from flashattn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    for label, (b, h, n, d), lens, causal, window in FLASH_SHAPES:
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        lens = None if lens is None else torch.tensor(lens, device=dev)
        lib, args = cs._sdpa(torch, q, k, v, causal, window, lens)
        ms = cs.time_ms(lambda: fa.flash_fwd(q, k, v, causal=causal,
                                             sm_scale=d ** -0.5, kv_lengths=lens,
                                             window=window))
        print(f"[ab] flash_fwd {label}: ms {ms:.4f}, SDPA {cs.time_ms(lambda: lib(*args)):.4f}",
              flush=True)


BWD_SHAPES = [("train B4 H16 N2048 D128 causal", (4, 16, 2048, 2048), True),
              ("cross B4 H16 1000 x 2048 D128", (4, 16, 1000, 2048), False),
              ("B4 H16 N512 D128 causal", (4, 16, 512, 512), True)]


def _bwd(torch, cs, dev):
    from flashattn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    for label, (b, h, n_q, n_kv), causal in BWD_SHAPES:
        q, do = (torch.randn(b, h, n_q, 128, generator=g, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, h, n_kv, 128, generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=128 ** -0.5)
        di = (o.float() * do.float()).sum(-1, keepdim=True)
        ms = cs.time_ms(lambda: fa.flash_bwd(q, k, v, lse, di, do, causal=causal,
                                             sm_scale=128 ** -0.5))
        lib = cs.time_ms(cs._sdpa_bwd(torch, q, k, v, do, causal, None, None))
        print(f"[ab] flash_bwd {label}: ms {ms:.4f}, SDPA bwd {lib:.4f}", flush=True)


# chip_smoke's f32 flash lines: (label, (b, h, n_q, n_kv, d), lengths
# ("mt": the MT phase's draw), causal, backward too)
F32_SHAPES = [
    ("varlen B4 H8 N2048 D128 causal", (4, 8, 2048, 2048, 128),
     [2048, 1536, 1024, 517], True, False),
    ("train B4 H16 N2048 D128 causal", (4, 16, 2048, 2048, 128), None, True, True),
    ("MT encoder B128 H8 40x40 D32 varlen", (128, 8, 40, 40, 32), "mt", False, True),
    ("MT decoder B128 H8 40x40 D32 causal", (128, 8, 40, 40, 32), None, True, True),
    ("MT cross B128 H8 40x40 D32 varlen", (128, 8, 40, 40, 32), "mt", False, True),
    ("MT generate B128 H8 1x40 D32 varlen", (128, 8, 1, 40, 32), "mt", False, False),
    ("distill B16 H2 128x128 D64 causal", (16, 2, 128, 128, 64), None, True, True)]


def _f32(torch, cs, dev):
    from flashattn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    for label, (b, h, n_q, n_kv, d), lens, causal, bwd in F32_SHAPES:
        if lens == "mt":
            gl = torch.Generator().manual_seed(cs.SEED + 11)
            lens = torch.randint(1, n_kv + 1, (b,), generator=gl)
            lens[:2] = torch.tensor([1, n_kv])
        lens = None if lens is None else torch.as_tensor(lens).to(dev)
        q, do = (torch.randn(b, h, n_q, d, generator=g, device=dev) for _ in range(2))
        k, v = (torch.randn(b, h, n_kv, d, generator=g, device=dev) for _ in range(2))
        sc = d ** -0.5
        kw = dict(causal=causal, sm_scale=sc, kv_lengths=lens)
        lib, args = cs._sdpa(torch, q, k, v, causal, None, lens)
        b_ms, b_by = cs.bound_ms(*cs._flash_cost(q, k, causal, None, lens), "float32")
        line = (f"[ab] f32 flash {label} ({cs._flash_name('flash_fwd', q, k)}): fwd ms "
                f"{cs.time_ms(lambda: fa.flash_fwd(q, k, v, **kw)):.4f}, SDPA "
                f"{cs.time_ms(lambda: lib(*args)):.4f}, bound {b_ms:.4f} ({b_by})")
        if bwd:
            o, lse = fa.flash_fwd(q, k, v, **kw)
            di = (o.float() * do.float()).sum(-1, keepdim=True)
            ms = cs.time_ms(lambda: fa.flash_bwd(q, k, v, lse, di, do, **kw))
            lib_b = cs.time_ms(cs._sdpa_bwd(torch, q, k, v, do, causal, None, lens))
            b_ms, b_by = cs.bound_ms(*cs._flash_cost(q, k, causal, None, lens, True),
                                     "float32")
            line += (f"; bwd ms {ms:.4f}, SDPA bwd {lib_b:.4f}, bound {b_ms:.4f} "
                     f"({b_by})")
        print(line, flush=True)
        del q, k, v, do


# the op graph's shapes: (label, (b, h, n_q, n_kv, d), varlen, causal,
# backward too, dtypes)
OPGRAPH_SHAPES = [
    ("MT encoder B128 H8 40x40 D32 varlen", (128, 8, 40, 40, 32), True, False, True,
     ("bfloat16", "float32")),
    ("MT decoder B128 H8 40x40 D32 causal", (128, 8, 40, 40, 32), False, True, True,
     ("bfloat16", "float32")),
    ("MT generate B128 H8 1x40 D32 varlen", (128, 8, 1, 40, 32), True, False, False,
     ("bfloat16", "float32")),
    ("B4 H16 N512 D128 causal", (4, 16, 512, 512, 128), False, True, True, ("bfloat16",)),
    ("B4 H8 N517 D128 causal", (4, 8, 517, 517, 128), False, True, False, ("bfloat16",)),
    ("B4 H8 N1000 D64 non-causal", (4, 8, 1000, 1000, 64), False, False, False,
     ("bfloat16",)),
    ("distill B16 H2 N128 D64 causal", (16, 2, 128, 128, 64), False, True, True,
     ("bfloat16",)),
    ("kv8 fallback's B4 H8 7x200 D128", (4, 8, 7, 200, 128), False, False, False,
     ("bfloat16",))]


def _opgraph(torch, cs, dev):
    from flashattn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    gl = torch.Generator().manual_seed(cs.SEED + 11)
    for label, (b, h, n_q, n_kv, d), varlen, causal, bwd, dtypes in OPGRAPH_SHAPES:
        lens = None
        if varlen:
            lens = torch.randint(1, n_kv + 1, (b,), generator=gl)
            lens[:2] = torch.tensor([1, n_kv])
            lens = lens.to(dev)
        for name in dtypes:
            dtype = getattr(torch, name)
            q, do = (torch.randn(b, h, n_q, d, generator=g, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(b, h, n_kv, d, generator=g, device=dev).to(dtype)
                    for _ in range(2))
            assert fa._schedule(q, k, causal, None, varlen).name == "op_graph"
            sc = d ** -0.5
            lib, args = cs._sdpa(torch, q, k, v, causal, None, lens)
            ms = cs.time_ms(lambda: fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc,
                                                 kv_lengths=lens))
            o, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc, kv_lengths=lens)
            shares = [_same(o, fa.flash_fwd_plain(q, k, v, causal, sc, lens)[0])]
            line = (f"[ab] op graph {label} {name}: fwd ms {ms:.4f}, SDPA "
                    f"{cs.time_ms(lambda: lib(*args)):.4f}")
            if bwd:
                di = (o.float() * do.float()).sum(-1, keepdim=True)
                ms = cs.time_ms(lambda: fa.flash_bwd(q, k, v, lse, di, do, causal=causal,
                                                     sm_scale=sc, kv_lengths=lens))
                lib_b = cs.time_ms(cs._sdpa_bwd(torch, q, k, v, do, causal, None, lens))
                line += f"; bwd ms {ms:.4f}, SDPA bwd {lib_b:.4f}"
                line += "; " + _kernel_split(torch, lambda: fa.flash_bwd(
                    q, k, v, lse, di, do, causal=causal, sm_scale=sc, kv_lengths=lens))
                got = fa.flash_bwd(q, k, v, lse, di, do, causal=causal, sm_scale=sc,
                                   kv_lengths=lens)
                want = fa.flash_bwd_plain(q, k, v, lse, di, do, causal, sc, lens)
                shares += [_same(a, b) for a, b in zip(got, want)]
            if dtype == torch.bfloat16:
                line += ("; bit for bit o" + (", dq, dk, dv" if bwd else "") + " "
                         + ", ".join(f"{100 * x:.3f}%" for x in shares))
            print(line, flush=True)


def _kernel_split(torch, fn, reps: int = 10) -> str:
    """The device time of each kernel that ``fn`` launches, per call (a
    torch.profiler trace of ``reps`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(anonymous namespace)::")[-1].split("(")[0]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    return ", ".join(f"{n} {t / reps / 1e3:.4f}" for n, t in sorted(by_name.items()))


def _same(got, want) -> float:
    """The share of elements equal to the plain version's bit for bit."""
    return float((got == want).float().mean())


# (label, (b, h, h_kv, n_q, n_kv), causal, payloads): a shape of each of
# JAX's routes (the subrow, the loop, the grid with two key blocks) and the
# subrow with GQA
KV8_SHAPES = [("B4 H8 N2048 D128 causal", (4, 8, 8, 2048, 2048), True, ("int8", "fp8")),
              ("B4 H8 N512 D128 causal", (4, 8, 8, 512, 512), True, ("int8", "fp8")),
              ("cross B4 H8 1000 x 2048 D128", (4, 8, 8, 1000, 2048), False,
               ("int8", "fp8")),
              ("GQA 8q/2kv B4 N2048 D128 causal", (4, 8, 2, 2048, 2048), True, ("int8",))]


def _kv8(torch, cs, dev):
    from flashattn_tpu_torch.ops import quant as qt

    g = torch.Generator(device=dev).manual_seed(0)
    quantizers = {"int8": qt.quantize_int8, "fp8": qt.quantize_fp8}
    for label, (b, h, h_kv, n_q, n_kv), causal, payloads in KV8_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            q = torch.randn(b, h, n_q, 128, generator=g, device=dev).to(dtype)
            for payload in payloads:
                k, v = (quantizers[payload](torch.randn(b, h_kv, n_kv, 128, generator=g,
                                                        device=dev)) for _ in range(2))
                lib, args = cs._sdpa(torch, q, k.dequantize(dtype), v.dequantize(dtype),
                                     causal, None, None)
                ms = cs.time_ms(lambda: qt.kv8_flash_fwd(q, k, v, causal=causal,
                                                         sm_scale=128 ** -0.5))
                print(f"[ab] kv8_flash {name} {payload} {label}: ms {ms:.4f} (the "
                      f"kernel call, fp8 not transcoded), SDPA on the dequantized "
                      f"cache {cs.time_ms(lambda: lib(*args)):.4f}", flush=True)


TRAIN_ROWS = (16384, 2048)   # the train step's LayerNorm and dropout rows


def _ln(torch, cs, dev):
    from flashattn_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device=dev).manual_seed(0)
    n, h = TRAIN_ROWS
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(n, h, generator=g, device=dev) * 2 + 0.5).to(dtype)
        dy, gam, bet = (torch.randn(*s, generator=g, device=dev).to(dtype)
                        for s in ((n, h), (h,), (h,)))
        name, isz = str(dtype).replace("torch.", ""), x.element_size()
        fwd = cs.time_ms(lambda: ln.layernorm_fwd(x, gam, bet))
        lib_fwd = cs.time_ms(lambda: torch.nn.functional.layer_norm(
            x, (h,), gam, bet))
        _, mean, rstd = ln.layernorm_fwd(x, gam, bet)
        bwd = cs.time_ms(lambda: ln.layernorm_bwd(x, dy, mean, rstd, gam))
        lib_bwd = cs.time_ms(cs._ln_bwd_library(torch, x, dy, gam, bet))
        b_fwd, b_bwd = (cs.bound_ms(*cs._ln_cost(n, h, isz, backward=b), name)[0]
                        for b in (False, True))
        print(f"[ab] layernorm {name} ({n}, {h}): fwd ms {fwd:.4f}, "
              f"F.layer_norm {lib_fwd:.4f}, bound {b_fwd:.4f}; bwd ms "
              f"{bwd:.4f}, autograd of F.layer_norm {lib_bwd:.4f}, bound "
              f"{b_bwd:.4f}", flush=True)
        del x, dy, mean, rstd


def _drop(torch, cs, dev):
    from flashattn_tpu_torch.ops import dropout as dr

    g = torch.Generator(device=dev).manual_seed(0)
    n, h = TRAIN_ROWS
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(n, h, generator=g, device=dev).to(dtype)
        name = str(dtype).replace("torch.", "")
        ms = cs.time_ms(lambda: dr.dropout(x, 0.1, 0x9E3779B97F4A7C15))
        lib = cs.time_ms(lambda: torch.nn.functional.dropout(x, 0.1, True))
        bound = cs.bound_ms(2 * x.numel() * x.element_size(), 0, name)[0]
        print(f"[ab] dropout {name} ({n}, {h}) p 0.1: ms {ms:.4f}, F.dropout "
              f"{lib:.4f}, bound {bound:.4f}", flush=True)
        del x


def _share(torch, cs, dev):
    from flashattn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    for b, h, n in ((1, 2, 16384), (1, 2, 9216), (4, 16, 2048)):
        q, k, v = (torch.randn(b, h, n, 128, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        o, _ = fa.flash_fwd(q, k, v, causal=True, sm_scale=128 ** -0.5)
        ref, _ = fa.flash_fwd_plain(q, k, v, True, 128 ** -0.5)
        share = float((o == ref).float().mean())
        ms = cs.time_ms(lambda: fa.flash_fwd(q, k, v, causal=True,
                                             sm_scale=128 ** -0.5))
        print(f"[ab] flash_fwd share B{b} H{h} N{n}: {100 * share:.3f}% of o bit "
              f"for bit, ms {ms:.4f}", flush=True)
        del q, k, v, o, ref
        torch.cuda.empty_cache()


def _bias(torch, cs, dev):
    from flashattn_tpu_torch.ops import dropout as dr

    g = torch.Generator(device=dev).manual_seed(0)
    seed, rate, n = 0x9E3779B97F4A7C15, 0.1, TRAIN_ROWS[0]
    for dtype, acts in ((torch.bfloat16, ("gelu", "relu")),
                        (torch.float32, ("gelu",))):
        name, isz = str(dtype).replace("torch.", ""), dtype.itemsize
        d = 4 * TRAIN_ROWS[1]
        x, gy = (torch.randn(n, d, generator=g, device=dev).to(dtype)
                 for _ in range(2))
        bias = torch.randn(d, generator=g, device=dev).to(dtype)
        for act in acts:
            for bwd in (False, True):
                fn = ((lambda: dr.dropout_act_bias_bwd(gy, x, bias, rate, seed,
                                                       True, act)) if bwd else
                      (lambda: dr.dropout_act_bias(x, bias, rate, seed, True, act)))
                nbytes = ((3 if bwd else 2) * n * d + d) * isz + (4 * d if bwd else 0)
                print(f"[ab] dropout_act_bias {act} {'bwd' if bwd else 'fwd'} {name} "
                      f"({n}, {d}): ms {cs.time_ms(fn):.4f}, bound "
                      f"{cs.bound_ms(nbytes, 0, name)[0]:.4f}", flush=True)
        del x, gy
        d = TRAIN_ROWS[1]
        x, r, gy = (torch.randn(n, d, generator=g, device=dev).to(dtype)
                    for _ in range(3))
        bias = torch.randn(d, generator=g, device=dev).to(dtype)
        for bwd in (False, True):
            fn = ((lambda: dr.dropout_res_bias_bwd(gy, rate, seed, True)) if bwd else
                  (lambda: dr.dropout_res_bias(x, bias, r, rate, seed, True)))
            nbytes = (2 * n * d * isz + 4 * d) if bwd else (3 * n * d + d) * isz
            print(f"[ab] dropout_res_bias {'bwd' if bwd else 'fwd'} {name} ({n}, {d}): "
                  f"ms {cs.time_ms(fn):.4f}, bound {cs.bound_ms(nbytes, 0, name)[0]:.4f}",
                  flush=True)
        del x, r, gy


def _sq(torch, cs, dev):
    from flashattn_tpu_torch.ops import quant as qt

    g = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        x = torch.randn(32768, 1024, generator=g, device=dev).to(dtype)
        ms = cs.time_ms(lambda: qt.stochastic_quant(x, 7))
        nbytes = x.numel() * (x.element_size() + 1) + 4 * 32768
        print(f"[ab] stochastic_quant {name} (32768, 1024): ms {ms:.4f}, bound "
              f"{cs.bound_ms(nbytes, 0, name)[0]:.4f}", flush=True)


SOFTMAX_SHAPES = [("B8 H16 N2048 causal", (8, 16, 2048, 2048)),
                  ("T 33 causal, F 2048", (8, 16, 2048, 33))]


def _softmax(torch, cs, dev):
    import inspect

    from flashattn_tpu_torch.ops import softmax as sm

    has_impl = "impl" in inspect.signature(sm.softmax_fwd).parameters
    g = torch.Generator(device=dev).manual_seed(0)
    for label, shape in SOFTMAX_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
            dout = torch.randn(shape, generator=g, device=dev).to(dtype)
            name = str(dtype).replace("torch.", "")
            future = torch.ones(shape[-2:], dtype=torch.bool, device=dev).triu(1)
            pre = x.masked_fill(future, float("-inf"))
            lib = cs.time_ms(lambda: torch.softmax(pre, -1))
            out = torch.softmax(pre, -1)
            lib_b = cs.time_ms(lambda: torch._softmax_backward_data(dout, out, -1, dtype))
            impls = ["auto", "pallas"] if has_impl and dtype == torch.bfloat16 else [None]
            for impl in impls:
                kw = {} if impl is None else {"impl": impl}
                op = impl == "auto"
                fwd = cs.time_ms(lambda: sm.softmax_fwd(x, None, True, **kw))
                res = x if op else sm.softmax_fwd(x, None, True, **kw)
                bwd = cs.time_ms(lambda: sm.softmax_bwd(res, dout, None, True, **kw)
                                 if kw else sm.softmax_bwd(res, dout))
                b_f = cs.bound_ms(*cs._softmax_cost(x, None, True), name)[0]
                b_b = cs.bound_ms(*cs._softmax_cost(x, None, True, backward=True,
                                                    op_graph=op), name)[0]
                print(f"[ab] softmax {name} {label} {impl or 'pallas (only)'}: fwd ms "
                      f"{fwd:.4f}, torch.softmax {lib:.4f}, bound {b_f:.4f}; bwd ms "
                      f"{bwd:.4f}, _softmax_backward_data {lib_b:.4f}, bound {b_b:.4f}",
                      flush=True)
            del x, dout, pre, out


# (label, q shape after the batch, chunk, q heads, histories, pool): bf16 q
PAGED_SHAPES = [
    ("decode <= 2048", (8, 128), 1, 8, [2048, 1536, 1024, 517], "bf16"),
    ("decode <= 8192", (8, 128), 1, 8, [8192, 6144, 4096, 2053], "bf16"),
    ("decode <= 8192", (8, 128), 1, 8, [8192, 6144, 4096, 2053], "int8"),
    ("decode <= 8192", (8, 128), 1, 8, [8192, 6144, 4096, 2053], "fp8"),
    ("chunk 64 <= 2048", (64, 8, 128), 64, 8, [2048, 1536, 1024, 517], "bf16"),
    ("GQA 4 <= 2048", (32, 128), 1, 32, [2048, 1536, 1024, 517], "bf16"),
    ("chunk 64 <= 8192", (64, 8, 128), 64, 8, [8192, 6144, 4096, 2053], "int8"),
    ("GQA 4 <= 8192", (32, 128), 1, 32, [8192, 6144, 4096, 2053], "int8"),
    ("extend wave 2048", (2048, 8, 128), 2048, 8, [2048] * 4, "bf16"),
    ("B1 decode 16384", (8, 128), 1, 8, [16384], "bf16"),
    ("B1 decode 16384", (8, 128), 1, 8, [16384], "int8"),
]
# the f32-q lines (an f32 pool is in q's dtype), with a window
PAGED_F32_SHAPES = [
    ("decode <= 2048", (8, 128), 1, 8, [2048, 1536, 1024, 517], "f32", None),
    ("decode <= 8192", (8, 128), 1, 8, [8192, 6144, 4096, 2053], "int8", None),
    ("decode <= 8192", (8, 128), 1, 8, [8192, 6144, 4096, 2053], "fp8", None),
    ("B1 decode 16384", (8, 128), 1, 8, [16384], "int8", None),
    ("B1 decode 16384", (8, 128), 1, 8, [16384], "f32", None),
    ("chunk 64 <= 8192", (64, 8, 128), 64, 8, [8192, 6144, 4096, 2053], "int8", None),
    ("chunk 64 <= 8192", (64, 8, 128), 64, 8, [8192, 6144, 4096, 2053], "fp8", None),
    ("GQA 4 <= 8192", (32, 128), 1, 32, [8192, 6144, 4096, 2053], "int8", None),
    ("window 256 <= 8192", (8, 128), 1, 8, [8192, 6144, 4096, 2053], "int8", 256),
    ("extend wave 2048", (2048, 8, 128), 2048, 8, [2048] * 4, "f32", None),
    ("extend wave 2048", (2048, 8, 128), 2048, 8, [2048] * 4, "int8", None),
]


def _paged(torch, cs, dev):
    from flashattn_tpu_torch.ops import paged_attention as pa
    from flashattn_tpu_torch.ops import quant as qt

    plain = getattr(pa, "paged_attention_plain", None)
    g = torch.Generator(device=dev).manual_seed(0)
    lines = ([(*shape, None, torch.bfloat16) for shape in PAGED_SHAPES]
             + [(*shape, torch.float32) for shape in PAGED_F32_SHAPES])
    for label, q_shape, chunk, hq, lens, pool, window, dtype in lines:
        b = len(lens)
        pps = max(-(-n // 128) for n in lens)
        n_pages = b * pps + 1
        table = torch.randperm(n_pages, generator=g, device=dev)[:b * pps]
        table = table.reshape(b, pps).int()
        lens_t = torch.tensor(lens, device=dev)
        q = torch.randn((b, *q_shape), generator=g, device=dev).to(dtype)
        kv = [torch.randn(8, n_pages, 128, 128, generator=g, device=dev)
              for _ in range(2)]
        kw = dict(window=window)
        if pool in ("bf16", "f32"):
            kp, vp = (t.to(dtype) for t in kv)
        else:
            quantize = qt.quantize_int8 if pool == "int8" else qt.quantize_fp8
            kq, vq = (quantize(t) for t in kv)
            kp, vp = kq.values, vq.values
            kw.update(k_scales=kq.scales, v_scales=vq.scales)
        ms = cs.time_ms(lambda: pa.paged_attention(q, kp, vp, lens_t, table, **kw))
        plain_ms = (cs.time_ms(lambda: plain(q, kp, vp, lens_t, table, **kw))
                    if plain is not None else float("nan"))
        cost = cs._paged_cost(q, chunk, hq, 8, lens_t, quantized=pool not in ("bf16", "f32"),
                              window=window)
        bound = cs.bound_ms(*cost[:2], "bfloat16")[0]
        name = str(dtype).replace("torch.", "")
        print(f"[ab] paged {name} q {label} {pool} pool: ms {ms:.4f}, plain "
              f"{plain_ms:.4f}, bound {bound:.4f}", flush=True)
        del kv, kp, vp, kw


# head dims either side of the 64- and 128-column tiles
HEAD_DIMS = (32, 64, 80, 96, 112, 128)


def _bwd_line(torch, cs, fa, label, q, k, v, causal):
    """(label, dtype name, fn, cost) of a flash_bwd call given its
    forward's lse and di (computed here, outside the timing)."""
    sc = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc)
    do = torch.randn_like(q)
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    return (label, str(q.dtype).replace("torch.", ""),
            lambda: fa.flash_bwd(q, k, v, lse, di, do, causal=causal, sm_scale=sc),
            cs._flash_cost(q, k, causal, None, None, backward=True))


def _headdim(torch, cs, dev):
    """The attention kernels at serve_d96's and train_d96's shapes (B4, 32
    heads, histories <= 2048) over HEAD_DIMS: the bf16 flash forward's
    subrow (the batched prefill) and grid, the f32 flash forward, paged
    decode and chunk 64 over a bf16 pool, kv8_flash int8, and the flash
    backward (bf16 subrow, grid with GQA, op graph; f32 split); device ms
    beside the bound at the real d.  A root whose kernels refuse a head dim
    prints "refused"."""
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.ops import paged_attention as pa
    from flashattn_tpu_torch.ops import quant as qt

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    lens = torch.tensor([2048, 1536, 1024, 517], device=dev)
    n_pages, pps = 4 * 16 + 1, 16
    table = torch.randperm(n_pages, generator=g, device=dev)[:4 * pps]
    table = table.reshape(4, pps).int()
    for d in HEAD_DIMS:
        def randn(*shape, dtype=bf):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        sc = d ** -0.5
        q, k, v = (randn(4, 32, 2048, d) for _ in range(3))
        q1, k1, v1 = (t[:1].contiguous() for t in (q, k, v))
        qf, kf, vf = (t.float() for t in (q, k, v))
        kp, vp = (randn(32, n_pages, 128, d) for _ in range(2))
        qd, qc = randn(4, 32, d), randn(4, 64, 32, d)
        k8, v8 = (qt.quantize_int8(t.float()) for t in (k, v))
        lines = [
            ("flash_fwd subrow B4 H32 N2048 varlen", "bfloat16",
             lambda: fa.flash_fwd(q, k, v, causal=True, sm_scale=sc, kv_lengths=lens),
             cs._flash_cost(q, k, True, None, lens)),
            ("flash_fwd grid B1 H32 N2048 non-causal", "bfloat16",
             lambda: fa.flash_fwd(q1, k1, v1, causal=False, sm_scale=sc),
             cs._flash_cost(q1, k1, False, None, None)),
            ("flash_fwd_f32 B4 H32 N2048 varlen", "float32",
             lambda: fa.flash_fwd(qf, kf, vf, causal=True, sm_scale=sc, kv_lengths=lens),
             cs._flash_cost(qf, kf, True, None, lens)),
            ("paged decode B4 Hkv32 bf16 pool", "bfloat16",
             lambda: pa.paged_attention(qd, kp, vp, lens, table),
             cs._paged_cost(qd, 1, 32, 32, lens)),
            ("paged chunk 64 B4 Hkv32 bf16 pool", "bfloat16",
             lambda: pa.paged_attention(qc, kp, vp, lens, table),
             cs._paged_cost(qc, 64, 32, 32, lens)),
            ("kv8_flash int8 B4 H32 N2048 causal", "bfloat16",
             lambda: qt.flash_attention_kv_int8(q, k8, v8, True, sc),
             cs._kv8_cost(q, k8.values, True))]
        kg, vg = (t[:, :8].contiguous() for t in (k1, v1))   # GQA 32q/8kv
        qo, ko, vo = (t[:, :, :512].contiguous() for t in (q, k, v))
        lines += [
            _bwd_line(torch, cs, fa, "flash_bwd subrow B4 H32 N2048 causal",
                      q, k, v, True),
            _bwd_line(torch, cs, fa, "flash_bwd grid B1 H32/8 N2048 non-causal",
                      q1, kg, vg, False),
            _bwd_line(torch, cs, fa, "flash_bwd op graph B4 H32 N512 causal",
                      qo, ko, vo, True),
            _bwd_line(torch, cs, fa, "flash_bwd_f32 B4 H32 N2048 causal",
                      qf, kf, vf, True)]
        for label, name, fn, cost in lines:
            b_ms, b_by = cs.bound_ms(*cost[:2], name)
            try:
                ms = cs.time_ms(fn)
            except (ValueError, RuntimeError, NotImplementedError) as e:
                print(f"[ab] headdim d{d} {label}: refused ({str(e)[:60]})", flush=True)
                continue
            print(f"[ab] headdim d{d} {label}: ms {ms:.4f}, bound {b_ms:.4g} "
                  f"({b_by}), share {b_ms / ms:.3f}", flush=True)
        del q, k, v, q1, k1, v1, qf, kf, vf, kp, vp, k8, v8, kg, vg, qo, ko, vo
        del lines
        torch.cuda.empty_cache()


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
    if "bwd" in phases:
        _bwd(torch, cs, dev)
    if "f32" in phases:
        _f32(torch, cs, dev)
    if "opgraph" in phases:
        _opgraph(torch, cs, dev)
    if "kv8" in phases:
        _kv8(torch, cs, dev)
    if "ln" in phases:
        _ln(torch, cs, dev)
    if "drop" in phases:
        _drop(torch, cs, dev)
    if "share" in phases:
        _share(torch, cs, dev)
    if "bias" in phases:
        _bias(torch, cs, dev)
    if "sq" in phases:
        _sq(torch, cs, dev)
    if "softmax" in phases:
        _softmax(torch, cs, dev)
    if "paged" in phases:
        _paged(torch, cs, dev)
    if "headdim" in phases:
        _headdim(torch, cs, dev)
    if "train" in phases:
        cs.train_phase(torch, dev, torch.cuda.get_device_name(0))
        torch.cuda.empty_cache()
    if "train_fused" in phases:
        cs.train_phase(torch, dev, torch.cuda.get_device_name(0),
                       cs.TRAIN_FUSED, "train_fused_softmax", cs.FUSED_KERNELS,
                       cs.FUSED_ABSENT)
    if "train_f32" in phases:
        from flashattn_tpu_torch.ops import flash_attention as fa

        split = hasattr(fa, "_f32_kernel")   # an older root: the CUDA-core f32 kernels
        cs.train_phase(torch, dev, torch.cuda.get_device_name(0), name="train_f32",
                       kernels=cs.TRAIN_F32_KERNELS if split else cs.TRAIN_KERNELS,
                       absent=cs.TRAIN_F32_ABSENT if split else (), mixed=False)
        torch.cuda.empty_cache()
    if "mt_step" in phases:
        data = cs.mt_data()
        cs.seq2seq_train_phase(torch, dev, torch.cuda.get_device_name(0), data)
        cs.seq2seq_train_phase(torch, dev, torch.cuda.get_device_name(0), data,
                               mixed=True, remat=True)
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
    for root in args.roots:   # one root at a time: each runs an nvcc per source
        if subprocess.run(
                [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                 "from flashattn_tpu_torch.ops import _build; _build.build()",
                 root]).returncode:
            print(f"[ab] the build of {root} failed", file=sys.stderr)
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
            if line.startswith(("[ab]", "[serve_quant]", "[train", "[seq2seq_train",
                                "[profile] op graph", "[profile] by group",
                                "[profile] attention")) \
                    or "device busy" in line:
                print(line, flush=True)
        if rc != 0:
            print(f"[ab] run {i} failed (rc {rc}); see {log}", file=sys.stderr)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
