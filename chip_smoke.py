#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flashattn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: requires CUDA (there is no CPU path); TF32 off; prints the card's
   name and power limit as nvidia-smi reports them.
2. build: compiles ``flashattn_tpu_torch/csrc/*.cu`` with nvcc for sm_90a.
3. kernels: every kernel of the serving and training paths against its
   plain PyTorch version, bf16 and f32, at the paths' shapes (serving:
   B4 H8 N2048 prefill, LN 8192 x 1024 and decode rows 4 x 1024 (by
   CUDA-graph replay), paged attention (split-K decode and the wgmma
   extend wave, against paged_attention_plain, the TPU kernels' page
   walk: bf16 gated relative to max |ref|; f32 q, the split-precision
   tiles (kernels-line name paged_attention_f32) over an f32 pool at
   decode, chunk 64, GQA 4 and the 2048-row wave, within 1e-4 of the
   plain version and 1e-5 of its float64 run, the split bound printed
   with the FMA figure beside); training: LN
   16384 x 2048, flash B4 H16 N2048 D128 (B4 rather than the train step's
   B8: the plain backward keeps several 1 GiB f32 score tensors), dropout
   16384 x 2048 at p 0.1) plus ragged variants (the bf16 flash forward
   and backward, tensor-core kernels, at head dims 32 / 64 / 128, n 517 /
   1000 / 3000, GQA 8/2 and 16/4, window 256, cross 1000 x 2048, a
   length-0 row, varlen; the loop schedule's forward and backward at B1 H2
   N16384).  f32 flash runs on the tensor cores in split precision: from
   F32_TC_MIN_KV keys on the wgmma kernels behind a split pass, named
   flash_fwd_f32 / flash_bwd_f32 in the lines and the kernels line (their
   main numbers: the train shape's f32 lines, the loop schedule's
   function); below it the warp-level kernels, flash_fwd_f32_mma /
   flash_bwd_f32_mma (their main numbers: the MT decoder's f32 lines),
   also at the distill draft's B16 H2 128 x 128 d64; then a +-inf in q,
   K, V or dO at 40 and 2048 keys (C17: the outputs' NaN / inf classes
   equal the plain versions', and at 2048 keys the wgmma route's call is
   the warp-level kernels' bit for bit).
   The bf16 flash forward (each schedule's function and the op graph) and
   the op graph's backward: at least 99% of the elements bit for bit, the
   rest within one bf16 ulp of their row's largest, lse within 1e-5; at
   16384 keys LOOP_16K_GATE.
   Other tolerances: f32 1e-4, bf16 2e-2, abs on unit-variance inputs for outputs
   and scaled by max(1, max |ref|) for gradients, which are sums over rows
   (bf16 rounds each output once, at 2^-8 of its magnitude); dropout
   bit-exact (the kernel and its plain version compute the same Philox
   bits).  Each line gives the kernel's and the plain version's device
   time (CUDA events, median of 15, each call queued behind a device sleep
   so that the host's launch work does not count), the library call's
   time where PyTorch has one (a yardstick only,
   never called by the port) and the bound: the larger of the bytes the
   function must move over 3.35 TB/s and its useful operations over the
   peak for the type (989 TF bf16 tensor, 67 TF f32; on the split-precision
   f32 kernels three times the operations at 494.7 TF TF32, f32-grade work
   on the tensor cores, with the FMA figure printed beside).
4. serve: the north-star serving model (E1024, 8 heads of 128, 4 layers,
   vocab 1000, middle 256) in bf16 with seeded random weights, driven
   through ContinuousBatchingEngine.submit()/step(): five greedy requests,
   four sharing one batched varlen prefill (2048/1536/1024/517 tokens) and
   a fifth of 3000 tokens admitted when a slot frees (chunked prefill).
   Every kernel's launch count is zeroed just before and must grow.
5. consistency: the same model in f32; engine logits along two ~600-token
   trajectories (one batched, one chunked prefill) against one dense
   DecoderLM.forward, to 1e-3 abs.
6. train: the training configuration of kernel_bench/bench_train_mfu.py
   (E2048, M8192, 4 layers, 16 heads of 128, vocab 16384, batch 8 x 2048)
   with p_dropout 0.1, bf16 compute over f32 masters, through
   make_train_step(Adam(1e-4), make_mixed_precision_loss(lm_loss),
   grad_clip=1.0): 2 warm-up and 5 timed steps on one batch.  Every loss
   finite, the last below the first, and each training kernel launched in
   every step (counts zeroed before each step).  Then train_f32: the same
   step in f32 (no mixed-precision wrapper), where every attention takes
   the loop schedule's function: losses finite and falling, flash_fwd_f32,
   flash_bwd_f32, LayerNorm and dropout launched in every step and the
   bf16 and warp-level flash kernels in none; ms/step, the peak and a profiled step
   with the attention's share of the device time.
7. train consistency: E1024 H8 M4096 L2 V16384, B2 x 1024, f32: one
   lm_loss backward on the card against the same on a CPU copy (the plain
   versions), with p 0 and with p 0.1 from the same generator seed (the
   same Philox masks): loss to 1e-5 relative, each gradient to 1e-4 in
   relative L2 norm — the token embedding's too, whose backward
   (index_put_ with accumulate) sums in no fixed order on the card — except
   the key-projection bias, whose exact gradient is 0 (softmax ignores a
   shift shared by every key): there both devices' rounding noise must stay
   under 1e-4 of the global gradient norm.  Then loop-consistency: the same
   gates on E256 H2 (heads of 128) L2 V16384, B1 x 2048, whose attention
   takes the loop schedule (512-key blocks) on the split-precision kernels.
8. quantization kernels: the weight-only matmul (int8 and fp8 payloads,
   bf16 and f32 x) at the quantized serving model's Linear shapes (K and
   N in {1024, 256}, the lm head's N 1000; bf16 x at M 1, 4, 16, 17, 100
   and 4 x 8192, where its GEMV and tensor-core tile branch; f32 x,
   ``wo_matmul_f32``, at decode M 4 and 16 (the f32 GEMV; N 1024 and the
   lm head's 1000) and prefill 4 x 8192 (the split-precision tile, its
   FMA bound printed beside); yardstick x @ W on the pre-dequantized
   bf16 / f32 weight; calls of M <= 100 timed by CUDA-graph replay, and
   their eager time, the host's launch work included, logged beside),
   quantized
   paged attention (int8 and fp8 pools: decode B4 Hkv8 d128 at histories
   <= 8192, chunk 64, GQA group 4, window 256; B1 Hkv8 decode at 16384
   positions, the quantized model's capacity, for bf16, int8 and fp8
   pools; f32 q on the split-precision tiles as in phase 3, the int8
   decode at <= 8192 the kernels line's paged_attention_f32; the split
   plans and the paged kernels' registers and shared memory logged
   once), flash attention over an
   int8 / fp8 KV cache at one shape of each of JAX's routes
   (``ops/quant.py::_kv8_route``): the subrow B4 H8 N2048 D128 causal
   (fp8 transcoded to int8 first, as JAX does; GQA 8q/2kv), the loop N512
   and the grid cross non-causal 1000 x 2048 (two 1024-key blocks) and
   ragged N 1000 (one block); bf16 q (``kv8_flash``, the route's mode)
   gated as the flash forward, f32 q (``kv8_flash_f32``, split
   precision) at 1e-4; yardstick SDPA on the dequantized cache) and
   stochastic-rounding int8 quantization (32768 x 1024 bf16, bit-exact;
   the mean of 8 seeds on a constant tensor within 2%).  Tolerances as in
   phase 3; the matmul, a sum over K, gated like a gradient.
9. serve_quant: the north-star quantized serving configuration of
   kernel_bench/bench_serving.py:105-141 at full width and depth
   (E1024, 8 heads of 128, 4 layers, vocab 1000, n_positions 16384;
   engine max_batch 4, page 128, 66 pages a sequence, prefill_chunk 8192,
   8 steps a dispatch), five variants in turn: bf16 weights + bf16 pool,
   int8 weights + int8 pool, int8 weights + fp8 pool (the model cast to
   bf16), then northstar() at its own dtype, the f32 model with int8
   weights over an int8 and an fp8 pool.  One warm-up request, then four
   greedy requests of 8192-token prompts and 64 new tokens each (one
   batched varlen prefill).  Every request finishes, no page leaks, the
   bf16 quantized variants launch wo_matmul, paged_attention, flash_fwd
   and layernorm_fwd (the bf16 variant no wo_matmul) and no
   paged_attention_f32, the f32 ones wo_matmul_f32, paged_attention_f32
   (the split-precision paged tiles), flash_fwd_f32 and layernorm_fwd and
   no wo_matmul or bf16-q paged tile.  Then the f32 model's gate: one 8192-token prompt and 16
   new tokens per pool, engine logits against a dense forward of the same
   quantized model, max |diff| / max |dense| < 0.08 and argmax agreement
   >= 0.8.
10. quant_consistency: the f32 model with int8 weights over an int8 and
   then an fp8 pool; engine logits along a 500-token (batched prefill) and
   a 600-token (chunked prefill, chunk 512) trajectory against one dense
   forward of the same quantized model, to the JAX tests' bounds
   (tests/test_serving.py:181-185): max |diff| / max |dense| < 0.08 and
   argmax agreement >= 0.8.
11. serve_features: the north-star serving model of phase 4 in bf16 under
   kernel_bench/bench_serving.py's traffic (16 requests of 64-token
   prompts from default_rng(0) in [1, 999), 64 new tokens each; engine
   max_batch 16, page 128, 8 pages a sequence, 8 steps a dispatch), one
   engine a mode: greedy; sampled at t 0.8 with a quarter of the requests
   each adding top-k 50, top-p 0.9, min-p 0.05, or repetition 1.2 with
   frequency 0.3; draft-model speculation k 4 with bench_serving.py's
   draft (E128, 2 heads, 1 layer); self-draft speculation, greedy and at
   t 0.8; prompt lookup k 3; and the prefix cache (4 requests sharing a
   1024-token prefix with distinct 64-token suffixes, 10 pages a
   sequence).  Logs new tok/s (generated tokens over the run's wall
   time, prefill included, after a warm-up engine), stats() and the
   n-gram proposer that ran, and profiles the first decode dispatch of
   the greedy, sampled and draft modes.  Gates: every request finishes; no page
   leaks once the cache is dropped; paged_attention and layernorm_fwd
   launch in every mode (counts zeroed just before each mode's run; the
   f32 modes launch paged_attention_f32 and no bf16-q paged tile) and
   the model's multi-token forward_extend_paged runs in the speculative
   and prefix-cache modes; the prefix-cache admissions attach the 8 cached
   pages; the native proposer ran; two sampled runs with the same seeds
   land the same tokens; sampled requests alone land what they land
   inside the batch.  The same model in f32: draft, self-draft, lookup
   and prefix-cache greedy tokens identical to plain greedy (in bf16 the
   agreement is logged, not gated).
12. fused-softmax kernels: the attention softmax forward and backward at
   the fused path's shape (8, 16, 2048, 2048) causal without a mask, and
   ragged variants (T 33, 1000, causal; T 4097 and 8200 non-causal, so
   every column is read, the second past the register envelope; a
   (B,1,1,T) padding mask with a length-0 row; a (1,1,F,T) window mask;
   F != T), bf16 in both roundings (JAX's op graph, impl "auto", the
   fused model's and the kernels line's; the Pallas function, "pallas")
   and f32, each against its own plain version; and the dropout variants
   at the training FFN's shapes (act-bias GELU and ReLU at 16384 x 8192,
   res-bias at 16384 x 2048, p 0.1, forward and backward, bf16 and f32).
   The bf16 Pallas function is gated per element at one bf16 ulp of the
   reference (2^-7 |ref| + 1e-6, the backward with slack for the f32
   rounding of its row sum); the op graph, whose arithmetic is its plain
   version's, at 99% of the elements bit for bit and every element within
   two ulps forward (w = sum(e), an f32 sum in another order rounded to
   bf16, may take the neighbouring value in a row) and one ulp plus
   |out| 2^-4 (sum_row |dout out| + |dout|) backward; f32 as in phase 3.
   Other tolerances as in phase 3; the dropout
   variants' dropped positions must be exactly those of the plain version's
   mask, then the values within tolerance (res-bias and ReLU bit for bit,
   GELU gated like a gradient: tanhf differs from torch.tanh).  The
   softmax yardsticks are torch.softmax on the pre-masked scores and
   torch._softmax_backward_data; the dropout variants have none.
13. train_fused_softmax: phase 6's configuration and step with
   attn_impl="fused_softmax" (score matmul, the softmax kernels in JAX's
   op-graph rounding, matmul with V): the bf16 step's losses finite and
   falling, its peak memory logged (the op graph's backward keeps each
   layer's scores); softmax_fwd, softmax_bwd, LayerNorm and dropout
   launched in every step and flash in none; one profiled step.
14. fused consistency: phase 7 with attn_impl="fused_softmax" (card vs CPU
   backward, p 0 and 0.1, the same bounds), and the fused-softmax model's
   dense f32 logits against the flash model's on the same weights, to 1e-4.
15. generate: batched generation over the dense KV cache on the serving
   model of phase 4.  f32 gates: forward_decode step by step over 256
   tokens (B2) against one dense forward, 1e-3 abs; greedy_generate on
   eight ragged prompts (17 to 300 tokens, 64 new) token-identical to the
   engine's greedy tokens; beam 1 equal to greedy; beam 4 (length penalty
   0, an eos no row emits) at least greedy's joint log-prob on two rows
   (tests/test_beam_search.py:69); layernorm_fwd launched.  bf16 (JAX's
   default f32 cache): new tok/s of greedy at B8 and of beam 4 at B2, and
   one profiled 8-step greedy loop.
16. distill: 200 steps of make_train_scan(Adam(1e-3),
   make_distill_loss(), clip 1.0) with the bf16 serving model as the ctx
   teacher of phase 11's draft (E128, 2 heads, 1 layer, f32), B16 x 128
   tokens from default_rng(0): the KL's last 20 steps below its first 20;
   then phase 11's draft mode (k 4, bf16) with the untrained and the
   distilled draft: acceptance and new tok/s, logged (no gate).
17. serve_rope: the serving model with pos_encoding="rope": phase 5's f32
   engine-vs-dense gate and phase 15's cached-decode gate, then phase 4's
   bf16 traffic (prompt tok/s, TTFT, decode tok/s; layernorm_fwd,
   flash_fwd and paged_attention launched); then with 8 experts, top-2:
   the same two f32 gates (equal logits mean equal routing).
18. train_moe: phase 6's configuration with pos_encoding="rope", 8 experts
   and top-2 routing under make_moe_loss(0.01), Adam: losses finite and
   falling, the peak under 80 GB, the training kernels launched in every
   step; then phase 7 on the consistency model with RoPE and 8 experts
   under make_moe_loss (the key-projection bias, whose gradient RoPE makes
   real, compared like the others).
19. train_adafactor: phase 6 with Adafactor() for Adam: losses finite and
   falling, ms/step and the peak logged beside Adam's, the peak below
   Adam's; then three Adafactor steps of the consistency model on the card
   and on the CPU, f32: parameters within 1e-5 relative L2 after steps 1
   and 3 (the key-projection bias, Adafactor's normalised rounding noise
   on a zero gradient, logged).
20. MT kernels (run with phase 3): the op graph (flash_fwd mode 0 and
   flash_bwd's op-graph mode) at the machine-translation model's attention
   shapes, B128 H8 D32 over 40 keys: the encoder's varlen self-attention,
   the decoder's causal self-attention, the cross-attention (forward and
   backward) and generation's cross-attention at n_q 1 (forward), source
   lengths from 1 to 40, f32 and bf16, gated as phase 3's flash lines,
   with SDPA and the bound beside; then the bf16 op graph at its tiles'
   edges (keys 1, 127, 129, 1023; rows 1, 17, 40, 128; GQA 8q/2kv, a
   length-0 row, a window, varlen; the distill draft's B16 H2 N128 D64
   causal), forward and backward.
21. seq2seq_train: the MT app's model at its defaults
   (flashattn_tpu_torch/training/translation.py MTConfig, arch seq2seq:
   E256, 8 heads of 32, 4 + 4 layers, vocab 10000, 40 tokens, p 0.1) over
   the vendored de-en corpus (the app's "deen-fixture" splits), collated
   by the port's collate_batch_seq2seq with a word-level tokenizer
   stand-in (the card's machine may lack the app's tokenizer packages),
   B128, 64 steps through the app's _dispatch_chunk / make_train_scan
   (Adam under the app's warmup-cosine schedule at 0.002, clip 1.0, 8
   steps a dispatch): the loss falls (the last 8 steps' mean below the
   first 8's), every MT kernel launches; ms/step, tokens/s, the peak and
   a profiled dispatch.  Then the same in bf16-mixed with remat.
   seq2seq-consistency: the f32 seq2seq_loss backward on the card against
   a CPU copy, B32, p 0 and 0.1, phase 7's gates.
22. seq2seq_generate: greedy_generate_seq2seq on the trained f32 model, 32
   test sources, 40 new tokens: the tokens equal a no-cache greedy loop
   over the full forward, the cached decode's logits within 1e-3 of the
   teacher-forced forward; new tok/s and a profiled call.
23. mt_app: the app's run() for one short epoch (16 steps) of each arch on
   "deen-fixture" (seq2seq; decoder-only with the engine) where
   tokenizers, transformers, sacrebleu and tqdm all import, its results
   logged; else one line naming the missing packages.
24. c15 (run after phase 3's serving kernels): paged waves wider than one
   row tile (bf16 q at 256 rows, GQA 4 x chunk 64 and 2048 rows; f32 q at
   256), causal and window 256, over bf16 / int8 / fp8 pools holding NaN V
   rows (and, quantized, NaN V scales) on pages outside some tile's own:
   the kernel's NaN pattern equal to paged_attention_plain's, its finite
   elements under the paged gates; the marks kernel (paged_nonfinite) at
   the 2048-row serving wave bit for bit against its plain version; the
   2048-row wave and the chunk-64 call timed beside the parent's figures.
25. utilities: the A6d modules on the card: conv1d / conv2d in f32 against
   the CPU (1e-5) and grad_check of conv1d; train_classifier at the JAX
   tests' arguments (accuracy gates 0.85 / 0.95, the final loss within
   1e-4 relative of the CPU's, ms an epoch); KernelBench over the
   LayerNorm kernel at bf16 (16384, 2048), its device_loop_time (a CUDA
   graph of the chained calls) within 1.5x of time_ms; checkify_errors
   raising on a CUDA NaN with the CUDA context still usable; find_nonfinite
   over a CUDA model.
26. parallel: a one-rank NCCL group (file:// store): the serve model in the
   tensor-parallel engine (bf16 and int8 weights) token-identical to the
   plain engine, logits within 1e-3; ShardedTrainer (plain and zero=True)
   on the train configuration within 1e-5 relative of make_train_step
   after 3 steps, ms/step beside it; ring_flash_attention and
   pipeline_apply(megatron_layer_fn) on one-rank axes; the ring of 4 run
   in one process at B4 H16 N2048 bf16 against the unsharded flash
   forward and backward at the bf16 gate.
27. head dims (last of phase 3's kernels): the attention kernels at heads
   of 80 and 96, between their tile widths (the 128-column tiles
   zero-padded as they load): the flash forward in bf16 in each mode and
   f32 on both routes, the flash backward (bf16 subrow B4 H32 N2048, the
   grid with GQA, the varlen subrow with a length of 0, the op graph at
   N512 and at the MT model's N40; f32 split at B4 H32 N2048, warp-level
   at N40 and N200), paged decode, chunk 64 and a split
   a page over every pool with bf16 and f32 q, kv8_flash bf16 and f32, the
   marks at d 80 with a NaN in V's last column; each under the gate of its
   d-128 line, timed as kernel / plain / library / bound with the bound at
   the real d (head_dim_kernel_phases).
28. serve_d96 (first of the model phases): PHI3_D96, Phi-3-mini-4k's
   widths (E3072, 32 heads of 96, M8192, vocab 32064, RoPE θ 10000) in
   the repo's DecoderLM block, depth cut to 4 layers: in f32 the engine
   logits against the dense forward (1e-3; flash_fwd_f32 and
   paged_attention_f32 launched), then serve's traffic in bf16 (every
   request finishes, no page leaks, flash_fwd, paged_attention and
   paged_nonfinite launched), with the plain versions made to raise
   throughout; prompt tok/s, TTFT and decode tok/s logged.
29. train_d96 (after train): TRAIN_D96, PHI3_D96's widths (E3072, 32 heads
   of 96, M8192, vocab 32064, RoPE) at 2048 positions and p_dropout 0.1,
   depth 4, through phase 6's step (B8 x 2048, bf16 over f32 masters,
   Adam, clip 1.0, 2 warm-up and 5 timed steps): losses finite and
   falling, TRAIN_KERNELS launched in every step, the plain versions made
   to raise throughout (the _pad128 subrow forward and the bf16 wgmma
   backward pair at d 96); ms/step, tokens/s, model TFLOP/s and the peak
   logged, and one profiled step.  Then d96-consistency (after
   loop-consistency): phase 7's gates on CONSIST_D96 (E192, 2 heads of 96,
   L2, RoPE) at B2 x 1024 (the f32 split pair on _pad128's subrow
   schedule) and B2 x 128 (the warp-level trio with its dS scratch).
30. wide head dims (after phase 27): the bf16 flash forward's and the
   bf16-q paged kernels' 256-column tiles at heads of 160 and 256 and
   serve_d256's shapes (8 q heads, one kv head): the flash grid B4 N2048
   varlen, the op graph at N1000 and N128, paged decode, chunk 64 and a
   2048-row wave over every pool, a split a page, the marks with a NaN in
   column d - 1; each under its d-128 line's gate, the bound at the real d
   (wide_head_dim_kernel_phases).
31. serve_d256 (after serve_d96): GEMMA_D256, Gemma-2B's widths (E2048, 8
   heads of 256 and one kv head, M16384, vocab 256000, RoPE, 18 layers,
   uncut) in the repo's block: the f32 engine raises ROADMAP.md §B2b's
   ValueError before any launch (an expected outcome, checked); in bf16,
   with the plain versions made to raise, the engine's logits against the
   bf16 dense forward over phase 5's traffic (max |diff| / max |dense| <
   0.08, argmax agreement >= 0.8), serve's traffic (every request
   finishes, no page leaks, flash_fwd, paged_attention and paged_nonfinite
   launched at d 256), one profiled decode dispatch; prompt tok/s, TTFT
   and decode tok/s logged beside the card's name and power limit.

Prints one ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parent
SEED = 0
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
HBM_BYTES_S = 3.35e12                                  # H100 SXM
PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12,   # dense tensor / FP32
               "int8": 1979e12, "tf32": 494.7e12}       # dense int8 / TF32 tensor
# the north-star serving model (kernel_bench/bench_serving.py:112-115)
MODEL = dict(n_vocab=1000, n_embd=1024, n_head=8, n_positions=4096,
             n_layer=4, p_dropout=0.0, attn_impl="flash")
ENGINE = dict(max_batch=4, page_size=128, pages_per_seq=32,
              prefill_chunk=2048, steps_per_dispatch=8)
PROMPTS = (2048, 1536, 1024, 517, 3000)
NEW_TOKENS = 32
# Phi-3-mini-4k's published widths (microsoft/Phi-3-mini-4k-instruct,
# config.json: hidden 3072, 32 heads of 96, intermediate 8192, vocab 32064,
# 4096 positions, rope theta 10000) in the repo's DecoderLM block, which
# keeps its LayerNorm and GELU FFN where Phi-3 has RMSNorm and SwiGLU.
# Depth cut from 32 layers to 4, as the north-star serve's, so that the
# script stays within its time limit; weights random from SEED.  Heads of
# 96: the attention kernels at a head dim between their tile widths.
PHI3_D96 = dict(n_vocab=32064, n_embd=3072, n_head=32, n_positions=4096,
                n_layer=4, middle_dim=8192, pos_encoding="rope",
                rope_theta=10000.0, p_dropout=0.0, attn_impl="flash")
# the head dims of the kernel lines beside 32, 64 and 128
HEAD_DIM_LINES = (80, 96)
# Gemma-2B's published widths (google/gemma-2b, config.json: hidden 2048,
# 8 heads with head_dim 256 and one kv head (multi-query), intermediate
# 16384, vocab 256000, 8192 positions, rope theta 10000, 18 layers) in the
# repo's DecoderLM block, which keeps its LayerNorm, GELU FFN and untied
# lm head where Gemma has RMSNorm, GeGLU and scaled tied embeddings.  Full
# depth, 2.43 B parameters (embeddings and lm head 2 x 524.3 M, 18 x 76.6 M
# in the layers): 4.9 GB in bf16.  Weights random from SEED.  Heads of 256:
# the bf16 flash forward's and the bf16-q paged tiles of 256 columns.
GEMMA_D256 = dict(n_vocab=256000, n_embd=2048, n_head=8, n_kv_head=1,
                  n_positions=8192, n_layer=18, middle_dim=16384,
                  pos_encoding="rope", rope_theta=10000.0, p_dropout=0.0,
                  attn_impl="flash")
# the head dims of the 256-column tiles' kernel lines: a tile zero-padded
# from 160, and full
WIDE_HEAD_DIM_LINES = (160, 256)
# train_d96: PHI3_D96's widths trained at TRAIN's batch (B8 x 2048), bf16
# over f32 masters, Adam, clip 1.0.  Positions cut from 4096 to the 2048
# the step runs; depth 4 of Phi-3-mini's 32, as serve_d96's.  Dropout 0.1
# as TRAIN's (Phi-3 trains at 0.0), so that the dropout kernel stays on the
# path.  ~549 M parameters: embeddings and lm head 2 x 98.5 M, 4 x 88.1 M
# in the layers.  Its attention (causal, 2048 keys, d 96) is JAX's _pad128
# subrow forward and the bf16 wgmma backward pair at d 96.
TRAIN_D96 = dict(PHI3_D96, n_positions=2048, p_dropout=0.1)
# the f32 card-vs-CPU backward at heads of 96: E192, 2 heads of 96, L2,
# RoPE; at B2 x 1024 (the f32 split pair on _pad128's subrow schedule) and
# B2 x 128 (the warp-level trio with its dS scratch)
CONSIST_D96 = dict(n_vocab=16384, n_embd=192, n_head=2, n_positions=1024,
                   n_layer=2, middle_dim=768, pos_encoding="rope",
                   rope_theta=10000.0, attn_impl="flash")
# (length, the kernel counter of the only f32 backward route it launches)
CONSIST_D96_SEQS = ((1024, "flash_bwd_f32"), (128, "flash_bwd_f32_mma"))
# the training configuration of kernel_bench/bench_train_mfu.py:59, with
# DecoderLM's default dropout so that the dropout kernel is on the path
TRAIN = dict(n_vocab=16384, n_embd=2048, n_head=16, n_positions=2048,
             n_layer=4, middle_dim=8192, p_dropout=0.1, attn_impl="flash")
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
WARMUP_STEPS, TIMED_STEPS = 2, 5
CONSIST = dict(n_vocab=16384, n_embd=1024, n_head=8, n_positions=1024,
               n_layer=2, middle_dim=4096, attn_impl="flash")
# a narrow model whose attention takes the loop schedule in f32 (heads of
# 128, causal, 2048 keys: 512-key blocks), for the card-vs-CPU backward
CONSIST_LOOP = dict(n_vocab=16384, n_embd=256, n_head=2, n_positions=2048,
                    n_layer=2, middle_dim=1024, attn_impl="flash")
# the north-star quantized serving configuration
# (kernel_bench/bench_serving.py:112-127)
QUANT_MODEL = dict(MODEL, n_positions=16384)
QUANT_ENGINE = dict(max_batch=4, page_size=128, pages_per_seq=66,
                    steps_per_dispatch=8, prefill_chunk=8192)
QUANT_PROMPT, QUANT_NEW_TOKENS = 8192, 64
QUANT_KERNELS = ("wo_matmul", "paged_attention", "flash_fwd", "layernorm_fwd")
QUANT_ABSENT = ("paged_attention_f32",)
# JAX's north-star at its own dtype (f32 DecoderLM, int8 weights): the f32
# kernels (split-precision wo tile, paged tiles and flash prefill, the f32
# GEMV) launch, the bf16 wo_matmul and bf16-q paged tiles none
QUANT_F32_KERNELS = ("wo_matmul_f32", "paged_attention_f32", "flash_fwd_f32",
                     "layernorm_fwd")
QUANT_F32_ABSENT = ("wo_matmul", "paged_attention")
# the f32 north-star gate: one 8192-token prompt and 16 new tokens, engine
# logits against a dense forward of the same quantized model
QUANT_F32_GATE_NEW = 16
TRAIN_KERNELS = ("layernorm_fwd", "layernorm_bwd", "flash_fwd", "flash_bwd",
                 "dropout")
# the same step in f32 (no mixed-precision wrapper): every attention takes
# the loop schedule's function on the wgmma split-precision kernels, and
# the bf16 and warp-level (short-walk) flash kernels none
TRAIN_F32_KERNELS = ("layernorm_fwd", "layernorm_bwd", "flash_fwd_f32",
                     "flash_bwd_f32", "dropout")
TRAIN_F32_ABSENT = ("flash_fwd", "flash_bwd", "flash_fwd_f32_mma",
                    "flash_bwd_f32_mma")
# the same training step through attn_impl="fused_softmax": the softmax
# kernels replace flash, which must not launch
TRAIN_FUSED = dict(TRAIN, attn_impl="fused_softmax")
FUSED_KERNELS = ("layernorm_fwd", "layernorm_bwd", "softmax_fwd", "softmax_bwd",
                 "dropout")
FUSED_ABSENT = ("flash_fwd", "flash_bwd")
# the serving-feature traffic of kernel_bench/bench_serving.py:27-60 and
# its draft (:170), on the north-star model
FEAT_ENGINE = dict(max_batch=16, page_size=128, pages_per_seq=8,
                   steps_per_dispatch=8)
FEAT_REQUESTS, FEAT_PROMPT, FEAT_NEW_TOKENS = 16, 64, 64
FEAT_DRAFT = dict(n_vocab=1000, n_embd=128, n_head=2, n_positions=4096,
                  n_layer=1, p_dropout=0.0, attn_impl="flash")
# each quarter of the sampled requests adds one of these to t 0.8
FEAT_SAMPLED = (dict(top_k=50), dict(top_p=0.9), dict(min_p=0.05),
                dict(repetition_penalty=1.2, frequency_penalty=0.3))
PREFIX_REQUESTS, PREFIX_LEN, SUFFIX_LEN = 4, 1024, 64
PREFIX_ENGINE = dict(FEAT_ENGINE, pages_per_seq=10)
FEAT_KERNELS = ("paged_attention", "layernorm_fwd")
# modes whose first decode dispatch is profiled
FEAT_PROFILED = ("greedy", "sampled", "draft k=4")
# batched generation over the dense KV cache, on the serving model: eight
# ragged prompts, 64 new tokens; beam 4 on the first two
GEN_PROMPTS = (17, 300, 45, 128, 233, 64, 190, 99)
GEN_NEW_TOKENS, BEAM_ROWS, BEAM = 64, 2, 4
DECODE_GATE_LEN = 256
# the serving model with rotary positions, and with 8 experts (top-2) too
ROPE_MODEL = dict(MODEL, pos_encoding="rope")
ROPE_MOE_MODEL = dict(ROPE_MODEL, n_experts=8, moe_top_k=2)
# the training configuration with rotary positions and 8 experts (top-2)
TRAIN_MOE = dict(TRAIN, pos_encoding="rope", n_experts=8, moe_top_k=2)
CONSIST_MOE = dict(CONSIST, pos_encoding="rope", n_experts=8, moe_top_k=2)
MOE_AUX_ALPHA = 0.01
# distillation of serve_features' draft from the serving model
DISTILL_STEPS, DISTILL_BATCH, DISTILL_SEQ = 200, 16, 128
# the machine-translation app's model and batch at their defaults
# (flashattn_tpu_torch/training/translation.py MTConfig, arch="seq2seq"):
# E256, 8 heads of 32, 4 encoder and 4 decoder layers, vocab 10000, 40
# tokens, batch 128, dropout 0.1, Adam at 0.002 under the app's one-epoch
# warmup-cosine schedule (20000 samples), clip 1.0, 8 steps a dispatch
MT = dict(n_vocab=10000, n_embd=256, n_head=8, n_positions=40,
          n_encoder_layer=4, n_decoder_layer=4, p_dropout=0.1,
          attn_impl="flash")
MT_LEN, MT_BATCH, MT_SPD, MT_STEPS = 40, 128, 8, 64
MT_LR, MT_SAMPLES, MT_SEED = 0.002, 20000, 11111
MT_GEN_BATCH = 32                     # the app's generation batch
MT_CONSIST_BATCH = 32
# the MT step's kernels in bf16-mixed; in f32 the flash pair's names take
# the f32 route's suffix (_f32_suffix: at 40 keys the warp-level kernels)
MT_KERNELS = ("layernorm_fwd", "layernorm_bwd", "flash_fwd", "flash_bwd",
              "dropout")
MG_KERNELS = ("layernorm_fwd", "flash_fwd")
MT_APP_PACKAGES = ("tokenizers", "transformers", "sacrebleu", "tqdm")
MT_APP_SAMPLES = 2048                 # one short epoch: 16 steps of 128


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 15, host: bool = False) -> float:
    """Median of ``reps`` CUDA-event timings of fn(), after warm-up.  Each
    timing queues behind a ~1 ms device sleep, so the host's launch work
    (the Python wrapper, ctypes) is done before the device reaches the
    start event and only device time counts, as long as that work is
    shorter than the sleep; ``host=True`` leaves the sleep out, so the
    launch work counts too."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if not host:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@functools.cache
def _graph_stream():
    """The one side stream of every graph_ms capture.  cuBLAS keeps a
    workspace for each stream it has run on, for the life of the process:
    a fresh stream per timing left 1 GiB held into the train phases."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fn, calls: int = 20, reps: int = 15) -> float:
    """Device time of one fn() call: ``calls`` calls captured in one CUDA
    graph, the replay timed as :func:`time_ms` times it, divided by
    ``calls``.  For calls of a few microseconds, where one pair of events
    would add its own overhead to each timing."""
    import torch

    side = _graph_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps) / calls


def bound_ms(bytes_: float, flops: float, dtype: str):
    """(least time in ms, what bounds it) for moving ``bytes_`` and doing
    ``flops`` useful operations of ``dtype`` on the H100 SXM; ``flops`` may
    instead map operand types to their operation counts, each at its own
    peak."""
    if not isinstance(flops, dict):
        flops = {dtype: flops}
    t_bytes = bytes_ / HBM_BYTES_S
    t_ops = sum(n / PEAK_FLOP_S[t] for t, n in flops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Phases:
    """Kernel-vs-plain checks: one printed line per phase, and the main-shape
    numbers per kernel for the ``kernels`` line."""

    def __init__(self):
        self.main = {}

    def check(self, kernel: str, label: str, dtype, run_kernel, run_plain,
              cost, main: bool = False, compare=None, library=None, tol=None,
              graph: bool = False):
        """``cost`` = (bytes, useful flops[, the flops of the FMA kernels a
        split-precision kernel replaced, whose bound is printed beside]);
        ``compare`` returns (abs err,
        gated err), gated at ``tol`` (default ``TOL`` of the dtype);
        ``library`` is the PyTorch yardstick call, or None.  ``graph``
        times all three calls by CUDA-graph replay (:func:`graph_ms`)."""
        import torch

        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err, gated = (compare or _max_err)(got, want)
        del got, want
        timer = graph_ms if graph else time_ms
        ms, plain_ms = timer(run_kernel), timer(run_plain)
        lib_ms = None if library is None else timer(library)
        name = str(dtype).replace("torch.", "")
        b_ms, b_by = bound_ms(*cost[:2], name)
        tol = TOL[name] if tol is None else tol
        ok = gated <= tol
        lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
        fma = ""
        if isinstance(cost[1], dict) and "tf32" in cost[1]:
            fma = (f"fma_bound_ms="
                   f"{bound_ms(cost[0], cost[1]['tf32'] / 3, 'float32')[0]:.4g} ")
        elif len(cost) > 2:
            fma = f"fma_bound_ms={bound_ms(cost[0], cost[2], 'float32')[0]:.4g} "
        log(f"[kernel] {kernel:15s} {label:38s} {name:8s} max_abs_err={err:.3e}"
            f" gated={gated:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib} bound_ms={b_ms:.4g} ({b_by}) {fma}"
            f"{'(graph) ' if graph else ''}{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} {label} {name}: error {gated} "
                                 f"over tolerance {tol}")
        if main:
            self.main[kernel] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                     bound_ms=b_ms, bound_by=b_by,
                                     library_ms=lib_ms)


def _abs_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _max_err(got, want):
    err = _abs_err(got, want)
    return err, err


def _lse_err(got, want):
    """max |err| over (o, lse); -inf lse entries must coincide."""
    (o, lse), (o_ref, lse_ref) = got, want
    fin = lse_ref.isfinite()
    if not bool((lse.isfinite() == fin).all()):
        return math.inf, math.inf
    err = max(_abs_err(o, o_ref), _abs_err(lse[fin], lse_ref[fin]))
    return err, err


# (share bit for bit, ulps of the row's largest) of the bf16 flash forward
# at 16384 keys, below the 99% and one ulp of the other flash phases.  A
# score's summation order flips the bf16 rounding of ~0.004% of the p at
# any length, but a row sees up to 16384 of them: with its scores summed in
# f64 the plain version agrees with itself in 99.80% of o at 2048 keys,
# 99.51% at 9216 and 99.31% at 16384, and the tensor cores' order is a
# third one (tools/flash_share_probe.py).  The kernel reads 98.8% there,
# the rest within 1.19 ulps.
LOOP_16K_GATE = (0.985, 2)


def _row_ulp_share(got, want):
    """(share of elements bit for bit, max |err| over one bf16 ulp of the
    row's largest magnitude, 2^-7 max |ref row|; max abs err)."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    row = w.abs().amax(-1, keepdim=True) * 2.0 ** -7
    ratio = torch.where(d == 0, torch.zeros_like(d), d / row)
    return float((g == w).float().mean()), float(ratio.max()), float(d.max())


# the most batch rows whose float64 gradients one witnessed check computes;
# more rows with an element over the gate fail it
WITNESS_ROWS = 8


def _f64_attn_grads(torch, fa, q, k, v, do, causal, scale, lens, window, b):
    """(dq, dk, dv) of batch row ``b`` in float64: autograd of softmax(q k^T
    scale) v over the call's own inputs, with its mask (causal, window,
    lengths; a row with no live key outputs 0) and GQA groups."""
    qb, kb, vb = (t[b:b + 1].double().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        kr, vr = fa.repeat_kv(kb, vb, q.shape[1])
        s = qb @ kr.transpose(-1, -2) * scale
        keep = fa._keep_mask(q.shape[2], k.shape[2], causal, window,
                             None if lens is None else lens[b:b + 1], q.device)
        if keep is not None:
            s = s.masked_fill(~keep, -math.inf)
        m = s.detach().amax(-1, keepdim=True)
        e = torch.exp(s - torch.where(m.isfinite(), m, torch.zeros_like(m)))
        l = e.sum(-1, keepdim=True)
        o = (e / torch.where(l == 0, torch.ones_like(l), l)) @ vr
        grads = torch.autograd.grad(o, (qb, kb, vb), do[b:b + 1].double())
    return tuple(x[0] for x in grads)


def _witnessed_ulp(g, w, exact, i, ulps, label):
    """The row-ulp ratio (``_row_ulp_share``'s) of gradient ``i`` after a
    float64 witness: an element over ``ulps`` ulps of its row's largest is
    exempt when the kernel's error against ``exact(b)[i]``, the float64
    gradient of its batch row, is at most the plain version's plus one bf16
    ulp (2^-7) of the float64 row's largest magnitude.  Every other element
    keeps its ratio; over WITNESS_ROWS batch rows none is exempt."""
    import torch

    g, w = g.float(), w.float()
    d = (g - w).abs()
    ratio = torch.where(d == 0, torch.zeros_like(d),
                        d / (w.abs().amax(-1, keepdim=True) * 2.0 ** -7))
    over = (ratio > ulps).nonzero()
    rows = over[:, 0].unique().tolist()
    if len(rows) > WITNESS_ROWS:
        return float(ratio.max())
    n_ok = 0
    for b in rows:
        x = exact(b)[i]
        idx = tuple(over[over[:, 0] == b][:, 1:].T)
        ulp64 = (x.abs().amax(-1, keepdim=True) * 2.0 ** -7).expand_as(x)
        ok = ((g[b].double() - x).abs()[idx]
              <= (w[b].double() - x).abs()[idx] + ulp64[idx])
        n_ok += int(ok.sum())
        rb = ratio[b]
        rb[idx] = torch.where(ok, torch.zeros_like(rb[idx]), rb[idx])
    log(f"[kernel] {label} gradient {i}: {over.shape[0]} elements over {ulps} "
        f"ulp of their row's largest, in batch rows {rows}; {n_ok} of them "
        f"no further from float64 than the plain version (+ one ulp of the "
        f"float64 row)")
    return float(ratio.max())


def _row_ulp_err(got, want, share=0.99, lse_tol=1e-5, label="", ulps=1,
                 exact=None):
    """For bf16 results that round where the plain version rounds (the flash
    forward's schedule functions and the op graph, its backward): (max abs
    err, gated), gated <= 1 when at least ``share`` of the elements are bit
    for bit, every other one within one bf16 ulp of its row's largest
    magnitude, and lse (for an (o, lse) pair) within ``lse_tol``.  Over a
    tuple of gradients, the worst of them; with ``exact`` (batch row ->
    its float64 gradients) an element over the ulp gate passes only where
    the float64 witness does (:func:`_witnessed_ulp`).  Logs the shares."""
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    lse_gated = 0.0
    if isinstance(got, tuple) and len(got) == 2 and got[1].dtype != got[0].dtype:
        (o, lse), (o_ref, lse_ref) = got, want
        fin = lse_ref.isfinite()
        if not bool((lse.isfinite() == fin).all()):
            return math.inf, math.inf
        lse_gated = _abs_err(lse[fin], lse_ref[fin]) / lse_tol
        pairs = [(o, o_ref)]
    err, gated, shares = 0.0, lse_gated, []
    for i, (g, w) in enumerate(pairs):
        sh, ulp, e = _row_ulp_share(g, w)
        if ulp > ulps and exact is not None:
            ulp = _witnessed_ulp(g, w, exact, i, ulps, label)
        shares.append(sh)
        err = max(err, e)
        gated = max(gated, ulp / ulps, (1.0 - sh) / (1.0 - share))
    log(f"[kernel] {label} bf16: " + ", ".join(f"{100 * x:.3f}%" for x in shares)
        + f" bit for bit (gate {100 * share:.2f}%, the rest within {ulps} ulp of "
        f"the row's largest)")
    return err, gated


def _flash_gate(dtype, label):
    """``compare`` and ``tol`` of a flash forward check: bf16 by
    :func:`_row_ulp_err` (gated at 1), f32 by :func:`_lse_err` at TOL."""
    import torch

    if dtype == torch.bfloat16:
        return dict(compare=lambda got, want: _row_ulp_err(got, want, label=label),
                    tol=1.0)
    return dict(compare=_lse_err)


def _grad_err(got, want):
    """Over a tuple of gradients: (max abs err, max of abs err over
    max(1, max |ref|)) — gradients are sums over rows."""
    errs = [(_abs_err(g, w), max(1.0, float(w.float().abs().max())))
            for g, w in zip(got, want)]
    return max(e for e, _ in errs), max(e / s for e, s in errs)


def _scaled_err(got, want):
    """One tensor gated like a gradient: over 33.5 M LayerNorm outputs the
    largest |y| reaches [8, 16), where one bf16 ulp is 0.0625."""
    return _grad_err((got,), (want,))


def _rel_err(got, want):
    """(max abs err, max abs err over max |ref|): attention outputs over long
    random histories are averages of size ~0.02, well under an abs gate."""
    err = _abs_err(got, want)
    return err, err / max(float(want.float().abs().max()), 1e-30)


def _bit_err(got, want):
    """0 when bit-identical, else the max abs difference (gated as inf)."""
    import torch

    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    if torch.equal(got.view(bits), want.view(bits)):
        return 0.0, 0.0
    return _abs_err(got, want), math.inf


def _live_pairs(n_q, n_kv, causal, window, lens, b):
    """(row, key) pairs that the attention mask leaves live, per head."""
    import numpy as np

    rows = np.arange(n_q)
    total = 0
    for bi in range(b):
        kv = n_kv if lens is None else min(n_kv, max(int(lens[bi]), 0))
        hi = np.minimum(kv, rows + 1) if causal else np.full(n_q, kv)
        lo = np.maximum(0, rows - window + 1) if window else 0
        total += int(np.maximum(hi - lo, 0).sum())
    return total


def _f32_suffix(n_kv: int) -> str:
    """The kernels-line suffix of an f32 flash call over ``n_kv`` keys:
    "_f32" on the wgmma split-precision kernels (``flash_fwd_f32``,
    ``flash_bwd_f32``), "_f32_mma" on the warp-level ones; an older package
    (tools/ab_chip_smoke.py's parent root) ran CUDA-core kernels below its
    threshold, counted with bf16's ("")."""
    from flashattn_tpu_torch.ops import flash_attention as fa

    min_kv = getattr(fa, "F32_TC_MIN_KV", None)   # None: an older package
    if hasattr(fa, "f32_route"):
        return "_f32" if fa.f32_route(n_kv) == "wgmma" else "_f32_mma"
    return "_f32" if min_kv is not None and n_kv >= min_kv else ""


def _suffixed(names, suffix):
    """``names`` with the flash kernels' names given an f32 route's suffix."""
    return tuple(n + suffix if n.startswith("flash_") else n for n in names)


def _f32_tc(q, k) -> bool:
    """Whether an f32 flash call runs on the tensor cores in split
    precision (either route; an older package's CUDA-core kernels not)."""
    return str(q.dtype) == "torch.float32" and _f32_suffix(k.shape[2]) != ""


def _flash_name(kernel, q, k) -> str:
    """The kernels-line name of a flash call's kernel: ``kernel`` plus the
    f32 route's suffix (_f32_suffix)."""
    return kernel + (_f32_suffix(k.shape[2]) if str(q.dtype) == "torch.float32"
                     else "")


def _flash_cost(q, k, causal, window, lens, backward=False):
    """(bytes, useful flops): fwd reads q, k, v and writes o, lse (2 dots);
    bwd reads q, k, v, do, lse, di and writes dq, dk, dv (5 dots).  On the
    split-precision kernels the flops count three times at the TF32 peak
    (f32-grade products on the tensor cores: three TF32 or six bf16 ones,
    the same least time), as {"tf32": 3 flops}."""
    b, h, n_q, d = q.shape
    h_kv, n_kv = k.shape[1], k.shape[2]
    isz = q.element_size()
    pairs = h * _live_pairs(n_q, n_kv, causal, window,
                            None if lens is None else lens.tolist(), b)
    q_elems, kv_elems = b * h * n_q * d, b * h_kv * n_kv * d
    if backward:
        cost = (3 * q_elems + 4 * kv_elems) * isz + 8 * b * h * n_q, \
            10 * d * pairs
    else:
        cost = (2 * q_elems + 2 * kv_elems) * isz + 4 * b * h * n_q, \
            4 * d * pairs
    return (cost[0], {"tf32": 3 * cost[1]}) if _f32_tc(q, k) else cost


def _sdpa(torch, q, k, v, causal, window, lens):
    """The library yardstick for flash: (fn, args) with fn(*args) the
    F.scaled_dot_product_attention call of the same function (GQA heads
    repeated; masks other than plain causal as a boolean mask)."""
    from flashattn_tpu_torch.ops import flash_attention as fa

    k, v = fa.repeat_kv(k, v, q.shape[1])
    mask = None
    if window is not None or lens is not None:
        mask = fa._keep_mask(q.shape[2], k.shape[2], causal, window, lens,
                             q.device)

    def fn(q_, k_, v_):
        return torch.nn.functional.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask, is_causal=causal and mask is None)

    return fn, (q, k, v)


def _sdpa_bwd(torch, q, k, v, do, causal, window, lens):
    """Yardstick for flash_bwd: the backward alone of the SDPA call."""
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    fwd, args = _sdpa(torch, qg, kg, vg, causal, window, lens)
    out = fwd(*args)
    return lambda: torch.autograd.grad(out, args, do, retain_graph=True)


def _ln_bwd_library(torch, x, dy, gam, bet):
    xg, gg, bg = (t.detach().requires_grad_() for t in (x, gam, bet))
    y = torch.nn.functional.layer_norm(xg, (x.shape[-1],), gg, bg)
    return lambda: torch.autograd.grad(y, (xg, gg, bg), dy, retain_graph=True)


def _ln_cost(n, h, isz, backward=False):
    if backward:   # read x, dy, gamma, mean, rstd; write dx, dgamma, dbeta
        return 3 * n * h * isz + 3 * h * isz + 8 * n, 0
    return 2 * n * h * isz + 2 * h * isz + 8 * n, 0


def serving_kernel_phases(torch, dev, ph: Phases, randn):
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.ops import layernorm as ln
    from flashattn_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        isz = torch.tensor([], dtype=dtype).element_size()
        # fused LayerNorm at the serving rows x width
        x = randn(8192, 1024, dtype=dtype)
        gam, bet = randn(1024, dtype=dtype), randn(1024, dtype=dtype)
        ph.check("layernorm_fwd", "rows 8192 h 1024", dtype,
                 lambda: ln.layernorm_fwd(x, gam, bet)[0],
                 lambda: ln.layernorm_reference(x, gam, bet),
                 _ln_cost(8192, 1024, isz), main=main,
                 library=lambda: torch.nn.functional.layer_norm(
                     x, (1024,), gam, bet))
        xd = randn(4, 1024, dtype=dtype)
        ph.check("layernorm_fwd", "decode rows 4 h 1024", dtype,
                 lambda: ln.layernorm_fwd(xd, gam, bet)[0],
                 lambda: ln.layernorm_reference(xd, gam, bet),
                 _ln_cost(4, 1024, isz), graph=True,
                 library=lambda: torch.nn.functional.layer_norm(
                     xd, (1024,), gam, bet))

        # flash: batched varlen prefill B4 H8 N2048 D128
        lens = torch.tensor([2048, 1536, 1024, 517], device=dev)
        q, k, v = (randn(4, 8, 2048, 128, dtype=dtype) for _ in range(3))
        scale = 128 ** -0.5
        lib, args = _sdpa(torch, q, k, v, True, None, lens)
        ph.check(_flash_name("flash_fwd", q, k),
                 "B4 H8 N2048 D128 causal varlen", dtype,
                 lambda: fa.flash_fwd(q, k, v, causal=True, sm_scale=scale,
                                      kv_lengths=lens),
                 lambda: fa.flash_fwd_plain(q, k, v, True, scale, lens),
                 _flash_cost(q, k, True, None, lens), main=main,
                 **_flash_gate(dtype, "flash_fwd varlen prefill"),
                 library=lambda: lib(*args))

        # paged decode: B4, 8 kv heads, d128, page 128, histories <= 2048
        n_pages, pps = 4 * 16 + 1, 16
        kp, vp = (randn(8, n_pages, 128, 128, dtype=dtype) for _ in range(2))
        table = torch.randperm(n_pages, generator=g, device=dev)[:4 * pps]
        table = table.reshape(4, pps).int()
        qd = randn(4, 8, 128, dtype=dtype)
        ph.check("paged_attention" if main else "paged_attention_f32",
                 "decode B4 Hkv8 d128 page128", dtype,
                 lambda: pa.paged_attention(qd, kp, vp, lens, table),
                 lambda: pa.paged_attention_plain(qd, kp, vp, lens, table),
                 _paged_cost(qd, 1, 8, 8, lens), main=main,
                 **(dict(compare=_rel_err) if main else _paged_f32_gate(
                     pa, qd, kp, vp, lens, table, {}, "decode f32 pool")))

    bf = torch.bfloat16
    # flash variants at the prefill shape: every head dim, ragged lengths
    # (517, 1000, 3000: neither the 128-row block nor the 128-key tile
    # divides them), GQA, window, cross attention and a length-0 row
    q, k, v = (randn(4, 8, 2048, 128, dtype=bf) for _ in range(3))
    k2, v2 = (randn(4, 2, 2048, 128, dtype=bf) for _ in range(2))
    lens = torch.tensor([2048, 1536, 1024, 517], device=dev)
    lens0 = torch.tensor([2048, 0, 1024, 517], device=dev)
    q32, k32, v32 = (randn(4, 8, 2048, 32, dtype=bf) for _ in range(3))
    q64, k64, v64 = (randn(4, 8, 2048, 64, dtype=bf) for _ in range(3))
    q3k, k3k, v3k = (randn(1, 8, 3000, 128, dtype=bf) for _ in range(3))
    variants = [
        ("GQA 8q/2kv varlen", (q, k2, v2), dict(kv_lengths=lens)),
        ("window 256 varlen", (q, k, v), dict(kv_lengths=lens, window=256)),
        ("D32 varlen", (q32, k32, v32), dict(kv_lengths=lens)),
        ("D64 varlen", (q64, k64, v64), dict(kv_lengths=lens)),
        ("len=0 row", (q, k, v), dict(kv_lengths=lens0)),
        ("dense causal, no lengths", (q, k, v), {}),
        ("causal N517", (q[:, :, :517], k[:, :, :517], v[:, :, :517]), {}),
        ("causal N1000 D64", (q64[:, :, :1000], k64[:, :, :1000],
                              v64[:, :, :1000]), {}),
        ("causal N3000", (q3k, k3k, v3k), {}),
        ("cross non-causal 1000 x 2048", (q[:, :, :1000], k, v),
         dict(causal=False)),
        ("grid D64 non-causal N2048", (q64, k64, v64), dict(causal=False)),
        ("window 256, no lengths", (q, k, v), dict(window=256)),
        ("op graph varlen N768", (q[:, :, :768], k[:, :, :768],
                                  v[:, :, :768]),
         dict(kv_lengths=torch.tensor([768, 500, 0, 300], device=dev))),
    ]
    for label, (a, b_, c), kw in variants:
        a, b_, c = (t.contiguous() for t in (a, b_, c))
        sc = a.shape[-1] ** -0.5
        kw = dict(kw)
        causal = kw.pop("causal", True)
        win, ln_ = kw.get("window"), kw.get("kv_lengths")
        lib, args = _sdpa(torch, a, b_, c, causal, win, ln_)
        ph.check("flash_fwd", label, bf,
                 lambda: fa.flash_fwd(a, b_, c, causal=causal, sm_scale=sc, **kw),
                 lambda: fa.flash_fwd_plain(a, b_, c, causal, sc, ln_, win),
                 _flash_cost(a, b_, causal, win, ln_),
                 **_flash_gate(bf, f"flash_fwd {label} ("
                                        f"{fa._schedule(a, b_, causal, win, ln_ is not None).name})"),
                 library=lambda: lib(*args))
    del q, k, v, k2, v2, q32, k32, v32, q64, k64, v64, q3k, k3k, v3k

    # paged: chunk 64, GQA group 4, and the 2048-token chunked-prefill wave
    n_pages, pps = 4 * 16 + 1, 16
    kp, vp = (randn(8, n_pages, 128, 128, dtype=bf) for _ in range(2))
    table = torch.randperm(n_pages, generator=g, device=dev)[:4 * pps]
    table = table.reshape(4, pps).int()
    # (lengths count the chunk, so a 2048-token wave from base 0 has 2048)
    wave = torch.full((4,), 2048, device=dev)
    for label, q_, ln_, chunk, hq in [
            ("chunk 64", randn(4, 64, 8, 128, dtype=bf), lens, 64, 8),
            ("decode GQA group 4", randn(4, 32, 128, dtype=bf), lens, 1, 32),
            ("extend wave chunk 2048", randn(4, 2048, 8, 128, dtype=bf), wave,
             2048, 8)]:
        ph.check("paged_attention", label, bf,
                 lambda: pa.paged_attention(q_, kp, vp, ln_, table),
                 lambda: pa.paged_attention_plain(q_, kp, vp, ln_, table),
                 _paged_cost(q_, chunk, hq, 8, ln_), compare=_rel_err)
    # the same three over an f32 pool with f32 q (the split-precision
    # tiles), drawn from a generator of their own so that the phases after
    # this one keep their inputs
    g32 = torch.Generator(device=dev).manual_seed(SEED + 21)

    def randn32(*shape):
        return torch.randn(shape, generator=g32, device=dev)

    kp, vp = (randn32(8, n_pages, 128, 128) for _ in range(2))
    for label, q_, ln_, chunk, hq in [
            ("chunk 64", randn32(4, 64, 8, 128), lens, 64, 8),
            ("decode GQA group 4", randn32(4, 32, 128), lens, 1, 32),
            ("extend wave chunk 2048", randn32(4, 2048, 8, 128), wave, 2048, 8)]:
        ph.check("paged_attention_f32", f"{label} f32 pool", torch.float32,
                 lambda: pa.paged_attention(q_, kp, vp, ln_, table),
                 lambda: pa.paged_attention_plain(q_, kp, vp, ln_, table),
                 _paged_cost(q_, chunk, hq, 8, ln_),
                 **_paged_f32_gate(pa, q_, kp, vp, ln_, table, {},
                                   f"{label} f32 pool"))


def _abs_err64(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def _paged_f32_gate(pa, q, kp, vp, lens, table, kw, label):
    """``compare`` and ``tol`` of an f32-q paged line: the split-precision
    tiles against the plain version (TOL, 1e-4) and against a float64 run
    of it (f32 pools widened) within 1e-5, where the plain f32 version is
    itself off by its dots' roundings (logged beside); gated at 1 as the
    larger of the two errors over its gate."""
    def compare(got, want):
        wide = [t.double() if t.dtype == q.dtype else t for t in (kp, vp)]
        ref64 = pa.paged_attention_plain(q.double(), *wide, lens, table, **kw)
        err, e64 = _abs_err64(got, want), _abs_err64(got, ref64)
        log(f"[kernel] paged_attention_f32 {label}: against float64 {e64:.3e} "
            f"(gate 1e-5), the plain f32 version {_abs_err64(want, ref64):.3e}")
        return err, max(err / TOL["float32"], e64 / 1e-5)

    return dict(compare=compare, tol=1.0)


def _paged_cost(q, chunk, hq, h_kv, lens, quantized=False, window=None):
    """(bytes, flops) of paged attention: q and out, the K/V of every token
    some row sees once (a quantized pool: 1-byte payloads and a 4-byte scale
    per token); row j of a chunk sees length - chunk + j + 1 keys, at most
    ``window`` of them, so a sequence's last window + chunk - 1 tokens.
    f32 q: (bytes, split-precision flops, FMA flops)."""
    isz, d = q.element_size(), q.shape[-1]
    lens = [int(n) for n in lens.tolist()]
    if window is None:
        pairs = sum(chunk * n - chunk * (chunk - 1) // 2 for n in lens) * hq
        tokens = sum(lens)
    else:
        pairs = sum(min(n - chunk + j + 1, window) for n in lens
                    for j in range(chunk)) * hq
        tokens = sum(min(n, window + chunk - 1) for n in lens)
    token = d + 4 if quantized else d * isz
    bytes_, flops = 2 * q.numel() * isz + 2 * tokens * h_kv * token, 4 * d * pairs
    if isz == 4:
        # f32 q runs split precision: three bf16 products a product over a
        # quantized pool (exact in bf16), six over an f32 one; the FMA
        # kernels' flops at the f32 peak beside
        return bytes_, {"bfloat16": (3 if quantized else 6) * flops}, flops
    return bytes_, flops


# C15: the 2048-row extend wave's and the chunk-64 call's times before the
# marks and poison passes, as PERF.md (section 6, row 12) records them
# (NVIDIA H100 80GB HBM3, 700.00 W)
C15_PARENT_MS = {"extend wave chunk 2048": 0.1564, "chunk 64": 0.0304}
C15_WAVES = {"256 rows": (256, 2, 2), "256 rows, GQA 4 x chunk 64": (64, 8, 2),
             "2048 rows": (2048, 2, 2)}


def c15_inputs(torch, dev, g, dtype, pool, chunk, hq, hkv, d=128, page=128):
    """q, pools (and scales) and a table for three sequences whose waves
    start at 0, 300 and 700, with NaN V rows in columns that say where: 1 on
    the first page (before a late tile's window), 2 mid-wave, 3 at the last
    key, 4 past the length in the last page, 5 on a page past the walk
    (never visited: no NaN); with a quantized pool NaN V scales in the last
    sequence.  An int8 payload cannot hold a NaN."""
    from flashattn_tpu_torch.ops import quant as qt

    b = 3
    lens = [chunk, chunk + 300, chunk + 700]
    pps = -(-max(lens) // page) + 1
    n_pages = b * pps + 1
    table = torch.randperm(n_pages, generator=g, device=dev)[:b * pps]
    table = table.reshape(b, pps).int()
    kv = [torch.randn(hkv, n_pages, page, d, generator=g, device=dev)
          for _ in range(2)]
    kw = {}
    if pool == "bf16":
        kp, vp = (t.to(dtype) for t in kv)
    else:
        quantize = qt.quantize_int8 if pool == "int8" else qt.quantize_fp8
        kq, vq = (quantize(t) for t in kv)
        kp, vp = kq.values, vq.values
        kw = dict(k_scales=kq.scales, v_scales=vq.scales)
    for bi, n in enumerate(lens):
        end = -(-n // page) * page
        for col, pos in ((1, 3), (2, n - chunk // 2), (3, n - 1),
                         (4, end - 1), (5, end + 5)):
            if pool != "int8" and pos // page < pps:
                vp[:, table[bi, pos // page], pos % page, col + 8 * bi] = math.nan
    if pool != "bf16":
        for pos in (10, lens[2] - 3):
            kw["v_scales"][:, table[2, pos // page], pos % page] = math.nan
    q = torch.randn((b, chunk, hq, d), generator=g, device=dev).to(dtype)
    return q, kp, vp, torch.tensor(lens, device=dev), table, kw


def _nan_err(got, want):
    """(max abs err, gated err) over the elements where ``want`` is not
    NaN, the gated one over max |want| in bf16 (the paged gate); inf where
    the NaN patterns differ."""
    import torch

    if not torch.equal(got.isnan(), want.isnan()):
        return math.inf, math.inf
    fin = ~want.isnan()
    scaled = want.dtype == torch.bfloat16
    got, want = got.float()[fin], want.float()[fin]
    err = _abs_err(got, want)
    return err, err / max(float(want.abs().max()), 1e-30) if scaled else err


def c15_kernel_phases(torch, dev, ph: Phases, randn):
    """C15: waves wider than one row tile hold the page walk's NaN pattern
    (every visited page's non-finite V reaches every row of the wave) and
    its finite values to the paged gates; the marks kernel at the serving
    wave's shape against its plain version; the 2048-row extend wave and
    the chunk-64 call timed beside the parent's figures."""
    from flashattn_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    cases = [(torch.bfloat16, name, shape, win, pool)
             for name, shape in C15_WAVES.items() for win in (None, 256)
             for pool in ("bf16", "int8", "fp8")]
    cases += [(torch.float32, "256 rows", (256, 2, 2), win, pool)
              for win in (None, 256) for pool in ("f32", "int8", "fp8")]
    for dtype, name, (chunk, hq, hkv), win, pool in cases:
        q, kp, vp, lens, table, kw = c15_inputs(
            torch, dev, g, dtype, "bf16" if pool == "f32" else pool, chunk,
            hq, hkv)
        got = pa.paged_attention(q, kp, vp, lens, table, window=win, **kw)
        want = pa.paged_attention_plain(q, kp, vp, lens, table, window=win,
                                        **kw)
        torch.cuda.synchronize()
        err, gated = _nan_err(got, want)
        nan_rows = [round(float(want[bi].isnan().any(-1).float().mean()), 3)
                    for bi in range(3)]
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        ok = gated <= tol
        log(f"[c15] {str(dtype)[6:]} q, {name}, window {win}, {pool} pool: "
            f"NaN pattern {'equal' if math.isfinite(err) else 'DIFFERS'}, "
            f"finite max_abs_err={err:.3e} gated={gated:.3e}, share of rows "
            f"with a NaN by sequence {nan_rows} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"c15 {name} {win} {pool}: {gated}")
        del q, kp, vp, got, want

    # the marks kernel at the serving wave: B4 Hkv8 d128 page 128, 2048 rows
    bf = torch.bfloat16
    n_pages, pps = 4 * 16 + 1, 16
    vp = randn(8, n_pages, 128, 128, dtype=bf)
    vp[:, 5, 7, 9] = math.nan
    table = torch.randperm(n_pages, generator=g, device=dev)[:4 * pps]
    table = table.reshape(4, pps).int()
    wave = torch.full((4,), 2048, device=dev)
    ph.check("paged_nonfinite", "marks, 2048-row wave B4 Hkv8 d128", bf,
             lambda: pa.paged_nonfinite(vp, wave, table, 2048),
             lambda: pa.paged_nonfinite_plain(vp, wave, table, 2048),
             (4 * 16 * 128 * 8 * 128 * 2 + 4 * 8 * 16 * 5 * 4, 0), main=True,
             compare=_bit_err)
    # the wave and the chunk-64 call (serving_kernel_phases' inputs) timed
    # with the passes, beside the parent's times
    kp = randn(8, n_pages, 128, 128, dtype=bf)
    lens = torch.tensor([2048, 1536, 1024, 517], device=dev)
    for label, q_, ln_ in (("extend wave chunk 2048",
                            randn(4, 2048, 8, 128, dtype=bf), wave),
                           ("chunk 64", randn(4, 64, 8, 128, dtype=bf), lens)):
        vp = randn(8, n_pages, 128, 128, dtype=bf)
        ms = time_ms(lambda: pa.paged_attention(q_, kp, vp, ln_, table))
        log(f"[c15] {label}: {ms:.4f} ms with the passes; the parent's "
            f"{C15_PARENT_MS[label]:.4f} (PERF.md, row 12)")


def training_kernel_phases(torch, dev, ph: Phases, randn):
    from flashattn_tpu_torch.ops import dropout as dr
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.ops import layernorm as ln

    n, h = TRAIN_BATCH * TRAIN_SEQ, TRAIN["n_embd"]
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        isz = torch.tensor([], dtype=dtype).element_size()
        x = randn(n, h, dtype=dtype) * 2 + 0.5
        dy = randn(n, h, dtype=dtype)
        gam, bet = randn(h, dtype=dtype), randn(h, dtype=dtype)
        ph.check("layernorm_fwd", f"train rows {n} h {h}", dtype,
                 lambda: ln.layernorm_fwd(x, gam, bet)[0],
                 lambda: ln.layernorm_reference(x, gam, bet),
                 _ln_cost(n, h, isz), compare=_scaled_err,
                 library=lambda: torch.nn.functional.layer_norm(
                     x, (h,), gam, bet))
        _, mean, rstd = ln.layernorm_fwd(x, gam, bet)
        ph.check("layernorm_bwd", f"train rows {n} h {h}", dtype,
                 lambda: ln.layernorm_bwd(x, dy, mean, rstd, gam),
                 lambda: ln.layernorm_bwd_reference(x, dy, mean, rstd, gam),
                 _ln_cost(n, h, isz, backward=True), main=main,
                 compare=_grad_err,
                 library=_ln_bwd_library(torch, x, dy, gam, bet))
        del x, dy, mean, rstd

        xd = randn(n, h, dtype=dtype)
        seed = 0x9E3779B97F4A7C15
        ph.check("dropout", f"train {n} x {h} p 0.1", dtype,
                 lambda: dr.dropout(xd, 0.1, seed),
                 lambda: dr.dropout_reference(xd, 0.1, seed),
                 (2 * xd.numel() * isz, 0), main=main, compare=_bit_err,
                 library=lambda: torch.nn.functional.dropout(xd, 0.1, True))
        keep = float((dr.dropout(xd, 0.1, seed) != 0).float().mean())
        log(f"[kernel] dropout keep fraction {keep:.5f} (want 0.9 +- 0.005)")
        if abs(keep - 0.9) > 0.005:
            raise AssertionError(f"dropout keeps {keep}, not 0.9")
        del xd

        # flash at the training head shape, B4 (see the module docstring)
        q, k, v, do = (randn(4, 16, 2048, 128, dtype=dtype) for _ in range(4))
        # bf16: the subrow schedule; f32: the loop schedule's function on
        # the split-precision kernels, whose main-shape numbers these are
        _flash_bwd_check(torch, ph, fa, "B4 H16 N2048 D128 dense causal",
                         dtype, q, k, v, do, True, None, None, main=True)
        lib, args = _sdpa(torch, q, k, v, True, None, None)
        ph.check(_flash_name("flash_fwd", q, k),
                 "train B4 H16 N2048 D128 causal", dtype,
                 lambda: fa.flash_fwd(q, k, v, causal=True, sm_scale=128**-0.5),
                 lambda: fa.flash_fwd_plain(q, k, v, True, 128**-0.5),
                 _flash_cost(q, k, True, None, None), main=not main,
                 **_flash_gate(dtype, "flash_fwd train (subrow)"),
                 library=lambda: lib(*args))
        del lib, args
        if _f32_tc(q, k):
            _f64_flash_check(torch, fa, q, k, v, do, True)
        del q, k, v, do

    bf = torch.bfloat16
    lens0 = torch.tensor([2048, 0, 1024, 517], device=dev)
    for label, shapes, causal, window, lens in [
            ("GQA 16q/4kv causal", ((4, 16, 2048, 128), (4, 4, 2048, 128)),
             True, None, None),
            ("window 256", ((4, 16, 2048, 128),) * 2, True, 256, None),
            ("varlen with a len-0 row", ((4, 16, 2048, 128),) * 2, True, None,
             lens0),
            ("D32 causal", ((4, 16, 2048, 32),) * 2, True, None, None),
            ("D64 causal", ((4, 16, 2048, 64),) * 2, True, None, None),
            ("cross non-causal n_q 1000 n_kv 2048",
             ((4, 16, 1000, 128), (4, 16, 2048, 128)), False, None, None)]:
        q, do = (randn(*shapes[0], dtype=bf) for _ in range(2))
        k, v = (randn(*shapes[1], dtype=bf) for _ in range(2))
        _flash_bwd_check(torch, ph, fa, label, bf, q, k, v, do, causal,
                         window, lens)

    # the op graph's forward and backward (below 1024 keys) at the train
    # head shape
    q, k, v, do = (randn(4, 16, 512, 128, dtype=bf) for _ in range(4))
    lib, args = _sdpa(torch, q, k, v, True, None, None)
    ph.check("flash_fwd", "op graph B4 H16 N512 D128 causal", bf,
             lambda: fa.flash_fwd(q, k, v, causal=True, sm_scale=128**-0.5),
             lambda: fa.flash_fwd_plain(q, k, v, True, 128**-0.5),
             _flash_cost(q, k, True, None, None),
             **_flash_gate(bf, "flash_fwd op graph N512"),
             library=lambda: lib(*args))
    _flash_bwd_check(torch, ph, fa, "op graph B4 H16 N512 D128 causal", bf, q,
                     k, v, do, True, None, None)

    # the loop schedule's function (TPU rows 6, 7): the forward at 16K, held
    # to LOOP_16K_GATE (see there)
    q, k, v = (randn(1, 2, 16384, 128, dtype=bf) for _ in range(3))
    sc = 128 ** -0.5
    lib, args = _sdpa(torch, q, k, v, True, None, None)
    ph.check("flash_fwd", "B1 H2 N16384 D128 causal", bf,
             lambda: fa.flash_fwd(q, k, v, causal=True, sm_scale=sc),
             lambda: fa.flash_fwd_plain(q, k, v, True, sc),
             _flash_cost(q, k, True, None, None),
             compare=lambda a, b: _row_ulp_err(
                 a, b, LOOP_16K_GATE[0], label="flash_fwd loop N16384",
                 ulps=LOOP_16K_GATE[1]),
             tol=1.0, library=lambda: lib(*args))
    del lib, args
    # and the loop schedule's backward (TPU row 9) at the same shape
    do = randn(1, 2, 16384, 128, dtype=bf)
    _flash_bwd_check(torch, ph, fa, "B1 H2 N16384 D128 causal (loop)", bf, q,
                     k, v, do, True, None, None)


# f32-grade: the split-precision flash kernels against a float64 evaluation
# of the same formulas (_f64_flash_check), where the plain f32 version's own
# error shows beside
F32_GRADE = 1e-5


def _f64_flash(torch, q, k, v, do, causal):
    """(o, lse, dq, dk, dv) of dense attention (no window or lengths, one
    kv head a query head) in float64, for q, k, v, do of one batch row
    (h, n, d): the exact function the f32 kernels approximate."""
    sc = q.shape[-1] ** -0.5
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = q @ k.transpose(-1, -2) * sc
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -math.inf)
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    del s
    o = p @ v
    ds = p * (do @ v.transpose(-1, -2) - (o * do).sum(-1, keepdim=True)) * sc
    return o, lse, ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do


def _f64_flash_check(torch, fa, q, k, v, do, causal) -> None:
    """The f32 flash forward and backward, kernel and plain version, against
    float64 (dense, no window or lengths; one batch row at a time): max abs
    error of o, lse, dq, dk, dv, the backward given its own forward's lse
    and di.  The kernel's must stay within F32_GRADE."""
    sc = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc)
    di = (o.float() * do.float()).sum(-1, keepdim=True)
    got = (o, lse, *fa.flash_bwd(q, k, v, lse, di, do, causal=causal, sm_scale=sc))
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, sc)
    di_p = (o_p.float() * do.float()).sum(-1, keepdim=True)
    plain = (o_p, lse_p, *fa.flash_bwd_plain(q, k, v, lse_p, di_p, do, causal, sc))
    del di, di_p
    err = {"kernel": [0.0] * 5, "plain": [0.0] * 5}
    for b in range(q.shape[0]):
        exact = _f64_flash(torch, q[b], k[b], v[b], do[b], causal)
        for name, res in (("kernel", got), ("plain", plain)):
            err[name] = [max(e, float((r[b].double() - x).abs().max()))
                         for e, r, x in zip(err[name], res, exact)]
        del exact
    fmt = lambda e: " ".join(f"{n} {x:.3e}" for n, x in
                             zip(("o", "lse", "dq", "dk", "dv"), e))
    log(f"[kernel] flash f32 {tuple(q.shape)} causal={causal} against float64: "
        f"kernel {fmt(err['kernel'])}; plain {fmt(err['plain'])} (gate "
        f"{F32_GRADE:g} on the kernel's)")
    if not max(err["kernel"]) <= F32_GRADE:
        raise AssertionError(f"f32 flash off float64 by {max(err['kernel'])}")


def _flash_bwd_check(torch, ph, fa, label, dtype, q, k, v, do, causal, window,
                     lens, main=False):
    sc = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc,
                          kv_lengths=lens, window=window)
    di = (o.float() * do.float()).sum(-1, keepdim=True)

    @functools.cache
    def exact(b):
        return _f64_attn_grads(torch, fa, q, k, v, do, causal, sc, lens,
                               window, b)

    ph.check(_flash_name("flash_bwd", q, k), label, dtype,
             lambda: fa.flash_bwd(q, k, v, lse, di, do, causal=causal,
                                  sm_scale=sc, kv_lengths=lens, window=window),
             lambda: fa.flash_bwd_plain(q, k, v, lse, di, do, causal, sc, lens,
                                        window),
             _flash_cost(q, k, causal, window, lens, backward=True),
             main=main, **(
                 dict(compare=lambda a, b: _row_ulp_err(
                     a, b, label=f"flash_bwd {label}", exact=exact), tol=1.0)
                 if dtype == torch.bfloat16 and fa._schedule(
                     q, k, causal, window, lens is not None).name == "op_graph"
                 else dict(compare=_grad_err)),
             library=_sdpa_bwd(torch, q, k, v, do, causal, window, lens))


def mt_kernel_phases(torch, dev, ph: Phases, randn):
    """The op graph (``flash_fwd`` mode 0 and ``flash_bwd``'s op-graph mode)
    at the MT model's attention shapes, B128 H8 D32 (40 keys, under the
    1024 where JAX's dispatcher leaves the op graph): the encoder's varlen
    self-attention, the decoder's causal self-attention, the
    cross-attention (forward and backward) and generation's cross-attention
    at n_q 1 (forward), over source lengths from 1 to 40, in f32 and
    bf16."""
    from flashattn_tpu_torch.ops import flash_attention as fa

    b, h, d = MT_BATCH, MT["n_head"], MT["n_embd"] // MT["n_head"]
    g = torch.Generator().manual_seed(SEED + 11)
    lens = torch.randint(1, MT_LEN + 1, (b,), generator=g)
    lens[:2] = torch.tensor([1, MT_LEN])
    lens = lens.to(dev)
    cases = (("encoder 40x40 varlen", MT_LEN, False, lens, True),
             ("decoder 40x40 causal", MT_LEN, True, None, True),
             ("cross 40x40 varlen", MT_LEN, False, lens, True),
             ("generate cross 1x40 varlen", 1, False, lens, False))
    for dtype in (torch.float32, torch.bfloat16):
        for label, n_q, causal, kv_lens, bwd in cases:
            q = randn(b, h, n_q, d, dtype=dtype)
            k, v = (randn(b, h, MT_LEN, d, dtype=dtype) for _ in range(2))
            assert fa._schedule(q, k, causal, None, kv_lens is not None
                                ).name == "op_graph"
            lib, args = _sdpa(torch, q, k, v, causal, None, kv_lens)
            # the f32 warp-level kernels' main numbers: the decoder's
            main = dtype == torch.float32 and label.startswith("decoder")
            ph.check(_flash_name("flash_fwd", q, k), f"MT {label} B128 H8 D32",
                     dtype,
                     lambda: fa.flash_fwd(q, k, v, causal=causal,
                                          sm_scale=d ** -0.5,
                                          kv_lengths=kv_lens),
                     lambda: fa.flash_fwd_plain(q, k, v, causal, d ** -0.5,
                                                kv_lens),
                     _flash_cost(q, k, causal, None, kv_lens), main=main,
                     **_flash_gate(dtype, f"flash_fwd MT {label}"),
                     library=lambda: lib(*args))
            if bwd:
                do = randn(b, h, n_q, d, dtype=dtype)
                _flash_bwd_check(torch, ph, fa, f"MT {label} B128 H8 D32",
                                 dtype, q, k, v, do, causal, None, kv_lens,
                                 main=main)
            del q, k, v, lib, args

    # the f32 distill draft's attention (DISTILL_BATCH x 2 heads of 64 over
    # DISTILL_SEQ keys, causal), forward and backward
    q, k, v, do = (randn(DISTILL_BATCH, 2, DISTILL_SEQ, 64, dtype=torch.float32)
                   for _ in range(4))
    lib, args = _sdpa(torch, q, k, v, True, None, None)
    label = f"distill B{DISTILL_BATCH} H2 {DISTILL_SEQ}x{DISTILL_SEQ} causal D64"
    ph.check(_flash_name("flash_fwd", q, k), label, torch.float32,
             lambda: fa.flash_fwd(q, k, v, causal=True, sm_scale=64 ** -0.5),
             lambda: fa.flash_fwd_plain(q, k, v, True, 64 ** -0.5),
             _flash_cost(q, k, True, None, None),
             **_flash_gate(torch.float32, f"flash_fwd {label}"),
             library=lambda: lib(*args))
    _flash_bwd_check(torch, ph, fa, label, torch.float32, q, k, v, do, True,
                     None, None)
    del q, k, v, do, lib, args

    # the bf16 kernels at their tiles' edges: keys 1, 127, 129 and 1023
    # (one key tile, then the two-pass walk), rows 1, 17, 40 and 128, GQA
    # 4, a length-0 row, a window, varlen; and the distill draft's shape
    bf = torch.bfloat16
    for label, (b, h, h_kv, n_q, n_kv, d), causal, lens, window in (
            ("1x1 D32", (64, 8, 8, 1, 1, 32), False, None, None),
            ("17x127 varlen len-0 D64", (16, 8, 8, 17, 127, 64), False,
             [127, 0, 64, 1] * 4, None),
            ("40x129 GQA 8q/2kv D32", (64, 8, 2, 40, 129, 32), False, None,
             None),
            ("distill B16 H2 128x128 causal D64", (16, 2, 2, 128, 128, 64),
             True, None, None),
            ("1023x1023 window 256 varlen D64", (4, 8, 8, 1023, 1023, 64),
             True, [1023, 700, 1, 512], 256),
            ("17x1023 D128", (8, 8, 8, 17, 1023, 128), False, None, None)):
        q, do = (randn(b, h, n_q, d, dtype=bf) for _ in range(2))
        k, v = (randn(b, h_kv, n_kv, d, dtype=bf) for _ in range(2))
        lens = None if lens is None else torch.tensor(lens, device=dev)
        assert fa._schedule(q, k, causal, window, lens is not None
                            ).name == "op_graph"
        lib, args = _sdpa(torch, q, k, v, causal, window, lens)
        ph.check("flash_fwd", f"op graph {label}", bf,
                 lambda: fa.flash_fwd(q, k, v, causal=causal, sm_scale=d ** -0.5,
                                      kv_lengths=lens, window=window),
                 lambda: fa.flash_fwd_plain(q, k, v, causal, d ** -0.5, lens,
                                            window),
                 _flash_cost(q, k, causal, window, lens),
                 **_flash_gate(bf, f"flash_fwd op graph {label}"),
                 library=lambda: lib(*args))
        _flash_bwd_check(torch, ph, fa, f"op graph {label}", bf, q, k, v, do,
                         causal, window, lens)
        del q, k, v, do, lib, args


def f32_nonfinite_phases(torch, dev) -> None:
    """C17 on the card: a +-inf in q, K, V or dO (element [0, 0, 5, 3])
    of an f32 flash call, not causal (every row's walk reads every key, as
    the plain versions' dense products do), at the MT model's 40 keys
    (B128 H8 d32: the warp-level kernels directly) and at 2048 keys (B2 H4
    d128: the wgmma route, whose split pass flags the inf; the warp-level
    kernels launched behind it compute the call).  Gates: the NaN / +inf /
    -inf positions of o, lse, dq, dk and dv equal the plain versions' (the
    TPU kernels' explicit formulas for the backward, fa._reference_bwd; dv
    only where every lse is finite: the plain version zeroes p on such a
    row, the kernels give NaN, ROADMAP C), the finite elements within 1e-4
    (gradients over max(1, max |ref|)); each call on its route's counter;
    at 2048 keys every output bit for bit the warp-level kernels' own (the
    route forced by the threshold, the backward given the same lse and di;
    with dO's +-inf the backward's alone): the same kernels computed it."""
    from flashattn_tpu_torch.ops import flash_attention as fa

    counters = (fa._f32_kernel, fa._f32_bwd_kernel, fa._f32_mma_kernel,
                fa._f32_mma_bwd_kernel)
    for label, (b, h, n, d) in (("40 keys B128 H8 D32", (128, 8, 40, 32)),
                                ("2048 keys B2 H4 D128", (2, 4, 2048, 128))):
        want_delta = [0, 0, 1, 1] if fa.f32_route(n) == "mma" else [1, 1, 0, 0]
        worst, cases = 0.0, 0
        for where in ("q", "k", "v", "do"):
            for value in (math.inf, -math.inf):
                g = torch.Generator(device=dev).manual_seed(SEED + 17)
                q, k, v, do = (torch.randn(b, h, n, d, generator=g, device=dev)
                               for _ in range(4))
                {"q": q, "k": k, "v": v, "do": do}[where][0, 0, 5, 3] = value
                sc = d ** -0.5

                def run(lse=None, di=None):
                    o, lse_ = fa.flash_fwd(q, k, v, causal=False, sm_scale=sc)
                    if lse is None:
                        lse, di = lse_, (o * do).sum(-1, keepdim=True)
                    return (o, lse_, *fa.flash_bwd(q, k, v, lse, di, do, causal=False,
                                                   sm_scale=sc)), di

                before = [c.launches for c in counters]
                got, di = run()
                delta = [c.launches - x for c, x in zip(counters, before)]
                if delta != want_delta:
                    raise AssertionError(f"f32 +-inf {label}: launches {delta}, "
                                         f"want {want_delta}")
                if fa.f32_route(n) == "wgmma":
                    keep = fa.F32_TC_MIN_KV
                    fa.F32_TC_MIN_KV = 1 << 30
                    try:
                        forced, _ = run(got[1], di)
                    finally:
                        fa.F32_TC_MIN_KV = keep
                    # dO's +-inf reaches the backward alone
                    same = ("o", "lse") * (where != "do") + ("dq", "dk", "dv")
                    for name, a, c in zip(("o", "lse", "dq", "dk", "dv"), got, forced):
                        if name in same and not torch.equal(a.view(torch.int32),
                                                            c.view(torch.int32)):
                            raise AssertionError(
                                f"f32 +-inf {label} {where}={value}: {name} is not "
                                f"the warp-level kernels' bit for bit")
                lse = got[1]
                plain = (*fa.flash_fwd_plain(q, k, v, False, sc),
                         *fa._reference_bwd(q, k, v, lse, di, do, False, sc))
                for name, a, c in zip(("o", "lse", "dq", "dk", "dv"), got, plain):
                    if name == "dv" and not bool(lse.isfinite().all()):
                        continue
                    for pick in (torch.isnan, torch.isposinf, torch.isneginf):
                        if not torch.equal(pick(a), pick(c)):
                            raise AssertionError(
                                f"f32 +-inf {label} {where}={value}: {name}'s "
                                f"{pick.__name__} positions differ from the plain "
                                f"version's ({int((pick(a) != pick(c)).sum())})")
                    fin = c.isfinite()
                    if bool(fin.any()):
                        scale = 1.0 if name in ("o", "lse") else max(
                            1.0, float(c[fin].abs().max()))
                        worst = max(worst, _abs_err(a[fin], c[fin]) / scale)
                cases += 1
                del q, k, v, do, got, plain
        log(f"[kernel] f32 flash +-inf {label} ({fa.f32_route(n)} route): "
            f"{cases} cases (q, K, V, dO x +-inf), NaN / inf positions equal to "
            f"the plain versions', finite elements within {worst:.3e} (gate 1e-4)"
            + ("; every output the warp-level kernels' bit for bit"
               if fa.f32_route(n) == "wgmma" else ""))
        if not worst <= 1e-4:
            raise AssertionError(f"f32 +-inf {label}: finite elements off by {worst}")
    torch.cuda.empty_cache()


def _quant_bits_err(got, want):
    """0 when payloads and scales are bit-identical, else inf."""
    import torch

    same = (torch.equal(got.values, want.values)
            and torch.equal(got.scales, want.scales))
    if same:
        return 0.0, 0.0
    return _abs_err(got.values, want.values), math.inf


def _wo_cost(m, k, n, isz):
    """x read, the 1-byte payload and f32 scales read, y written; 2MNK.  f32
    x above 16 rows runs split precision: three bf16 products, the FMA
    kernel's 2MNK at the f32 peak beside."""
    bytes_, flops = m * k * isz + k * n + 4 * n + m * n * isz, 2 * m * n * k
    if isz == 4 and m > 16:
        return bytes_, {"bfloat16": 3 * flops}, flops
    return bytes_, flops


def _kv8_cost(q, k_values, causal):
    """q read and o, lse written in q's dtype; 1-byte K/V payloads and their
    f32 scales read once; 2 dots per live (row, key) pair.  With int8
    payloads q is quantized to int8, so QK^T is an int8 product at the int8
    peak and only PV runs at q's type; with fp8 payloads both run at q's."""
    import torch

    b, h, n_q, d = q.shape
    h_kv, n_kv = k_values.shape[1], k_values.shape[2]
    pairs = h * _live_pairs(n_q, n_kv, causal, None, None, b)
    kv_tokens = b * h_kv * n_kv
    q_type = str(q.dtype).replace("torch.", "")
    dot = 2 * d * pairs
    int8 = k_values.dtype == torch.int8
    ops = {"int8": dot, q_type: dot} if int8 else {q_type: 2 * dot}
    bytes_ = (2 * q.numel() * q.element_size() + 4 * b * h * n_q
              + 2 * kv_tokens * (d + 4))
    if q.dtype == torch.float32:
        # split precision: the f32 side of each bf16 product in three pieces
        split = ({"int8": dot, "bfloat16": 3 * dot} if int8
                 else {"bfloat16": 6 * dot})
        return bytes_, split, ops
    return bytes_, ops


def _log_paged_plan(torch, pa):
    """The split plan of the paged shapes above, and the paged kernels'
    registers, shared memory and spills (d 128), once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (b, rows, chunk, pps, dtype) in {
            "decode B4 Hkv8 <= 2048": (4, 1, 1, 16, torch.bfloat16),
            "decode B4 Hkv8 <= 8192": (4, 1, 1, 64, torch.bfloat16),
            "decode B1 Hkv8 16384": (1, 1, 1, 128, torch.bfloat16),
            "GQA 4 <= 8192": (4, 4, 1, 64, torch.bfloat16),
            "chunk 64 <= 8192": (4, 64, 64, 64, torch.bfloat16),
            "extend wave 2048": (4, 2048, 2048, 16, torch.bfloat16),
            "f32 decode <= 8192": (4, 1, 1, 64, torch.float32)}.items():
        sp, n = pa.split_plan(b, 8, rows, chunk, 128, pps, dtype, None, sms)
        log(f"[paged] plan {label}: {n} splits of {sp} pages")
    for pool in (torch.bfloat16, torch.float32, torch.int8, torch.float8_e4m3fn):
        attrs = pa.kernel_attrs(128, pool)
        log(f"[paged] d128 {str(pool)[6:]} pool: " + ", ".join(
            f"{k} {r} regs / {sm} B smem / {lc} B spill"
            for k, (r, sm, lc) in attrs.items()))


def quant_kernel_phases(torch, dev, ph: Phases, randn):
    """The four quantization kernels (quantized paged attention, the
    weight-only matmul, flash over a quantized KV cache, stochastic
    quantization) against their plain versions at the quantized serving
    shapes."""
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.ops import paged_attention as pa
    from flashattn_tpu_torch.ops import quant as qt

    payloads = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

    def quantize(t, payload, axis=-1):
        return (qt.quantize_int8 if payload == torch.int8
                else qt.quantize_fp8)(t, axis=axis)

    # weight-only matmul at the Linear shapes of the serving model; bf16 x
    # at every M the kernels branch on (the GEMV at M <= 16, the tensor-core
    # tile above, ragged 17 and 100, decode 4 and prefill 4 x 8192) and
    # every (K, N) of the model, the lm head's N 1000 among them
    shapes = [(4, 1024, 1024), (4, 1024, 1000), (16, 1024, 1024),
              (32768, 1024, 1024), (32768, 1024, 256), (32768, 256, 1024),
              (32768, 1024, 1000)]
    bf16_shapes = [(m, k, n) for m in (1, 4, 16, 17, 100, 32768)
                   for k, n in ((1024, 1024), (1024, 256), (256, 1024),
                                (1024, 1000))]
    for pname, payload in payloads.items():
        for dtype in (torch.bfloat16, torch.float32):
            isz = torch.tensor([], dtype=dtype).element_size()
            for m, k, n in (bf16_shapes if dtype == torch.bfloat16 else shapes):
                x = randn(m, k, dtype=dtype)
                w = quantize(randn(k, n, dtype=torch.float32), payload, axis=0)
                w_full = w.dequantize(dtype)
                main = pname == "int8" and (m, k, n) == (32768, 1024, 1024)
                # f32 x: the split-precision tile (or the f32 GEMV), its own
                # entry point and counter
                kname = "wo_matmul" if dtype == torch.bfloat16 else "wo_matmul_f32"
                ph.check(kname, f"({m}, {k}) x ({k}, {n}) {pname}", dtype,
                         lambda: qt.wo_matmul(x, w),
                         lambda: qt.int8_weight_only_matmul_reference(x, w),
                         _wo_cost(m, k, n, isz), main=main,
                         compare=_scaled_err, library=lambda: x @ w_full,
                         graph=m <= 100)
                if m <= 100:   # the same call timed eagerly, host launch included
                    eager = time_ms(lambda: qt.wo_matmul(x, w), host=True)
                    lib = time_ms(lambda: x @ w_full, host=True)
                    log(f"[kernel] {kname:15s} ({m}, {k}) x ({k}, {n}) {pname} "
                        f"{str(dtype)[6:]} eager ms={eager:.4f} library_ms={lib:.4f}")
                del x, w, w_full

    # quantized paged attention: B4, 8 kv heads, d128, page 128, <= 8192
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    pps = 64
    n_pages = 4 * pps + 1
    table = torch.randperm(n_pages, generator=g, device=dev)[:4 * pps]
    table = table.reshape(4, pps).int()
    lens = torch.tensor([8192, 6144, 4096, 2053], device=dev)
    bf = torch.bfloat16
    # the bf16 pool at the same histories, for comparison
    kp, vp = (randn(8, n_pages, 128, 128, dtype=bf) for _ in range(2))
    qd = randn(4, 8, 128, dtype=bf)
    # bf16 outputs are gated relative to max |ref|, f32 ones at 1e-4 abs
    ph.check("paged_attention", "decode B4 Hkv8 d128 <= 8192", bf,
             lambda: pa.paged_attention(qd, kp, vp, lens, table),
             lambda: pa.paged_attention_plain(qd, kp, vp, lens, table),
             _paged_cost(qd, 1, 8, 8, lens), compare=_rel_err)
    del kp, vp
    # B1 Hkv8 d128 decode at 16384 positions (the serve_quant model's
    # capacity), where one sequence has only eight (sequence, kv head) pairs
    pps16 = 128
    table16 = torch.randperm(pps16 + 1, generator=g, device=dev)[:pps16]
    table16 = table16.reshape(1, pps16).int()
    lens16 = torch.tensor([16384], device=dev)
    q16 = randn(1, 8, 128, dtype=bf)
    kp, vp = (randn(8, pps16 + 1, 128, 128, dtype=bf) for _ in range(2))
    ph.check("paged_attention", "decode B1 Hkv8 d128 16384", bf,
             lambda: pa.paged_attention(q16, kp, vp, lens16, table16),
             lambda: pa.paged_attention_plain(q16, kp, vp, lens16, table16),
             _paged_cost(q16, 1, 8, 8, lens16), compare=_rel_err)
    del kp, vp
    _log_paged_plan(torch, pa)
    for pname, payload in payloads.items():
        kq, vq = (quantize(randn(8, n_pages, 128, 128, dtype=torch.float32),
                           payload) for _ in range(2))
        kw = dict(k_scales=kq.scales, v_scales=vq.scales)
        for label, q_shape, chunk, hq, win in [
                ("decode B4 Hkv8 d128 <= 8192", (4, 8, 128), 1, 8, None),
                ("chunk 64", (4, 64, 8, 128), 64, 8, None),
                ("decode GQA group 4", (4, 32, 128), 1, 32, None),
                ("decode window 256", (4, 8, 128), 1, 8, 256)]:
            q32 = randn(*q_shape, dtype=torch.float32)
            for dtype in (bf, torch.float32):
                q_ = q32.to(dtype)
                decode = chunk == 1 and hq == 8 and win is None
                # f32 q: the split-precision tiles, their own count; the
                # int8 decode is the f32 north-star's (the kernels line)
                ph.check(f"paged_attention_{pname}" if dtype == bf
                         else "paged_attention_f32",
                         label if dtype == bf else f"{label} {pname}", dtype,
                         lambda: pa.paged_attention(q_, kq.values, vq.values,
                                                    lens, table, window=win,
                                                    **kw),
                         lambda: pa.paged_attention_plain(
                             q_, kq.values, vq.values, lens, table, window=win,
                             **kw),
                         _paged_cost(q_, chunk, hq, 8, lens, quantized=True,
                                     window=win),
                         main=decode and (dtype == bf or pname == "int8"),
                         **(dict(compare=_rel_err) if dtype == bf else
                            _paged_f32_gate(pa, q_, kq.values, vq.values, lens,
                                            table, dict(kw, window=win),
                                            f"{label} {pname}")))
        kq, vq = (quantize(randn(8, pps16 + 1, 128, 128, dtype=torch.float32),
                           payload) for _ in range(2))
        ph.check(f"paged_attention_{pname}", "decode B1 Hkv8 d128 16384", bf,
                 lambda: pa.paged_attention(q16, kq.values, vq.values, lens16,
                                            table16, k_scales=kq.scales,
                                            v_scales=vq.scales),
                 lambda: pa.paged_attention_plain(
                     q16, kq.values, vq.values, lens16, table16,
                     k_scales=kq.scales, v_scales=vq.scales),
                 _paged_cost(q16, 1, 8, 8, lens16, quantized=True),
                 compare=_rel_err)
        q16f = q16.float()
        kw16 = dict(k_scales=kq.scales, v_scales=vq.scales)
        ph.check("paged_attention_f32", f"decode B1 Hkv8 d128 16384 {pname}",
                 torch.float32,
                 lambda: pa.paged_attention(q16f, kq.values, vq.values, lens16,
                                            table16, **kw16),
                 lambda: pa.paged_attention_plain(
                     q16f, kq.values, vq.values, lens16, table16, **kw16),
                 _paged_cost(q16f, 1, 8, 8, lens16, quantized=True),
                 **_paged_f32_gate(pa, q16f, kq.values, vq.values, lens16,
                                   table16, kw16, f"B1 16384 {pname}"))
        del kq, vq, kw

    # flash attention over a quantized KV cache, at one shape of each of
    # JAX's routes (qt._kv8_route): the subrow (B4 H8 N2048 causal, fp8
    # transcoded to int8 first; GQA 8q/2kv), the loop (N512: one 512-key
    # chunk a query block) and the grid (cross 1000 x 2048: two 1024-key
    # blocks; ragged N1000: one block); bf16 q on fa_kv8_flash in the
    # route's mode, gated as the flash forward (at least 99% of o bit for
    # bit, the rest within one bf16 ulp of its row's largest, lse 1e-5), f32
    # q on fa_kv8_flash_f32 (split precision) at 1e-4
    def kv8_check(label, dtype, q, k, v, causal, main=False):
        sc = q.shape[-1] ** -0.5
        lib, args = _sdpa(torch, q, k.dequantize(q.dtype), v.dequantize(q.dtype),
                          causal, None, None)
        route = qt._kv8_route(causal, q.shape[2], k.values.shape[2], q.shape[3])
        k_ref, v_ref = k, v
        if k.values.dtype != torch.int8 and route.name == "subrow":
            k_ref, v_ref = (qt.requantize_fp8_to_int8(t) for t in (k, v))
            label += " (fp8 transcoded)"
        label = f"{route.name} {label}"
        name = "kv8_flash" if dtype == bf else "kv8_flash_f32"
        ph.check(name, label, dtype,
                 lambda: qt.flash_attention_kv_int8(q, k, v, causal, sc),
                 lambda: qt.flash_attention_kv_int8_reference(q, k_ref, v_ref,
                                                              causal, sc),
                 _kv8_cost(q, k_ref.values, causal), main=main,
                 **_flash_gate(dtype, f"{name} {label}"),
                 library=lambda: lib(*args))

    def kv(b, h, n, payload):
        return (quantize(randn(b, h, n, 128, dtype=torch.float32), payload)
                for _ in range(2))

    for pname, payload in payloads.items():
        k, v = kv(4, 8, 2048, payload)
        k5, v5 = kv(4, 8, 512, payload)
        for dtype in (bf, torch.float32):
            q = randn(4, 8, 2048, 128, dtype=dtype)
            kv8_check(f"B4 H8 N2048 D128 causal {pname}", dtype, q, k, v, True,
                      main=pname == "int8")
            kv8_check(f"B4 H8 N512 D128 causal {pname}", dtype,
                      randn(4, 8, 512, 128, dtype=dtype), k5, v5, True)
            kv8_check(f"cross non-causal 1000 x 2048 {pname}", dtype,
                      randn(4, 8, 1000, 128, dtype=dtype), k, v, False)
        k2, v2 = kv(4, 2, 2048, payload)
        kv8_check(f"GQA 8q/2kv N2048 causal {pname}", bf,
                  randn(4, 8, 2048, 128, dtype=bf), k2, v2, True)
        k3, v3 = kv(4, 8, 1000, payload)
        kv8_check(f"ragged N1000 causal {pname}", bf,
                  randn(4, 8, 1000, 128, dtype=bf), k3, v3, True)
        del k, v, k2, v2, k3, v3, k5, v5
        # shapes the JAX tiler cannot divide (n_q 1 and 7): the public
        # function falls back to the flash op graph over K and V dequantized
        # to q's dtype, the flash kernel's op-graph mode
        for n_q, n_kv in ((1, 40), (7, 200)):
            kf, vf = kv(4, 8, n_kv, payload)
            qf = randn(4, 8, n_q, 128, dtype=bf)
            for causal in (False, True):
                kd, vd = kf.dequantize(bf), vf.dequantize(bf)
                lib, args = _sdpa(torch, qf, kd, vd, causal, None, None)
                label = f"kv8 fallback {n_q} x {n_kv} {pname}" + (
                    " causal" if causal else "")
                ph.check("flash_fwd", label, bf,
                         lambda: qt.flash_attention_kv_int8(qf, kf, vf, causal),
                         lambda: fa._reference_fwd_with_lse(
                             qf, kf.dequantize(bf), vf.dequantize(bf), causal,
                             128 ** -0.5),
                         _flash_cost(qf, kd, causal, None, None),
                         **_flash_gate(bf, f"flash_fwd {label}"),
                         library=lambda: lib(*args))

    # stochastic-rounding int8 quantization
    xs = randn(32768, 1024, dtype=bf)
    seed = 0x5DEECE66D
    ph.check("stochastic_quant", "(32768, 1024)", bf,
             lambda: qt.stochastic_quant(xs, seed),
             lambda: qt.quantize_int8_stochastic_reference(xs, seed),
             (xs.numel() * 2 + xs.numel() + 4 * 32768, 0), main=True,
             compare=_quant_bits_err)
    const = torch.full((8, 256), 0.37, device=dev)
    mean = statistics.mean(float(qt.stochastic_quant(const, i).dequantize().mean())
                           for i in range(8))
    log(f"[kernel] stochastic_quant mean of 8 seeds on 0.37: {mean:.6f} "
        f"(want within 2%)")
    if abs(mean - 0.37) > 0.02 * 0.37:
        raise AssertionError(f"stochastic rounding is biased: {mean}")
    # on the constant x / s is exactly 127, so that mean holds for any bits;
    # here one 1.0 per row makes s = 1/127 and 0.3 / s = 38.1: floor and
    # round-to-nearest both give 38/127, 0.26% low, while the 8-seed mean of
    # 16320 unbiased draws has a standard error of 0.006%
    frac = torch.full((8, 256), 0.3, device=dev)
    frac[:, 0] = 1.0
    fmean = statistics.mean(
        float(qt.stochastic_quant(frac, i).dequantize()[:, 1:].mean())
        for i in range(8))
    log(f"[kernel] stochastic_quant mean of 8 seeds on 0.3 beside a 1.0: "
        f"{fmean:.6f} (want within 0.1%)")
    if abs(fmean - 0.3) > 1e-3 * 0.3:
        raise AssertionError(f"stochastic rounding is biased: {fmean}")
    del xs


def _softmax_cost(x, mask, causal, backward=False, op_graph=False):
    """(bytes, 0): the forward reads the entries of x that the causal mask
    leaves live (those past the diagonal are known without reading them)
    and the mask's own elements once, and writes every output; the Pallas
    function's backward reads out and dout and writes dinp; the op graph's
    backward reads x's and dout's live entries and the mask, and writes
    dinp (0 past the diagonal, written without reading)."""
    b, h, f, t = x.shape
    isz = x.element_size()
    mask_bytes = 0 if mask is None else 4 * mask.numel()
    if backward and not op_graph:
        return 3 * x.numel() * isz, 0
    live = b * h * (sum(min(i + 1, t) for i in range(f)) if causal else f * t)
    reads = 2 * live if backward else live
    return (reads + x.numel()) * isz + mask_bytes, 0


BF16_ULP = 2.0 ** -7   # one bf16 ulp relative to a value of [1, 2)


def _ulp_err(got, want, slack=None, ulps=1):
    """Per element, for bf16 results of f32 arithmetic: (max abs err, max of
    |err| / (ulps 2^-7 |ref| + 1e-6 [+ slack])), gated at 1.  Both sides
    round an f32 value to bf16, so a sound kernel is at most one bf16 ulp
    off; a softmax output averages 1/T, far under any absolute gate."""
    d = (got.float() - want.float()).abs()
    allowed = want.float().abs().mul_(ulps * BF16_ULP).add_(1e-6)
    if slack is not None:
        allowed += slack
    return float(d.max()), float((d / allowed).max())


def _softmax_bwd_ulp_err(out, dout, op_graph=False):
    """_ulp_err for dinp = out (dout - s), s = sum_row(dout out).  The
    Pallas function: the slack |out| 2^-12 (sum_row |dout out| + |dout|)
    covers the f32 rounding of s and of dout - s, whose difference may
    cancel to far below either.  The op graph computes the kernel's
    arithmetic bit for bit (:func:`_softmax_check` holds the share), except
    where w = sum(e), an f32 sum in another order rounded to bf16, takes
    the neighbouring value: then dout / w moves by an ulp and s, a bf16
    sum rounded at every add, by a few ulps of sum_row |dout out|, hence
    |out| 2^-4 (sum_row |dout out| + |dout|)."""
    o, g = out.float(), dout.float()
    slack = (o * g).abs().sum(-1, keepdim=True).add(g.abs()).mul_(o.abs())
    slack *= 2.0 ** (-4 if op_graph else -12)
    del o, g
    return lambda got, want: _ulp_err(got, want, slack)


def _softmax_check(torch, ph, randn, label, x, mask, causal, impl="auto",
                   main=False):
    """softmax_fwd and softmax_bwd on one input with ``impl``'s rounding
    (the op graph for "auto" in bf16, the Pallas function else), each held
    to its own plain version; the yardsticks are torch.softmax on the
    pre-masked scores and its backward.  bf16 is gated per element at one
    ulp (:func:`_ulp_err`), f32 at ``TOL``."""
    from flashattn_tpu_torch.ops import softmax as sm
    from flashattn_tpu_torch.ops._utils import DEFAULT_MASK_VALUE

    dtype = x.dtype
    bf = dtype == torch.bfloat16
    op = bf and impl == "auto"
    fwd_plain = (sm.attn_softmax_reference if impl == "auto"
                 else sm._attn_softmax_pallas_reference)
    pre = x.float() if mask is None else x.float() + mask
    if causal:
        f, t = x.shape[-2:]
        future = torch.ones(f, t, dtype=torch.bool, device=x.device).triu(1)
        pre = pre.masked_fill(future, DEFAULT_MASK_VALUE)
    pre = pre.to(dtype)
    # the op graph adds the mask in the scores' dtype (a weakly typed mask)
    pmask = None if mask is None else mask.to(dtype) if op else mask
    # the op graph rounds w = sum(e) to bf16: an f32 sum in another order may
    # take the neighbouring value (2^-7 relative), moving the row's outputs
    # by up to one more ulp
    compare = ((lambda a, b: _ulp_err(a, b, ulps=2)) if op else _ulp_err
               ) if bf else _max_err
    ph.check("softmax_fwd", f"{label} {impl}", dtype,
             lambda: sm.softmax_fwd(x, pmask, causal, impl),
             lambda: fwd_plain(x, pmask, causal),
             _softmax_cost(x, mask, causal), main=main,
             compare=compare, tol=1.0 if bf else None,
             library=lambda: torch.softmax(pre, -1))
    del pre
    out = fwd_plain(x, pmask, causal)
    dout = randn(*x.shape, dtype=dtype)
    if op:
        run_kernel = lambda: sm.softmax_bwd(x, dout, pmask, causal, impl)
        run_plain = lambda: sm._softmax_bwd_op_graph(x, dout, pmask, causal)
    else:
        run_kernel = lambda: sm.softmax_bwd(out, dout)
        run_plain = lambda: sm.softmax_bwd_reference(out, dout)
    ph.check("softmax_bwd", f"{label} {impl}", dtype, run_kernel, run_plain,
             _softmax_cost(x, mask, causal, backward=True, op_graph=op),
             main=main,
             compare=_softmax_bwd_ulp_err(out, dout, op) if bf else _scaled_err,
             tol=1.0 if bf else None,
             library=lambda: torch._softmax_backward_data(dout, out, -1, dtype))
    if op:
        # the arithmetic is the plain version's: all but the rows whose w
        # rounds the other way agree bit for bit
        same = [float((k() == p()).float().mean()) for k, p in (
            (lambda: sm.softmax_fwd(x, pmask, causal, impl),
             lambda: fwd_plain(x, pmask, causal)), (run_kernel, run_plain))]
        log(f"[kernel] softmax {label} auto: {100 * same[0]:.4f}% (forward), "
            f"{100 * same[1]:.4f}% (backward) of the elements equal the "
            f"plain version's bit for bit (gate 99%)")
        if min(same) < 0.99:
            raise AssertionError(f"softmax {label} auto: only {same} of the "
                                 f"elements are bit-exact")


def softmax_kernel_phases(torch, dev, ph: Phases, randn):
    """The fused-softmax path's kernels at its shape (B8 H16 N2048 causal, no
    mask; the main shape in the model's "auto" rounding), then ragged and
    masked variants; each in bf16 and f32 (whose kernels are other template
    instances), bf16 in both roundings."""
    b, h, n = TRAIN_BATCH, TRAIN["n_head"], TRAIN_SEQ
    lens = torch.tensor([2048, 0, 1536, 1024, 517, 2048, 1000, 33][:b],
                        device=dev)
    cols = torch.arange(n, device=dev)
    padding = torch.where(cols[None] < lens[:, None], 0.0, -1e9)[:, None, None]
    window = torch.where(cols[None] > cols[:, None] - 256, 0.0, -1e9)[None, None]
    for dtype in (torch.bfloat16, torch.float32):
        impls = ("auto", "pallas") if dtype == torch.bfloat16 else ("auto",)
        for i, (label, shape, mask, causal) in enumerate([
                (f"B{b} H{h} N{n} causal", (b, h, n, n), None, True),
                (f"T 33 causal, F {n}", (b, h, n, 33), None, True),
                ("T 1000 causal", (b, h, 1000, 1000), None, True),
                ("T 4097 non-causal, F 512", (2, h, 512, 4097), None, False),
                ("T 8200 non-causal, F 64", (2, h, 64, 8200), None, False),
                ("(B,1,1,T) padding mask, a length-0 row", (b, h, n, n),
                 padding, True),
                ("(1,1,F,T) window 256 mask", (b, h, n, n), window, True),
                ("F 1000 x T 2048 non-causal", (4, h, 1000, n), None, False)]):
            x = randn(*shape, dtype=dtype) * 3
            for impl in impls:
                _softmax_check(torch, ph, randn, label, x, mask, causal, impl,
                               main=dtype == torch.bfloat16 and i == 0
                               and impl == "auto")
            del x
            torch.cuda.empty_cache()


def _dropped_then(keep, dropped, inner):
    """A compare: the kernel's output holds exactly ``dropped`` (0 when
    None) where the plain version's mask drops, then ``inner`` on the
    values."""
    import torch

    def compare(got, want):
        at = got[~keep]
        if not torch.equal(at, torch.zeros_like(at) if dropped is None
                           else dropped[~keep]):
            return math.inf, math.inf
        return inner(got, want)

    return compare


def _bias_bwd_err(keep, exact):
    """Over (dx, db): dx 0 where the mask drops, then dx bit for bit
    (``exact``) or gated like a gradient, and db (a column sum over rows)
    gated like a gradient."""
    def compare(got, want):
        (dx, db), (dx_ref, db_ref) = got, want
        if dx[~keep].any():
            return math.inf, math.inf
        e = (_bit_err if exact else _scaled_err)(dx, dx_ref)
        f = _grad_err((db,), (db_ref,))
        return max(e[0], f[0]), max(e[1], f[1])

    return compare


def dropout_bias_kernel_phases(torch, dev, ph: Phases, randn):
    """The dropout variants at the training FFN's shapes: act-bias at the
    hidden width (16384 x 8192), res-bias at the model width
    (16384 x 2048), p 0.1, forward and backward."""
    from flashattn_tpu_torch.ops import dropout as dr

    seed, rate, scale = 0x9E3779B97F4A7C15, 0.1, True
    n = TRAIN_BATCH * TRAIN_SEQ
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        isz = torch.tensor([], dtype=dtype).element_size()
        d = TRAIN["middle_dim"]
        x, g = randn(n, d, dtype=dtype), randn(n, d, dtype=dtype)
        bias = randn(d, dtype=dtype)
        keep = dr.keep_mask(n * d, rate, seed, dev).reshape(n, d)
        for act in ("gelu", "relu"):
            relu = act == "relu"
            ph.check("dropout_act_bias", f"{act} {n} x {d} p 0.1", dtype,
                     lambda: dr.dropout_act_bias(x, bias, rate, seed, scale, act),
                     lambda: dr.dropout_act_bias_reference(x, bias, rate, seed,
                                                           scale, act),
                     (2 * n * d * isz + d * isz, 0), main=main and not relu,
                     compare=_dropped_then(keep, None,
                                           _bit_err if relu else _scaled_err))
            ph.check("dropout_act_bias", f"{act} backward {n} x {d} p 0.1",
                     dtype,
                     lambda: dr.dropout_act_bias_bwd(g, x, bias, rate, seed,
                                                     scale, act),
                     lambda: dr.dropout_act_bias_bwd_reference(
                         g, x, bias, rate, seed, scale, act),
                     (3 * n * d * isz + d * isz + 4 * d, 0),
                     compare=_bias_bwd_err(keep, exact=relu))
        del x, g, bias, keep
        torch.cuda.empty_cache()

        d = TRAIN["n_embd"]
        x, r, g = (randn(n, d, dtype=dtype) for _ in range(3))
        bias = randn(d, dtype=dtype)
        keep = dr.keep_mask(n * d, rate, seed, dev).reshape(n, d)
        ph.check("dropout_res_bias", f"{n} x {d} p 0.1", dtype,
                 lambda: dr.dropout_res_bias(x, bias, r, rate, seed, scale),
                 lambda: dr.dropout_res_bias_reference(x, bias, r, rate, seed,
                                                       scale),
                 (3 * n * d * isz + d * isz, 0), main=main,
                 compare=_dropped_then(keep, r, _bit_err))
        ph.check("dropout_res_bias", f"backward {n} x {d} p 0.1", dtype,
                 lambda: dr.dropout_res_bias_bwd(g, rate, seed, scale),
                 lambda: dr.dropout_res_bias_bwd_reference(g, rate, seed, scale),
                 (2 * n * d * isz + 4 * d, 0),
                 compare=_bias_bwd_err(keep, exact=True))
        del x, r, g, bias, keep


def head_dim_kernel_phases(torch, dev, ph: Phases) -> None:
    """The attention kernels at head dims between their tile widths
    (HEAD_DIM_LINES, heads of 80 and 96: the 128-column tiles zero-padded
    as they load) at serve_d96's and train_d96's shapes, each against its
    plain version under the gate of its d-128 line, the bound counted at
    the real d (so the padding's waste shows): the flash forward in bf16 in
    each mode (the _pad128 subrow of the batched prefill and of a dense
    causal forward, the grid, the op graph's two kernels) and f32 on both
    routes; the flash backward in bf16 (the subrow, the grid with GQA, the
    varlen subrow with a length of 0, the op graph at 512 and 40 keys) and
    f32 (the split pair at 2048 keys, the warp-level kernels at 40 and 200);
    paged decode (B4, 32 kv heads, histories <= 2048) and a chunk of 64
    over bf16, int8 and fp8 pools with bf16 q and over f32, int8 and fp8
    pools with f32 q; the decode a split a page (the merge); the marks at
    d 80 with a NaN in column d - 1; kv8_flash in bf16 and f32 over int8
    and fp8 payloads.  Inputs from a generator of their own, so the other
    phases keep theirs."""
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.ops import paged_attention as pa
    from flashattn_tpu_torch.ops import quant as qt

    g = torch.Generator(device=dev).manual_seed(SEED + 23)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    bf, f32 = torch.bfloat16, torch.float32
    payloads = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

    def quantize(t, payload):
        return (qt.quantize_int8 if payload == torch.int8 else qt.quantize_fp8)(t)

    lens = torch.tensor([2048, 1536, 1024, 517], device=dev)
    lens0 = torch.tensor([2048, 0, 1024, 517], device=dev)
    for d in HEAD_DIM_LINES:
        sc = d ** -0.5
        # flash: (label, B, H, N_q, N_kv, causal, lengths); H 32 as serve_d96
        for label, b, h, n_q, n_kv, causal, ln_ in (
                ("B4 H32 N2048 causal varlen", 4, 32, 2048, 2048, True, lens),
                ("B4 H32 N2048 causal", 4, 32, 2048, 2048, True, None),
                ("grid B1 H32 N2048 non-causal", 1, 32, 2048, 2048, False, None),
                ("op graph B1 H32 N1000 causal", 1, 32, 1000, 1000, True, None),
                ("op graph B16 H32 N128 causal", 16, 32, 128, 128, True, None)):
            for dtype in (bf, f32):
                q, k, v = (randn(b, h, n, d, dtype=dtype)
                           for n in (n_q, n_kv, n_kv))
                sched = fa._schedule(q, k, causal, None, ln_ is not None).name
                lib, args = _sdpa(torch, q, k, v, causal, None, ln_)
                ph.check(_flash_name("flash_fwd", q, k), f"{label} D{d} ({sched})",
                         dtype,
                         lambda: fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc,
                                              kv_lengths=ln_),
                         lambda: fa.flash_fwd_plain(q, k, v, causal, sc, ln_),
                         _flash_cost(q, k, causal, None, ln_),
                         **_flash_gate(dtype, f"flash_fwd {label} D{d}"),
                         library=lambda: lib(*args))
                del q, k, v
                torch.cuda.empty_cache()

        # the flash backward: (label, dtype, B, H, H_kv, N, causal, lengths):
        # the bf16 subrow (train_d96's shape), the grid with GQA, the varlen
        # subrow with a length of 0, the op graph at 512 keys and at the MT
        # model's 40; f32 the split pair at 2048 keys and the warp-level trio
        # at 40 and 200
        for label, dtype, b, h, h_kv, n, causal, ln_ in (
                ("B4 H32 N2048 causal", bf, 4, 32, 32, 2048, True, None),
                ("grid B1 H32/8 N2048 non-causal GQA", bf, 1, 32, 8, 2048, False,
                 None),
                ("B4 H32 N2048 causal varlen len 0", bf, 4, 32, 32, 2048, True,
                 lens0),
                ("op graph B4 H32 N512 causal", bf, 4, 32, 32, 512, True, None),
                ("op graph B128 H8 N40 causal", bf, 128, 8, 8, 40, True, None),
                ("B4 H32 N2048 causal", f32, 4, 32, 32, 2048, True, None),
                ("B128 H8 N40 causal", f32, 128, 8, 8, 40, True, None),
                ("B16 H8 N200 causal", f32, 16, 8, 8, 200, True, None)):
            q, do = (randn(b, h, n, d, dtype=dtype) for _ in range(2))
            k, v = (randn(b, h_kv, n, d, dtype=dtype) for _ in range(2))
            sched = fa._schedule(q, k, causal, None, ln_ is not None).name
            _flash_bwd_check(torch, ph, fa, f"{label} D{d} ({sched})", dtype, q,
                             k, v, do, causal, None, ln_)
            del q, k, v, do
            torch.cuda.empty_cache()

        # paged: B4, 32 kv heads, page 128, the histories above
        n_pages, pps = 4 * 16 + 1, 16
        table = torch.randperm(n_pages, generator=g, device=dev)[:4 * pps]
        table = table.reshape(4, pps).int()
        for dtype in (bf, f32):
            name = "paged_attention" if dtype == bf else "paged_attention_f32"
            for pname in ("native", "int8", "fp8"):
                kv = [randn(32, n_pages, 128, d) for _ in range(2)]
                kw = {}
                if pname == "native":
                    kp, vp = (t.to(dtype) for t in kv)
                else:
                    kq, vq = (quantize(t, payloads[pname]) for t in kv)
                    kp, vp = kq.values, vq.values
                    kw = dict(k_scales=kq.scales, v_scales=vq.scales)
                del kv
                pool = {"native": str(dtype)[6:]}.get(pname, pname)
                for label, q_, chunk in (
                        ("decode", randn(4, 32, d, dtype=dtype), 1),
                        ("chunk 64", randn(4, 64, 32, d, dtype=dtype), 64)):
                    full = f"{label} B4 Hkv32 d{d} page128 {pool} pool"
                    gate = (dict(compare=_rel_err) if dtype == bf else
                            _paged_f32_gate(pa, q_, kp, vp, lens, table, kw, full))
                    ph.check(name, full, dtype,
                             lambda: pa.paged_attention(q_, kp, vp, lens, table, **kw),
                             lambda: pa.paged_attention_plain(q_, kp, vp, lens, table,
                                                              **kw),
                             _paged_cost(q_, chunk, 32, 32, lens,
                                         quantized=pname != "native"), **gate)
                if pname == "native":
                    # a split a page: 16 splits a sequence, merged
                    qm = randn(4, 1, 32, d, dtype=dtype)
                    plan = pa.split_plan(4, 32, 1, 1, 128, pps, dtype, None,
                                         torch.cuda.get_device_properties(0)
                                         .multi_processor_count, 1)
                    full = f"decode B4 Hkv32 d{d} a split a page ({plan[1]} splits)"
                    gate = (dict(compare=_rel_err) if dtype == bf else
                            _paged_f32_gate(pa, qm, kp, vp, lens, table, {}, full))
                    ph.check(name, full, dtype,
                             lambda: pa.paged_attention_fwd(qm, kp, vp, lens, table,
                                                            sm_scale=sc, split_pages=1),
                             lambda: pa.paged_attention_plain(qm, kp, vp, lens, table),
                             _paged_cost(qm, 1, 32, 32, lens), **gate)
                del kp, vp, kw
                torch.cuda.empty_cache()

        # kv8_flash: B4 H32 N2048 causal (the grid route below d 128)
        for pname, payload in payloads.items():
            k8, v8 = (quantize(randn(4, 32, 2048, d), payload) for _ in range(2))
            for dtype in (bf, f32):
                q = randn(4, 32, 2048, d, dtype=dtype)
                route = qt._kv8_route(True, 2048, 2048, d).name
                lib, args = _sdpa(torch, q, k8.dequantize(dtype),
                                  v8.dequantize(dtype), True, None, None)
                name = "kv8_flash" if dtype == bf else "kv8_flash_f32"
                ph.check(name, f"{route} B4 H32 N2048 D{d} causal {pname}", dtype,
                         lambda: qt.flash_attention_kv_int8(q, k8, v8, True, sc),
                         lambda: qt.flash_attention_kv_int8_reference(q, k8, v8,
                                                                      True, sc),
                         _kv8_cost(q, k8.values, True),
                         **_flash_gate(dtype, f"{name} D{d} {pname}"),
                         library=lambda: lib(*args))
                del q
            del k8, v8
            torch.cuda.empty_cache()

    # the marks at d 80: serve_d96's 2048-row wave shape, a NaN in V's last
    # column
    d = 80
    n_pages, pps = 4 * 16 + 1, 16
    vp = randn(32, n_pages, 128, d, dtype=bf)
    vp[:, 5, 7, d - 1] = math.nan
    table = torch.randperm(n_pages, generator=g, device=dev)[:4 * pps]
    table = table.reshape(4, pps).int()
    wave = torch.full((4,), 2048, device=dev)
    words = -(-d // 32) + 1
    ph.check("paged_nonfinite", f"marks, 2048-row wave B4 Hkv32 d{d}", bf,
             lambda: pa.paged_nonfinite(vp, wave, table, 2048),
             lambda: pa.paged_nonfinite_plain(vp, wave, table, 2048),
             (4 * pps * 128 * 32 * d * 2 + 4 * 32 * pps * words * 4, 0),
             compare=_bit_err)


def wide_head_dim_kernel_phases(torch, dev, ph: Phases) -> None:
    """The bf16 forward's and bf16-q paged attention's 256-column tiles at
    WIDE_HEAD_DIM_LINES (d 160: zero-padded to 256; d 256: full) at
    serve_d256's shapes (GEMMA_D256: 8 q heads, one kv head), each against
    its plain version under the gate of its d-128 line, the bound counted
    at the real d: the flash forward's grid (B4 N2048 causal varlen, the
    batched prefill), the op graph's wgmma walk (B1 N1000) and its
    warp-level kernel (B16 N128), SDPA in bf16 beside each; paged decode
    (B4, group 8, histories <= 8192, page 128) over bf16, int8 and fp8
    pools, a chunk of 64, a 2048-row extend wave (chunk 256 x 8 q heads:
    the marks and the poison pass) and the decode a split a page (the
    merge); the marks with a NaN in column d - 1.  Inputs from a generator
    of their own, so the other phases keep theirs."""
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.ops import paged_attention as pa
    from flashattn_tpu_torch.ops import quant as qt

    g = torch.Generator(device=dev).manual_seed(SEED + 25)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    bf = torch.bfloat16
    payloads = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
    lens = torch.tensor([2048, 1536, 1024, 517], device=dev)
    hist = torch.tensor([8192, 4096, 2048, 517], device=dev)
    n_pages, pps = 4 * 64 + 1, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in WIDE_HEAD_DIM_LINES:
        sc = d ** -0.5
        # flash: (label, B, H, H_kv, N_q, N_kv, causal, lengths)
        for label, b, h, h_kv, n_q, n_kv, causal, ln_ in (
                ("B4 H8/1 N2048 causal varlen", 4, 8, 1, 2048, 2048, True, lens),
                ("op graph B1 H8/1 N1000 causal", 1, 8, 1, 1000, 1000, True, None),
                ("op graph B16 H8/1 N128 causal", 16, 8, 1, 128, 128, True, None)):
            q = randn(b, h, n_q, d, dtype=bf)
            k, v = (randn(b, h_kv, n_kv, d, dtype=bf) for _ in range(2))
            sched = fa._schedule(q, k, causal, None, ln_ is not None).name
            lib, args = _sdpa(torch, q, k, v, causal, None, ln_)
            ph.check("flash_fwd", f"{label} D{d} ({sched})", bf,
                     lambda: fa.flash_fwd(q, k, v, causal=causal, sm_scale=sc,
                                          kv_lengths=ln_),
                     lambda: fa.flash_fwd_plain(q, k, v, causal, sc, ln_),
                     _flash_cost(q, k, causal, None, ln_),
                     **_flash_gate(bf, f"flash_fwd {label} D{d}"),
                     library=lambda: lib(*args))
            del q, k, v, args
            torch.cuda.empty_cache()

        # paged: B4, one kv head and 8 q heads, page 128, histories <= 8192
        table = torch.randperm(n_pages, generator=g, device=dev)[:4 * pps]
        table = table.reshape(4, pps).int()
        for pname in ("bf16", "int8", "fp8"):
            kv = [randn(1, n_pages, 128, d) for _ in range(2)]
            kw = {}
            if pname == "bf16":
                kp, vp = (t.to(bf) for t in kv)
            else:
                quant = qt.quantize_int8 if pname == "int8" else qt.quantize_fp8
                kq, vq = (quant(t) for t in kv)
                kp, vp = kq.values, vq.values
                kw = dict(k_scales=kq.scales, v_scales=vq.scales)
            del kv
            for label, q_, chunk in (
                    ("decode", randn(4, 8, d, dtype=bf), 1),
                    ("chunk 64", randn(4, 64, 8, d, dtype=bf), 64),
                    ("extend wave 2048 rows (chunk 256)",
                     randn(4, 256, 8, d, dtype=bf), 256)):
                ph.check("paged_attention",
                         f"{label} B4 H8/1 d{d} page128 {pname} pool", bf,
                         lambda: pa.paged_attention(q_, kp, vp, hist, table, **kw),
                         lambda: pa.paged_attention_plain(q_, kp, vp, hist, table,
                                                          **kw),
                         _paged_cost(q_, chunk, 8, 1, hist,
                                     quantized=pname != "bf16"),
                         compare=_rel_err)
            if pname == "bf16":
                # a split a page: 64 splits a sequence, merged
                qm = randn(4, 1, 8, d, dtype=bf)
                plan = pa.split_plan(4, 1, 8, 1, 128, pps, bf, None, sms, 1)
                ph.check("paged_attention",
                         f"decode B4 H8/1 d{d} a split a page ({plan[1]} splits)",
                         bf,
                         lambda: pa.paged_attention_fwd(qm, kp, vp, hist, table,
                                                        sm_scale=sc, split_pages=1),
                         lambda: pa.paged_attention_plain(qm, kp, vp, hist, table),
                         _paged_cost(qm, 1, 8, 1, hist), compare=_rel_err)
            del kp, vp, kw
            torch.cuda.empty_cache()

        # the marks at the wave's shape, a NaN in V's last column
        vp = randn(1, n_pages, 128, d, dtype=bf)
        vp[:, table[0, 3], 7, d - 1] = math.nan
        words = -(-d // 32) + 1
        walked = sum(-(-int(n) // 128) for n in hist.tolist())
        ph.check("paged_nonfinite", f"marks, 2048-row wave B4 H8/1 d{d}", bf,
                 lambda: pa.paged_nonfinite(vp, hist, table, 256),
                 lambda: pa.paged_nonfinite_plain(vp, hist, table, 256),
                 (walked * 128 * d * 2 + 4 * pps * words * 4, 0),
                 compare=_bit_err)
        del vp
        torch.cuda.empty_cache()


def kernel_phases(torch, dev) -> Phases:
    ph = Phases()
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    serving_kernel_phases(torch, dev, ph, randn)
    c15_kernel_phases(torch, dev, ph, randn)
    torch.cuda.empty_cache()
    training_kernel_phases(torch, dev, ph, randn)
    torch.cuda.empty_cache()
    quant_kernel_phases(torch, dev, ph, randn)
    torch.cuda.empty_cache()
    softmax_kernel_phases(torch, dev, ph, randn)
    torch.cuda.empty_cache()
    dropout_bias_kernel_phases(torch, dev, ph, randn)
    torch.cuda.empty_cache()
    mt_kernel_phases(torch, dev, ph, randn)
    torch.cuda.empty_cache()
    f32_nonfinite_phases(torch, dev)
    torch.cuda.empty_cache()
    head_dim_kernel_phases(torch, dev, ph)
    torch.cuda.empty_cache()
    wide_head_dim_kernel_phases(torch, dev, ph)
    torch.cuda.empty_cache()
    return ph


def kernel_counters():
    from flashattn_tpu_torch.ops import dropout as dr
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.ops import layernorm as ln
    from flashattn_tpu_torch.ops import paged_attention as pa
    from flashattn_tpu_torch.ops import quant as qt
    from flashattn_tpu_torch.ops import softmax as sm

    # an older package (tools/ab_chip_smoke.py's parent root) has no
    # split-precision f32 kernels
    f32 = ({"flash_fwd_f32": fa._f32_kernel, "flash_bwd_f32": fa._f32_bwd_kernel}
           if hasattr(fa, "_f32_kernel") else {})
    if hasattr(fa, "_f32_mma_kernel"):
        f32.update(flash_fwd_f32_mma=fa._f32_mma_kernel,
                   flash_bwd_f32_mma=fa._f32_mma_bwd_kernel)
    if hasattr(qt, "_wo_f32_kernel"):
        f32.update(wo_matmul_f32=qt._wo_f32_kernel, kv8_flash_f32=qt._kv8_f32_kernel)
    if hasattr(pa, "_f32_kernel"):
        f32.update(paged_attention_f32=pa._f32_kernel)
    return {"layernorm_fwd": ln._kernel, "layernorm_bwd": ln._bwd_kernel,
            "flash_fwd": fa._kernel, "flash_bwd": fa._bwd_kernel, **f32,
            "paged_attention": pa._kernel, "paged_nonfinite": pa._nf_kernel,
            "dropout": dr._kernel,
            "wo_matmul": qt._wo_kernel, "kv8_flash": qt._kv8_kernel,
            "stochastic_quant": qt._sq_kernel, "softmax_fwd": sm._fwd_kernel,
            "softmax_bwd": sm._bwd_kernel, "dropout_res_bias": dr._res_kernel,
            "dropout_act_bias": dr._act_kernel}


SERVE_KERNELS = ("layernorm_fwd", "flash_fwd", "paged_attention",
                 "paged_nonfinite")


def _widths(cfg) -> str:
    """A model configuration's widths for the logs: E1024 8x128 L4."""
    return (f"E{cfg['n_embd']} {cfg['n_head']}x{cfg['n_embd'] // cfg['n_head']} "
            f"L{cfg['n_layer']}")


def serve_phase(torch, model, dev, label: str = "serve", cfg=MODEL) -> dict:
    """``model`` (of configuration ``cfg``) in bf16 through the engine: the
    serve traffic (PROMPTS, NEW_TOKENS new tokens each) after a warm-up;
    every request finishes, no page leaks, SERVE_KERNELS launch."""
    import numpy as np

    from flashattn_tpu_torch import ContinuousBatchingEngine

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg["n_vocab"], n).tolist() for n in PROMPTS]

    # warm-up on the same paths (batched prefill, chunked prefill, decode)
    warm = ContinuousBatchingEngine(model, dtype=torch.bfloat16, **ENGINE)
    warm.submit(prompts[3][:300], 9)
    warm.run()
    warm.submit(prompts[4][:2100], 9)
    warm.run()
    del warm

    eng = ContinuousBatchingEngine(model, dtype=torch.bfloat16, **ENGINE)
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    counters = {n: k for n, k in kernel_counters().items()
                if n in SERVE_KERNELS}
    for kern in counters.values():
        kern.launches = 0
    prompt_tok = decode_tok = 0
    prefill_s = decode_s = 0.0
    ttft = {}
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
        for r in reqs:
            if r.generated and r.uid not in ttft:
                ttft[r.uid] = (time.perf_counter() - t_start) * 1e3
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
        assert all(0 <= t < cfg["n_vocab"] for t in r.generated)
        assert all(math.isfinite(lp) and lp <= 0 for lp in r.token_logprobs)
    assert eng.pool.n_free == eng.pool.total, "pages leaked"
    for name, n in launches.items():
        assert n > 0, f"{name} was not launched on the serving path"
    out = dict(prompt_tok_s=prompt_tok / prefill_s,
               decode_tok_s=decode_tok / decode_s, wall_ms=wall_ms,
               prompt_tokens=prompt_tok, decode_tokens=decode_tok,
               ttft_ms=[ttft[r.uid] for r in reqs], launches=launches)
    log(f"[{label}] {torch.cuda.get_device_name(0)} bf16 {_widths(cfg)}: "
        f"prompt {prompt_tok} tok in {prefill_s * 1e3:.1f} ms "
        f"({out['prompt_tok_s']:.1f} tok/s), decode {decode_tok} tok in "
        f"{decode_s * 1e3:.1f} ms ({out['decode_tok_s']:.1f} tok/s), "
        f"wall {wall_ms:.1f} ms, TTFT ms by request "
        f"{[round(t, 1) for t in out['ttft_ms']]}, launches {launches}")
    return out


def _engine_vs_dense(torch, model, dev, cfg, dtype=None):
    """The consistency traffic through ``model``'s engine (in ``dtype``;
    None: the model's): a 500-token prompt (batched prefill) with 100 new
    tokens and a 600-token one (chunked prefill) with 8, every position's
    logits against one dense forward of the trajectory.  Returns (max abs
    err, max abs err over max |dense|, the least argmax agreement, the
    positions)."""
    import numpy as np

    from flashattn_tpu_torch import ContinuousBatchingEngine

    rng = np.random.default_rng(SEED + 1)
    kw = {} if dtype is None else dict(dtype=dtype)
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=128,
                                   pages_per_seq=8, prefill_chunk=512,
                                   collect_logits=True, **kw)
    # 500-token prompt: batched prefill; 600-token prompt: chunked prefill
    reqs = [eng.submit(rng.integers(0, cfg["n_vocab"], 500).tolist(), 100),
            eng.submit(rng.integers(0, cfg["n_vocab"], 600).tolist(), 8)]
    eng.run()
    assert eng.pool.n_free == eng.pool.total, "pages leaked"
    err, rel, agree = 0.0, 0.0, 1.0
    with torch.inference_mode():
        for r in reqs:
            traj = r.prompt + r.generated[:-1]
            dense = model(torch.tensor([traj], device=dev))[0].float().cpu()
            got = torch.from_numpy(np.stack(r.logits))
            assert got.shape == dense.shape, (got.shape, dense.shape)
            e = float((got - dense).abs().max())
            err, rel = max(err, e), max(rel, e / float(dense.abs().max()))
            agree = min(agree, float((got.argmax(-1) == dense.argmax(-1))
                                     .float().mean()))
            del dense, got
    return err, rel, agree, [len(r.prompt) + len(r.generated) - 1 for r in reqs]


def consistency_phase(torch, model, dev, label: str = "consistency",
                      cfg=MODEL) -> float:
    """``model`` (f32, of configuration ``cfg``): engine logits along a
    batched and a chunked prefill and their decodes against the dense
    forward, within 1e-3."""
    err, _, _, positions = _engine_vs_dense(torch, model, dev, cfg)
    log(f"[{label}] f32 engine vs dense forward over {positions} positions: "
        f"max_abs_err={err:.3e}")
    if not err <= 1e-3:
        raise AssertionError(f"engine logits differ from dense by {err}")
    return err


class _NoPlain:
    """Makes the plain versions of the serving and training paths' kernels
    (flash forward and backward, paged attention and its marks, LayerNorm
    forward and backward, dropout) raise while it is entered: a run on the
    card must launch the kernels, never fall back."""

    def __init__(self):
        from flashattn_tpu_torch.ops import dropout as dr
        from flashattn_tpu_torch.ops import flash_attention as fa
        from flashattn_tpu_torch.ops import layernorm as ln
        from flashattn_tpu_torch.ops import paged_attention as pa

        self.names = [(fa, n) for n in ("flash_fwd_plain", "flash_bwd_plain",
                                        "_reference_fwd_with_lse",
                                        "_kernel_fwd_plain", "_reference_bwd",
                                        "_op_graph_bwd")]
        self.names += [(pa, "paged_attention_plain"), (pa, "paged_nonfinite_plain"),
                       (ln, "_layernorm_fwd_reference"),
                       (ln, "layernorm_bwd_reference"), (dr, "dropout_reference")]
        self.saved = []

    def __enter__(self):
        def refuse(name):
            def fn(*args, **kw):
                raise AssertionError(f"plain version {name} called on the card")
            return fn

        self.saved = [(m, n, getattr(m, n)) for m, n in self.names]
        for m, n in self.names:
            setattr(m, n, refuse(n))
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def serve_d96_phase(torch, dev) -> dict:
    """The PHI3_D96 model (heads of 96): f32 engine logits against the dense
    forward within 1e-3 (the f32 flash forward and the f32-q paged tiles),
    then the serve traffic in bf16 (batched prefill: the _pad128 subrow at
    d 96; the 3000-token prompt: the grid and the extend tile; decode: the
    decode tile), and one decode dispatch profiled.  The plain versions
    must not run (_NoPlain)."""
    import numpy as np

    from flashattn_tpu_torch import ContinuousBatchingEngine, DecoderLM

    model = DecoderLM(**PHI3_D96, device=dev,
                      generator=torch.Generator().manual_seed(SEED)).eval()
    f32_kernels = ("flash_fwd_f32", "paged_attention_f32")
    with _NoPlain(), _Launches(SERVE_KERNELS + f32_kernels) as run:
        consistency_phase(torch, model, dev, "serve_d96", PHI3_D96)
    for name in f32_kernels:
        if not run.counts[name] > 0:
            raise AssertionError(f"{name} was not launched by serve_d96's f32 run")
    log(f"[serve_d96] f32 launches {run.counts}")
    bf_model = copy.deepcopy(model).to(torch.bfloat16)
    del model
    with _NoPlain():
        out = serve_phase(torch, bf_model, dev, "serve_d96", PHI3_D96)
        # where a decode dispatch spends its time: serve's first four
        # prompts prefilled, one warm dispatch, then one under the profiler
        eng = ContinuousBatchingEngine(bf_model, dtype=torch.bfloat16, **ENGINE)
        rng = np.random.default_rng(SEED + 3)
        for n in PROMPTS[:4]:
            eng.submit(rng.integers(0, PHI3_D96["n_vocab"], n).tolist(), NEW_TOKENS)
        eng.step()
        eng.step()
        profile_step(torch, eng.step, "serve_d96 decode dispatch "
                     f"(B4, {ENGINE['steps_per_dispatch']} steps)")
        del eng
    del bf_model
    out["launches"] = {n: out["launches"].get(n, 0) + run.counts[n]
                       for n in run.counts}
    return out


def serve_d256_phase(torch, dev, power: str) -> dict:
    """The GEMMA_D256 model (8 heads of 256, one kv head).  In f32 the engine
    raises ROADMAP.md §B2b's ValueError before any launch (the f32 kernels
    stop at d 128): an expected outcome, checked.  Then in bf16, under
    _NoPlain: the engine's logits against the bf16 dense forward over
    consistency_phase's traffic (max |diff| / max |dense| < 0.08, argmax
    agreement >= 0.8: the bound of a served model against its dense forward,
    JAX's tests/test_serving.py), serve's traffic (batched prefill: the grid
    at d 256 over 2048, 1536 and 1024 keys, the op graph's wgmma walk at 517;
    the 3000-token prompt: the grid, then the extend tile with the marks and
    the poison pass; decode: the decode tile and the merge), and one decode
    dispatch profiled."""
    import numpy as np

    from flashattn_tpu_torch import ContinuousBatchingEngine, DecoderLM

    t0 = time.perf_counter()
    model = DecoderLM(**GEMMA_D256, device=dev,
                      generator=torch.Generator().manual_seed(SEED)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve_d256] {_widths(GEMMA_D256)} 1 kv head, "
        f"{n_params / 1e9:.3f} B parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    f32_kernels = ("flash_fwd_f32", "flash_fwd_f32_mma", "paged_attention_f32")
    with _Launches(f32_kernels) as run:
        eng = ContinuousBatchingEngine(model, **ENGINE)
        eng.submit(list(range(1, 301)), 4)
        try:
            eng.run()
        except ValueError as e:
            if "§B2b" not in str(e):
                raise
            log(f"[serve_d256] f32 engine refused, as expected: {e}")
        else:
            raise AssertionError("the f32 engine ran at d 256: ROADMAP.md "
                                 "§B2b's ValueError was expected")
        del eng
    if any(run.counts.values()):
        raise AssertionError(f"serve_d256 f32: launches {run.counts}")
    model = model.to(torch.bfloat16)
    torch.cuda.empty_cache()
    with _NoPlain():
        with _Launches(SERVE_KERNELS) as cons:
            err, rel, agree, positions = _engine_vs_dense(
                torch, model, dev, GEMMA_D256, torch.bfloat16)
        log(f"[serve_d256] {power} bf16 engine vs bf16 dense forward over "
            f"{positions} positions: max_abs_err={err:.3e}, max rel err "
            f"{rel:.3e} (< 0.08), argmax agreement {agree:.4f} (>= 0.8), "
            f"launches {cons.counts}")
        if not (rel < 0.08 and agree >= 0.8):
            raise AssertionError(f"serve_d256: rel {rel}, agreement {agree}")
        out = serve_phase(torch, model, dev, "serve_d256", GEMMA_D256)
        eng = ContinuousBatchingEngine(model, dtype=torch.bfloat16, **ENGINE)
        rng = np.random.default_rng(SEED + 3)
        for n in PROMPTS[:4]:
            eng.submit(rng.integers(0, GEMMA_D256["n_vocab"], n).tolist(),
                       NEW_TOKENS)
        eng.step()
        eng.step()
        profile_step(torch, eng.step, "serve_d256 decode dispatch "
                     f"(B4, {ENGINE['steps_per_dispatch']} steps)")
        del eng
    del model
    log(f"[serve_d256] {power} {_widths(GEMMA_D256)} bf16: prompt "
        f"{out['prompt_tok_s']:.1f} tok/s, TTFT ms by request "
        f"{[round(t, 1) for t in out['ttft_ms']]}, decode "
        f"{out['decode_tok_s']:.1f} tok/s")
    out["launches"] = {n: out["launches"][n] + cons.counts[n]
                       for n in out["launches"]}
    return out


def _pool_bytes(pools) -> int:
    return sum(t.numel() * t.element_size() for pool in pools
               for t in pool.values())


def serve_quant_variant(torch, model, label: str, pool_dtype,
                        kernels=QUANT_KERNELS) -> dict:
    """One variant of the quantized serving configuration: a warm-up
    request, then four 8192-token prompts through one batched prefill and
    64 greedy decode steps each; the launches of ``kernels``."""
    import numpy as np

    from flashattn_tpu_torch import ContinuousBatchingEngine

    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, MODEL["n_vocab"], QUANT_PROMPT).tolist()
               for _ in range(5)]
    eng = ContinuousBatchingEngine(model, dtype=pool_dtype, **QUANT_ENGINE)
    warm = eng.submit(prompts[4], 9)
    eng.run()
    assert warm.done and not warm.truncated
    counters = {n: k for n, k in kernel_counters().items() if n in kernels}
    for kern in counters.values():
        kern.launches = 0
    reqs = [eng.submit(p, QUANT_NEW_TOKENS) for p in prompts[:4]]
    first_token = {}
    prefill_s = decode_s = 0.0
    prompt_tok = decode_tok = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    while True:
        queued = {id(r) for r in eng.queue}
        gen_before = sum(len(r.generated) for r in reqs)
        t0 = time.perf_counter()
        progressed = eng.step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if not progressed:
            break
        for r in reqs:
            if r.generated and r.uid not in first_token:
                first_token[r.uid] = t1 - t_start
        admitted = [r for r in reqs if id(r) in queued and r not in eng.queue]
        if admitted:
            prefill_s += t1 - t0
            prompt_tok += sum(len(r.prompt) for r in admitted)
        else:
            decode_s += t1 - t0
            decode_tok += sum(len(r.generated) for r in reqs) - gen_before
    wall_ms = (time.perf_counter() - t_start) * 1e3
    launches = {name: kern.launches for name, kern in counters.items()}
    for r in reqs:
        assert r.done and not r.truncated, f"request {r.uid} did not finish"
        assert len(r.generated) == QUANT_NEW_TOKENS, (r.uid, len(r.generated))
        assert all(0 <= t < MODEL["n_vocab"] for t in r.generated)
        assert all(math.isfinite(lp) and lp <= 0 for lp in r.token_logprobs)
    # one more request: its prefill, then one decode dispatch (8 steps)
    # under the profiler
    extra = eng.submit(prompts[4][:2048], 17)
    eng.step()
    profile_step(torch, eng.step, f"serve_quant {label}: decode dispatch")
    eng.run()
    assert extra.done and not extra.truncated
    assert eng.pool.n_free == eng.pool.total, "pages leaked"
    out = dict(prompt_tok_s=prompt_tok / prefill_s,
               ttft_ms=statistics.mean(first_token.values()) * 1e3,
               decode_tok_s=decode_tok / decode_s, wall_ms=wall_ms,
               pool_bytes=_pool_bytes(eng.pools), launches=launches)
    log(f"[serve_quant] {label}: prompt {prompt_tok} tok in "
        f"{prefill_s * 1e3:.1f} ms ({out['prompt_tok_s']:.1f} tok/s), TTFT "
        f"{out['ttft_ms']:.1f} ms, decode {decode_tok} tok in "
        f"{decode_s * 1e3:.1f} ms ({out['decode_tok_s']:.1f} tok/s), wall "
        f"{wall_ms:.1f} ms, pool {out['pool_bytes'] / 2**20:.1f} MiB, "
        f"launches {launches}")
    del eng
    return out


def serve_quant_phase(torch, dev) -> dict:
    """bf16 weights + bf16 pool, int8 weights + int8 pool, int8 weights +
    fp8 pool (bench_serving.py's northstar() configurations, the model cast
    to bf16), then northstar() at its own dtype: the f32 model with int8
    weights over an int8 and an fp8 pool, and its gate."""
    import flashattn_tpu_torch as pt

    base32 = pt.DecoderLM(**QUANT_MODEL,
                          generator=torch.Generator().manual_seed(SEED),
                          device=dev).eval()
    q32 = pt.quantize_model_weights(base32, torch.int8)
    base = base32.to(torch.bfloat16)
    del base32
    qmodel = pt.quantize_model_weights(base, torch.int8)
    variants = {"bf16 weights + bf16 pool": (base, torch.bfloat16),
                "int8 weights + int8 pool": (qmodel, torch.int8),
                "int8 weights + fp8 pool": (qmodel, torch.float8_e4m3fn),
                "f32, int8 weights + int8 pool": (q32, torch.int8),
                "f32, int8 weights + fp8 pool": (q32, torch.float8_e4m3fn)}
    results = {}
    # an older root (tools/ab_chip_smoke.py's parent) counts f32-q paged
    # launches under paged_attention
    f32_absent = (QUANT_F32_ABSENT if "paged_attention_f32" in kernel_counters()
                  else ("wo_matmul",))
    for label, (model, pool_dtype) in variants.items():
        f32 = model is q32
        res = serve_quant_variant(
            torch, model, label, pool_dtype,
            QUANT_F32_KERNELS + f32_absent if f32
            else QUANT_KERNELS + QUANT_ABSENT)
        quantized = model is not base
        for name, n in res["launches"].items():
            if (name == "wo_matmul" and not quantized) or (
                    name in (f32_absent if f32 else QUANT_ABSENT)):
                assert n == 0, f"{label}: {name} launched {n} times"
            elif n <= 0:
                raise AssertionError(f"{label}: {name} was not launched")
        results[label] = res
        torch.cuda.empty_cache()
    del base, qmodel
    torch.cuda.empty_cache()
    northstar_f32_gate(torch, q32, dev)
    return results


def northstar_f32_gate(torch, q32, dev) -> None:
    """The f32 north-star model with int8 weights over an int8 and an fp8
    pool: one 8192-token prompt and QUANT_F32_GATE_NEW greedy tokens
    through the engine (its settings), the logits of every position against
    one dense forward of the same quantized model over the trajectory, to
    the JAX tests' bounds (max |diff| / max |dense| < 0.08, argmax
    agreement >= 0.8)."""
    import numpy as np

    from flashattn_tpu_torch import ContinuousBatchingEngine

    prompt = np.random.default_rng(SEED + 4).integers(
        0, MODEL["n_vocab"], QUANT_PROMPT).tolist()
    for name, dtype in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        eng = ContinuousBatchingEngine(q32, collect_logits=True, dtype=dtype,
                                       **QUANT_ENGINE)
        req = eng.submit(prompt, QUANT_F32_GATE_NEW)
        eng.run()
        assert req.done and eng.pool.n_free == eng.pool.total
        traj = req.prompt + req.generated[:-1]
        with torch.inference_mode():
            dense = q32(torch.tensor([traj], device=dev))[0].float().cpu()
        got = torch.from_numpy(np.stack(req.logits))
        assert got.shape == dense.shape, (got.shape, dense.shape)
        rel = float((got - dense).abs().max() / dense.abs().max())
        agree = float((got.argmax(-1) == dense.argmax(-1)).float().mean())
        log(f"[serve_quant] f32 north-star, int8 weights, {name} pool: engine "
            f"vs dense over {len(traj)} positions: max rel err {rel:.3e} "
            f"(< 0.08), argmax agreement {agree:.4f} (>= 0.8)")
        if not (rel < 0.08 and agree >= 0.8):
            raise AssertionError(f"f32 north-star {name} pool: rel {rel}, "
                                 f"agreement {agree}")
        del eng, req, dense, got
        torch.cuda.empty_cache()


def quant_consistency_phase(torch, model, dev) -> None:
    """The f32 model with int8 weights, over an int8 and then an fp8 pool:
    engine logits against one dense forward of the same quantized model."""
    import numpy as np

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch import ContinuousBatchingEngine

    qmodel = pt.quantize_model_weights(model, torch.int8)
    for name, dtype in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        rng = np.random.default_rng(SEED + 5)
        eng = ContinuousBatchingEngine(qmodel, max_batch=1, page_size=128,
                                       pages_per_seq=8, prefill_chunk=512,
                                       collect_logits=True, dtype=dtype)
        reqs = [eng.submit(rng.integers(0, MODEL["n_vocab"], 500).tolist(), 40),
                eng.submit(rng.integers(0, MODEL["n_vocab"], 600).tolist(), 8)]
        eng.run()
        assert eng.pool.n_free == eng.pool.total, "pages leaked"
        worst_rel, worst_agree = 0.0, 1.0
        with torch.inference_mode():
            for r in reqs:
                traj = r.prompt + r.generated[:-1]
                dense = qmodel(torch.tensor([traj], device=dev))[0].float().cpu()
                got = torch.from_numpy(np.stack(r.logits))
                assert got.shape == dense.shape, (got.shape, dense.shape)
                rel = float((got - dense).abs().max() / dense.abs().max())
                agree = float((got.argmax(-1) == dense.argmax(-1)).float().mean())
                worst_rel, worst_agree = max(worst_rel, rel), min(worst_agree, agree)
        log(f"[quant_consistency] f32 int8 weights, {name} pool, engine vs "
            f"dense over {[len(r.prompt) + len(r.generated) - 1 for r in reqs]}"
            f" positions: max rel err {worst_rel:.3e} (< 0.08), argmax "
            f"agreement {worst_agree:.4f} (>= 0.8)")
        if not (worst_rel < 0.08 and worst_agree >= 0.8):
            raise AssertionError(f"{name} pool: rel {worst_rel}, agreement "
                                 f"{worst_agree}")


def _feature_prompts():
    """bench_serving.py's prompts: 16 of 64 tokens from default_rng(0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(1, 999, size=FEAT_PROMPT).tolist()
            for _ in range(FEAT_REQUESTS)]


def _prefix_prompts():
    """4 prompts sharing a 1024-token prefix, each with its own 64-token
    suffix."""
    import numpy as np

    rng = np.random.default_rng(SEED + 6)
    prefix = rng.integers(1, 999, size=PREFIX_LEN).tolist()
    return [prefix + rng.integers(1, 999, size=SUFFIX_LEN).tolist()
            for _ in range(PREFIX_REQUESTS)]


def _sampled_kw(i: int, extras: bool = True) -> dict:
    kw = dict(temperature=0.8, seed=i)
    if extras:
        kw.update(FEAT_SAMPLED[i * len(FEAT_SAMPLED) // FEAT_REQUESTS])
    return kw


class _ExtendCalls:
    """Counts a model's multi-token ``forward_extend_paged`` calls (verify
    waves, chunked prefill) while active; decode steps do not go through
    it."""

    def __init__(self, model):
        self.model, self.calls = model, 0

    def __enter__(self):
        bound = self.model.forward_extend_paged

        def counted(*args, **kwargs):
            self.calls += 1
            return bound(*args, **kwargs)

        self.model.forward_extend_paged = counted
        return self

    def __exit__(self, *exc):
        del self.model.forward_extend_paged


def _feature_run(torch, model, dtype, engine_kw, reqs, prefix=False):
    """One engine serves ``reqs`` (prompt, submit kwargs); with ``prefix``
    the first request runs alone (its prompt pages enter the cache) and the
    rest are admitted together after it.  Returns (requests, a dict of the
    run's seconds, kernel launches, extend calls, shared pages of the later
    admissions, stats() and n-gram proposer)."""
    from flashattn_tpu_torch import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, dtype=dtype, **engine_kw)
    counters = {n: k for n, k in kernel_counters().items()
                if n in SERVE_KERNELS + ("paged_attention_f32",)}
    shared = []
    torch.cuda.synchronize()
    for kern in counters.values():
        kern.launches = 0
    with _ExtendCalls(model) as ext:
        t0 = time.perf_counter()
        if prefix:
            first = eng.submit(reqs[0][0], FEAT_NEW_TOKENS, **reqs[0][1])
            eng.run()
            out = [first] + [eng.submit(p, FEAT_NEW_TOKENS, **kw)
                             for p, kw in reqs[1:]]
            eng.step()                      # admission + suffix prefill
            shared = [s.shared_pages for s in eng.slots if s is not None]
        else:
            out = [eng.submit(p, FEAT_NEW_TOKENS, **kw) for p, kw in reqs]
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    run = dict(seconds=dt, extends=ext.calls, shared=shared,
               launches={name: k.launches for name, k in counters.items()},
               stats=eng.stats(), proposer=eng._ngram_impl)
    for r in out:
        assert r.done and not r.truncated, f"request {r.uid} did not finish"
        assert len(r.generated) == FEAT_NEW_TOKENS, (r.uid, len(r.generated))
        assert all(0 <= t < MODEL["n_vocab"] for t in r.generated)
        assert all(math.isfinite(lp) and lp <= 0 for lp in r.token_logprobs)
    # drop the prefix cache: every page must then be free
    for key, page in list(eng._prefix_cache.items()):
        del eng._prefix_cache[key]
        eng._drop_page_ref(page)
    assert eng.pool.n_free == eng.pool.total, "pages leaked"
    return out, run


def _feature_modes(model, draft):
    """mode -> (engine settings, submit kwargs of request i, the stats()
    key counting its speculative waves or None)."""
    greedy = lambda i: {}
    return {
        "greedy": ({}, greedy, None),
        "sampled": ({}, _sampled_kw, None),
        "draft k=4": (dict(draft_model=draft, spec_len=4), greedy,
                      "spec_waves"),
        "self-draft k=4": (dict(draft_model=model, spec_len=4), greedy,
                           "spec_waves"),
        "self-draft k=4 t=0.8": (dict(draft_model=model, spec_len=4),
                                 lambda i: _sampled_kw(i, extras=False),
                                 "spec_waves"),
        "lookup k=3": (dict(prompt_lookup=3), greedy, "lookup_waves"),
        "prefix cache": (dict(enable_prefix_cache=True), greedy, None),
    }


# modes held to plain greedy: token-identical in f32, agreement logged in bf16
FEAT_GREEDY_EXACT = ("draft k=4", "self-draft k=4", "lookup k=3",
                     "prefix cache")


def serve_features_phase(torch, model_f32, dev) -> dict:
    """Sampling, penalties, seeds, the prefix cache and both speculation
    modes on the north-star model at full width (phase 11)."""
    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.utils import native_loader

    prompts, prefix_prompts = _feature_prompts(), _prefix_prompts()
    draft_f32 = pt.DecoderLM(**FEAT_DRAFT,
                             generator=torch.Generator().manual_seed(SEED + 3),
                             device=dev).eval()
    total = {name: 0 for name in SERVE_KERNELS + ("paged_attention_f32",)}
    tokens = {}
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = copy.deepcopy(model_f32).to(dtype)
        draft = copy.deepcopy(draft_f32).to(dtype)
        for mode, (engine_kw, kw, waves) in _feature_modes(model,
                                                         draft).items():
            if label == "f32" and mode not in ("greedy",) + FEAT_GREEDY_EXACT:
                continue
            prefix = mode == "prefix cache"
            reqs = ([(p, kw(i)) for i, p in enumerate(prefix_prompts)]
                    if prefix else [(p, kw(i)) for i, p in enumerate(prompts)])
            eng_kw = dict(PREFIX_ENGINE if prefix else FEAT_ENGINE,
                          **engine_kw)
            if label == "bf16":   # warm-up engine: two requests, 16 tokens
                warm = pt.ContinuousBatchingEngine(model, dtype=dtype,
                                                   **eng_kw)
                for p, k in reqs[:2]:
                    warm.submit(p, 16, **k)
                warm.run()
                del warm
            out, run = _feature_run(torch, model, dtype, eng_kw, reqs, prefix)
            tokens[label, mode] = [r.generated for r in out]
            # each q dtype on its own paged tiles
            mine, other = (("paged_attention_f32", "paged_attention")
                           if label == "f32" else
                           ("paged_attention", "paged_attention_f32"))
            assert run["launches"][mine] > 0 and run["launches"][other] == 0, (
                f"{label} {mode}: paged launches {run['launches']}")
            if label == "f32":
                total[mine] += run["launches"][mine]
                continue
            new = sum(len(r.generated) for r in out)
            proposer = run["proposer"]
            if mode == "lookup k=3":
                assert proposer is native_loader.ngram_propose_native, (
                    f"the n-gram proposer was {proposer!r}, not the native one")
            log(f"[serve_features] bf16 {mode}: {new} new tokens in "
                f"{run['seconds'] * 1e3:.1f} ms "
                f"({new / run['seconds']:.1f} new tok/s), launches "
                f"{run['launches']}, extend calls {run['extends']}, stats "
                f"{run['stats']}"
                + (f", n-gram proposer {proposer.__module__}."
                   f"{proposer.__name__}" if proposer else "")
                + (f", shared pages {run['shared']}" if prefix else ""))
            for name, n in run["launches"].items():
                assert name not in FEAT_KERNELS or n > 0, (
                    f"{mode}: {name} was not launched")
                total[name] += n
            if mode in FEAT_GREEDY_EXACT:
                assert run["extends"] > 0, f"{mode}: the extend path did not run"
            if waves:
                assert run["stats"].get(waves, 0) > 0, f"{mode}: no waves"
            if prefix:
                hits = [PREFIX_LEN // PREFIX_ENGINE["page_size"]] * (
                    PREFIX_REQUESTS - 1)
                assert run["shared"] == hits, f"cache hits {run['shared']}"
            if mode == "sampled":
                _sampled_gates(torch, model, dtype, eng_kw, reqs,
                               tokens[label, mode])
            if mode in FEAT_PROFILED:
                _profile_dispatch(torch, model, dtype, eng_kw, reqs, mode)
        del model, draft
        torch.cuda.empty_cache()
    for label in ("bf16", "f32"):
        plain, prefix_plain = tokens[label, "greedy"], None
        for mode in FEAT_GREEDY_EXACT:
            want = plain
            if mode == "prefix cache":
                model = copy.deepcopy(model_f32).to(
                    torch.bfloat16 if label == "bf16" else torch.float32)
                want = [r.generated for r in _feature_run(
                    torch, model, next(model.parameters()).dtype,
                    PREFIX_ENGINE, [(p, {}) for p in prefix_prompts],
                    prefix=True)[0]]
                del model
            got = tokens[label, mode]
            same = sum(g == w for g, w in zip(got, want))
            log(f"[serve_features] {label} {mode}: {same}/{len(want)} "
                f"requests token-identical to plain greedy")
            if label == "f32" and same != len(want):
                raise AssertionError(f"f32 {mode} differs from plain greedy")
    return dict(launches=total)


def _profile_dispatch(torch, model, dtype, eng_kw, reqs, mode) -> None:
    """One dispatch after the admission (8 decode steps, or a scan of
    speculative waves) under torch.profiler."""
    from flashattn_tpu_torch import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, dtype=dtype, **eng_kw)
    for p, kw in reqs:
        eng.submit(p, FEAT_NEW_TOKENS, **kw)
    eng.step()
    profile_step(torch, eng.step, f"serve_features bf16 {mode}: the first "
                 "dispatch after the admission")
    eng.run()


def _sampled_gates(torch, model, dtype, eng_kw, reqs, batched) -> None:
    """Two runs with the same seeds land the same tokens; a sampled request
    alone lands what it lands inside the batch (one of each quarter)."""
    again = [r.generated for r in _feature_run(torch, model, dtype, eng_kw,
                                               reqs)[0]]
    assert again == batched, "sampled tokens differ between two runs"
    step = FEAT_REQUESTS // len(FEAT_SAMPLED)
    for i in range(1, FEAT_REQUESTS, step):
        alone = _feature_run(torch, model, dtype, eng_kw, [reqs[i]])[0][0]
        assert alone.generated == batched[i], (
            f"request {i} alone differs from the batch")
    log(f"[serve_features] bf16 sampled: two runs identical; requests "
        f"{list(range(1, FEAT_REQUESTS, step))} alone equal the batch")


def train_flops(cfg, batch, seq) -> float:
    """Model FLOP per train step, the formula of
    kernel_bench/bench_train_mfu.py:70-73: 6 x matmul weights x tokens, plus
    the causal attention's 7 score-shaped products.  An MoE layer counts
    the expert products of its top-k choices a token (not the capacity's
    padding, the router, nor the dispatch and combine products)."""
    e, m, l, h, v = (cfg[k] for k in ("n_embd", "middle_dim", "n_layer",
                                       "n_head", "n_vocab"))
    k = cfg.get("moe_top_k", 2) if cfg.get("n_experts") else 1
    w = l * (4 * e * e + k * 2 * e * m) + e * v
    return 6 * w * batch * seq + l * batch * h * (seq * seq / 2) * (e // h) * 2 * 7


def train_phase(torch, dev, power: str, cfg=TRAIN, name: str = "train",
                kernels=TRAIN_KERNELS, absent=(), opt=None, loss=None,
                mixed: bool = True) -> dict:
    """The training step at full width: losses finite and falling, every
    kernel of ``kernels`` launched in every step and none of ``absent``.
    ``opt`` defaults to Adam(1e-4), ``loss`` to lm_loss; either is wrapped
    in make_mixed_precision_loss unless ``mixed`` is False (f32 compute)."""
    import numpy as np

    import flashattn_tpu_torch as pt

    model = pt.DecoderLM(**cfg, generator=torch.Generator().manual_seed(SEED),
                         device=dev).train()
    n_params = sum(p.numel() for p in model.parameters())
    opt = pt.Adam(lr=1e-4) if opt is None else opt
    state = opt.init(model)
    loss = pt.lm_loss if loss is None else loss
    step = pt.make_train_step(
        opt, pt.make_mixed_precision_loss(loss) if mixed else loss,
        grad_clip=1.0)
    tok = np.random.default_rng(SEED).integers(
        0, cfg["n_vocab"], (TRAIN_BATCH, TRAIN_SEQ))
    tokens = torch.from_numpy(tok).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, device=dev)
    gen = torch.Generator().manual_seed(SEED)
    counters = {n: k for n, k in kernel_counters().items()
                if n in kernels or n in absent}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # model, optimizer state, earlier phases
    losses, times, per_step = [], [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        for kern in counters.values():
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, loss = step(model, state, tokens, targets, mask, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append({n: k.launches for n, k in counters.items()})
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times[WARMUP_STEPS:]) * 1e3
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tflops = flops / (ms * 1e-3) / 1e12
    launches = {n: sum(s[n] for s in per_step) for n in counters}
    extras = {k: cfg[k] for k in ("pos_encoding", "n_experts", "moe_top_k")
              if k in cfg}
    log(f"[{name}] {power} {'bf16-mixed' if mixed else 'f32'} {_widths(cfg)} "
        f"M{cfg['middle_dim']} V{cfg['n_vocab']} B{TRAIN_BATCH} S{TRAIN_SEQ} "
        f"p{cfg['p_dropout']} attn_impl={cfg['attn_impl']} {extras} "
        f"{type(opt).__name__}, {n_params / 1e6:.1f} M params: "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"[{name}] step ms {[round(t * 1e3, 1) for t in times]}; median of "
        f"{TIMED_STEPS} timed: {ms:.1f} ms, "
        f"{TRAIN_BATCH * TRAIN_SEQ / (ms * 1e-3):.1f} tokens/s, "
        f"{flops / 1e12:.2f} model TFLOP/step -> {tflops:.2f} TFLOP/s "
        f"({100 * tflops * 1e12 / PEAK_FLOP_S['bfloat16']:.2f}% of 989 TF); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({held / 2**30:.2f} "
        f"held before the first step)")
    log(f"[{name}] launches in each of the {len(per_step)} steps: "
        + ("same in every step: " + str(per_step[0])
           if all(c == per_step[0] for c in per_step) else str(per_step)))
    profile_step(torch, lambda: step(model, state, tokens, targets, mask, gen),
                 f"{name} step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        for kern, n in counts.items():
            if kern in absent and n != 0:
                raise AssertionError(f"{kern} launched {n} times in {name} "
                                     f"step {i}")
            if kern not in absent and n <= 0:
                raise AssertionError(f"{kern} not launched in {name} step {i}")
    if not peak < 80e9:
        raise AssertionError(f"{name} peak {peak / 2**30:.2f} GiB")
    return dict(ms=ms, peak=peak, launches=launches)


def profile_step(torch, run, label: str = "train step") -> None:
    """``run()`` (one more train step, or an engine step) under
    torch.profiler: the device busy share (the union of kernel intervals
    over the wall time) and the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    ours = [kv for kv in by_name.items() if re.search(
        r"\(anonymous namespace\)::(flash_|layernorm_|dropout_|softmax_"
        r"|paged_|wo_\w+_kernel|split_rows_kernel|kv8_flash_|sp::split_kernel"
        r"|stochastic_quant_kernel)", kv[0])]
    rest = sorted((kv for kv in by_name.items() if kv not in ours),
                  key=lambda kv: -kv[1][1])
    groups = {"matmul (cuBLAS)": ("nvjet", "gemm", "cutlass", "xmma"),
              "elementwise": ("elementwise",), "reduce": ("reduce",)}
    sums = {g: 0.0 for g in (*groups, "other PyTorch")}
    for name, (_, t) in rest:
        hit = [g for g, keys in groups.items() if any(k in name for k in keys)]
        sums[hit[0] if hit else "other PyTorch"] += t
    log(f"[profile] {label} wall {wall_ms:.1f} ms (under the profiler), "
        f"device busy {busy / 1e3:.1f} ms = "
        f"{100 * busy / 1e3 / wall_ms:.1f}% of wall; {len(spans)} device "
        f"events")
    for name, (n, t) in sorted(ours, key=lambda kv: -kv[1][1]) + rest[:6]:
        short = name.split("(anonymous namespace)::", 1)[-1]
        log(f"[profile]   {t / 1e3:9.3f} ms  {100 * t / max(busy, 1e-9):5.1f}%"
            f"  x{n:<5d} {short[:100]}")
    log("[profile] by group: " + ", ".join(
        f"{g} {t / 1e3:.1f} ms" for g, t in sums.items()))
    attn = [(n, t) for name, (n, t) in ours
            if re.search(r"::(flash_|sp::split_kernel)", name)]
    if attn:
        t_attn = sum(t for _, t in attn)
        log(f"[profile] attention (flash_*, the f32 split): {t_attn / 1e3:.3f} "
            f"ms in {sum(n for n, _ in attn)} launches = "
            f"{100 * t_attn / max(busy, 1e-9):.1f}% of device busy")
    paged = [(name, n, t) for name, (n, t) in ours if re.search(r"::paged_", name)]
    if paged:
        t_paged = sum(t for _, _, t in paged)
        t_f32 = sum(t for name, _, t in paged if "_f32_kernel" in name)
        log(f"[profile] paged attention (the split kernels, merge, marks, "
            f"poison): {t_paged / 1e3:.3f} ms in {sum(n for _, n, _ in paged)} "
            f"launches = {100 * t_paged / max(busy, 1e-9):.1f}% of device busy; "
            f"the f32-q tiles {t_f32 / 1e3:.3f} ms = "
            f"{100 * t_f32 / max(busy, 1e-9):.1f}%")
    # the op graph's kernels (an older tree's: the <..., true> instances of
    # flash_{fwd,bwd}_*_kernel and flash_bwd_opstats_kernel)
    op = [(n, t) for name, (n, t) in ours if re.search(
        r"flash_\w*_op_|flash_bwd_opstats|flash_(fwd|bwd)_\w*<[^>]*, true>", name)]
    if op:
        t_op = sum(t for _, t in op)
        log(f"[profile] op graph (flash_fwd_op_kernel, flash_bwd_op_*): "
            f"{t_op / 1e3:.3f} ms in {sum(n for n, _ in op)} launches = "
            f"{100 * t_op / max(busy, 1e-9):.1f}% of device busy")


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / max(b.double().norm(), 1e-30))


def train_consistency_phase(torch, dev, cfg=CONSIST,
                            name: str = "train-consistency",
                            loss_fn=None, batch: int = 2,
                            seq: int = 1024) -> None:
    """One backward of ``loss_fn`` (lm_loss by default) on the card vs a
    CPU copy (the plain versions); f32 with TF32 off."""
    import numpy as np

    import flashattn_tpu_torch as pt

    tok = np.random.default_rng(SEED + 2).integers(0, cfg["n_vocab"],
                                                   (batch, seq))
    for p in (0.0, 0.1):
        card = pt.DecoderLM(**cfg, p_dropout=p, device=dev,
                            generator=torch.Generator().manual_seed(SEED)).train()
        host = copy.deepcopy(card).to("cpu")
        out = []
        for m in (card, host):
            d = next(m.parameters()).device
            tokens = torch.from_numpy(tok).to(d)
            gen = torch.Generator().manual_seed(SEED + 3) if p else None
            loss = (loss_fn or pt.lm_loss)(
                m, tokens, torch.roll(tokens, -1, dims=1), None, gen)
            names, params = zip(*m.named_parameters())
            grads = torch.autograd.grad(loss, params)
            out.append((loss.detach().cpu(), {n: g.cpu() for n, g in
                                              zip(names, grads)}))
        _backward_gates(name, f"f32 E{cfg['n_embd']} H{cfg['n_head']} "
                        f"L{cfg['n_layer']} B{batch} S{seq} {cfg['attn_impl']} "
                        f"{cfg.get('pos_encoding', 'learned')} experts "
                        f"{cfg.get('n_experts')} p{p}", out,
                        cfg.get("pos_encoding") == "rope")
        del card, host, out


def _backward_gates(name: str, head: str, out, rope: bool = False) -> None:
    """Card vs CPU backward, ``out`` = [(loss, grads by name)] for the card
    and the CPU: the loss within 1e-5 relative, each gradient within 1e-4
    in relative L2 norm.  The key-projection biases have an exactly zero
    gradient (softmax is blind to a shift shared by every key): both
    devices return rounding noise there, held to 1e-4 of the global norm
    instead.  Under RoPE the rotation makes the shift depend on the key's
    position, so the gradient is real and compared as any other."""
    (l_card, g_card), (l_host, g_host) = out
    loss_err = abs(float(l_card) - float(l_host)) / abs(float(l_host))
    zero = [n for n in g_host if n.endswith("k_projection.bias") and not rope]
    total = math.sqrt(sum(float(g.double().square().sum())
                          for g in g_host.values()))
    noise = max([float(g[n].norm()) for g in (g_card, g_host)
                 for n in zero], default=0.0)
    grad_err = {n: _rel(g_card[n], g_host[n]) for n in g_host
                if n not in zero}
    worst = max(grad_err, key=grad_err.get)
    log(f"[{name}] {head}: loss card {float(l_card):.6f} cpu "
        f"{float(l_host):.6f} (rel {loss_err:.2e}); max grad rel-norm err "
        f"{grad_err[worst]:.2e} ({worst}); token_embeddings "
        f"{grad_err['token_embeddings.weights']:.2e}; k-bias noise "
        f"{noise:.2e} of global norm {total:.3e}")
    if not loss_err <= 1e-5:
        raise AssertionError(f"card loss differs from CPU by {loss_err}")
    if not grad_err[worst] <= 1e-4:
        raise AssertionError(f"{worst} gradient differs by {grad_err[worst]}")
    if not noise <= 1e-4 * total:
        raise AssertionError(f"key-bias gradient {noise} is not ~0")


def fused_logits_phase(torch, dev) -> None:
    """The fused-softmax model's dense f32 logits against the flash model's
    on the same weights."""
    import numpy as np

    import flashattn_tpu_torch as pt

    models = [pt.DecoderLM(**dict(CONSIST, attn_impl=impl), p_dropout=0.0,
                           device=dev,
                           generator=torch.Generator().manual_seed(SEED)).eval()
              for impl in ("fused_softmax", "flash")]
    models[1].load_state_dict(models[0].state_dict())
    tok = np.random.default_rng(SEED + 6).integers(0, CONSIST["n_vocab"],
                                                   (2, 1024))
    with torch.inference_mode():
        fused, flash = (m(torch.from_numpy(tok).to(dev)) for m in models)
    err = _abs_err(fused, flash)
    log(f"[fused-consistency] f32 E1024 L2 B2 S1024 dense logits, "
        f"fused_softmax vs flash: max_abs_err={err:.3e} (max |logit| "
        f"{float(flash.abs().max()):.3f})")
    if not err <= 1e-4:
        raise AssertionError(f"fused-softmax logits differ from flash by {err}")


class _Launches:
    """Zeroes the named kernels' launch counts on entry; ``counts`` holds
    them on exit."""

    def __init__(self, names):
        self.kernels = {n: k for n, k in kernel_counters().items()
                        if n in names}
        self.counts = {}

    def __enter__(self):
        for kern in self.kernels.values():
            kern.launches = 0
        return self

    def __exit__(self, *exc):
        self.counts = {n: k.launches for n, k in self.kernels.items()}


def cached_decode_gate(torch, model, dev, label: str) -> float:
    """The dense-cache decode, step by step over DECODE_GATE_LEN tokens of
    two rows, against one dense forward: f32 logits within 1e-3."""
    import numpy as np

    tok = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, MODEL["n_vocab"], (2, DECODE_GATE_LEN))).to(dev)
    with torch.inference_mode():
        dense = model(tok)
        caches = model.init_cache(2, DECODE_GATE_LEN)
        steps = torch.arange(DECODE_GATE_LEN, device=dev)
        err = torch.zeros((), device=dev)
        for i in range(DECODE_GATE_LEN):
            logits, caches = model.forward_decode(tok[:, i:i + 1], caches,
                                                  steps[i])
            err = torch.maximum(err, (logits[:, 0] - dense[:, i]).abs().max())
    err = float(err)
    log(f"[{label}] f32 cached decode vs dense forward over "
        f"{DECODE_GATE_LEN} positions, B2: max_abs_err={err:.3e}")
    if not err <= 1e-3:
        raise AssertionError(f"{label}: cached decode differs by {err}")
    return err


def _gen_inputs(torch, dev):
    """GEN_PROMPTS' prompts from default_rng: (list of prompts, padded (B,
    max) ids on the card, lengths on the card)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 8)
    prompts = [rng.integers(0, MODEL["n_vocab"], n).tolist()
               for n in GEN_PROMPTS]
    buf = np.zeros((len(prompts), max(GEN_PROMPTS)), np.int64)
    for r, p in enumerate(prompts):
        buf[r, :len(p)] = p
    return (prompts, torch.from_numpy(buf).to(dev),
            torch.tensor(GEN_PROMPTS, device=dev))


def _joint_logprob(torch, model, row, p: int) -> float:
    """Log-probability of ``row``'s tokens after its first ``p`` under one
    dense forward."""
    with torch.inference_mode():
        logp = torch.log_softmax(model(row[None])[0].float(), -1)
    idx = torch.arange(p - 1, row.shape[0] - 1, device=row.device)
    return float(logp[idx, row[idx + 1]].sum())


def generate_phase(torch, model_f32, dev) -> dict:
    """Batched generation over the dense KV cache on the serving model:
    the f32 cached decode against the dense forward; greedy_generate on
    eight ragged prompts token-identical to the engine's greedy tokens;
    beam 1 equal to greedy; beam 4's hypotheses scoring at least greedy's;
    then bf16 new tok/s of greedy (B8) and beam 4 (B2)."""
    from flashattn_tpu_torch import ContinuousBatchingEngine
    from flashattn_tpu_torch.training.generate import (
        beam_search_generate,
        greedy_generate,
    )

    cached_decode_gate(torch, model_f32, dev, "generate")
    prompts, buf, plen = _gen_inputs(torch, dev)
    never = MODEL["n_vocab"] + 5           # an eos no row can emit
    with _Launches(("layernorm_fwd",)) as run:
        greedy = greedy_generate(model_f32, buf, plen, GEN_NEW_TOKENS)
    assert run.counts["layernorm_fwd"] > 0, "layernorm_fwd did not launch"
    eng = ContinuousBatchingEngine(model_f32, max_batch=len(prompts),
                                   page_size=128, pages_per_seq=3)
    reqs = [eng.submit(p, GEN_NEW_TOKENS) for p in prompts]
    eng.run()
    rows = greedy.cpu().tolist()
    same = sum(r.generated == rows[i][n:n + GEN_NEW_TOKENS]
               for i, (r, n) in enumerate(zip(reqs, GEN_PROMPTS)))
    beam1 = beam_search_generate(model_f32, buf, plen, GEN_NEW_TOKENS, 1,
                                 never)
    b, bp = buf[:BEAM_ROWS], plen[:BEAM_ROWS]
    beam4 = beam_search_generate(model_f32, b, bp, GEN_NEW_TOKENS, BEAM,
                                 never, length_penalty=0.0)
    g2 = greedy_generate(model_f32, b, bp, GEN_NEW_TOKENS)
    scores = [(_joint_logprob(torch, model_f32, beam4[r], GEN_PROMPTS[r]),
               _joint_logprob(torch, model_f32, g2[r], GEN_PROMPTS[r]))
              for r in range(BEAM_ROWS)]
    log(f"[generate] f32 B{len(prompts)} prompts {list(GEN_PROMPTS)}, "
        f"{GEN_NEW_TOKENS} new tokens: greedy_generate token-identical to "
        f"the engine on {same}/{len(prompts)} requests; beam 1 equals "
        f"greedy: {bool(torch.equal(beam1, greedy))}; beam {BEAM} vs greedy "
        f"joint log-prob (lp 0) by row {[tuple(round(x, 4) for x in sc) for sc in scores]}; "
        f"layernorm_fwd launches {run.counts['layernorm_fwd']}")
    if same != len(prompts):
        raise AssertionError("greedy_generate differs from the engine")
    if not torch.equal(beam1, greedy):
        raise AssertionError("beam 1 differs from greedy")
    for r, (sb, sg) in enumerate(scores):
        if not sb >= sg - 1e-4:
            raise AssertionError(f"beam {BEAM} row {r} scores {sb} < greedy {sg}")

    model = copy.deepcopy(model_f32).to(torch.bfloat16)
    rates, launches = {}, {}
    for label, fn, new in (
            ("greedy B8", lambda: greedy_generate(model, buf, plen,
                                                  GEN_NEW_TOKENS),
             int((buf.shape[1] + GEN_NEW_TOKENS - plen).sum())),
            (f"beam {BEAM} B{BEAM_ROWS}", lambda: beam_search_generate(
                model, b, bp, GEN_NEW_TOKENS, BEAM, never),
             int((buf.shape[1] + GEN_NEW_TOKENS - bp).sum()))):
        fn()                                          # warm-up
        with _Launches(SERVE_KERNELS) as run:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        steps = buf.shape[1] + GEN_NEW_TOKENS - 1
        rates[label] = new / dt
        for n, c in run.counts.items():
            launches[n] = launches.get(n, 0) + c
        log(f"[generate] bf16 {label}: {new} new tokens ({steps} decode "
            f"steps, f32 cache) in {dt * 1e3:.1f} ms: {new / dt:.1f} new "
            f"tok/s, {dt * 1e3 / steps:.2f} ms a step; launches {run.counts}")
    profile_step(torch, lambda: greedy_generate(model, buf[:, :1], 1, 8),
                 "generate bf16 greedy B8, 8 decode steps")
    del model
    return dict(rates=rates, launches=launches)


def serve_rope_phase(torch, dev) -> dict:
    """The serving model with rotary positions: f32 engine logits and the
    cached decode against the dense forward, the bf16 serve traffic, then
    the RoPE + MoE model's f32 engine logits against its dense forward."""
    from flashattn_tpu_torch import DecoderLM

    model = DecoderLM(**ROPE_MODEL, device=dev,
                      generator=torch.Generator().manual_seed(SEED)).eval()
    consistency_phase(torch, model, dev, "serve_rope")
    cached_decode_gate(torch, model, dev, "serve_rope")
    out = serve_phase(torch, copy.deepcopy(model).to(torch.bfloat16), dev,
                      "serve_rope")
    del model
    moe = DecoderLM(**ROPE_MOE_MODEL, device=dev,
                    generator=torch.Generator().manual_seed(SEED)).eval()
    with _Launches(SERVE_KERNELS + ("paged_attention_f32",)) as run:
        consistency_phase(torch, moe, dev, "serve_rope_moe")
    log(f"[serve_rope_moe] launches {run.counts}")
    cached_decode_gate(torch, moe, dev, "serve_rope_moe")
    out["launches"] = {n: out["launches"].get(n, 0) + run.counts[n]
                       for n in run.counts}
    return out


def adafactor_consistency_phase(torch, dev) -> None:
    """Three Adafactor train steps (lm_loss, clip 1.0) of the consistency
    model on the card and on a CPU copy, f32: every parameter within 1e-5
    relative L2 after steps 1 and 3 but the key-projection bias, whose
    exact gradient is 0 and whose update, Adafactor's normalised rounding
    noise on either device, is logged instead."""
    import numpy as np

    import flashattn_tpu_torch as pt

    tok = np.random.default_rng(SEED + 9).integers(0, CONSIST["n_vocab"],
                                                   (2, 1024))
    card = pt.DecoderLM(**CONSIST, p_dropout=0.0, device=dev,
                        generator=torch.Generator().manual_seed(SEED)).train()
    host = copy.deepcopy(card).to("cpu")
    runs = []
    for m in (card, host):
        d = next(m.parameters()).device
        tokens = torch.from_numpy(tok).to(d)
        opt = pt.Adafactor()
        step, state = pt.make_train_step(opt, grad_clip=1.0), opt.init(m)
        snaps = []
        for i in range(3):
            m, state, _ = step(m, state, tokens, torch.roll(tokens, -1, 1))
            if i in (0, 2):
                snaps.append({n: p.detach().cpu().clone()
                              for n, p in m.named_parameters()})
        runs.append(snaps)
    for i, (c, h) in zip((1, 3), zip(*runs)):
        err = {n: _rel(c[n], h[n]) for n in h
               if not n.endswith("k_projection.bias")}
        worst = max(err, key=err.get)
        kb = max(_rel(c[n], h[n]) for n in h if n.endswith("k_projection.bias"))
        log(f"[adafactor-consistency] f32 E1024 L2 B2 S1024 after step {i}: "
            f"max param rel-L2 err {err[worst]:.2e} ({worst}); key bias "
            f"(zero gradient) {kb:.2e}")
        if not err[worst] <= 1e-5:
            raise AssertionError(f"Adafactor step {i}: {worst} differs by "
                                 f"{err[worst]}")


def distill_phase(torch, model_f32, dev) -> dict:
    """DISTILL_STEPS steps of make_train_scan(Adam, make_distill_loss())
    with the bf16 serving model as the ctx teacher of serve_features' draft
    (B16 x 128 tokens from default_rng(0)); the KL must fall.  Then the
    draft-model mode of serve_features with the untrained and the
    distilled draft: acceptance and new tok/s side by side."""
    import numpy as np

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.ops import flash_attention as fa

    teacher = copy.deepcopy(model_f32).to(torch.bfloat16).eval()
    draft = pt.DecoderLM(**FEAT_DRAFT, device=dev,
                         generator=torch.Generator().manual_seed(SEED + 3))
    untrained = copy.deepcopy(draft).eval()
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, MODEL["n_vocab"], (DISTILL_STEPS, DISTILL_BATCH, DISTILL_SEQ + 1)
    )).to(dev)
    opt = pt.Adam(1e-3)
    state = opt.init(draft)
    scan = pt.make_train_scan(opt, pt.make_distill_loss(), grad_clip=1.0)
    # the f32 draft's attention at DISTILL_SEQ keys (the warp-level kernels)
    f32 = _f32_suffix(DISTILL_SEQ)
    draft_flash = ("flash_fwd" + f32, "flash_bwd" + f32)
    with _Launches(TRAIN_KERNELS + draft_flash) as run:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draft, state, losses = scan(draft.train(), state, tok[..., :-1],
                                    tok[..., 1:], None, None, ctx=teacher)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    losses = losses.tolist()
    head, tail = np.mean(losses[:20]), np.mean(losses[-20:])
    log(f"[distill] {DISTILL_STEPS} steps, B{DISTILL_BATCH} x {DISTILL_SEQ}, "
        f"teacher bf16 E1024 L4, draft f32 E128 L1: KL first 20 mean "
        f"{head:.4f}, last 20 mean {tail:.4f} (every {DISTILL_STEPS // 4}th "
        f"loss: {[round(x, 4) for x in losses[::DISTILL_STEPS // 4]]}); "
        f"{dt * 1e3 / DISTILL_STEPS:.2f} ms a step; launches {run.counts}")
    if not (all(math.isfinite(x) for x in losses) and tail < head):
        raise AssertionError(f"the distillation KL did not fall: {head} -> {tail}")
    for kern in ("layernorm_fwd", "layernorm_bwd") + draft_flash:
        assert run.counts[kern] > 0, f"{kern} did not launch in distill"
    reqs = [(p, {}) for p in _feature_prompts()]
    eng_kw = dict(FEAT_ENGINE, spec_len=4)
    out = {}
    for label, d in (("untrained", untrained), ("distilled", draft.eval())):
        d = copy.deepcopy(d).to(torch.bfloat16)
        warm = pt.ContinuousBatchingEngine(teacher, dtype=torch.bfloat16,
                                           draft_model=d, **eng_kw)
        for p, _ in reqs[:2]:
            warm.submit(p, 16)
        warm.run()
        done, res = _feature_run(torch, teacher, torch.bfloat16,
                                 dict(eng_kw, draft_model=d), reqs)
        new = sum(len(r.generated) for r in done)
        out[label] = dict(acceptance=res["stats"]["spec_acceptance"],
                          tok_s=new / res["seconds"])
    log(f"[distill] serve_features draft k=4 (bf16): acceptance untrained "
        f"{out['untrained']['acceptance']:.3f} / distilled "
        f"{out['distilled']['acceptance']:.3f} a wave; new tok/s "
        f"{out['untrained']['tok_s']:.1f} / {out['distilled']['tok_s']:.1f}")
    return dict(out, launches=run.counts)


class _WordTokenizer:
    """A word-level stand-in for the MT app's byte-level BPE tokenizer
    (the card's machine may lack ``tokenizers`` and ``transformers``): the
    app's three specials, ``<unk>``, then the train split's words in order
    of first appearance, within the app's 10000 ids.  It has what the
    port's collate and generation use: ``__call__(text)["input_ids"]``,
    ``.vocab`` and ``.decode``; it is no part of the port."""

    def __init__(self, examples, size: int):
        self.vocab = {"<eos_de>": 0, "<eos_en>": 1, "<pad>": 2, "<unk>": 3}
        for ex in examples:
            for w in f"{ex['de']} {ex['en']}".split():
                if w not in self.vocab and len(self.vocab) < size:
                    self.vocab[w] = len(self.vocab)
        self._words = {i: w for w, i in self.vocab.items()}

    def __call__(self, text: str) -> dict:
        words = text.replace("<eos_", " <eos_").split()
        return {"input_ids": [self.vocab.get(w, 3) for w in words]}

    def decode(self, ids) -> str:
        return " ".join(self._words.get(i, "<unk>") for i in ids)


def mt_data():
    """(splits of the vendored de-en corpus as the app makes them, the
    word-level tokenizer over its train split)."""
    from flashattn_tpu_torch.training import translation as tr

    dataset, _, _ = tr.get_dataset("deen-fixture", MT_LEN, seed=MT_SEED)
    return dataset, _WordTokenizer(dataset["train"], MT["n_vocab"])


def _mt_batches(data, n: int, batch: Optional[int] = None):
    """``n`` batches (of MT_BATCH rows unless ``batch`` says) of the train
    split, shuffled from SEED, by the port's collate_batch_seq2seq."""
    import random

    from flashattn_tpu_torch.training import translation as tr

    dataset, tok = data
    batch = batch or MT_BATCH
    ex = list(dataset["train"])
    random.Random(SEED).shuffle(ex)
    return [tr.collate_batch_seq2seq(ex[i * batch:(i + 1) * batch], "de",
                                     "en", tok, MT_LEN) for i in range(n)]


def seq2seq_train_phase(torch, dev, power: str, data, mixed: bool = False,
                        remat: bool = False) -> dict:
    """MT_STEPS steps of the MT model at full width and depth through the
    app's _dispatch_chunk / make_train_scan (Adam under the app's schedule,
    clip 1.0, 8 steps a dispatch) over collated fixture batches: losses
    finite and falling, every MT kernel launched; ms/step, tokens/s, the
    peak, and one profiled dispatch."""
    import numpy as np

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.training import translation as tr

    name = "seq2seq_train" + ("_mixed_remat" if mixed else "")
    model = pt.EncoderDecoderLM(**MT, remat=remat, device=dev,
                                generator=torch.Generator().manual_seed(SEED)
                                ).train()
    total = MT_SAMPLES // MT_BATCH
    opt = pt.Adam(lr=pt.warmup_cosine(MT_LR, max(10, total // 20), total))
    state = opt.init(model)
    loss_fn = (pt.make_mixed_precision_loss(tr.seq2seq_loss) if mixed
               else tr.seq2seq_loss)
    scan = pt.make_train_scan(opt, loss_fn, grad_clip=1.0)
    batches = _mt_batches(data, MT_STEPS)
    gen = torch.Generator().manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, n_tok = [], [], 0
    f32 = "" if mixed else _f32_suffix(MT_LEN)
    with _Launches(_suffixed(MT_KERNELS, f32)) as run:
        for i in range(0, MT_STEPS, MT_SPD):
            t0 = time.perf_counter()
            model, state, gen, chunk, n = tr._dispatch_chunk(
                model, state, scan, batches[i:i + MT_SPD], gen)
            times.append(time.perf_counter() - t0)    # the losses synced
            losses.extend(chunk.tolist())
            n_tok = n
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times[1:]) * 1e3 / MT_SPD
    tok_s = n_tok / (statistics.median(times[1:]))
    head, tail = np.mean(losses[:MT_SPD]), np.mean(losses[-MT_SPD:])
    log(f"[{name}] {power} {'bf16-mixed' if mixed else 'f32'} "
        f"{'remat ' if remat else ''}E256 H8x32 L4+4 V10000 B{MT_BATCH} "
        f"S{MT_LEN} p0.1, {MT_STEPS} steps in dispatches of {MT_SPD}: loss "
        f"first {MT_SPD} mean {head:.4f}, last {MT_SPD} mean {tail:.4f} "
        f"(every 8th: {[round(x, 4) for x in losses[::8]]})")
    log(f"[{name}] dispatch s {[round(t, 3) for t in times]}; median of the "
        f"last {len(times) - 1}: {ms:.2f} ms/step, {tok_s:.1f} tokens/s "
        f"(source + target, padding included); max_memory_allocated "
        f"{peak / 2**30:.3f} GiB; launches over the {MT_STEPS} steps "
        f"{run.counts}")
    profile_step(torch, lambda: tr._dispatch_chunk(
        model, state, scan, batches[:MT_SPD], gen), f"{name} dispatch "
        f"({MT_SPD} steps)")
    if not (all(math.isfinite(x) for x in losses) and tail < head):
        raise AssertionError(f"{name}: the loss did not fall: {head} -> {tail}")
    for kern, n in run.counts.items():
        if n <= 0:
            raise AssertionError(f"{kern} not launched in {name}")
    return dict(model=model, ms=ms, tok_s=tok_s, peak=peak,
                launches=run.counts)


def seq2seq_consistency_phase(torch, dev, data) -> None:
    """One seq2seq_loss backward of the MT model on the card against the
    same on a CPU copy, f32, p 0 and p 0.1 from one generator seed (the
    same Philox masks): _backward_gates."""
    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.training import translation as tr

    batch = _mt_batches(data, 1, MT_CONSIST_BATCH)[0]
    for p in (0.0, 0.1):
        card = pt.EncoderDecoderLM(**dict(MT, p_dropout=p), device=dev,
                                   generator=torch.Generator().manual_seed(
                                       SEED)).train()
        host = copy.deepcopy(card).to("cpu")
        out = []
        for m in (card, host):
            d = next(m.parameters()).device
            to = lambda name: torch.from_numpy(batch[name]).to(d)
            inputs = {"src": to("src"), "src_lens": to("src_lens"),
                      "tgt_in": to("input_ids")}
            gen = torch.Generator().manual_seed(SEED + 3) if p else None
            loss = tr.seq2seq_loss(m, inputs, to("labels"),
                                   to("label_token_weights"), gen)
            names, params = zip(*m.named_parameters())
            grads = torch.autograd.grad(loss, params)
            out.append((loss.detach().cpu(), {n: g.cpu() for n, g in
                                              zip(names, grads)}))
        _backward_gates("seq2seq-consistency", f"f32 MT E256 L4+4 "
                        f"B{MT_CONSIST_BATCH} S{MT_LEN} p{p}", out)
        del card, host, out


def _mt_sources(torch, dev, data, batch: int = MT_GEN_BATCH):
    """The first ``batch`` test sources, padded as generate_seq2seq pads
    them: (ids (B, 40), lengths (B,)) on the card."""
    dataset, tok = data
    buf = torch.full((batch, MT_LEN), tok.vocab["<pad>"], dtype=torch.long)
    lens = []
    for r, ex in enumerate(dataset["test"][:batch]):
        ids = tok(f"{ex['de']}<eos_de>")["input_ids"][:MT_LEN]
        buf[r, :len(ids)] = torch.tensor(ids)
        lens.append(len(ids))
    return buf.to(dev), torch.tensor(lens, device=dev)


def seq2seq_generate_phase(torch, dev, model, data) -> dict:
    """greedy_generate_seq2seq on the trained f32 MT model at the app's
    batch of 32 test sources and 40 new tokens.  Gates: the tokens equal a
    no-cache greedy loop over the full forward; the cached decode's logits
    along them within 1e-3 of the teacher-forced forward.  Then new tok/s
    (B x 40 positions over the loop's wall time) and a profiled call."""
    from flashattn_tpu_torch.training.generate import greedy_generate_seq2seq

    _, tok = data
    src, lens = _mt_sources(torch, dev, data)
    bos, eos = tok.vocab["<eos_de>"], tok.vocab["<eos_en>"]
    model.eval()
    with _Launches(_suffixed(MG_KERNELS, _f32_suffix(MT_LEN))) as run:
        out = greedy_generate_seq2seq(model, src, lens, MT_LEN, bos, eos)
    with torch.inference_mode():
        tgt = torch.full((src.shape[0], 1), bos, device=dev)
        done = torch.zeros(src.shape[0], dtype=torch.bool, device=dev)
        for _ in range(MT_LEN):
            nxt = model(src, tgt, lens)[:, -1].argmax(-1)
            nxt = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
            tgt = torch.cat([tgt, nxt[:, None]], 1)
        forced = model(src, tgt[:, :-1], lens)
        mem = model.encode(src, lens)
        cross, caches = model.precompute_cross(mem), model.init_cache(
            src.shape[0], MT_LEN)
        steps = torch.arange(MT_LEN, device=dev)
        err = torch.zeros((), device=dev)
        for i in range(MT_LEN):
            logits, caches = model.forward_decode(tgt[:, i:i + 1], caches,
                                                  cross, steps[i], lens)
            err = torch.maximum(err, (logits[:, 0] - forced[:, i]).abs().max())
    same = int((out == tgt[:, 1:]).all(1).sum())
    err = float(err)
    ended = int((out == eos).any(1).sum())
    log(f"[seq2seq_generate] f32 B{src.shape[0]} {MT_LEN} new tokens: "
        f"token-identical to the no-cache greedy loop on {same}/"
        f"{src.shape[0]} rows; cached decode vs teacher-forced logits "
        f"max_abs_err={err:.3e}; {ended} rows emitted eos; launches "
        f"{run.counts}; first row: {tok.decode(out[0].tolist())!r}")
    if same != src.shape[0]:
        raise AssertionError("greedy_generate_seq2seq differs from the "
                             "no-cache greedy loop")
    if not err <= 1e-3:
        raise AssertionError(f"cached decode differs by {err}")
    for kern, n in run.counts.items():
        if n <= 0:
            raise AssertionError(f"{kern} not launched in seq2seq_generate")
    fn = lambda: greedy_generate_seq2seq(model, src, lens, MT_LEN, bos, eos)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = src.shape[0] * MT_LEN / dt
    log(f"[seq2seq_generate] f32 B{src.shape[0]}: {src.shape[0] * MT_LEN} "
        f"positions in {dt * 1e3:.1f} ms: {rate:.1f} new tok/s, "
        f"{dt * 1e3 / MT_LEN:.2f} ms a step (one encode, one cross "
        f"projection, {MT_LEN} cached steps)")
    profile_step(torch, fn, f"seq2seq_generate f32 B{src.shape[0]}, "
                 f"{MT_LEN} steps")
    return dict(rate=rate, launches=run.counts)


def mt_app_phase(torch) -> Optional[dict]:
    """The MT app's run() for one short epoch of each arch on the vendored
    corpus at its defaults (seq2seq; decoder-only with the engine), where
    tokenizers, transformers, sacrebleu and tqdm all import; otherwise one
    line naming the missing ones.  Any error inside run() fails the
    script."""
    import importlib.util
    import shutil

    missing = [m for m in MT_APP_PACKAGES if importlib.util.find_spec(m) is None]
    if missing:
        log(f"[mt_app] not run: {', '.join(missing)} does not import "
            f"(run() needs {', '.join(MT_APP_PACKAGES)}); the app's "
            f"model, collate, loss, scan dispatch and generation ran in "
            f"seq2seq_train and seq2seq_generate")
        return None
    from flashattn_tpu_torch.training import translation as tr

    root = REPO / "workdir_mt_app"
    out = {}
    try:
        for arch, extra in (("seq2seq", {}),
                            ("decoder_only", dict(decode="engine"))):
            cfg = tr.MTConfig(arch=arch, dataset_name="deen-fixture",
                              samples_per_epoch=MT_APP_SAMPLES,
                              workdir=str(root / arch), device="cuda",
                              **extra)
            t0 = time.perf_counter()
            out[arch] = tr.run(cfg)
            log(f"[mt_app] {arch} {extra}: {json.dumps(out[arch])} in "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# the JAX tests' classifier calls (tests/test_neural_network.py) and their
# accuracy gates
CLASSIFIER_RUNS = ((("Xor", 60, 12, 0.5, 600, 0), 0.85),
                   (("Simple", 60, 6, 0.5, 250, 3), 0.95))


def utilities_phase(torch, dev) -> None:
    """A6d on the card: f32 conv against the CPU (1e-5) and its grad_check;
    the toy classifier's accuracy at the JAX tests' gates and its final
    loss within 1e-4 relative of the same call on the CPU, ms an epoch;
    KernelBench over the LayerNorm kernel against layernorm_reference at
    bf16 (16384, 2048), its device_loop_time within 1.5x of time_ms of the
    same call; checkify_errors raising on a CUDA NaN with the context still
    usable; find_nonfinite over a CUDA model."""
    import numpy as np

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.autodiff import grad_check
    from flashattn_tpu_torch.ops.conv import conv1d, conv2d
    from flashattn_tpu_torch.training import classifier as tc
    from flashattn_tpu_torch.utils import (KernelBench, assert_finite,
                                           checkify_errors, datasets,
                                           find_nonfinite)

    g = torch.Generator().manual_seed(SEED)
    for name, fn, xs, ws in (("conv1d", conv1d, (8, 16, 512), (32, 16, 5)),
                             ("conv2d", conv2d, (4, 8, 64, 64), (16, 8, 3, 3))):
        x, w = torch.randn(xs, generator=g), torch.randn(ws, generator=g)
        err = _abs_err(fn(x.to(dev), w.to(dev)).cpu(), fn(x, w))
        log(f"[utilities] {name} f32 {xs} x {ws}: card vs CPU max_abs_err "
            f"{err:.3e} {'ok' if err <= 1e-5 else 'FAIL'}")
        if err > 1e-5:
            raise AssertionError(f"{name}: card vs CPU {err}")
    grad_check(conv1d, torch.randn((2, 3, 9), generator=g).to(dev),
               torch.randn((4, 3, 3), generator=g).to(dev), n_samples=10,
               tol=2e-2, epsilon=1e-3)
    log("[utilities] grad_check(conv1d) on the card: ok")

    for args, gate in CLASSIFIER_RUNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, acc = tc.train_classifier(*args, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / args[4]
        cpu_model, acc_cpu = tc.train_classifier(*args, device="cpu")
        graph = datasets.datasets[args[0]](args[1], seed=args[5])
        X = torch.tensor(np.asarray(graph.X, np.float32))
        y = torch.tensor(np.asarray(graph.y, np.float32))
        with torch.no_grad():
            loss = tc.binary_nll(model(X.to(dev)), y.to(dev)).item()
            loss_cpu = tc.binary_nll(cpu_model(X), y).item()
        rel = abs(loss - loss_cpu) / abs(loss_cpu)
        ok = acc >= gate and rel <= 1e-4
        log(f"[utilities] train_classifier{args} on the card: accuracy "
            f"{acc:.4f} (gate {gate}; CPU {acc_cpu:.4f}), final loss {loss:.6f} "
            f"(CPU {loss_cpu:.6f}, rel {rel:.2e}), {ms:.3f} ms an epoch "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train_classifier{args}: {acc} / {rel}")
        bad = find_nonfinite(model)
        with torch.no_grad():
            model.layer2.bias[3] = math.nan
        found = find_nonfinite({"net": model})
        log(f"[utilities] find_nonfinite over the card model: {bad} before, "
            f"{found} after a NaN")
        if bad or found != {"net.layer2.bias": {"nan": 1, "inf": 0}}:
            raise AssertionError(f"find_nonfinite: {bad} / {found}")

    bf = torch.bfloat16
    x = torch.randn((16384, 2048), generator=g).to(dev, bf)
    gam, bet = (torch.randn(2048, generator=g).to(dev, bf) for _ in range(2))
    kt = KernelBench(rtol=2e-2, atol=2e-2, ntest=1, iters=20)

    @kt.case(name="layernorm")
    def _ln_case(kt):
        return (lambda a, w, b: pt.layernorm(a, w, b),
                lambda a, w, b: pt.layernorm_reference(a, w, b), (x, gam, bet))

    (res,) = kt.run("layernorm")
    ms = time_ms(lambda: pt.layernorm(x, gam, bet))
    ratio = res.custom_ms / ms
    ok = 1 / 1.5 <= ratio <= 1.5
    log(f"[utilities] KernelBench layernorm bf16 (16384, 2048): "
        f"device_loop_time {res.custom_ms:.4f} ms, time_ms {ms:.4f} ms "
        f"(ratio {ratio:.3f}), layernorm_reference {res.baseline_ms:.4f} ms, "
        f"max_err {res.max_err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"device_loop_time vs time_ms: {ratio}")

    @checkify_errors
    def logs(t):
        return torch.log(assert_finite(t, "input")) + assert_finite(
            torch.log(t), "log")

    logs(torch.ones(4, device=dev))
    try:
        logs(torch.tensor([-1.0, 2.0], device=dev))
    except FloatingPointError as e:
        raised = str(e)
    else:
        raise AssertionError("checkify_errors did not raise on a CUDA NaN")
    after = float((torch.ones(8, device=dev) * 2).sum())
    log(f"[utilities] checkify_errors on a CUDA NaN raised {raised!r}; the "
        f"next CUDA op gives {after}")
    if raised != "log contains NaN/Inf" or after != 16.0:
        raise AssertionError(f"checkify_errors: {raised!r} / {after}")


# -- parallel (A7): the sharded entry points on a one-rank NCCL group ---------

RING_SHAPE = (4, 16, 2048, 128)   # B H N d: the train phase's flash shape
RING_WORLD = 4                    # 512-key shards: the op graph's forward
PARALLEL_STEPS = 3
PIPE_BATCH, PIPE_SEQ, PIPE_MB = 8, 1024, 4

def _engine_run(torch, model, prompts, mesh, collect: bool):
    """Serve ``prompts`` (NEW_TOKENS each) through a fresh engine; returns
    the requests and the decode steps' new tok/s (steps that admit
    nothing, as serve_phase counts them)."""
    from flashattn_tpu_torch import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, dtype=torch.bfloat16, mesh=mesh,
                                   collect_logits=collect, **ENGINE)
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    decode_s, decode_tok = 0.0, 0
    torch.cuda.synchronize()
    while True:
        queued = {id(r) for r in eng.queue}
        gen_before = sum(len(r.generated) for r in reqs)
        t0 = time.perf_counter()
        progressed = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not progressed:
            break
        if not any(id(r) in queued and r not in eng.queue for r in reqs):
            decode_s += dt
            decode_tok += sum(len(r.generated) for r in reqs) - gen_before
    assert eng.pool.n_free == eng.pool.total, "pages leaked"
    for r in reqs:
        assert r.done and len(r.generated) == NEW_TOKENS, r.uid
    return reqs, decode_tok / decode_s


def _tp_engine_check(torch, model, label: str, power: str, mesh,
                     kernels) -> dict:
    """The TP engine (mesh=) against the plain engine on the same model and
    serve's requests: tokens identical, logits within 1e-3; decode tok/s of
    both (no logits collected); the kernels of ``kernels`` launched in the
    TP run."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, MODEL["n_vocab"], n).tolist() for n in PROMPTS]
    counters = {n: k for n, k in kernel_counters().items() if n in kernels}
    plain, _ = _engine_run(torch, model, prompts, None, True)
    for kern in counters.values():
        kern.launches = 0
    tp, _ = _engine_run(torch, model, prompts, mesh, True)
    launches = {n: k.launches for n, k in counters.items()}
    err = 0.0
    for a, b in zip(plain, tp):
        if a.generated != b.generated:
            raise AssertionError(f"[{label}] TP engine tokens differ: "
                                 f"{a.generated} vs {b.generated}")
        err = max(err, float(np.abs(np.stack(a.logits).astype(np.float32)
                                    - np.stack(b.logits).astype(np.float32)
                                    ).max()))
    rates = {}
    for name, m in (("plain", None), ("tp", mesh), ("plain again", None),
                    ("tp again", mesh)):
        _, rates[name] = _engine_run(torch, model, prompts, m, False)
    log(f"[{label}] {power} TP engine (mesh (1,) model) vs plain: tokens "
        f"identical over {len(prompts)} requests, logits max_abs_err="
        f"{err:.3e}; decode new tok/s " + ", ".join(
            f"{n} {r:.1f}" for n, r in rates.items())
        + f"; launches in the TP run {launches}")
    if not err <= 1e-3:
        raise AssertionError(f"[{label}] TP logits differ by {err}")
    for name, n in launches.items():
        if not n > 0:
            raise AssertionError(f"[{label}] {name} not launched")
    return dict(launches=launches, rates=rates, err=err)


def _train_runs(torch, dev, mesh, power: str) -> dict:
    """make_train_step and ShardedTrainer (plain TP, then zero=True) on the
    train configuration, PARALLEL_STEPS steps each from the same weights
    and generator seed: losses and parameters equal within 1e-5
    relative; ms/step of each; the training kernels launched in each
    sharded run."""
    import numpy as np

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.parallel import unshard
    from flashattn_tpu_torch.training import ShardedTrainer

    tok = np.random.default_rng(SEED).integers(
        0, TRAIN["n_vocab"], (TRAIN_BATCH, TRAIN_SEQ))
    tokens = torch.from_numpy(tok).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, device=dev)
    loss_fn = pt.make_mixed_precision_loss(pt.lm_loss)
    counters = {n: k for n, k in kernel_counters().items()
                if n in TRAIN_KERNELS}
    out = {}
    for kind in ("make_train_step", "ShardedTrainer", "ShardedTrainer zero"):
        model = pt.DecoderLM(**TRAIN,
                             generator=torch.Generator().manual_seed(SEED),
                             device=dev).train()
        gen = torch.Generator().manual_seed(SEED)
        opt = pt.Adam(lr=1e-4)
        if kind == "make_train_step":
            state = opt.init(model)
            step = pt.make_train_step(opt, loss_fn, grad_clip=1.0)

            def run():
                nonlocal model, state
                model, state, loss = step(model, state, tokens, targets,
                                          mask, gen)
                return loss
        else:
            trainer = ShardedTrainer(model, opt, mesh, loss_fn=loss_fn,
                                     zero=kind.endswith("zero"),
                                     grad_clip=1.0)
            del model

            def run():
                return trainer.step(tokens, targets, mask, gen)
        losses, times = [], []
        for kern in counters.values():
            kern.launches = 0
        for _ in range(PARALLEL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(run()))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        final = (dict(model.named_parameters()) if kind == "make_train_step"
                 else {n: unshard(p, mesh, p.spec) for n, p in
                       trainer.model.named_parameters()})
        out[kind] = dict(losses=losses, ms=times,
                         params={n: p.detach().float().cpu()
                                 for n, p in final.items()},
                         launches={n: k.launches for n, k in counters.items()})
        del final, run
        if kind != "make_train_step":
            del trainer
        torch.cuda.empty_cache()
    ref = out["make_train_step"]
    for kind in ("ShardedTrainer", "ShardedTrainer zero"):
        got = out[kind]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(got["losses"], ref["losses"]))
        param_rel = max(float((got["params"][n] - p).norm()
                              / max(float(p.norm()), 1e-30))
                        for n, p in ref["params"].items())
        log(f"[parallel] {power} {kind} (mesh (1, 1) data x model) vs "
            f"make_train_step, train config bf16-mixed p0.1 clip 1.0, "
            f"{PARALLEL_STEPS} steps: losses {got['losses']} vs "
            f"{ref['losses']} (max rel {loss_rel:.2e}), parameters max rel "
            f"L2 {param_rel:.2e}; ms/step {[round(t, 1) for t in got['ms']]}"
            f" vs {[round(t, 1) for t in ref['ms']]}; launches "
            f"{got['launches']}")
        if not (loss_rel <= 1e-5 and param_rel <= 1e-5):
            raise AssertionError(f"{kind} differs from make_train_step")
        for name, n in got["launches"].items():
            if not n > 0:
                raise AssertionError(f"{kind}: {name} not launched")
    return {k: dict(launches=v["launches"]) for k, v in out.items()
            if k != "make_train_step"}


def _ring_pair_times(torch, q, k, v, do, causal) -> dict:
    """Device ms of one ring step's pieces at the shard length: the forward
    pair (the op graph below 1024 keys), the backward pair (the grid
    function, flash_bwd grid=True; the op graph's autodiff, SDPA's
    backward and the bound beside it) and one merge."""
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.parallel.sharded_attention import _merge_partials

    n = RING_SHAPE[2] // RING_WORLD
    qs, ks, vs, ds = (t[:, :, :n] for t in (q, k, v, do))
    sc = RING_SHAPE[3] ** -0.5
    o, lse = fa.flash_attention_with_lse(qs, ks, vs, causal)
    di = (o.float() * ds.float()).sum(-1, keepdim=True)
    of = o.float()
    return {
        "forward": round(time_ms(lambda: fa.flash_attention_with_lse(
            qs, ks, vs, causal)), 4),
        "backward grid": round(time_ms(lambda: fa.flash_bwd(
            qs, ks, vs, lse, di, ds, causal=causal, sm_scale=sc,
            grid=True)), 4),
        "backward op graph": round(time_ms(lambda: fa.flash_bwd(
            qs, ks, vs, lse, di, ds, causal=causal, sm_scale=sc)), 4),
        "backward SDPA": round(time_ms(_sdpa_bwd(torch, qs, ks, vs, ds, causal,
                                                 None, None)), 4),
        "backward bound": round(bound_ms(*_flash_cost(
            qs, ks, causal, None, None, backward=True),
            str(q.dtype).replace("torch.", ""))[0], 4),
        "merge": round(time_ms(lambda: _merge_partials(of, lse, of, lse)), 4)}


def _ring_checks(torch, dev, power: str) -> dict:
    """ring_flash_attention on a one-rank seq axis, and the ring of
    RING_WORLD ranks in one process (its per-step functions), at
    RING_SHAPE bf16, against the unsharded flash forward and backward."""
    from flashattn_tpu_torch.ops import flash_attention as fa
    from flashattn_tpu_torch.parallel import create_mesh, ring_flash_attention
    from flashattn_tpu_torch.parallel.sharded_attention import (
        _ring_in_process)

    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = (torch.randn(RING_SHAPE, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    seq = create_mesh((1,), ("seq",))
    counters = {n: kn for n, kn in kernel_counters().items()
                if n in ("flash_fwd", "flash_bwd")}
    out = {}
    for causal in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o_ref, lse_ref = fa.flash_attention_with_lse(*leaves, causal)
        o_ref.backward(do)
        ref = (o_ref.detach(), lse_ref, *(t.grad for t in leaves))
        for kern in counters.values():
            kern.launches = 0
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o1 = ring_flash_attention(*leaves, causal, mesh=seq)
        o1.backward(do)
        launches = {n: kn.launches for n, kn in counters.items()}
        one = (o1.detach(), *(t.grad for t in leaves))
        with torch.no_grad():
            o4, lse4, *grads4 = _ring_in_process(q, k, v, do, causal,
                                                 RING_WORLD)
        errs = {}
        for name, (got, want) in {
                "world 1 o": (one[0], ref[0]),
                f"world {RING_WORLD} o": (o4, ref[0])}.items():
            errs[name] = _abs_err(got, want)
        errs[f"world {RING_WORLD} lse"] = _abs_err(lse4, ref[1])
        g1 = _grad_err(one[1:], ref[2:])
        g4 = _grad_err(tuple(grads4), ref[2:])
        t_ring = time_ms(lambda: _ring_in_process(q, k, v, do, causal,
                                                  RING_WORLD), reps=5)
        pair = _ring_pair_times(torch, q, k, v, do, causal)
        t_flash = time_ms(lambda: fa.flash_bwd(
            q, k, v, ref[1], (ref[0].float() * do.float()).sum(
                -1, keepdim=True), do, causal=causal,
            sm_scale=RING_SHAPE[3] ** -0.5), reps=5)
        log(f"[parallel] {power} ring B{RING_SHAPE[0]} H{RING_SHAPE[1]} "
            f"N{RING_SHAPE[2]} d{RING_SHAPE[3]} bf16 causal={causal}: "
            f"max_abs_err {errs}, gradients (abs, scaled) world 1 {g1}, "
            f"world {RING_WORLD} {g4}; launches on the one-rank ring "
            f"{launches}; in-process ring of {RING_WORLD} (forward + "
            f"backward) {t_ring:.3f} ms, unsharded backward alone "
            f"{t_flash:.3f} ms; one pair of {RING_SHAPE[2] // RING_WORLD} "
            f"keys, ms: {pair}")
        tol = TOL["bfloat16"]
        if not (max(errs.values()) <= tol and g1[1] <= tol and g4[1] <= tol):
            raise AssertionError(f"ring causal={causal} outside the bf16 "
                                 f"gate {tol}")
        if not all(n > 0 for n in launches.values()):
            raise AssertionError(f"ring kernels not launched: {launches}")
        out[f"causal={causal}"] = dict(launches=launches)
    return out


def _pipeline_check(torch, dev, power: str) -> dict:
    """pipeline_apply of megatron_layer_fn over a one-rank stage x model
    mesh: the serve model's layers (f32) on a PIPE_BATCH x PIPE_SEQ batch
    in PIPE_MB microbatches, forward and backward, against the layers
    applied in order."""
    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.parallel import (create_mesh, megatron_layer_fn,
                                              megatron_stage_specs,
                                              pipeline_apply, scan_stage_fn,
                                              shard_stage_params,
                                              split_layers_into_stages,
                                              stack_stage_params)

    model = pt.DecoderLM(**MODEL, generator=torch.Generator().manual_seed(SEED),
                         device=dev).eval()
    mesh = create_mesh((1, 1), ("stage", "model"))
    stacked = stack_stage_params(split_layers_into_stages(model.layers, 1))
    specs = megatron_stage_specs(model.layers[0], "stage", "model")
    local = shard_stage_params(stacked, mesh, "stage", specs)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(PIPE_BATCH, PIPE_SEQ, MODEL["n_embd"], generator=g,
                    device=dev)
    # f32 at PIPE_SEQ keys: the split-precision flash kernels
    from flashattn_tpu_torch.ops import flash_attention as fa

    f32 = _f32_suffix(PIPE_SEQ)
    counters = {n: k for n, k in kernel_counters().items()
                if n in ("layernorm_fwd", "flash_fwd" + f32, "layernorm_bwd",
                         "flash_bwd" + f32)}
    for kern in counters.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = pipeline_apply(scan_stage_fn(megatron_layer_fn(model.layers[0])),
                       local, x, mesh, n_microbatches=PIPE_MB,
                       param_specs=specs)
    (h.float() ** 2).mean().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {n: k.launches for n, k in counters.items()}
    want = x
    for layer in model.layers:
        want = layer(want)
    (want.float() ** 2).mean().backward()
    err = _abs_err(h.detach(), want.detach())
    grads = stack_stage_params(split_layers_into_stages(
        [{n: p.grad for n, p in layer.named_parameters()}
         for layer in model.layers], 1))
    g_err = max(_grad_err((local[n].grad,), (grads[n],))[1] for n in grads)
    log(f"[parallel] {power} pipeline_apply(megatron_layer_fn) over a (1, 1) "
        f"stage x model mesh, serve model f32 L{MODEL['n_layer']}, "
        f"B{PIPE_BATCH} x {PIPE_SEQ} in {PIPE_MB} microbatches: forward "
        f"max_abs_err {err:.3e}, gradients (scaled) {g_err:.3e}; forward + "
        f"backward {ms:.1f} ms; launches {launches}")
    if not (err <= TOL["float32"] and g_err <= TOL["float32"]):
        raise AssertionError("pipeline differs from the layers in order")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"pipeline kernels not launched: {launches}")
    return dict(launches=launches)


def parallel_phase(torch, dev, power: str) -> list:
    """A7 on the card: a one-rank NCCL group (file:// store), the sharded
    entry points at full width against the unsharded port, the ring of
    RING_WORLD in one process.  Returns the runs whose launches count on
    the main path."""
    import tempfile

    import torch.distributed as dist

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch.parallel import create_mesh, init_distributed

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(0, 1, f"file://{tmp}/store", device="cuda")
        try:
            serve = pt.DecoderLM(**MODEL,
                                 generator=torch.Generator().manual_seed(SEED),
                                 device=dev).eval().to(torch.bfloat16)
            tp_mesh = create_mesh((1,), ("model",))
            runs.append(_tp_engine_check(torch, serve, "parallel-serve", power,
                                         tp_mesh, SERVE_KERNELS))
            quant = pt.quantize_model_weights(serve, torch.int8)
            del serve
            runs.append(_tp_engine_check(torch, quant, "parallel-serve-int8",
                                         power, tp_mesh,
                                         SERVE_KERNELS + ("wo_matmul",)))
            del quant
            torch.cuda.empty_cache()
            dm = create_mesh((1, 1), ("data", "model"))
            runs += list(_train_runs(torch, dev, dm, power).values())
            torch.cuda.empty_cache()
            runs += list(_ring_checks(torch, dev, power).values())
            runs.append(_pipeline_check(torch, dev, power))
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return runs


SOURCES = {
    "layernorm_fwd": ("flashattn_tpu_torch/csrc/layernorm.cu",
                      ["flashattn_tpu/ops/layernorm.py:47"]),
    "layernorm_bwd": ("flashattn_tpu_torch/csrc/layernorm.cu",
                      ["flashattn_tpu/ops/layernorm.py:96"]),
    "flash_fwd": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                  ["flashattn_tpu/ops/flash_attention.py:627",
                   "flashattn_tpu/ops/flash_attention.py:79",
                   "flashattn_tpu/ops/flash_attention.py:551",
                   "flashattn_tpu/ops/flash_attention.py:327",
                   "flashattn_tpu/ops/flash_attention.py:753"]),
    "flash_bwd": ("flashattn_tpu_torch/csrc/flash_bwd.cu",
                  ["flashattn_tpu/ops/flash_attention.py:874",
                   "flashattn_tpu/ops/flash_attention.py:999",
                   "flashattn_tpu/ops/flash_attention.py:1086",
                   "flashattn_tpu/ops/flash_attention.py:1320",
                   "flashattn_tpu/ops/flash_attention.py:1416"]),
    "flash_fwd_f32": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                      ["flashattn_tpu/ops/flash_attention.py:327",
                       "flashattn_tpu/ops/flash_attention.py:79",
                       "flashattn_tpu/ops/flash_attention.py:551",
                       "flashattn_tpu/ops/flash_attention.py:627"]),
    "flash_bwd_f32": ("flashattn_tpu_torch/csrc/flash_bwd_f32.cu",
                      ["flashattn_tpu/ops/flash_attention.py:999",
                       "flashattn_tpu/ops/flash_attention.py:1086",
                       "flashattn_tpu/ops/flash_attention.py:874",
                       "flashattn_tpu/ops/flash_attention.py:1320",
                       "flashattn_tpu/ops/flash_attention.py:1416"]),
    # the f32 function of every schedule below F32_TC_MIN_KV keys (where
    # JAX runs its op graph) and of a +-inf call at any length: the grid
    # kernels' first
    "flash_fwd_f32_mma": ("flashattn_tpu_torch/csrc/flash_fwd.cu",
                          ["flashattn_tpu/ops/flash_attention.py:79",
                           "flashattn_tpu/ops/flash_attention.py:627",
                           "flashattn_tpu/ops/flash_attention.py:551",
                           "flashattn_tpu/ops/flash_attention.py:327"]),
    "flash_bwd_f32_mma": ("flashattn_tpu_torch/csrc/flash_bwd_f32.cu",
                          ["flashattn_tpu/ops/flash_attention.py:1320",
                           "flashattn_tpu/ops/flash_attention.py:1416",
                           "flashattn_tpu/ops/flash_attention.py:874",
                           "flashattn_tpu/ops/flash_attention.py:999",
                           "flashattn_tpu/ops/flash_attention.py:1086"]),
    "paged_attention": ("flashattn_tpu_torch/csrc/paged_attention.cu",
                        ["flashattn_tpu/ops/paged_attention.py:119",
                         "flashattn_tpu/ops/paged_attention.py:34"]),
    "paged_attention_f32": ("flashattn_tpu_torch/csrc/paged_attention.cu",
                            ["flashattn_tpu/ops/paged_attention.py:119",
                             "flashattn_tpu/ops/paged_attention.py:34"]),
    "paged_nonfinite": ("flashattn_tpu_torch/csrc/paged_attention.cu",
                        ["flashattn_tpu/ops/paged_attention.py:34"]),
    "dropout": ("flashattn_tpu_torch/csrc/dropout.cu",
                ["flashattn_tpu/ops/dropout.py:77"]),
    "wo_matmul": ("flashattn_tpu_torch/csrc/wo_matmul.cu",
                  ["flashattn_tpu/ops/quant.py:145"]),
    "wo_matmul_f32": ("flashattn_tpu_torch/csrc/wo_matmul.cu",
                      ["flashattn_tpu/ops/quant.py:145"]),
    "paged_attention_int8": ("flashattn_tpu_torch/csrc/paged_attention.cu",
                             ["flashattn_tpu/ops/paged_attention.py:119",
                              "flashattn_tpu/ops/paged_attention.py:34"]),
    "paged_attention_fp8": ("flashattn_tpu_torch/csrc/paged_attention.cu",
                            ["flashattn_tpu/ops/paged_attention.py:119",
                             "flashattn_tpu/ops/paged_attention.py:34"]),
    "kv8_flash": ("flashattn_tpu_torch/csrc/kv8_flash.cu",
                  ["flashattn_tpu/ops/quant.py:216",
                   "flashattn_tpu/ops/quant.py:312",
                   "flashattn_tpu/ops/quant.py:516"]),
    "kv8_flash_f32": ("flashattn_tpu_torch/csrc/kv8_flash.cu",
                      ["flashattn_tpu/ops/quant.py:216",
                       "flashattn_tpu/ops/quant.py:312",
                       "flashattn_tpu/ops/quant.py:516"]),
    "stochastic_quant": ("flashattn_tpu_torch/csrc/quant.cu",
                         ["flashattn_tpu/ops/quant.py:84"]),
    "softmax_fwd": ("flashattn_tpu_torch/csrc/softmax.cu",
                    ["flashattn_tpu/ops/softmax.py:40",
                     "flashattn_tpu/ops/softmax.py:105"]),
    "softmax_bwd": ("flashattn_tpu_torch/csrc/softmax.cu",
                    ["flashattn_tpu/ops/softmax.py:55"]),
    "dropout_res_bias": ("flashattn_tpu_torch/csrc/dropout_bias.cu",
                         ["flashattn_tpu/ops/dropout.py:85",
                          "flashattn_tpu/ops/dropout.py:105"]),
    "dropout_act_bias": ("flashattn_tpu_torch/csrc/dropout_bias.cu",
                         ["flashattn_tpu/ops/dropout.py:93",
                          "flashattn_tpu/ops/dropout.py:127"]),
}
# the quantized paged entries (bf16 q): the serve_quant variants whose pools
# they serve; f32 q counts under paged_attention_f32
QUANT_PAGED = {"paged_attention_int8": ("int8 weights + int8 pool",),
               "paged_attention_fp8": ("int8 weights + fp8 pool",)}


def main_path_launches(name, runs, serve_quant) -> int:
    """A kernel's launches over the main-path runs (``runs``: each phase's
    result with its ``launches``).  The paged kernel's launches over a
    quantized pool count under that pool's entry, the others under
    ``paged_attention``."""
    if name in QUANT_PAGED:
        return sum(serve_quant[label]["launches"]["paged_attention"]
                   for label in QUANT_PAGED[name])
    quant_pools = {label for labels in QUANT_PAGED.values() for label in labels}
    runs = list(runs) + [
        res for label, res in serve_quant.items()
        if name != "paged_attention" or label not in quant_pools]
    return sum(r["launches"].get(name, 0) for r in runs)


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
    power = smi.stdout.strip().splitlines()[0]
    log(f"[device] {power}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    import flashattn_tpu_torch as pt
    from flashattn_tpu_torch import DecoderLM
    from flashattn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[build] {lib.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")
    t_start = time.perf_counter()

    phases = kernel_phases(torch, dev)

    serve_d96 = serve_d96_phase(torch, dev)
    torch.cuda.empty_cache()
    serve_d256 = serve_d256_phase(torch, dev, power)
    torch.cuda.empty_cache()
    model = DecoderLM(**MODEL, generator=torch.Generator().manual_seed(SEED),
                      device=dev).eval()
    serve = serve_phase(torch, copy.deepcopy(model).to(torch.bfloat16), dev)
    consistency_phase(torch, model, dev)
    quant_consistency_phase(torch, model, dev)
    serve_features = serve_features_phase(torch, model, dev)
    generate = generate_phase(torch, model, dev)
    distill = distill_phase(torch, model, dev)
    del model
    torch.cuda.empty_cache()
    serve_rope = serve_rope_phase(torch, dev)
    torch.cuda.empty_cache()
    serve_quant = serve_quant_phase(torch, dev)
    torch.cuda.empty_cache()
    train = train_phase(torch, dev, power)
    torch.cuda.empty_cache()
    with _NoPlain():
        train_d96 = train_phase(torch, dev, power, TRAIN_D96, "train_d96")
    torch.cuda.empty_cache()
    train_f32 = train_phase(torch, dev, power, name="train_f32",
                            kernels=TRAIN_F32_KERNELS, absent=TRAIN_F32_ABSENT,
                            mixed=False)
    torch.cuda.empty_cache()
    train_consistency_phase(torch, dev)
    torch.cuda.empty_cache()
    train_consistency_phase(torch, dev, CONSIST_LOOP, "loop-consistency",
                            batch=1, seq=2048)
    torch.cuda.empty_cache()
    for seq, route in CONSIST_D96_SEQS:
        routes = ("flash_bwd_f32", "flash_bwd_f32_mma")
        with _Launches(routes) as run:
            train_consistency_phase(torch, dev, CONSIST_D96, "d96-consistency",
                                    seq=seq)
        log(f"[d96-consistency] S{seq} launches {run.counts}")
        if not (run.counts[route] > 0 and all(
                run.counts[r] == 0 for r in routes if r != route)):
            raise AssertionError(f"d96-consistency S{seq}: the backward took "
                                 f"{run.counts}, not {route} alone")
    torch.cuda.empty_cache()
    train_fused = train_phase(torch, dev, power, TRAIN_FUSED,
                              "train_fused_softmax", FUSED_KERNELS,
                              FUSED_ABSENT)
    torch.cuda.empty_cache()
    train_consistency_phase(torch, dev, dict(CONSIST, attn_impl="fused_softmax"),
                            "fused-consistency")
    fused_logits_phase(torch, dev)
    torch.cuda.empty_cache()
    train_moe = train_phase(torch, dev, power, TRAIN_MOE, "train_moe",
                            loss=pt.make_moe_loss(MOE_AUX_ALPHA))
    torch.cuda.empty_cache()
    train_consistency_phase(torch, dev, CONSIST_MOE, "moe-consistency",
                            pt.make_moe_loss(MOE_AUX_ALPHA))
    torch.cuda.empty_cache()
    train_adafactor = train_phase(torch, dev, power, TRAIN, "train_adafactor",
                                  opt=pt.Adafactor())
    log(f"[train_adafactor] {power}: {train_adafactor['ms']:.1f} ms/step, "
        f"peak {train_adafactor['peak'] / 2**30:.2f} GiB; Adam (phase train) "
        f"{train['ms']:.1f} ms/step, peak {train['peak'] / 2**30:.2f} GiB")
    if not train_adafactor["peak"] < train["peak"]:
        raise AssertionError("Adafactor's peak is not below Adam's")
    torch.cuda.empty_cache()
    adafactor_consistency_phase(torch, dev)
    torch.cuda.empty_cache()

    mt = mt_data()
    s2s = seq2seq_train_phase(torch, dev, power, mt)
    s2s_mixed = seq2seq_train_phase(torch, dev, power, mt, mixed=True,
                                    remat=True)
    del s2s_mixed["model"]
    seq2seq_consistency_phase(torch, dev, mt)
    s2s_gen = seq2seq_generate_phase(torch, dev, s2s.pop("model"), mt)
    torch.cuda.empty_cache()
    mt_app_phase(torch)
    utilities_phase(torch, dev)
    torch.cuda.empty_cache()
    parallel = parallel_phase(torch, dev, power)
    log(f"[mt] launches a step of the MT train step (MT, f32): "
        f"{ {n: c / MT_STEPS for n, c in s2s['launches'].items()} }; "
        f"in one greedy_generate_seq2seq call (MG): {s2s_gen['launches']}")

    runs = (train, train_d96, train_f32, train_fused, serve, serve_features,
            generate, distill, serve_rope, serve_d96, serve_d256, train_moe, train_adafactor, s2s, s2s_mixed,
            s2s_gen, *parallel)
    kernels = []
    for name, (src, tpu) in SOURCES.items():
        launches = main_path_launches(name, runs, serve_quant)
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=tpu[0], counterparts=tpu,
                            launches=launches, **phases.main[name]))
    log(f"[done] phases after the build took "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
