"""Timed-correctness kernel benchmark harness (counterpart of
flashattn_tpu/utils/timing.py).

The reference's ``TestDecorator`` (test_utils.py:13-231): register cases,
draw random (batch, seq) shapes, run custom against baseline, assert
allclose, report speedup.  Timing chains the calls (each call's input is
the last one's output, every output folded in, as the JAX module's scan
does) and takes the two-point slope of the chain's time: on the card the
chain is captured in a CUDA graph and timed with CUDA events (device time,
as the JAX module's scan is one device program), on the CPU by the host
clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _tensor_leaves(out: Any) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _tensor_leaves(x)]
    return []


def make_timing_loop(fn: Callable, length: int) -> Callable:
    """The chain :func:`device_loop_time` measures: ``loop(x, *rest)`` calls
    ``fn(c, *rest)`` ``length`` times, the carry ``c`` starting at ``x``.

    Every output leaf of ``fn`` is folded into the carry, as in the JAX
    module (its r1-r3 tables were voided by an elided second output): an
    output shaped and typed as ``x`` becomes the carry, plus 1e-12 times the
    sum of the other leaves; otherwise the sums of all leaves, times 1e-12,
    are added to the carry.  Eager PyTorch elides nothing, but the fold
    makes each call wait on the last one, and a NaN in any leaf reaches the
    result.  Returns the final carry's float32 sum (no host sync)."""

    def loop(x, *rest):
        c = x
        for _ in range(length):
            leaves = _tensor_leaves(fn(c, *rest))
            first, extra = leaves[0], leaves[1:]
            sig_extra = (sum(t.sum().float() for t in extra) if extra
                         else None)
            if first.shape == x.shape and first.dtype == x.dtype:
                c = first if sig_extra is None else (
                    first + (sig_extra * 1e-12).to(x.dtype))
                continue
            sig = first.sum().float()
            if sig_extra is not None:
                sig = sig + sig_extra
            # keep the carry's dtype (an int carry: the f32 detour keeps the
            # data dependency, the cast restores the type)
            c = (c.float() + sig * 1e-12).to(x.dtype)
        return c.sum().float()

    return loop


def _timer(loop: Callable, args: tuple) -> Callable[[], float]:
    """A function that runs ``loop(*args)`` once and returns its seconds.
    On the card the loop is captured once in a CUDA graph (after a warm-up
    run) and each timing replays it between CUDA events: one device
    program, as the JAX module's jitted scan is, so the host's launch work
    per call does not count (``fn`` must not sync the host).  On the CPU
    the loop runs eagerly under the host clock."""
    x = args[0]
    if not (isinstance(x, torch.Tensor) and x.is_cuda):
        def host() -> float:
            t0 = time.perf_counter()
            float(loop(*args))
            return time.perf_counter() - t0
        return host
    loop(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop(*args)

    def replay() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    return replay


def device_loop_time(fn: Callable, args: tuple, iters: int = 30,
                     repeats: int = 3) -> float:
    """Seconds per call of fn(*args), the two-point slope of chained calls.

    The first argument is threaded through the chain (:func:`make_timing_loop`),
    so each call depends on the last.  The chain runs at ``iters`` and
    ``3 * iters`` calls and the per-call time is the difference over
    ``2 * iters``, which cancels a fixed cost per chain; the least of
    ``repeats`` timings of each is taken.  A slope under 10 ms is rescaled
    (up to three times, at most 50000 calls) until the signal dominates.
    When the first argument lies on the card the chain is a CUDA graph
    timed with CUDA events (device time); on the CPU the host clock times
    it."""
    def measure(n):
        run1 = _timer(make_timing_loop(fn, n), args)
        run3 = _timer(make_timing_loop(fn, 3 * n), args)
        run1()   # warm
        run3()
        t1 = min(run1() for _ in range(repeats))
        t3 = min(run3() for _ in range(repeats))
        return max(t3 - t1, 1e-9)

    MIN_SIGNAL = 10e-3
    MAX_ITERS = 50000
    delta = measure(iters)
    for _ in range(3):
        if delta >= MIN_SIGNAL or iters >= MAX_ITERS:
            break
        scale = min(int(2 * MIN_SIGNAL / max(delta, 2e-4)) + 1, 100)
        iters = min(iters * scale, MAX_ITERS)
        delta = measure(iters)
    return delta / (2 * iters)


@dataclasses.dataclass
class CaseResult:
    name: str
    shape: tuple
    custom_ms: float
    baseline_ms: float
    max_err: float

    @property
    def speedup(self) -> float:
        return self.baseline_ms / self.custom_ms


def _numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class KernelBench:
    """Register + run custom-vs-baseline cases (reference kt.init/case/run).
    Both run eagerly, as called (no ``torch.compile``)."""

    def __init__(self, rtol: float = 1e-3, atol: float = 1e-3,
                 ntest: int = 3, iters: int = 20, seed: int = 0,
                 max_batch_tokens: int = 1024, max_seq_len: int = 512):
        self.rtol, self.atol = rtol, atol
        self.ntest, self.iters = ntest, iters
        self.rng = np.random.default_rng(seed)
        self.max_batch_tokens = max_batch_tokens
        self.max_seq_len = max_seq_len
        self.cases: Dict[str, Tuple] = {}
        self.results: List[CaseResult] = []

    def bs_sl(self, batch: Optional[int] = None) -> Tuple[int, int]:
        """Random (batch_size, seq_len) draw (reference test_utils.py:28-42)."""
        if batch is None:
            batch = int(self.rng.integers(1, 9))
        seq = int(self.rng.integers(8, self.max_seq_len + 1))
        while batch * seq > self.max_batch_tokens:
            seq = max(8, seq // 2)
        return batch, seq

    def case(self, name: Optional[str] = None, rtol: Optional[float] = None,
             atol: Optional[float] = None, ntest: Optional[int] = None):
        def deco(fn):
            self.cases[name or fn.__name__] = (fn, rtol or self.rtol,
                                               atol or self.atol,
                                               ntest or self.ntest)
            return fn

        return deco

    def run(self, name: str) -> List[CaseResult]:
        fn, rtol, atol, ntest = self.cases[name]
        out = []
        for _ in range(ntest):
            custom, baseline, args = fn(self)
            ref = _numpy(baseline(*args))
            got = _numpy(custom(*args))
            err = float(np.max(np.abs(got - ref)))
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
            t_c = device_loop_time(custom, args, self.iters)
            t_b = device_loop_time(baseline, args, self.iters)
            r = CaseResult(name, tuple(args[0].shape), t_c * 1e3, t_b * 1e3, err)
            out.append(r)
            self.results.append(r)
            print(f"[{name}] shape={r.shape} custom={r.custom_ms:.3f}ms "
                  f"baseline={r.baseline_ms:.3f}ms speedup={r.speedup:.3f} "
                  f"max_err={r.max_err:.2e}")
        return out

    def run_all(self):
        for name in self.cases:
            self.run(name)
        return self.results
