"""Timing core of the benchmarks and the tuner: fresh inputs, CUDA-event and CUDA-graph
timing, the bound, TFLOPS.

The role of ``tpul2/harness/bench_utils.py`` and of the reference's
``benchmarking_utils.py``: fresh random operands every iteration, TFLOPS = 2·M·N·K / t.
Two ways to time on the card:

* ``time_call_ms``: one call between a pair of ``torch.cuda.Event``s on the current
  stream, which is what a caller pays end to end, the host's enqueue included whenever
  the card is idle when the window opens (the offline and server benches).
* ``GraphTimer``: the device time of one call with no host time in it.  ``n_lo`` and
  ``n_hi`` calls (``GRAPH_CALLS``) are captured as two CUDA graphs on static operands,
  each replay is timed with events, and the per-call time is taken from the difference,
  which cancels the replay's fixed launch cost (the counterpart of the JAX package's ``ChainedTimer``,
  whose program of N calls is a graph here).  The counts are fixed: no calibration.

On the CPU the host clock is used; such times describe the CPU and are labelled by the
device recorded beside them, never as card numbers.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from tpul2_torch.harness.profiling import H100

VERSION_STAMP = "tpul2_torch-0.1"
#: Timing-methodology revision, stamped into TuneDB entries.  1 = medians of per-call
#: CUDA-event windows over 5 back-to-back calls (host-bound wherever the enqueue is longer
#: than the kernel); 2 = device time per call from ``GraphTimer``.
TIMING_REV = 2
#: The H100 SXM's published peaks (``profiling.DEVICE_PEAKS``, the one table of them):
#: dense bf16 tensor-core rate and HBM rate.  The bound of a product is the larger of its
#: bytes and its FLOPs over these.
PEAK_FLOPS = H100.flops
PEAK_BYTES = H100.bytes
#: Calls in the two graphs of a ``GraphTimer``: a difference of 100 calls keeps the
#: replays' jitter (a few microseconds) to a few percent of a 2-microsecond kernel; at
#: 16 calls it moved two timings of one library call 30% apart at 1024x128x64.
GRAPH_CALLS = (10, 110)


def bound_ms(m: int, n: int, k: int, out_bytes: int = 2, batch: int = 1) -> float:
    """The least time the card could take for C = A @ B: the bf16 operands read once and
    the output written once at PEAK_BYTES, or 2·M·N·K FLOPs at PEAK_FLOPS, the larger."""
    t_bytes = batch * ((m * k + k * n) * 2 + m * n * out_bytes) / PEAK_BYTES * 1e3
    return max(t_bytes, 2.0 * batch * m * n * k / PEAK_FLOPS * 1e3)


def per_call_ms(t_lo: float, t_hi: float, n_lo: int, n_hi: int, floor_ms: float) -> float:
    """Per-call time from two timed runs of ``n_lo`` and ``n_hi`` calls: the difference
    cancels what both runs pay once; clamped at ``floor_ms`` (the bound), below which the
    difference can only be noise."""
    if n_hi <= n_lo:
        raise ValueError(f"n_hi ({n_hi}) must exceed n_lo ({n_lo})")
    return max((t_hi - t_lo) / (n_hi - n_lo), floor_ms)


def fresh_inputs(rng: np.random.Generator, m: int, n: int, k: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda") -> tuple:
    """Normal-random (a, b, b_t) made on ``device`` from a seed drawn from ``rng``.

    b_t is a separately materialised (N, K) copy, the reference's b_col_major operand."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**31 - 1)))
    a = torch.randn((m, k), generator=gen, device=device, dtype=torch.float32).to(dtype)
    b = torch.randn((k, n), generator=gen, device=device, dtype=torch.float32).to(dtype)
    return a, b, b.t().contiguous()


def time_call_ms(fn: Callable, data: tuple) -> float:
    """Milliseconds of one call ``fn(*data)``: CUDA events on the card, host clock on CPU."""
    if data[0].is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*data)
        end.record()
        end.synchronize()
        return float(start.elapsed_time(end))
    t0 = time.perf_counter()
    fn(*data)
    return (time.perf_counter() - t0) * 1e3


def load_inputs(static: tuple, data: tuple) -> None:
    """Copy fresh operands into the static ones that captured graphs read."""
    for dst, src in zip(static, data):
        dst.copy_(src)


class GraphTimer:
    """Device milliseconds per call of ``fn(*static)``, by the difference of two graphs.

    On the card, ``fn`` runs once outside capture on the side stream, so that a library's
    workspace for that stream exists before any capture.  Then ``n_lo`` and ``n_hi`` calls
    are captured as two CUDA graphs that share one private memory pool: an output or a
    workspace allocated inside a call comes from it.  ``time_ms`` replays each graph
    alone between two events, with the card idle before each, and returns
    ``per_call_ms(t_lo, t_hi, ...)`` clamped at ``floor_ms``.  The graphs read the static
    operands, so fresh inputs are copied into them (``load_inputs``) before a replay.  A
    capture that raises propagates: the caller decides whether that refuses a candidate.

    On the CPU it takes the same difference over ``n_lo`` and ``n_hi`` direct calls on the
    host clock (``clock == 'host'``): a CPU number."""

    def __init__(self, fn: Callable, static: tuple, floor_ms: float = 0.0,
                 calls: tuple = GRAPH_CALLS, stream=None):
        self.fn, self.static, self.floor_ms = fn, tuple(static), floor_ms
        self.n_lo, self.n_hi = calls
        if self.n_hi <= self.n_lo:
            raise ValueError(f"calls must rise: {calls}")
        self.on_card = self.static[0].is_cuda
        self.clock = "cuda_graph" if self.on_card else "host"
        self.graphs = []
        if not self.on_card:
            return
        side = stream or torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.static)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        pool = None
        for n in (self.n_lo, self.n_hi):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=side):
                for _ in range(n):
                    fn(*self.static)
            pool = g.pool()
            self.graphs.append(g)
        for g in self.graphs:  # the first replay uploads the graph
            g.replay()
        torch.cuda.synchronize()

    def _run_ms(self, i: int, n: int) -> float:
        if not self.on_card:
            t0 = time.perf_counter()
            for _ in range(n):
                self.fn(*self.static)
            return (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        self.graphs[i].replay()
        end.record()
        end.synchronize()
        return float(start.elapsed_time(end))

    def time_ms(self) -> float:
        return per_call_ms(self._run_ms(0, self.n_lo), self._run_ms(1, self.n_hi),
                           self.n_lo, self.n_hi, self.floor_ms)


def tflops(m: int, n: int, k: int, ms: float, batch: int = 1) -> float:
    return 2.0 * batch * m * n * k * 1e-12 * 1e3 / ms


def percentile_stats(ms_list) -> dict:
    arr = np.asarray(ms_list, np.float64)
    q25, q75 = np.percentile(arr, [25, 75])
    return {
        "mean_ms": float(arr.mean()),
        "median_ms": float(np.median(arr)),
        "p50_ms": float(np.percentile(arr, 50)),
        "p99_ms": float(np.percentile(arr, 99)),
        "iqr_ms": float(q75 - q25),
        "min_ms": float(arr.min()),
        "iters": int(arr.size),
    }
