"""Timing core of the benchmarks: fresh inputs, per-call CUDA-event timing, TFLOPS.

The role of ``tpul2/harness/bench_utils.py`` and of the reference's
``benchmarking_utils.py``: fresh random operands every iteration, TFLOPS = 2·M·N·K / t.
On the card each call is timed by a pair of ``torch.cuda.Event``s recorded around it on
the current stream, so the time is the device's, not the host's enqueue.  On the CPU the
host clock is used; such times describe the CPU and are labelled by the device recorded
beside them, never as card numbers.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

VERSION_STAMP = "tpul2_torch-0.1"
#: Timing-methodology revision, stamped into TuneDB entries.  1 = the tuner's medians of
#: per-call CUDA-event times over a fixed count of back-to-back calls (time_median_ms).
TIMING_REV = 1


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


def time_median_ms(fn: Callable, data: tuple, calls: int = 5) -> float:
    """Median of the per-call times of ``calls`` back-to-back calls ``fn(*data)``.

    On the card one CUDA event is recorded between consecutive calls, so each call is
    timed on the device with no host wait in between; on the CPU the host clock is used.
    The count is fixed: there is no calibration and no floor to subtract."""
    if data[0].is_cuda:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
        events[0].record()
        for ev in events[1:]:
            fn(*data)
            ev.record()
        events[-1].synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    else:
        ms = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn(*data)
            ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def tflops(m: int, n: int, k: int, ms: float, batch: int = 1) -> float:
    return 2.0 * batch * m * n * k * 1e-12 * 1e3 / ms


def percentile_stats(ms_list) -> dict:
    arr = np.asarray(ms_list, np.float64)
    return {
        "mean_ms": float(arr.mean()),
        "median_ms": float(np.median(arr)),
        "p50_ms": float(np.percentile(arr, 50)),
        "p99_ms": float(np.percentile(arr, 99)),
        "min_ms": float(arr.min()),
        "iters": int(arr.size),
    }
