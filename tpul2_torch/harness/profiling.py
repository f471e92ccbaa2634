"""Profiling and roofline placement on the card.

Counterpart of ``tpul2/harness/profiling.py``: ``roofline`` places one GEMM measurement
against the card's published peaks, ``maybe_trace`` wraps a block in a ``torch.profiler``
trace (CPU and CUDA activities) that TensorBoard and Perfetto read, and ``profile_shape``
times the dispatched candidate and torch.matmul at one shape by device time
(``bench_utils.GraphTimer``) and places both.  ``profile_step`` serves the model path: for
one call of a step (a forward, a training step) the device's busy time against the wall
time, so the idle share, and the device ops that took the most time.

The peaks are a table keyed by ``torch.cuda.get_device_name()`` (``DEVICE_PEAKS``), the
role of the TPU generation table.  An unknown card, or the CPU, gets ``None`` shares,
never another card's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, NamedTuple, Optional

import torch

from tpul2_torch.utils.platform import check_device, device_name


class DevicePeaks(NamedTuple):
    flops: float   # dense bf16 tensor-core rate, FLOP/s
    bytes: float   # device-memory rate, bytes/s
    sms: int       # streaming multiprocessors


#: Published peaks per card name (NVIDIA data sheet; the SXM part at its 700 W limit; a
#: card set below that limit runs slower under load, which its nvidia-smi line shows).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(flops=989e12, bytes=3.35e12, sms=132),
}
#: The H100 SXM row: the bound of every timing in this package (``bench_utils``).
H100 = DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]


def _current_name() -> str:
    return device_name("cuda" if torch.cuda.is_available() else "cpu")


def flops_share(flops: float, ms: float, name: Optional[str] = None) -> Optional[float]:
    """Achieved FLOP/s over the peak of card ``name`` (default: card 0, or 'cpu' without
    a card), or None for a card the table lacks."""
    row = DEVICE_PEAKS.get(name or _current_name())
    return None if row is None else flops / (ms * 1e-3) / row.flops


def roofline(m: int, n: int, k: int, ms: float, in_dtype: torch.dtype = torch.bfloat16,
             out_dtype: torch.dtype = torch.bfloat16, name: Optional[str] = None,
             batch: int = 1) -> dict:
    """Roofline placement of one GEMM measurement of ``ms`` milliseconds on card ``name``:
    2·batch·M·N·K FLOPs; each input read once and the output written once."""
    name = name or _current_name()
    row = DEVICE_PEAKS.get(name)
    flops = 2.0 * batch * m * n * k
    moved = batch * ((m * k + k * n) * in_dtype.itemsize + m * n * out_dtype.itemsize)
    t = ms * 1e-3
    intensity = flops / moved
    ridge = None if row is None else row.flops / row.bytes
    bound_ms = None if row is None else max(flops / row.flops, moved / row.bytes) * 1e3
    return {
        "device": name,
        "ms": ms,
        "tflops": flops / t / 1e12,
        "pct_flops_peak": None if row is None else 100.0 * flops / t / row.flops,
        "gb_per_s": moved / t / 1e9,
        "pct_bytes_peak": None if row is None else 100.0 * moved / t / row.bytes,
        "arithmetic_intensity": intensity,
        "ridge_intensity": ridge,
        "bound_ms": bound_ms,
        "bound": ("unknown" if ridge is None else
                  "compute" if intensity >= ridge else "memory"),
    }


def _profiler(trace_dir: Optional[str] = None):
    """A ``torch.profiler.profile`` of CPU activity, and CUDA where a card is present,
    writing its trace into ``trace_dir`` where one is given."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(trace_dir) if trace_dir else None
    return profile(activities=activities, on_trace_ready=handler)


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block into ``trace_dir``, yielding the profiler;
    a no-op yielding None when ``trace_dir`` is None."""
    if not trace_dir:
        yield None
        return
    with _profiler(trace_dir) as prof:
        yield prof


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _union_us(intervals: list) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


#: Device and host ops that ``profile_step`` ranks.
TOP_OPS = 8


def profile_step(step: Callable[[], object]) -> dict:
    """One call of ``step`` under ``torch.profiler``, after one warm-up call.

    ``device_busy_ms`` is the union of the device events' intervals (kernels, copies,
    sets); ``idle_share`` is 1 - busy / the wall time of the same call (host clock, from
    the call to the card's end, the profiler's own host cost included);
    ``wall_ms_unprofiled`` is one more call with no profiler, for scale.
    ``top_device_ops`` sums the device events by name, ``top_host_ops`` ranks the host ops
    by their own CPU time (the profiler's cost per op included).  Where the profiler sees
    no device event (the CPU, or a machine where CUPTI records nothing) the device fields
    are None and ``device_events`` is 0."""
    from torch.autograd import DeviceType
    step()
    _sync()
    t0 = time.perf_counter()
    step()
    _sync()
    unprofiled = (time.perf_counter() - t0) * 1e3
    with _profiler() as prof:
        t0 = time.perf_counter()
        step()
        _sync()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    by_name = {}
    for e in device:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:TOP_OPS]
    return {
        "wall_ms": wall, "wall_ms_unprofiled": unprofiled, "device_events": len(device),
        "device_busy_ms": busy if device else None,
        "idle_share": 1.0 - busy / wall if device else None,
        "top_device_ops": [{"name": name[:120], "ms": ms, "calls": calls}
                           for name, (ms, calls) in ranked],
        "top_host_ops": [{"name": e.key[:120], "self_ms": e.self_cpu_time_total / 1e3,
                          "calls": e.count} for e in host],
    }


def profile_shape(m: int, n: int, k: int, acc: str = "float32", trials: int = 5,
                  trace_dir: Optional[str] = None, device: str = "cuda") -> dict:
    """Time the dispatched candidate and torch.matmul at one shape by device time and
    place both on the roofline; the candidate's timing is traced into ``trace_dir`` if
    given.  On the CPU (asked for) the times are the host clock's and the shares None."""
    check_device(device, "profile_shape")
    import numpy as np

    from tpul2_torch.dispatch import candidate_fn
    from tpul2_torch.harness import bench_utils as bu
    from tpul2_torch.ops.baselines import torch_matmul

    data = bu.fresh_inputs(np.random.default_rng(0), m, n, k, device=device)
    name = device_name(device)
    report = {"mnk": [m, n, k], "acc": acc, "device": name}
    for key, fn in (("tpul2_torch", candidate_fn(acc)), ("torch_matmul", torch_matmul)):
        fn(*data)  # the first call resolves the config and, on the card, loads the kernels
        timer = bu.GraphTimer(fn, data, bu.bound_ms(m, n, k))
        with maybe_trace(trace_dir if key == "tpul2_torch" else None):
            times = [timer.time_ms() for _ in range(trials)]
        report[key] = roofline(m, n, k, float(np.median(times)), name=name)
        report[key]["clock"] = timer.clock
    report["speedup_vs_torch_matmul"] = (report["torch_matmul"]["ms"]
                                         / report["tpul2_torch"]["ms"])
    if trace_dir:
        report["trace_dir"] = trace_dir
    return report
