"""Benchmark-integrity defenses: checks that a timed function is not cheating the harness.

Counterpart of ``tpul2/harness/defense.py``, on the reference's own torch threat model
(its ``defense.py``, SURVEY.md C8), five checks:

  thread injection     a call must not leave helper threads running after it returns
                       (counted after a warm call and a settle, so the first call's kernel
                       build and the library's own start-up do not count);
  stream injection     hybrid timing: "event" timing brackets the call with CUDA events on
                       the current stream; "sync" timing brackets it with
                       ``torch.cuda.synchronize()`` and the host clock, less the cost of a
                       synchronize on an empty queue.  Work launched on another stream
                       and not joined escapes the first but not the second.  A run flags
                       where sync / event > ``RATIO`` and the hidden time is above
                       ``HIDDEN_FLOOR_MS``; the verdict is the majority of ``STREAM_RUNS``
                       runs, and where it flags, the sync time is the authoritative one;
  lazy evaluation      the output must be exactly a ``torch.Tensor`` (no subclass), not on
                       the meta device, on the inputs' device, with storage that covers
                       its elements, a non-zero data pointer and the expected shape;
  precision downgrade  the output's dtype must be the contract's (bf16 for the
                       ``cuda_l2_h100_*`` candidates);
  monkey-patching      the timing and fencing primitives must be the objects captured
                       when this module was imported.

``run_all_defenses`` composes them with the JAX function's return shape,
``{"pass": bool, "defenses": [one dict per check]}``.  A check that cannot run raises: no
check is skipped.  The checks time with the primitives captured at import, so a patched
timer cannot fool them.  On CPU tensors (asked for) there is no stream: both timings
are the host clock's, the result says so, and the stream check cannot flag.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

# --- the originals, captured at import (the monkey-patch canaries) ---
_REF_EVENT_RECORD = torch.cuda.Event.record
_REF_EVENT_ELAPSED = torch.cuda.Event.elapsed_time
_REF_SYNCHRONIZE = torch.cuda.synchronize
_REF_PERF_COUNTER = time.perf_counter
_REF_SLEEP = time.sleep

#: Seconds a call's helper threads get to start and to end before the count.
SETTLE_S = 0.1
#: sync / event ratio above which a stream-injection run may flag (the reference's).
RATIO = 1.5
#: Hidden milliseconds below which a stream-injection run never flags.  The entry
#: point's host time (0.02-0.05 ms a call at the host-bound shapes) lands in both
#: timings alike, and what is left of an honest call's difference is the jitter of a
#: synchronize and the host clock around it; the floor sits above that jitter and far
#: below the time of a product worth hiding (8192^3 takes ~1.5 ms).  The JAX check's
#: 0.5 ms is a TPU fence floor and does not carry over.
HIDDEN_FLOOR_MS = 0.05
#: Runs of the stream-injection timing; the majority decides.
STREAM_RUNS = 3
#: Event- and sync-timed calls per stream-injection run, interleaved in a shuffled order.
STREAM_ITERS = 10

NAMES = ("monkey_patching", "thread_injection", "stream_injection", "lazy_evaluation",
         "precision_downgrade")


def _on_card(args: tuple) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in args)


def _wait(on_card: bool) -> None:
    """Wait for everything on the card (the defenses' own fence)."""
    if on_card:
        _REF_SYNCHRONIZE()


def defend_against_thread_injection(perf_func: Callable, args: tuple,
                                    settle_s: float = SETTLE_S) -> dict:
    """Flag a function that leaves threads alive after it returns."""
    on_card = _on_card(args)
    perf_func(*args)  # the warm call: kernel builds, the libraries' own start-up
    _wait(on_card)
    _REF_SLEEP(settle_s)
    before = threading.active_count()
    perf_func(*args)
    _wait(on_card)
    _REF_SLEEP(settle_s)
    after = threading.active_count()
    return {"name": "thread_injection", "pass": after <= before,
            "threads_before": before, "threads_after": after}


def _event_ms(perf_func: Callable, args: tuple) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _REF_EVENT_RECORD(start)
    perf_func(*args)
    _REF_EVENT_RECORD(end)
    end.synchronize()
    ms = _REF_EVENT_ELAPSED(start, end)
    _REF_SYNCHRONIZE()  # drain whatever the call left on other streams, outside the window
    return float(ms)


def _sync_ms(perf_func: Callable, args: tuple, on_card: bool) -> float:
    _wait(on_card)
    t0 = _REF_PERF_COUNTER()
    perf_func(*args)
    _wait(on_card)
    return (_REF_PERF_COUNTER() - t0) * 1e3


def _host_ms(perf_func: Callable, args: tuple) -> float:
    t0 = _REF_PERF_COUNTER()
    perf_func(*args)
    return (_REF_PERF_COUNTER() - t0) * 1e3


def _stream_run(perf_func: Callable, args: tuple, iters: int, ratio: float,
                floor_ms: float, seed: int) -> dict:
    """One hybrid-timing run: medians of ``iters`` event- and sync-timed calls."""
    on_card = _on_card(args)
    perf_func(*args)
    _wait(on_card)
    costs = []
    for _ in range(5):  # a synchronize on an empty queue, discounted below
        t0 = _REF_PERF_COUNTER()
        _wait(on_card)
        costs.append((_REF_PERF_COUNTER() - t0) * 1e3)
    sync_cost = float(np.median(costs))
    order = ["e", "s"] * iters
    np.random.default_rng(seed).shuffle(order)
    event, sync = [], []
    for tag in order:
        if tag == "s":
            sync.append(_sync_ms(perf_func, args, on_card))
        elif on_card:
            event.append(_event_ms(perf_func, args))
        else:
            event.append(_host_ms(perf_func, args))
    me, ms = float(np.median(event)), float(np.median(sync))
    ms_adj = max(ms - sync_cost, me)
    hidden = ms_adj - me
    # host ops run in order on the host clock: with no card there is no stream to hide on
    flagged = on_card and ms_adj / max(me, 1e-9) > ratio and hidden > floor_ms
    return {"event_ms": me, "sync_ms": ms, "sync_cost_ms": sync_cost,
            "sync_adj_ms": ms_adj, "ratio": ms_adj / max(me, 1e-9), "hidden_ms": hidden,
            "flagged": bool(flagged)}


def defend_against_stream_injection(perf_func: Callable, args: tuple,
                                    runs: int = STREAM_RUNS, iters: int = STREAM_ITERS,
                                    ratio: float = RATIO,
                                    floor_ms: float = HIDDEN_FLOOR_MS) -> dict:
    """Flag a function whose work escapes event timing on the current stream.

    ``runs`` hybrid-timing runs; the check fails where more than half of them flag.
    ``authoritative_ms`` is the median sync time (less a synchronize's cost) where the
    check fails, else the median event time."""
    res = [_stream_run(perf_func, args, iters, ratio, floor_ms, seed=r) for r in range(runs)]
    n_flagged = sum(r["flagged"] for r in res)
    failed = 2 * n_flagged > runs
    event = float(np.median([r["event_ms"] for r in res]))
    sync_adj = float(np.median([r["sync_adj_ms"] for r in res]))
    return {"name": "stream_injection", "pass": not failed,
            "clock": "cuda_event" if _on_card(args) else "host",
            "runs_flagged": n_flagged, "runs": res, "event_ms": event,
            "sync_ms": float(np.median([r["sync_ms"] for r in res])),
            "ratio": sync_adj / max(event, 1e-9), "ratio_limit": ratio,
            "floor_ms": floor_ms, "authoritative_ms": sync_adj if failed else event}


def _storage_covers(out: torch.Tensor) -> bool:
    if out.numel() == 0:
        return True
    extent = out.storage_offset() + 1 + sum((s - 1) * st
                                            for s, st in zip(out.shape, out.stride()))
    return out.untyped_storage().nbytes() >= extent * out.element_size()


def defend_against_lazy_evaluation(perf_func: Callable, args: tuple,
                                   expected_shape: Optional[tuple] = None) -> dict:
    """The output must be a materialised ``torch.Tensor`` on the inputs' device."""
    out = perf_func(*args)
    tensor = type(out) is torch.Tensor
    checks = {"is_plain_tensor": tensor, "not_meta": tensor and not out.is_meta,
              "on_input_device": tensor and out.device == args[0].device,
              "storage_covers": False, "nonzero_data_ptr": False}
    if checks["not_meta"]:
        try:
            checks["storage_covers"] = _storage_covers(out)
            checks["nonzero_data_ptr"] = out.data_ptr() != 0
        except RuntimeError:  # a storage that cannot be read is not materialised
            pass
    if expected_shape is not None:
        checks["shape_ok"] = tensor and tuple(out.shape) == tuple(expected_shape)
    return {"name": "lazy_evaluation", "pass": all(checks.values()), **checks}


def defend_against_precision_downgrade(perf_func: Callable, args: tuple,
                                       expected_dtype: torch.dtype) -> dict:
    """The output's dtype must be the contract's."""
    out = perf_func(*args)
    actual = getattr(out, "dtype", None)
    return {"name": "precision_downgrade", "pass": actual == expected_dtype,
            "expected": str(expected_dtype).removeprefix("torch."),
            "actual": str(actual).removeprefix("torch.")}


def defend_against_monkey_patching() -> dict:
    """The timing and fencing primitives must be the originals."""
    checks = {
        "torch.cuda.Event.record": torch.cuda.Event.record is _REF_EVENT_RECORD,
        "torch.cuda.Event.elapsed_time": torch.cuda.Event.elapsed_time is _REF_EVENT_ELAPSED,
        "torch.cuda.synchronize": torch.cuda.synchronize is _REF_SYNCHRONIZE,
        "time.perf_counter": time.perf_counter is _REF_PERF_COUNTER,
        "time.sleep": time.sleep is _REF_SLEEP,
    }
    return {"name": "monkey_patching", "pass": all(checks.values()), **checks}


def run_all_defenses(perf_func: Callable, args: tuple,
                     expected_dtype: Optional[torch.dtype] = None,
                     expected_shape: Optional[tuple] = None,
                     which: Sequence[str] = NAMES) -> dict:
    """Run the checks in ``which`` on ``perf_func(*args)``.

    ``args`` is the harness ABI's (a, b, b_t); the contract defaults to the operands'
    dtype and the (M, N) of a @ b.  Returns ``{"pass", "defenses"}``; where the stream
    check fails, its ``authoritative_ms`` is the time to trust."""
    if expected_dtype is None:
        expected_dtype = args[0].dtype
    if expected_shape is None:
        expected_shape = (args[0].shape[0], args[1].shape[1])
    results = []
    for name in which:
        if name == "monkey_patching":
            results.append(defend_against_monkey_patching())
        elif name == "thread_injection":
            results.append(defend_against_thread_injection(perf_func, args))
        elif name == "stream_injection":
            results.append(defend_against_stream_injection(perf_func, args))
        elif name == "lazy_evaluation":
            results.append(defend_against_lazy_evaluation(perf_func, args, expected_shape))
        elif name == "precision_downgrade":
            results.append(defend_against_precision_downgrade(perf_func, args,
                                                              expected_dtype))
        else:
            raise ValueError(f"unknown defense {name!r}; choose from {NAMES}")
    return {"pass": all(r["pass"] for r in results), "defenses": results}
