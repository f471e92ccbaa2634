"""Offline (max-throughput) benchmark: the candidate against the torch baselines.

Counterpart of ``tpul2/harness/bench_offline.py`` (reference ``benchmarking_offline.py``):
time-boxed warmup and benchmark loops; every iteration draws fresh random operands,
shuffles the order of the functions and times one call of each with CUDA events.  One
``benchmark_result_<perf_func>.json`` per baseline, with the JAX package's schema
(``per_call_ms``, ``tflops_mean``, ``tflops_median``, ``speedup``) plus the device.

``_run_mode`` is the engine of both modes: the server bench (``bench_server.py``) is this
loop with a Poisson gap after every iteration (``between_iterations``), measuring the
server twin of the candidate, so the two cannot drift apart.  The cuBLASLt auto-tuning
baselines are searched before any timing (the reference's pre-tune,
``benchmarking_offline.py:71-84``).
"""

from __future__ import annotations

import json
import random
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from tpul2_torch.dispatch import candidate_fn
from tpul2_torch.harness import bench_utils as bu
from tpul2_torch.harness.correctness import CANDIDATE
from tpul2_torch.ops import lt_autotune
from tpul2_torch.ops.baselines import BASELINES
from tpul2_torch.utils.platform import check_device, device_name

#: The baselines searched before timing, and the layout each searches.
AUTOTUNED = {"cublaslt_autotuned_nn": "nn", "cublaslt_autotuned_tn": "tn"}


def _one_iteration(funcs: dict, rng: np.random.Generator, order_rng: random.Random,
                   m: int, n: int, k: int, device: str) -> dict:
    data = bu.fresh_inputs(rng, m, n, k, device=device)
    order = list(funcs)
    order_rng.shuffle(order)
    return {name: bu.time_call_ms(funcs[name], data) for name in order}


def _run_mode(mode: str, m: int, n: int, k: int, perf_funcs, acc: str,
              warmup_seconds: float, benchmark_seconds: float, seed: int, device: str,
              between_iterations: Optional[Callable[[], None]] = None) -> dict:
    """Time the candidate (``candidate_fn(acc, mode)``) and the baselines in one shuffled
    loop, ``between_iterations()`` after every warmup and benchmark iteration; return the
    per-baseline results."""
    check_device(device, "the bench times the card")
    perf_funcs = list(BASELINES) if perf_funcs is None else list(perf_funcs)
    for pf in perf_funcs:
        if pf not in BASELINES:
            raise ValueError(f"unknown perf_func {pf}; choose from {list(BASELINES)}")
        if pf in AUTOTUNED and device == "cuda":
            lt_autotune.search(m, n, k, AUTOTUNED[pf], seed=seed)
    funcs = {CANDIDATE: candidate_fn(acc, mode)}
    funcs.update({pf: BASELINES[pf] for pf in perf_funcs})
    rng = np.random.default_rng(seed)
    order_rng = random.Random(seed)

    t_end = time.time() + warmup_seconds
    while True:  # at least one warmup iteration, then time-boxed
        _one_iteration(funcs, rng, order_rng, m, n, k, device)
        if between_iterations is not None:
            between_iterations()
        if time.time() >= t_end:
            break

    records = {name: [] for name in funcs}
    t_end = time.time() + benchmark_seconds
    while True:
        for name, ms in _one_iteration(funcs, rng, order_rng, m, n, k, device).items():
            records[name].append(ms)
        if between_iterations is not None:
            between_iterations()
        if time.time() >= t_end:
            break

    collected = {}
    for name, ms_list in records.items():
        stats = bu.percentile_stats(ms_list)
        collected[name] = {
            **stats,
            "per_call_ms": stats["median_ms"],
            "tflops_mean": bu.tflops(m, n, k, stats["mean_ms"]),
            "tflops_median": bu.tflops(m, n, k, stats["median_ms"]),
        }
    results = {}
    for pf in perf_funcs:
        result = {
            "mode": mode,
            "mnk": [m, n, k],
            "acc": acc,
            "in_dtype": "bfloat16",
            "perf_func": pf,
            "version": bu.VERSION_STAMP,
            "device": device_name(device),
            pf: collected[pf],
            CANDIDATE: collected[CANDIDATE],
            "speedup": collected[pf]["per_call_ms"] / collected[CANDIDATE]["per_call_ms"],
        }
        if pf in AUTOTUNED and device == "cuda":
            found = lt_autotune.search(m, n, k, AUTOTUNED[pf])
            result["cublaslt_search"] = {"n_algos": found.n_algos,
                                         "n_skipped": found.n_skipped, "best": found.best}
        results[pf] = result
    return results


def write_results(results: dict, base_dir: Optional[str]) -> None:
    if base_dir:
        p = Path(base_dir)
        p.mkdir(parents=True, exist_ok=True)
        for pf, result in results.items():
            (p / f"benchmark_result_{pf}.json").write_text(json.dumps(result, indent=1))


def benchmark_offline(m: int, n: int, k: int,
                      perf_func: str,
                      acc: str = "float32",
                      warmup_seconds: float = 2.0,
                      benchmark_seconds: float = 10.0,
                      base_dir: Optional[str] = None,
                      seed: int = 0,
                      device: str = "cuda") -> dict:
    """Time the candidate against one baseline (the reference's one process per
    perf_func); write and return its result."""
    return benchmark_offline_all(m, n, k, [perf_func], acc, warmup_seconds,
                                 benchmark_seconds, base_dir, seed, device)[perf_func]


def benchmark_offline_all(m: int, n: int, k: int,
                          perf_funcs=None,
                          acc: str = "float32",
                          warmup_seconds: float = 2.0,
                          benchmark_seconds: float = 10.0,
                          base_dir: Optional[str] = None,
                          seed: int = 0,
                          device: str = "cuda") -> dict:
    """Time the candidate and each baseline in one shuffled loop; write and return the
    per-baseline results."""
    results = _run_mode("offline", m, n, k, perf_funcs, acc, warmup_seconds,
                        benchmark_seconds, seed, device)
    write_results(results, base_dir)
    return results
