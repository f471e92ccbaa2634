"""Server (Poisson-arrival) benchmark: the candidate's server twin against the baselines.

Counterpart of ``tpul2/harness/bench_server.py`` and of the reference's
``benchmarking_server.py`` (its C6): the offline loop (``bench_offline._run_mode``) with
``time.sleep(Exponential(1 / target_qps))`` after every warmup and benchmark iteration, so
requests arrive as a Poisson process and each call lands on a card that has gone idle:
the cold-ish, latency-shaped regime.  Each call is timed alone between CUDA events, one
call per request, the reference's own method.  The JAX package's chained-request engine
(``tpul2/harness/bench_suite.py``) works around a TPU fence floor the card does not have,
and is not carried over.  ``benchmark_result_<pf>.json`` holds p50 and p99 of the per-call
times of each function and ``target_qps``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from tpul2_torch.harness.bench_offline import _run_mode, write_results


def benchmark_server(m: int, n: int, k: int,
                     perf_func: str,
                     target_qps: float,
                     acc: str = "float32",
                     warmup_seconds: float = 2.0,
                     benchmark_seconds: float = 10.0,
                     base_dir: Optional[str] = None,
                     seed: int = 0,
                     device: str = "cuda") -> dict:
    """The server twin against one baseline under Poisson arrivals; write and return its
    result."""
    return benchmark_server_all(m, n, k, target_qps, [perf_func], acc, warmup_seconds,
                                benchmark_seconds, base_dir, seed, device)[perf_func]


def benchmark_server_all(m: int, n: int, k: int,
                         target_qps: float,
                         perf_funcs=None,
                         acc: str = "float32",
                         warmup_seconds: float = 2.0,
                         benchmark_seconds: float = 10.0,
                         base_dir: Optional[str] = None,
                         seed: int = 0,
                         device: str = "cuda") -> dict:
    """Candidate (``candidate_fn(acc, 'server')``) vs the baselines under Poisson
    arrivals; write and return the per-baseline results.  Raises unless target_qps > 0,
    and without a card unless ``device='cpu'``."""
    if not target_qps > 0:
        raise ValueError(f"target_qps must be > 0 in server mode, got {target_qps} "
                         "(reference benchmarking_server.py:30)")
    gaps = np.random.default_rng((seed, 1))

    def poisson_gap():
        time.sleep(float(gaps.exponential(1.0 / target_qps)))

    results = _run_mode("server", m, n, k, perf_funcs, acc, warmup_seconds,
                        benchmark_seconds, seed, device, between_iterations=poisson_gap)
    for r in results.values():
        r["target_qps"] = target_qps
    write_results(results, base_dir)
    return results
