"""The cuBLASLt auto-tuning baseline: a per-shape search over cuBLASLt's heuristic algos.

The reference's C12 (``cublas/fp32/hgemm_cublaslt_auto_tuning.cu``): ask
``cublasLtMatmulAlgoGetHeuristic`` for up to ``MAX_ALGOS`` algos of the shape, time them
over rounds of fresh normal data in a shuffled order (one untimed call of the
shuffled-last algo first, then CUDA events per algo), keep the algo with the least median
as the shape's winner, and run the winner from then on.  The search and the launches are
``csrc/tl2_lt_autotune.cu`` (host code only, built with the kernels); the rounds are
driven from here.  It is a measuring baseline, never called by the port's dispatch.

The reference times 50 warmup and 100 timed rounds; the counts here are fixed at
``WARMUP_ROUNDS`` and ``TIMED_ROUNDS``, with no calibration.  A caller that must bound the
search's cost (the lean campaign engine, at shapes up to 16384^3, where one round of 100
algos takes over a second) passes ``budget_ms``: one warmup round, then as many timed
rounds as the algos' summed times of that round fit in the budget, at least
``MIN_TIMED_ROUNDS`` and at most ``TIMED_ROUNDS``.  The workspace is
``WORKSPACE_BYTES``, allocated once through torch's allocator (the reference's 20 GB is
far beyond what any algo asks on Hopper); an algo that needs more is skipped and counted.

On the CPU the baseline runs as ``torch.mm``: a labelled CPU path, as every baseline's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import random
import time

import numpy as np
import torch

from tpul2_torch.ops._build import load_library

MAX_ALGOS = 100
WARMUP_ROUNDS = 5
TIMED_ROUNDS = 20
#: The fewest timed rounds of a search bounded by ``budget_ms``.
MIN_TIMED_ROUNDS = 3
WORKSPACE_BYTES = 64 << 20
#: Pointer alignment the heuristic's algos assume (cuBLASLt's default preference).
ALIGN_BYTES = 256


@dataclasses.dataclass
class LtSearch:
    """One shape's search: the algos kept and skipped, the winner, every algo's median."""
    m: int
    n: int
    k: int
    layout: str
    out_dtype: str
    n_algos: int
    n_skipped: int
    best: int
    medians_ms: list
    seconds: float
    timed_rounds: int = TIMED_ROUNDS


_SEARCHES: dict = {}
_WORKSPACE: dict = {}


def select_winner(rounds_ms: list) -> tuple:
    """(index of the least median, the medians) over rounds of per-algo times; the first
    such algo on a tie."""
    medians = [float(x) for x in np.median(np.asarray(rounds_ms, np.float64), axis=0)]
    return int(np.argmin(medians)), medians


def bounded_rounds(budget_ms: float, round_ms: float) -> int:
    """Timed rounds of a search bounded by ``budget_ms``, one round taking ``round_ms``."""
    return max(MIN_TIMED_ROUNDS, min(TIMED_ROUNDS, int(budget_ms / max(round_ms, 1e-6))))


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: error {err} (a cudaError_t, or 1000 + a "
                           "cublasStatus_t)")


def _key(m: int, n: int, k: int, layout: str, out_dtype: torch.dtype) -> tuple:
    if layout not in ("nn", "tn"):
        raise ValueError(f"layout must be 'nn' or 'tn', got {layout!r}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    return (m, n, k, int(layout == "tn"), int(out_dtype == torch.float32))


def _workspace(device: torch.device) -> torch.Tensor:
    ws = _WORKSPACE.get(device)
    if ws is None:
        ws = _WORKSPACE[device] = torch.empty(WORKSPACE_BYTES, dtype=torch.uint8,
                                              device=device)
    return ws


def _stream(device: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(device.index)


def search(m: int, n: int, k: int, layout: str, out_dtype: torch.dtype = torch.bfloat16,
           device="cuda", seed: int = 0, budget_ms: float | None = None) -> LtSearch:
    """The shape's search, run once per process and kept (whatever budget a later call
    names); raises if cuBLASLt refuses the shape or an algo fails to launch.
    ``budget_ms`` bounds the timed rounds' summed algo time (module docstring)."""
    key = _key(m, n, k, layout, out_dtype)
    found = _SEARCHES.get(key)
    if found is not None:
        return found
    from tpul2_torch.harness.bench_utils import fresh_inputs
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the cuBLASLt search runs on the card")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lib = load_library()
    t0 = time.perf_counter()
    ws = _workspace(device)
    n_algos, n_skipped = ctypes.c_int(), ctypes.c_int()
    _check(lib.tl2_lt_prepare(*key, WORKSPACE_BYTES, MAX_ALGOS, ctypes.byref(n_algos),
                              ctypes.byref(n_skipped)), "cublasLt heuristic")
    count = n_algos.value
    rng, order_rng = np.random.default_rng(seed), random.Random(seed)
    out = torch.empty((m, n), dtype=out_dtype, device=device)

    def one_round() -> list:
        """Every algo once, in a shuffled order, on fresh inputs: each one's ms."""
        a, b, b_t = fresh_inputs(rng, m, n, k, device=device)
        order = list(range(count))
        order_rng.shuffle(order)
        ms = (ctypes.c_float * count)()
        _check(lib.tl2_lt_time_round(*key, a.data_ptr(),
                                     (b_t if layout == "tn" else b).data_ptr(),
                                     out.data_ptr(), ws.data_ptr(), WORKSPACE_BYTES,
                                     (ctypes.c_int * count)(*order), count, ms,
                                     _stream(device)), "cublasLt timing round")
        return list(ms)

    with torch.cuda.device(device):
        warm = [one_round() for _ in range(WARMUP_ROUNDS if budget_ms is None else 1)]
        timed = TIMED_ROUNDS if budget_ms is None else bounded_rounds(budget_ms, sum(warm[-1]))
        rounds = [one_round() for _ in range(timed)]
    best, medians = select_winner(rounds)
    _check(lib.tl2_lt_select(*key, best), "cublasLt select")
    found = _SEARCHES[key] = LtSearch(m, n, k, layout, str(out_dtype).removeprefix("torch."),
                                      count, n_skipped.value, best, medians,
                                      time.perf_counter() - t0, len(rounds))
    return found


def lt_matmul(a: torch.Tensor, rhs: torch.Tensor, layout: str,
              out_dtype: torch.dtype = torch.bfloat16, algo: int = -1) -> torch.Tensor:
    """C = A @ B through the shape's searched winner (``algo=-1``) or one of its algos.

    a (M, K) bf16; rhs the (K, N) B for 'nn' or the (N, K) B_t for 'tn'.  On the card the
    shape is searched at its first call; on the CPU this is ``torch.mm``."""
    if layout not in ("nn", "tn"):
        raise ValueError(f"layout must be 'nn' or 'tn', got {layout!r}")
    b = rhs.t() if layout == "tn" else rhs
    if not a.is_cuda:
        return torch.mm(a.float(), b.float()).to(out_dtype) if out_dtype != a.dtype \
            else torch.mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    if (a.dtype, rhs.dtype) != (torch.bfloat16, torch.bfloat16) or b.shape[0] != k \
            or not (a.is_contiguous() and rhs.is_contiguous()) or rhs.device != a.device:
        raise ValueError(f"cuBLASLt baseline takes contiguous bf16 operands on one device, "
                         f"got {tuple(a.shape)} {a.dtype} and {tuple(rhs.shape)} {rhs.dtype}")
    if a.data_ptr() % ALIGN_BYTES or rhs.data_ptr() % ALIGN_BYTES:
        raise ValueError(f"cuBLASLt baseline needs {ALIGN_BYTES}-byte aligned operands")
    key = _key(m, n, k, layout, out_dtype)
    search(m, n, k, layout, out_dtype, a.device)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _check(load_library().tl2_lt_matmul(*key, algo, a.data_ptr(), rhs.data_ptr(),
                                        out.data_ptr(), _workspace(a.device).data_ptr(),
                                        WORKSPACE_BYTES, _stream(a.device)),
           "cublasLt matmul")
    return out
