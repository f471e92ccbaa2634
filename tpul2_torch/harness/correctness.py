"""Bit-exact correctness gate — the reference's 0/1 check, on torch.

Counterpart of ``tpul2/harness/correctness.py`` (reference
``zero_one_correctness_check.py``): 0/1-valued inputs make the bf16 product an integer
computation, every function (candidate and baselines) is compared with a CPU f32 truth
computed by numpy, entries whose truth exceeds the output's integer-exactness bound are
masked, and the candidate's average max-diff must be exactly 0.0.

Guard bands (reference ``:98-149``): the candidate writes C through ``out=`` into a view
in the middle of one buffer with GUARD elements on each side filled with a sentinel
value.  The bands are checked after every iteration; a changed element fails the gate
with "memory overflow detected.".  The Hopper kernel predicates its own stores and
writes into caller memory, so the bands test the kernel itself.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tpul2_torch.config import KernelConfig
from tpul2_torch.dispatch import candidate_fn, resolve_config
from tpul2_torch.ops.baselines import BASELINES
from tpul2_torch.utils.platform import check_device, device_name

#: Largest integer exactly representable for each output dtype's mantissa.
EXACT_BOUND = {
    "bfloat16": 256,
    "float16": 2048,
    "float32": 1 << 24,
}

#: Target expected dot-product magnitude for the density rule.
_DENSITY_TARGET = 64.0

#: Elements of guard band on each side of C, and the value they hold (exact in bf16).
GUARD = 16384
SENTINEL = 131072.0

CANDIDATE = "tpul2_torch"


def _name(dtype) -> str:
    return dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")


def zero_one_density(k: int, out_dtype="bfloat16") -> float:
    """Bernoulli density p for {0,1} draws keeping E[dot] = K·p² ≲ bound/4."""
    if EXACT_BOUND[_name(out_dtype)] >= 1 << 24:
        return 0.5  # f32 out: everything is exact anyway
    return min(0.5, math.sqrt(_DENSITY_TARGET / max(k, 1)))


def _draw_01(rng: np.random.Generator, shape, p: float) -> np.ndarray:
    return (rng.random(shape) < p).astype(np.float32)


def _to(x: np.ndarray, device, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def guarded_output(shape: tuple, dtype: torch.dtype, device) -> tuple:
    """(buffer, C): C is a contiguous view in the middle of a sentinel-filled buffer."""
    size = math.prod(shape)
    buf = torch.full((2 * GUARD + size,), SENTINEL, dtype=dtype, device=device)
    return buf, buf[GUARD:GUARD + size].view(shape)


def bands_intact(buf: torch.Tensor) -> bool:
    return bool((buf[:GUARD] == SENTINEL).all() and (buf[-GUARD:] == SENTINEL).all())


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def compare_with_cpu_f32(m: int, n: int, k: int,
                         acc: str = "float32",
                         out_dtype: torch.dtype = torch.bfloat16,
                         iterations: int = 100,
                         time_cap_s: float = 60.0,
                         seed: int = 0,
                         funcs: Optional[dict] = None,
                         device: str = "cuda",
                         mode: str = "offline") -> dict:
    """Run candidate + baselines against the CPU f32 truth; return per-function stats.

    ``funcs`` maps names to ``f(a, b, b_t, out=None)``-style callables; the entry named
    ``CANDIDATE`` writes through ``out=`` into a guarded buffer, the others return.  The
    default candidate is ``candidate_fn(acc, mode)``: in server mode, the server twin."""
    bound = EXACT_BOUND[_name(out_dtype)] if acc == "float32" else \
        min(EXACT_BOUND[_name(out_dtype)], EXACT_BOUND[acc])
    p = zero_one_density(k, out_dtype if acc == "float32" else acc)
    if funcs is None:
        funcs = dict(BASELINES)
        funcs[CANDIDATE] = candidate_fn(acc, mode)

    rng = np.random.default_rng(seed)
    diffs = {name: [] for name in funcs}
    nan_inf = {name: False for name in funcs}
    guard_hits = 0
    t_end = time.time() + time_cap_s
    iters_done = 0
    mask = None
    for _ in range(iterations):
        if time.time() > t_end:
            break
        a_np, b_np = _draw_01(rng, (m, k), p), _draw_01(rng, (k, n), p)
        a, b = _to(a_np, device), _to(b_np, device)
        b_t = b.t().contiguous()
        truth = a_np @ b_np
        mask = np.abs(truth) <= bound
        for name, fn in funcs.items():
            if name == CANDIDATE:
                buf, c = guarded_output((m, n), out_dtype, device)
                fn(a, b, b_t, out=c)
                guard_hits += 0 if bands_intact(buf) else 1
            else:
                c = fn(a, b, b_t)
            out = _host(c)
            if not np.all(np.isfinite(out)):
                nan_inf[name] = True
            d = np.abs(out - truth)
            d[~mask] = 0.0
            diffs[name].append(float(d.max()) if d.size else 0.0)
        iters_done += 1

    return {
        "iterations": iters_done,
        "density": p,
        "exact_bound": bound,
        "masked_frac": float((~mask).mean()) if iters_done else None,
        "avg_max_diff": {name: float(np.mean(d)) if d else None
                         for name, d in diffs.items()},
        "nan_or_inf": nan_inf,
        "guard_iterations": iters_done if CANDIDATE in funcs else 0,
        "guard_hits": guard_hits,
    }


def gate_kernel_variants(m: int, n: int, k: int,
                         config: Optional[KernelConfig] = None,
                         acc: str = "float32",
                         seed: int = 0,
                         batch: int = 2,
                         device: str = "cuda",
                         mode: str = "offline") -> dict:
    """Exactness over every kernel entry point: plain NN, TN (b_t read directly), fused
    bias + relu (integer-exact on 0/1 inputs) and batched, each against the CPU f32 truth,
    each writing into a guarded buffer.  A wide block has no batched kernel (the batched
    entry point never runs one): its batched check is left out, with the reason under
    ``batched_skipped``."""
    from tpul2_torch.ops.batched import cuda_batched_matmul
    from tpul2_torch.ops.matmul import cuda_matmul, cuda_matmul_fused, cuda_matmul_tn

    cfg = config or resolve_config(m, n, k, acc, mode=mode)
    if cfg.use_vendor:
        return {"pass": True, "skipped": "vendor sentinel config"}
    rng = np.random.default_rng(seed)
    p = zero_one_density(k, "float32" if acc == "float32" else acc)
    a_np, b_np = _draw_01(rng, (m, k), p), _draw_01(rng, (k, n), p)
    a, b = _to(a_np, device), _to(b_np, device)
    truth = a_np @ b_np
    bound = EXACT_BOUND["float32"] if acc == "float32" else EXACT_BOUND[acc]
    guard_hits = 0

    def exact(run, shape, ref) -> bool:
        nonlocal guard_hits
        buf, c = guarded_output(shape, torch.float32, device)
        run(c)
        guard_hits += 0 if bands_intact(buf) else 1
        keep = np.abs(ref) <= bound
        return bool(np.array_equal(_host(c)[keep], ref[keep]))

    cfg_nn = dataclasses.replace(cfg, rhs_layout="kn")
    cfg_tn = dataclasses.replace(cfg, rhs_layout="nk")
    checks = {}
    checks["plain_nn"] = exact(lambda c: cuda_matmul(a, b, cfg_nn, out=c), (m, n), truth)
    b_t = b.t().contiguous()
    checks["tn"] = exact(lambda c: cuda_matmul_tn(a, b_t, cfg_tn, out=c), (m, n), truth)
    bias_np = _draw_01(rng, (n,), 0.5)
    bias = _to(bias_np, device, torch.float32)
    checks["fused_bias_relu"] = exact(
        lambda c: cuda_matmul_fused(a, b, bias=bias, activation="relu", config=cfg_nn,
                                    out=c),
        (m, n), np.maximum(truth + bias_np, 0.0))
    skipped = {}
    if cfg.wide:
        skipped["batched_skipped"] = "wide block: the batched kernel has no wide blocks"
    else:
        ab_np, bb_np = _draw_01(rng, (batch, m, k), p), _draw_01(rng, (batch, k, n), p)
        ab, bb = _to(ab_np, device), _to(bb_np, device)
        checks["batched"] = exact(lambda c: cuda_batched_matmul(ab, bb, cfg_nn, out=c),
                                  (batch, m, n), np.matmul(ab_np, bb_np))
    ok = all(checks.values()) and guard_hits == 0
    return {"pass": ok, "guard_hits": guard_hits, **checks, **skipped}


def run_correctness_check(m: int, n: int, k: int,
                          acc: str = "float32",
                          iterations: int = 100,
                          time_cap_s: float = 60.0,
                          seed: int = 0,
                          result_path: Optional[str] = None,
                          device: str = "cuda",
                          funcs: Optional[dict] = None,
                          mode: str = "offline") -> dict:
    """Full gate: exactness + guard bands for the candidate, cross-checks of the
    baselines, and every kernel variant.

    Pass criterion (reference :242-268): the candidate's average max-diff is exactly 0.0
    and free of NaN/Inf, no guard band was ever touched, and every variant is exact.
    Baselines are reported, not gated on.  Without a card it raises unless
    ``device='cpu'``."""
    check_device(device, "the gate checks the card's kernels")
    stats = compare_with_cpu_f32(m, n, k, acc, iterations=iterations,
                                 time_cap_s=time_cap_s, seed=seed, funcs=funcs,
                                 device=device, mode=mode)
    variants = gate_kernel_variants(m, n, k, acc=acc, seed=seed, device=device, mode=mode)
    cand_diff = stats["avg_max_diff"][CANDIDATE]
    cand_ok = cand_diff == 0.0 and not stats["nan_or_inf"][CANDIDATE]
    guard_ok = stats["guard_hits"] == 0 and variants.get("guard_hits", 0) == 0
    result = {
        "mnk": [m, n, k],
        "acc": acc,
        "mode": mode,
        "in_dtype": "bfloat16",
        "device": device_name(device),
        "pass": bool(cand_ok and guard_ok and variants["pass"]),
        "candidate_avg_max_diff": cand_diff,
        "variants": variants,
        "stats": stats,
    }
    if not guard_ok:
        result["failure"] = "memory overflow detected."
    elif not cand_ok:
        result["failure"] = (f"candidate avg max diff {cand_diff} != 0.0"
                             if not stats["nan_or_inf"][CANDIDATE] else "NaN/Inf in output")
    elif not variants["pass"]:
        bad = [kk for kk, v in variants.items() if kk != "pass" and v is False]
        result["failure"] = f"kernel variant(s) not exact: {bad}"
    if result_path:
        Path(result_path).parent.mkdir(parents=True, exist_ok=True)
        Path(result_path).write_text(json.dumps(result, indent=1))
    return result
