#!/usr/bin/env python3
"""Chip smoke test of tpul2_torch on one H100: build, check and drive the main path.

Run from the repository root, on a machine with one Hopper card:

    python3 chip_smoke.py [--json_out PATH]

Phases (each prints one line; any failure raises and the exit code is non-zero):
  0  require an sm_90 card; print the environment record and nvidia-smi's name/power line
  1  build csrc/*.cu for sm_90a (nvcc, one process per source, at first use), print the
     build time and ptxas report; the shared-memory models of config.py and ops/matmul.py
     must equal the kernels' own counts for every tile (and depth) they take, and
     tl2_wgmma_route must agree with ops.matmul.multi_k_route over a grid of shapes,
     tiles, bk, layouts and operand alignments
  2  kernel vs plain torch version on the card over the grid
     {f32, bf16 acc} x {kn, nk} x {gk == 1, gk > 1} x {aligned, unaligned}
     x {no epilogue, bias + gelu|silu|tanh}, plus batched (B = 3), at the main-path
     shapes, and with long K intervals (bk = K = 8192, bk = 4096); then the wgmma route
     over {f32, bf16 acc} x {kn, nk} x {64, 128}^2 tiles x {aligned, M/N/K edges with
     K % 64 != 0} x {plain, bias + act}, batched (B = 3) with M % BM != 0, and long
     intervals (4096^3 at bk 2048, 128x8192x8192 at bk 4096), each case required to take
     the wgmma route: 0/1 inputs must agree exactly (the epilogue cases then use
     bias + relu, since no library's tanh is correctly rounded), normal inputs within
     ops.matmul.allowed_error; and the max |error| against an f64 product at 4096^3 of
     both multi-K bodies and of cuBLAS's f32 product
  2b the staged kernel vs its plain version over {f32, bf16 acc} x {kn, nk} x depth
     {2, 3, 4, 6, 8} x tiles x {bf16, f32 out}, the depth clamp (gk < depth), gk == 1
     (which must not launch it), and the tuning shape's staged candidates: 0/1 inputs
     exact, normal inputs within allowed_error(..., bk=K, acc_dtype='float32')
  3  the slice: scripts/eval_one_shape_torch.py's main() for the bring-up shapes
     (gate with guard bands -> offline bench -> summary); every gate must pass
  4  the launch counters, zeroed just before phase 3, must show every kernel body of the
     heuristic path ran, both routes of both multi-K bodies included (4096^3 and its
     batched gate variant take wgmma, 64x8192x8192's 32x64 tile mma.sync)
  tune  `python -m tpul2_torch.autotune` (its main()) for 64x8192x8192 f32 into
     runs/chip_smoke/tunedb_h100.json, with few candidates and rounds: every candidate
     must launch, at least two staged candidates must be timed, the staged kernel must
     have launched, and the entry must be on disk
  tuned dispatch  a DB holding the tune's fastest staged candidate for both families at
     64x8192x8192 (runs/chip_smoke/tunedb_staged.json, via TPUL2_TORCH_TUNEDB), then
     eval_one_shape_torch's main() for both: every gate must pass with 0 guard hits, and
     the staged kernel must launch on this path
  5  per-kernel times on the card against the plain version and torch.matmul, with the
     bound of each (the larger of bytes over 3.35 TB/s and FLOPs over 989 TFLOP/s): the
     two routes of each multi-K body at 4096^3 (and 2 x 4096^3) on the same 128x128 tile,
     timed in turns (the mma.sync one launched through lib.tl2_matmul_*out directly),
     the single-K bodies, the staged kernel and its time at every depth on the dispatched
     tile, the 64-row wgmma tiles against the heuristic's mma.sync 32x64 at
     64x8192x8192, and for each bring-up shape the entry point's time back to back and
     its host time per call
The last two lines are the per-kernel JSON record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import sys
import time
from pathlib import Path

#: Bring-up shapes (bench.py DEFAULT_SHAPES and its large-square probe) and families.
SLICE_SHAPES = [
    ((4096, 4096, 4096), "float32"),   # square headline, multi-K
    ((64, 8192, 8192), "float32"),     # skinny serving shape, long K loop
    ((8192, 128, 64), "float32"),      # thin-K: gk == 1
    ((1000, 1000, 1000), "float32"),   # unaligned: predicated edges
    ((1000, 1000, 1000), "bfloat16"),
]
GATE_BATCH = 2   # the gate's batched variant (harness.correctness.gate_kernel_variants)
GRID_BATCH = 3
#: The tuning path's shape: the skinny serving shape, where the kStage axis competes.
TUNE_SHAPE = (64, 8192, 8192)
#: Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, HBM rate.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)", flush=True)
        raise
    print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def _inputs(torch, gen, shape, zero_one: bool):
    if zero_one:
        return torch.randint(0, 2, shape, generator=gen, device="cuda").to(torch.bfloat16)
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _grid_cases():
    """(name, batch, m, n, k, cfg kwargs, activation, out dtype name) of phase 2."""
    tiles = [(bm, bn) for bm in (32, 64, 128) for bn in (32, 64, 128)]
    cases = []
    i = 0
    for acc in ("float32", "bfloat16"):
        for gk in ("gk1", "gkN"):
            for aligned in (True, False):
                if aligned:
                    m, n, k, bk = (256, 384, 256, 256) if gk == "gk1" else (256, 384, 1024, 256)
                else:  # odd K takes the scalar loads, N % 8 != 0 the scalar 'kn' loads
                    m, n, k, bk = (200, 300, 203, 224) if gk == "gk1" else (200, 300, 1001, 256)
                for layout in ("kn", "nk"):
                    for epilogue in (False, True):
                        act = ("gelu", "gelu", "silu", "tanh")[i % 4] if epilogue else None
                        bm, bn = tiles[i % len(tiles)]
                        cfg = dict(bm=bm, bn=bn, bk=bk, acc_dtype=acc, rhs_layout=layout,
                                   grid_order="nm" if i % 2 else "mn")
                        out = "float32" if i % 3 else "bfloat16"
                        cases.append((f"2d/{acc}/{layout}/{gk}/{'al' if aligned else 'un'}/"
                                      f"{act or 'plain'}", 1, m, n, k, cfg, act, out))
                        i += 1
                bm, bn = tiles[i % len(tiles)]
                cases.append((f"batched/{acc}/{gk}/{'al' if aligned else 'un'}", GRID_BATCH,
                              m, n, k, dict(bm=bm, bn=bn, bk=bk, acc_dtype=acc), None,
                              "float32"))
                i += 1
    return cases


def _wgmma_cases():
    """(name, batch, m, n, k, cfg kwargs, activation, out dtype name) of phase 2's wgmma
    route grid; each must take the wgmma route."""
    cases = []
    i = 0
    for acc in ("float32", "bfloat16"):
        for layout in ("kn", "nk"):
            for bm in (64, 128):
                for bn in (64, 128):
                    for edge in (False, True):
                        # edges: M % BM, N % BN != 0 and a K tail of 8 (K % 64 != 0)
                        m, n, k = (200, 264, 328) if edge else (256, 384, 512)
                        for epilogue in (False, True):
                            act = ("gelu", "silu", "tanh")[i % 3] if epilogue else None
                            cfg = dict(bm=bm, bn=bn, bk=128, acc_dtype=acc, rhs_layout=layout,
                                       grid_order="nm" if i % 2 else "mn")
                            out = "float32" if i % 3 else "bfloat16"
                            cases.append((f"wgmma/{acc}/{layout}/{'edge' if edge else 'al'}/"
                                          f"{act or 'plain'}", 1, m, n, k, cfg, act, out))
                            i += 1
        for bm, bn in ((64, 128), (128, 64)):  # the rank-3 maps' M edge inside a batch
            cases.append((f"wgmma-batched/{acc}/m-edge", GRID_BATCH, 100, 136, 328,
                          dict(bm=bm, bn=bn, bk=128, acc_dtype=acc), None, "float32"))
    cases.append(("wgmma-long/4096x4096x4096/float32", 1, 4096, 4096, 4096,
                  dict(bm=128, bn=128, bk=2048), None, "float32"))
    cases.append(("wgmma-long/128x8192x8192/float32", 1, 128, 8192, 8192,
                  dict(bm=64, bn=128, bk=4096), None, "float32"))
    return cases


def _check_route_mirror(torch, lib, mm, KernelConfig) -> tuple:
    """tl2_wgmma_route against ops.matmul.multi_k_route over shapes, tiles, bk, layouts and
    operand alignments (views 2, 8 and 16 bytes into one allocation); return (cases,
    wgmma cases).  Raises on the first disagreement."""
    buf = torch.zeros(64, dtype=torch.bfloat16, device="cuda")
    shapes = ((256, 256, 1024), (200, 1001, 328), (64, 8192, 8192), (96, 160, 1004),
              (128, 128, 64))
    n = n_wgmma = 0
    for off_a in (0, 1, 8):
        for off_b in (0, 4):
            a, b = buf[off_a:], buf[off_b:]
            for m, nn, k in shapes:
                for bm in (32, 64, 128):
                    for bn in (32, 64, 128):
                        for bk in (64, 96, 128, 256, 1024, 8192):
                            for layout in ("kn", "nk"):
                                cfg = KernelConfig(bm=bm, bn=bn, bk=bk, rhs_layout=layout)
                                py = mm.multi_k_route(cfg, a, b, m, nn, k) == "wgmma"
                                c = lib.tl2_wgmma_route(m, nn, k, bm, bn, bk,
                                                        int(layout == "nk"), a.data_ptr(),
                                                        b.data_ptr())
                                if py != bool(c):
                                    raise AssertionError(
                                        f"route rule differs at {m}x{nn}x{k} {cfg} "
                                        f"offsets {off_a}, {off_b}: python {py}, C {c}")
                                n += 1
                                n_wgmma += py
    return n, n_wgmma


def _check_case(torch, mods, gen, batch, m, n, k, cfg, act, out_name, zero_one):
    """Run kernel and plain version on the same inputs; return max |diff| (raises if out
    of tolerance)."""
    KernelConfig, mm, bmm = mods
    out_dtype = getattr(torch, out_name)
    batched = batch > 1
    a = _inputs(torch, gen, (batch, m, k) if batched else (m, k), zero_one)
    rhs_shape = (n, k) if cfg.rhs_layout == "nk" else (k, n)
    rhs = _inputs(torch, gen, (batch, *rhs_shape) if batched else rhs_shape, zero_one)
    if zero_one and act is not None:
        act = "relu"  # exact on integers; tanh-based epilogues are checked on normal inputs
    bias = None
    if act is not None:
        bias = (torch.randint(0, 2, (n,), generator=gen, device="cuda").float() if zero_one
                else torch.randn((n,), generator=gen, device="cuda"))
    if batched:
        got = bmm.cuda_batched_matmul(a, rhs, cfg, out_dtype=out_dtype)
        want = bmm.batched_matmul_reference(a, rhs, cfg.bk, cfg.acc_dtype, out_dtype)
    elif act is None:
        wrapper = mm.cuda_matmul_tn if cfg.rhs_layout == "nk" else mm.cuda_matmul
        got = wrapper(a, rhs, cfg, out_dtype=out_dtype)
        want = mm.matmul_reference(a, rhs, cfg.bk, cfg.acc_dtype, cfg.rhs_layout,
                                   out_dtype=out_dtype)
    else:
        b = rhs.t() if cfg.rhs_layout == "nk" else rhs
        got = mm.cuda_matmul_fused(a, b.contiguous(), bias=bias, activation=act, config=cfg,
                                   out_dtype=out_dtype, b_t=rhs if cfg.rhs_layout == "nk"
                                   else None)
        want = mm.matmul_reference(a, rhs, cfg.bk, cfg.acc_dtype, cfg.rhs_layout, bias, act,
                                   out_dtype)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite kernel output")
    if zero_one:
        # exact: every sum is an integer below 2^24, so both round identically
        if diff.max().item() != 0.0:
            raise AssertionError(f"0/1 inputs: max |diff| {diff.max().item()} != 0")
    else:
        tol = mm.allowed_error(a, rhs, cfg.bk, cfg.acc_dtype, cfg.rhs_layout, out_dtype,
                               bias, act)
        bad = (diff > tol).sum().item()
        if bad:
            raise AssertionError(f"normal inputs: {bad} elements beyond tolerance, "
                                 f"max |diff| {diff.max().item()}")
    return diff.max().item()


def _staged_cases(candidate_configs):
    """(name, m, n, k, cfg kwargs, out dtype name, launches) of phase 2b; ``launches`` is
    whether the staged kernel must launch (False where gk == 1 takes the single-K one)."""
    tiles = [(bm, bn) for bm in (32, 64, 128) for bn in (32, 64, 128)]
    cases = []
    i = 0
    for acc in ("float32", "bfloat16"):
        for layout in ("kn", "nk"):
            for depth in (2, 3, 4, 6, 8):
                bm, bn = tiles[i % len(tiles)]
                kw = dict(bm=bm, bn=bn, bk=256, acc_dtype=acc, rhs_layout=layout,
                          pipeline_depth=depth, grid_order="nm" if i % 2 else "mn")
                out = "float32" if i % 3 else "bfloat16"
                cases.append((f"staged/{acc}/{layout}/d{depth}", 256, 384, 2048, kw, out, True))
                i += 1
            # gk = 3 < depth 8: the ring is clamped to 3 slots
            kw = dict(bm=64, bn=128, bk=256, acc_dtype=acc, rhs_layout=layout, pipeline_depth=8)
            cases.append((f"staged-clamp/{acc}/{layout}", 128, 256, 768, kw, "float32", True))
            # gk == 1: the single-K kernel, not the ring
            kw = dict(bm=128, bn=64, bk=512, acc_dtype=acc, rhs_layout=layout, pipeline_depth=4)
            cases.append((f"staged-gk1/{acc}/{layout}", 128, 256, 512, kw, "bfloat16", False))
    m, n, k = TUNE_SHAPE  # the tuning path's staged candidates, at its shape
    for c in candidate_configs(m, n, k, "float32"):
        if c.pipeline_depth >= 2:
            kw = {f: getattr(c, f) for f in ("bm", "bn", "bk", "acc_dtype", "rhs_layout",
                                             "pipeline_depth", "grid_order")}
            cases.append((f"staged-tune/{c.bm}x{c.bn}/{c.rhs_layout}/d{c.pipeline_depth}",
                          m, n, k, kw, "bfloat16", True))
    return cases


def _check_staged(torch, mm, pl, gen, m, n, k, cfg, out_name, zero_one):
    """Run the staged wrapper and its plain version on the same inputs; return max |diff|
    (raises if out of tolerance)."""
    out_dtype = getattr(torch, out_name)
    a = _inputs(torch, gen, (m, k), zero_one)
    rhs = _inputs(torch, gen, (n, k) if cfg.rhs_layout == "nk" else (k, n), zero_one)
    got = pl.cuda_matmul_pipelined(a, rhs, cfg, out_dtype=out_dtype)
    want = pl.pipelined_reference(a, rhs, cfg.rhs_layout, out_dtype)
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite kernel output")
    diff = (got.float() - want.float()).abs()
    if zero_one:
        if diff.max().item() != 0.0:
            raise AssertionError(f"0/1 inputs: max |diff| {diff.max().item()} != 0")
    else:
        tol = mm.allowed_error(a, rhs, k, "float32", cfg.rhs_layout, out_dtype)
        bad = (diff > tol).sum().item()
        if bad:
            raise AssertionError(f"normal inputs: {bad} elements beyond tolerance, "
                                 f"max |diff| {diff.max().item()}")
    return diff.max().item()


def _bound(batch: int, m: int, n: int, k: int, out_bytes: int = 2) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time the card could take for the product:
    each bf16 input read once and the output written once at PEAK_BYTES, or the FLOPs at
    PEAK_FLOPS, whichever is larger."""
    t_ops = 2.0 * batch * m * n * k / PEAK_FLOPS * 1e3
    t_bytes = batch * ((m * k + k * n) * 2 + m * n * out_bytes) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device milliseconds per call over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json_out", default=None, help="also write the detailed record here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from tpul2_torch.autotune import __main__ as tune_cli
    from tpul2_torch.autotune import db as db_mod
    from tpul2_torch.config import PIPELINE_DEPTHS, KernelConfig, candidate_configs
    from tpul2_torch.dispatch import candidate_fn, resolve_config
    from tpul2_torch.ops import baselines
    from tpul2_torch.ops import batched as bmm
    from tpul2_torch.ops import matmul as mm
    from tpul2_torch.ops import pipelined as pl
    from tpul2_torch.ops._build import check_launch, load_library
    from tpul2_torch.utils.platform import device_info, require_hopper

    def zero_counters():
        mm.LAUNCHES_MULTI_K_WGMMA = mm.LAUNCHES_MULTI_K_MMA_SYNC = mm.LAUNCHES_SINGLE_K = 0
        bmm.LAUNCHES_MULTI_K_WGMMA = bmm.LAUNCHES_MULTI_K_MMA_SYNC = 0
        bmm.LAUNCHES_SINGLE_K = 0
        pl.LAUNCHES_STAGED = 0

    def counters() -> dict:
        return {"multi_k_wgmma": mm.LAUNCHES_MULTI_K_WGMMA,
                "multi_k_mma_sync": mm.LAUNCHES_MULTI_K_MMA_SYNC,
                "single_k": mm.LAUNCHES_SINGLE_K,
                "batched_multi_k_wgmma": bmm.LAUNCHES_MULTI_K_WGMMA,
                "batched_multi_k_mma_sync": bmm.LAUNCHES_MULTI_K_MMA_SYNC,
                "batched_single_k": bmm.LAUNCHES_SINGLE_K, "staged": pl.LAUNCHES_STAGED}

    record = {}
    with phase("0 device"):
        require_hopper()
        info = device_info()
        if not info["nvidia_smi"]:
            raise RuntimeError("nvidia-smi gave no name/power.limit line")
        baselines.pin_precision()  # full-f32 library GEMMs for the plain versions too
        print(json.dumps(info))
        print(info["nvidia_smi"])
        record["device"] = info

    with phase("1 build"):
        lib = load_library()
        regs = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln or "entry function" in ln or "spill" in ln]
        for ln in regs:
            print(f"  ptxas: {ln}")
        if lib.tl2_kstep() != 32:
            raise AssertionError("kernel K step differs from config.KSTEP")
        for bm in (32, 64, 128):
            for bn in (32, 64, 128):
                if lib.tl2_smem_bytes(bm, bn) != KernelConfig(bm=bm, bn=bn).smem_bytes():
                    raise AssertionError(f"smem model differs from the kernel at {bm}x{bn}")
                for depth in PIPELINE_DEPTHS[1:]:
                    cfg = KernelConfig(bm=bm, bn=bn, pipeline_depth=depth)
                    if (cfg.validate() is None and lib.tl2_staged_smem_bytes(bm, bn, depth)
                            != cfg.smem_bytes()):
                        raise AssertionError(f"staged smem model differs from the kernel at "
                                             f"{bm}x{bn} depth {depth}")
        for bm in mm.WGMMA_TILES:
            for bn in mm.WGMMA_TILES:
                if lib.tl2_wgmma_smem_bytes(bm, bn) != mm.wgmma_smem_bytes(bm, bn):
                    raise AssertionError(f"wgmma smem model differs from the kernel at "
                                         f"{bm}x{bn}")
        n_route = _check_route_mirror(torch, lib, mm, KernelConfig)
        print(f"  wgmma smem model and route rule agree with the kernel ({n_route[0]} route "
              f"cases, {n_route[1]} of them wgmma)")
        print(f"  build {lib.build_seconds:.1f} s (0.0 = library was current)")
        record["build_seconds"] = lib.build_seconds
        record["ptxas"] = regs

    max_err = {key: 0.0 for key in counters()}

    with phase("2 kernel vs plain"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        mods = (KernelConfig, mm, bmm)
        cases = _grid_cases()
        for (sh, acc) in SLICE_SHAPES:  # main-path shapes with their resolved configs
            m, n, k = sh
            c = resolve_config(m, n, k, acc)
            kw = dict(bm=c.bm, bn=c.bn, bk=c.bk, acc_dtype=acc)
            cases.append((f"slice/{m}x{n}x{k}/{acc}", 1, m, n, k, kw, None, "bfloat16"))
            cases.append((f"slice-batched/{m}x{n}x{k}/{acc}", GATE_BATCH, m, n, k, kw, None,
                          "bfloat16"))
        # long K intervals, up to bk = K: the tuner's candidate space offers them, and the
        # f32 sum over one interval must stay inside allowed_error on normal inputs
        m, n, k = TUNE_SHAPE
        for bk, layout, acc in ((k, "kn", "float32"), (k // 2, "nk", "float32"),
                                (k // 2, "kn", "bfloat16")):
            kw = dict(bm=32, bn=64, bk=bk, acc_dtype=acc, rhs_layout=layout)
            cases.append((f"long-interval/{m}x{n}x{k}/{acc}/{layout}", 1, m, n, k, kw, None,
                          "float32"))
        cases.append(("long-interval/4096x4096x4096/float32", 1, 4096, 4096, 4096,
                      dict(bm=128, bn=128, bk=4096), None, "float32"))
        cases += _wgmma_cases()
        for name, batch, m, n, k, kw, act, out in cases:
            cfg = KernelConfig(**kw)
            before = counters()
            errs = []
            for zero_one in (True, False):
                errs.append(_check_case(torch, mods, gen, batch, m, n, k, cfg, act, out,
                                        zero_one))
            key = next(key for key, v in counters().items() if v != before[key])
            if name.startswith("wgmma") and not key.endswith("wgmma"):
                raise AssertionError(f"{name} took {key}, not the wgmma route")
            max_err[key] = max(max_err[key], errs[1])
            print(f"  {name} {cfg.bm}x{cfg.bn} bk={cfg.bk} out={out}: {key}, 0/1 exact, "
                  f"normal max|diff| {errs[1]:.3g}")
        record["phase2_cases"] = len(cases)
        # precision of both multi-K bodies at the headline shape against an f64 product,
        # beside cuBLAS's f32 product (the plain version's sum)
        m = n = k = 4096
        cfg = resolve_config(m, n, k, "float32")
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        ref = a.double() @ b.double()
        body = torch.empty((m, n), dtype=torch.float32, device="cuda")
        check_launch(lib.tl2_matmul_f32out(*mm.launch_args(a, b, cfg, body, None, None, 1,
                                                           m, n, k)), "tl2_matmul")
        outs = {"wgmma": mm.cuda_matmul(a, b, cfg, out_dtype=torch.float32),
                "mma_sync": body, "cublas_f32": a.float() @ b.float()}
        record["precision_vs_f64_4096"] = {name: (x.double() - ref).abs().max().item()
                                           for name, x in outs.items()}
        print(f"  max |err| vs an f64 product at 4096^3 ({cfg.bm}x{cfg.bn} bk={cfg.bk}): "
              + json.dumps(record["precision_vs_f64_4096"]))
        del a, b, ref, body, outs

    with phase("2b staged kernel vs plain"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        cases = _staged_cases(candidate_configs)
        for name, m, n, k, kw, out, launches in cases:
            cfg = KernelConfig(**kw)
            before = pl.LAUNCHES_STAGED
            errs = [_check_staged(torch, mm, pl, gen, m, n, k, cfg, out, zero_one)
                    for zero_one in (True, False)]
            if (pl.LAUNCHES_STAGED - before == 2) != launches:
                raise AssertionError(f"{name}: staged launches {pl.LAUNCHES_STAGED - before}, "
                                     f"expected {2 if launches else 0}")
            if launches:
                max_err["staged"] = max(max_err["staged"], errs[1])
            print(f"  {name} {m}x{n}x{k} {cfg.bm}x{cfg.bn} bk={cfg.bk} out={out}: 0/1 exact, "
                  f"normal max|diff| {errs[1]:.3g}")
        record["phase2b_cases"] = len(cases)
        # precision of the f32 sums at the tuning shape, against an f64 product: the staged
        # kernel, the plain version (cuBLAS f32) and tl2_matmul over one K interval (bk = K)
        m, n, k = TUNE_SHAPE
        cfg = next(KernelConfig(**kw) for _, cm, _, _, kw, _, _ in cases if cm == m)
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        ref = a.double() @ b.double()
        outs = {"staged": pl.cuda_matmul_pipelined(a, b.t().contiguous() if cfg.rhs_layout
                                                   == "nk" else b, cfg, out_dtype=torch.float32),
                "plain": pl.pipelined_reference(a, b, "kn", torch.float32),
                "tl2_matmul_one_interval": mm.cuda_matmul(
                    a, b, KernelConfig(bm=cfg.bm, bn=cfg.bn, bk=k), out_dtype=torch.float32)}
        record["precision_vs_f64"] = {name: (x.double() - ref).abs().max().item()
                                      for name, x in outs.items()}
        print(f"  max |err| vs an f64 product at {m}x{n}x{k}: "
              + json.dumps(record["precision_vs_f64"]))

    eval_spec = importlib.util.spec_from_file_location(
        "eval_one_shape_torch", repo / "scripts" / "eval_one_shape_torch.py")
    eval_mod = importlib.util.module_from_spec(eval_spec)
    eval_spec.loader.exec_module(eval_mod)

    def run_slice(m, n, k, acc, base) -> dict:
        """eval_one_shape_torch's main(): gate -> bench -> summary; the gate must pass
        with no guard-band hit.  Returns the speedup row."""
        rc = eval_mod.main(["--mnk", str(m), str(n), str(k), "--acc", acc,
                            "--warmup_seconds", "1", "--benchmark_seconds", "2",
                            "--correctness_seconds", "20", "--correctness_iters", "3",
                            "--base_dir", str(base)])
        if rc != 0:
            raise AssertionError(f"eval_one_shape_torch failed for {m}x{n}x{k} {acc}")
        gate = json.loads((base / "zero_one_correctness_check_result.json").read_text())
        row = json.loads((base / "speedup_row.json").read_text())
        if not gate["pass"] or gate["stats"]["guard_hits"] or gate["variants"]["guard_hits"]:
            raise AssertionError(f"gate did not pass cleanly: {gate.get('failure')}")
        print(f"  {m}x{n}x{k} {acc}: gate pass, guard hits 0, speedups " + json.dumps(row))
        return {"mnk": [m, n, k], "acc": acc, "speedups": row,
                "gate_iterations": gate["stats"]["iterations"]}

    zero_counters()
    record["slice"] = []
    with phase("3 slice"):
        for (m, n, k), acc in SLICE_SHAPES:
            base = repo / "runs" / "chip_smoke" / f"{m}x{n}x{k}_{acc}"
            record["slice"].append(run_slice(m, n, k, acc, base))
    launches = counters()

    with phase("4 launch counts"):
        print("  " + json.dumps(launches))
        missing = [key for key, v in launches.items() if v <= 0 and key != "staged"]
        if missing:
            raise AssertionError(f"main path never launched: {missing}")

    tm, tn, tk = TUNE_SHAPE
    with phase("tune"):
        db_path = repo / "runs" / "chip_smoke" / "tunedb_h100.json"
        db_path.unlink(missing_ok=True)
        os.environ[db_mod.ENV_VAR] = str(db_path)
        db_mod.reset_default_db()
        zero_counters()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = tune_cli.main(["--mnk", str(tm), str(tn), str(tk), "--acc", "float32",
                                "--max_candidates", "8", "--stage1_rounds", "3",
                                "--stage2_rounds", "5", "--finalists", "4"])
        tune_launches = counters()
        if rc != 0:
            raise AssertionError(f"the tuner exited {rc}")
        tuned = json.loads(printed.getvalue())
        for d in tuned["medians_ms"]:
            c = d["config"]
            name = (f"vendor {c['vendor_variant']}" if c["use_vendor"] else
                    f"{c['bm']}x{c['bn']} bk={c['bk']} {c['grid_order']} {c['rhs_layout']} "
                    f"depth={c['pipeline_depth']}")
            print(f"  {name}: stage1 {d['stage1_ms']:.5f} ms, stage2 "
                  + ("-" if d["stage2_ms"] is None else f"{d['stage2_ms']:.5f} ms"))
        best = tuned["best"]
        print(f"  winner: {json.dumps(best)}, {tuned['best_tflops']:.2f} TFLOP/s, "
              f"{tuned['speedup']:.4f}x vs torch_matmul "
              f"({tuned['torch_matmul_tflops']:.2f} TFLOP/s); launches "
              + json.dumps(tune_launches))
        staged = [d for d in tuned["medians_ms"] if d["config"]["pipeline_depth"] >= 2]
        if tuned["n_launched"] != tuned["n_candidates"]:
            raise AssertionError(f"only {tuned['n_launched']} of {tuned['n_candidates']} "
                                 "candidates launched")
        if len(staged) < 2:
            raise AssertionError(f"{len(staged)} staged candidates timed (need 2)")
        if tune_launches["staged"] <= 0:
            raise AssertionError("the tuning path never launched the staged kernel")
        stored = db_mod.TuneDB(path=db_path).load().get(tm, tn, tk, "float32")
        if stored != KernelConfig(**best):
            raise AssertionError(f"the winner is not on disk: {stored}")
        record["tune"] = {**tuned, "launches": tune_launches}

    with phase("tuned dispatch"):
        fastest = min(staged, key=lambda d: d["stage1_ms"])
        staged_cfg = KernelConfig(**fastest["config"])
        reference_ms = next(d["stage1_ms"] for d in tuned["medians_ms"]
                            if d["config"]["use_vendor"]
                            and d["config"]["vendor_variant"] == "torch_matmul")
        db_path = repo / "runs" / "chip_smoke" / "tunedb_staged.json"
        db_path.unlink(missing_ok=True)
        db = db_mod.TuneDB(path=db_path)
        for acc in ("float32", "bfloat16"):
            db.put(tm, tn, tk, dataclasses.replace(staged_cfg, acc_dtype=acc),
                   2.0 * tm * tn * tk / fastest["stage1_ms"] * 1e-9, acc=acc,
                   extra={"speedup_vs_torch_matmul": reference_ms / fastest["stage1_ms"]})
        db.save()
        os.environ[db_mod.ENV_VAR] = str(db_path)
        db_mod.reset_default_db()
        for acc in ("float32", "bfloat16"):
            got = resolve_config(tm, tn, tk, acc)
            if got != dataclasses.replace(staged_cfg, acc_dtype=acc):
                raise AssertionError(f"dispatch resolved {got}, not the stored staged config")
        print(f"  stored {staged_cfg} (stage1 {fastest['stage1_ms']:.5f} ms)")
        zero_counters()
        record["tuned_dispatch"] = [
            run_slice(tm, tn, tk, acc, repo / "runs" / "chip_smoke" / f"staged_{acc}")
            for acc in ("float32", "bfloat16")]
        staged_launches = counters()
        print("  launches " + json.dumps(staged_launches))
        if staged_launches["staged"] <= 0:
            raise AssertionError("the tuned dispatch path never launched the staged kernel")
        os.environ.pop(db_mod.ENV_VAR)
        db_mod.reset_default_db()  # phase 5 and later resolve without a DB again
        record["tuned_dispatch_launches"] = staged_launches

    # Representative main-path call of each kernel body, timed against its plain version:
    # both routes of each multi-K body on the same tile and inputs, then the single-K ones.
    kernels = []
    record["shapes"] = []
    with phase("5 timing"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        m = n = k = 4096
        cfg = resolve_config(m, n, k, "float32")
        for batch in (1, GATE_BATCH):
            batched = batch > 1
            a = _inputs(torch, gen, (batch, m, k) if batched else (m, k), False)
            b = _inputs(torch, gen, (batch, k, n) if batched else (k, n), False)
            out = torch.empty((batch, m, n) if batched else (m, n), dtype=torch.bfloat16,
                              device="cuda")
            if mm.multi_k_route(cfg, a, b, m, n, k) != "wgmma":
                raise AssertionError(f"{cfg} does not take the wgmma route at 4096^3")
            call = mm.launch_args(a, b, cfg, out, None, None, batch, m, n, k)
            if batched:
                run = lambda: bmm.cuda_batched_matmul(a, b, cfg, out=out)  # noqa: E731
                plain = lambda: bmm.batched_matmul_reference(a, b, cfg.bk)  # noqa: E731
                library = lambda: torch.bmm(a, b)  # noqa: E731
            else:
                run = lambda: mm.cuda_matmul(a, b, cfg, out=out)  # noqa: E731
                plain = lambda: mm.matmul_reference(a, b, cfg.bk)  # noqa: E731
                library = lambda: torch.matmul(a, b)  # noqa: E731
            # the mma.sync body on the same tile, launched directly (the route sends this
            # shape to wgmma)
            mma_sync = lambda: check_launch(lib.tl2_matmul_bf16out(*call),  # noqa: E731
                                            "tl2_matmul")
            turns = [_time_ms(torch, fn) for fn in (run, mma_sync, mma_sync, run)]
            plain_ms, library_ms = _time_ms(torch, plain), _time_ms(torch, library)
            bound_ms, bound_by = _bound(batch, m, n, k)
            prefix = "batched_" if batched else ""
            print(f"  {prefix}multi_k {batch}x{m}x{n}x{k} {cfg.bm}x{cfg.bn} bk={cfg.bk} in "
                  f"turns (wgmma, mma.sync, mma.sync, wgmma) ms: " + json.dumps(turns))
            record[f"{prefix}multi_k_turns_ms"] = turns
            for route, source, ms in (
                    ("wgmma", "tpul2_torch/csrc/tl2_wgmma.cu", (turns[0] + turns[3]) / 2),
                    ("mma_sync", "tpul2_torch/csrc/tl2_matmul.cu", (turns[1] + turns[2]) / 2)):
                key = f"{prefix}multi_k_{route}"
                kernels.append({
                    "name": (f"{'tl2_wgmma' if route == 'wgmma' else 'tl2_matmul mma.sync'}"
                             f"{' batched' if batched else ''} (multi-K)"),
                    "route": "cuda", "source": source,
                    "replaces": ("tpul2/ops/batched.py:25" if batched
                                 else "tpul2/ops/matmul.py:96"),
                    "launches": launches[key], "max_abs_err": max_err[key], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms})
        del a, b, out
        m, n, k = 8192, 128, 64
        cfg = resolve_config(m, n, k, "float32")
        for key, batch, replaces in (("single_k", 1, "tpul2/ops/matmul.py:136"),
                                     ("batched_single_k", GATE_BATCH,
                                      "tpul2/ops/batched.py:40")):
            batched = batch > 1
            a = _inputs(torch, gen, (batch, m, k) if batched else (m, k), False)
            b = _inputs(torch, gen, (batch, k, n) if batched else (k, n), False)
            if batched:
                run = lambda: bmm.cuda_batched_matmul(a, b, cfg)  # noqa: E731
                plain = lambda: bmm.batched_matmul_reference(a, b, cfg.bk)  # noqa: E731
                library = lambda: torch.bmm(a, b)  # noqa: E731
            else:
                run = lambda: mm.cuda_matmul(a, b, cfg)  # noqa: E731
                plain = lambda: mm.matmul_reference(a, b, cfg.bk)  # noqa: E731
                library = lambda: torch.matmul(a, b)  # noqa: E731
            ms, plain_ms = _time_ms(torch, run), _time_ms(torch, plain)
            library_ms = _time_ms(torch, library)
            bound_ms, bound_by = _bound(batch, m, n, k)
            kernels.append({"name": f"tl2_matmul{' batched' if batched else ''} (single-K)",
                            "route": "cuda", "source": "tpul2_torch/csrc/tl2_matmul.cu",
                            "replaces": replaces, "launches": launches[key],
                            "max_abs_err": max_err[key], "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": library_ms})
        # the staged kernel at the tuning shape, with the config the tuned path dispatched
        a, b = _inputs(torch, gen, (tm, tk), False), _inputs(torch, gen, (tk, tn), False)
        rhs = b.t().contiguous() if staged_cfg.rhs_layout == "nk" else b
        ms = _time_ms(torch, lambda: pl.cuda_matmul_pipelined(a, rhs, staged_cfg))
        plain_ms = _time_ms(torch, lambda: pl.pipelined_reference(a, rhs, staged_cfg.rhs_layout))
        library_ms = _time_ms(torch, lambda: torch.matmul(a, b))
        bound_ms, bound_by = _bound(1, tm, tn, tk)
        kernels.append({"name": f"tl2_staged ({staged_cfg.bm}x{staged_cfg.bn} "
                                f"{staged_cfg.rhs_layout} depth {staged_cfg.pipeline_depth})",
                        "route": "cuda", "source": "tpul2_torch/csrc/tl2_staged.cu",
                        "replaces": "tpul2/ops/pipelined.py:39",
                        "launches": staged_launches["staged"],
                        "max_abs_err": max_err["staged"], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})
        # the same tile at every depth (same inputs): what the ring depth buys at this shape
        record["staged_depth_sweep_ms"] = {
            depth: _time_ms(torch, lambda d=depth: pl.cuda_matmul_pipelined(
                a, rhs, dataclasses.replace(staged_cfg, pipeline_depth=d)))
            for depth in PIPELINE_DEPTHS[1:]}
        print("  staged depth sweep (ms): " + json.dumps(record["staged_depth_sweep_ms"]))
        # the skinny serving shape (same inputs): the heuristic's mma.sync tile against the
        # 64-row wgmma tiles, in turns
        heuristic = resolve_config(tm, tn, tk, "float32")
        tiles = [heuristic] + [KernelConfig(bm=64, bn=bn, bk=heuristic.bk) for bn in (64, 128)]
        skinny = {f"{c.bm}x{c.bn} bk={c.bk}": {"route": mm.multi_k_route(c, a, b, tm, tn, tk),
                                               "ms": []} for c in tiles}
        for c in tiles + tiles[::-1]:
            skinny[f"{c.bm}x{c.bn} bk={c.bk}"]["ms"].append(
                _time_ms(torch, lambda c=c: mm.cuda_matmul(a, b, c)))
        record["skinny_tiles"] = skinny
        print(f"  {tm}x{tn}x{tk} tiles in turns (ms): " + json.dumps(skinny))
        for row in kernels:
            print("  " + json.dumps(row))
        for (m, n, k), acc in SLICE_SHAPES:
            cfg = resolve_config(m, n, k, acc)
            a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
            b_t = b.t().contiguous()
            cand = candidate_fn(acc)
            t = {"kernel_ms": _time_ms(torch, lambda: cand(a, b, b_t)),
                 "plain_ms": _time_ms(torch, lambda: mm.matmul_reference(a, b, cfg.bk, acc)),
                 "torch_matmul_ms": _time_ms(torch, lambda: torch.matmul(a, b))}
            t["kernel_tflops"] = 2 * m * n * k / t["kernel_ms"] * 1e-9
            t["torch_matmul_tflops"] = 2 * m * n * k / t["torch_matmul_ms"] * 1e-9
            # host time of one entry-point call: 20 calls enqueued with no wait between them
            # (the card's queue absorbs them), on the host clock
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                cand(a, b, b_t)
            t["host_ms_per_call"] = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
            print(f"  {m}x{n}x{k} {acc} cfg {cfg.bm}x{cfg.bn} bk={cfg.bk}: " + json.dumps(t))
            record["shapes"].append({"mnk": [m, n, k], "acc": acc, **t})
    record["kernels"] = kernels
    if "jax" in sys.modules:
        raise AssertionError("jax was imported on the port's path")
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(record, indent=1))
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
