#!/usr/bin/env python3
"""Chip smoke test of tpul2_torch on one H100: build, check and drive the main path.

Run from the repository root, on a machine with one Hopper card:

    python3 chip_smoke.py [--json_out PATH]

Phases (each prints one line; any failure raises and the exit code is non-zero):
  0  require an sm_90 card; print the environment record and nvidia-smi's name/power line
  1  build csrc/*.cu for sm_90a (nvcc, one process per source, at first use), print the
     build time and ptxas report; the shared-memory models of config.py must equal the
     kernels' own counts for every tile (and depth, on each staged route) they take, and
     validate must refuse exactly what exceeds 227 KB; tl2_wgmma_route must agree with
     ops.matmul.launch_route over a grid of shapes, tiles, bk (single intervals
     included), layouts and operand alignments, and tl2_staged_route with
     ops.pipelined.staged_route over shapes, tiles, depths, layouts and alignments
  2  kernel vs plain torch version on the card over the grid
     {f32, bf16 acc} x {kn, nk} x {gk == 1, gk > 1} x {aligned, unaligned}
     x {no epilogue, bias + gelu|silu|tanh}, plus batched (B = 3), at the main-path
     shapes, and with long K intervals (bk = K = 8192, bk = 4096); then the wgmma route
     over {K carry (bk 128), one interval (bk >= K)} x {f32, bf16 acc} x {kn, nk}
     x {64, 128}^2 tiles x {aligned, M/N/K edges with K % 64 != 0} x {plain, bias + act},
     batched (B = 3) with M % BM != 0 for both, 1000^3 at one interval over families,
     layouts and epilogues, and long intervals (4096^3 at bk 2048, 128x8192x8192 at
     bk 4096), each case required to take the wgmma route and the body its gk names:
     0/1 inputs must agree exactly (the epilogue cases then use bias + relu, since no
     library's tanh is correctly rounded), normal inputs within ops.matmul.allowed_error
     (which holds a single interval to the f32 terms in both families); the bf16
     family's single interval with f32 output must also differ from its own bf16
     rounding; and the max |error| against an f64 product at 4096^3 of both multi-K
     bodies and of cuBLAS's f32 product
  2b the staged kernel vs its plain version (with the launch's split count) on both
     routes: every tile x depth {2, 3, 4, 6, 8} that fits, the ring tiles at a shape of
     few tiles (split K) and of many (one split), families, layouts and out dtypes
     spread over them; the depth clamp (gk < depth) on both routes, gk == 1 (which must
     not launch it), a K tail (K % 64 != 0) with and without a split, and the tuning
     shapes' staged candidates; each case must take its route (and split where its
     shape says): 0/1 inputs exact, normal inputs within allowed_error(..., bk=K,
     acc_dtype='float32'), a split case run twice on the same inputs bit-identical;
     then the max |error| against an f64 product at 64x8192x8192 of the ring, a split
     of it (8 splits, launched directly), the mma.sync body and one K interval
  3  the slice: scripts/eval_one_shape_torch.py's main() for the bring-up shapes and the
     few-CTA streaming shapes (gate with guard bands -> offline bench -> summary); every
     gate must pass; then the entry points (dispatch.matmul, dispatch.batched_matmul) at
     shapes with K % 8 != 0, which TMA cannot read, with one K interval and with several,
     and dispatch.matmul with a staged config on each route (a 32-edge tile; a ring tile
     whose few tiles split K): exact on 0/1 inputs
  4  the launch counters, zeroed just before phase 3, must show that each body ran on
     both routes, single-K and multi-K, 2-D and batched, and the staged kernel on both
     routes with a split: the bring-up shapes and the gate's batched variants take wgmma
     (64x8192x8192 at the heuristic's 64x64 tile included), the K % 8 != 0 shapes
     mma.sync
  tune  `python -m tpul2_torch.autotune` (its main()) for each tuning shape (64x8192x8192,
     64x64x12288) f32 into runs/chip_smoke/tunedb_h100.json, with few candidates and
     rounds, ranked by device time (GraphTimer): each candidate's device and end-to-end
     time per call is printed; every candidate must launch and capture, at least two
     staged candidates must be timed, every staged candidate must be a ring tile and
     launch on the ring (never mma.sync), 64x64x12288's must split K, the winner must be
     torch_matmul or beat it by more than 10%, torch_matmul and cublas_nn (one library
     call) must time within 10% of each other over 10 rounds in turns, and the entry must
     be on disk with timing_rev 2
  tuned dispatch  a DB holding each tuning shape's fastest staged candidate for both
     families (runs/chip_smoke/tunedb_staged.json, via TPUL2_TORCH_TUNEDB), then
     eval_one_shape_torch's main() for both: every gate must pass with 0 guard hits, and
     the staged ring (with a split at 64x64x12288) must launch on this path
  5  per-kernel times on the card against the plain version and torch.matmul, with the
     bound of each (the larger of bytes over 3.35 TB/s and FLOPs over 989 TFLOP/s): the
     two routes of each multi-K body at 4096^3 (and 2 x 4096^3) on the same 128x128 tile,
     timed in turns (the mma.sync one launched through lib.tl2_matmul_*out directly);
     the two routes of each single-K body alone (a CUDA graph of direct launches, so no
     host time enters; torch.matmul the same way) at 8192x128x64 (and 2 x), and at 1000^3
     in both families; the staged kernel alone at 64x8192x8192 on the dispatched ring
     tile against tl2_staged.cu's 32x64 at depth 4, in turns, and at every depth on both
     (64x64 ring, 32x64 mma.sync); for each few-CTA shape, alone and through the entry
     point in turns, the heuristic config (both families), the fastest of the tuner's
     staged candidates there (split K) and torch.matmul, beside the bound; the split
     launch and the reduction alone at 64x64x12288; the heuristic's 64x64 wgmma tile
     against the 32x64 mma.sync tile it used to pick and the 64x128 wgmma tile at
     64x8192x8192, through the wrapper in turns and alone; and for each bring-up shape
     the entry point's time back to back and its host time per call
  lt-autotune  the cuBLASLt auto-tuning baseline's search (csrc/tl2_lt_autotune.cu) at
     4096^3 and 64x8192x8192 per layout: the algos kept and skipped, the winner, its time
     alone beside torch.matmul's; exact on 0/1 inputs against torch.mm, the winner and
     every algo kept
  sentinel  the dispatch sentinel's f32 output and bias + gelu at 4096^3, the old path (f32
     copies, an f32 GEMM) against the new one (one bf16-in, f32-out library GEMM), timed
     in turns; exact on 0/1 inputs, the old against the new
  server slice  eval_one_shape_torch's main() with --mode server --target_qps 100 at two
     shapes in both families, through the heuristic (an empty DB): every gate must pass,
     each result JSON must carry p50/p99 and target_qps, and the launch counters (zeroed
     just before) must show the wgmma ring ran
  committed-DB slice  scripts/run_suite_torch.py's main() over a few DEFAULT_SHAPES
     through tpul2_torch/data/tunedb_h100.json (both families, offline): the CSV rows are
     printed, with how many of the 20 shapes resolve to the sentinel in each family and
     mode, and how many stored kernel configs the card refuses (resolved to the sentinel)
  model  the flagship block (tpul2_torch.models.entry: d_model 1024, d_ff 4096, seq 512,
     8 heads) through the committed DB: 8 forward requests one at a time (p50/p99), 5
     block_train_steps on a fixed seeded (x, y) whose loss must be finite and fall, 3 FFN
     train_steps (1024 x 4096, batch 512); the block's output, loss and grads held
     against the same block on a CPU copy (every GEMM on its plain version, the same
     configs) and against the vendor config on the card (output rtol = atol = 0.05, loss
     rtol 1e-3, each grad within 0.02 relative L2); the forward again through the
     heuristic (an empty DB); the counters (zeroed before each counted part) must show
     the 2-D wgmma single-K and multi-K bodies under the committed DB and the batched
     single-K wgmma body under the heuristic; then forward and train-step ms under the
     committed DB, the heuristic and the vendor config in turns, the model FLOPs' share
     of peak (harness.profiling's table), one profiled forward and train step (device
     busy time, idle share, top device ops) and a profiled train step through the
     heuristic and the vendor config, and profile_shape at FFN-1's shape with a trace;
     each kernel row's launches add the model path's
Phases 2 to 5 and the server slice measure the heuristic: they run with
TPUL2_TORCH_TUNEDB naming an empty file, so the committed DB does not steer them.
The last two lines are the per-kernel JSON record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
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
#: (batch, m, n, k) with K % 8 != 0, whose rows TMA cannot read: the entry points send
#: them to the mma.sync bodies, with one K interval (bk 1024 >= K) and with two.
UNALIGNED_SHAPES = [(1, 200, 300, 1001), (1, 200, 300, 2001), (GATE_BATCH, 200, 300, 1001),
                    (GATE_BATCH, 200, 300, 2001)]
#: The tuning path's shape: the skinny serving shape, where the kStage axis competes.
TUNE_SHAPE = (64, 8192, 8192)
#: Streaming shapes of bench.py's DEFAULT_SHAPES whose heuristic grid has few CTAs (1, 1,
#: 2, 4 and 64 of 132 SMs): where the staged ring splits K.
FEW_CTA_SHAPES = [(64, 64, 12288), (64, 64, 4096), (128, 64, 4096), (64, 256, 8192),
                  (64, 4096, 4096)]
#: The shapes the tune phase tunes: the skinny one (no split) and a one-CTA one (48 splits).
TUNE_SHAPES = [TUNE_SHAPE, FEW_CTA_SHAPES[0]]
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
    route grid; each must take the wgmma route: a K carry (bk 128) and one interval
    (bk >= K; at the edge shape 352, not a multiple of 64)."""
    cases = []
    i = 0
    for gk in ("gkN", "gk1"):
        for acc in ("float32", "bfloat16"):
            for layout in ("kn", "nk"):
                for bm in (64, 128):
                    for bn in (64, 128):
                        for edge in (False, True):
                            # edges: M % BM, N % BN != 0 and a K tail of 8 (K % 64 != 0)
                            m, n, k = (200, 264, 328) if edge else (256, 384, 512)
                            bk = 128 if gk == "gkN" else -(-k // 32) * 32
                            for epilogue in (False, True):
                                act = ("gelu", "silu", "tanh")[i % 3] if epilogue else None
                                cfg = dict(bm=bm, bn=bn, bk=bk, acc_dtype=acc,
                                           rhs_layout=layout,
                                           grid_order="nm" if i % 2 else "mn")
                                out = "float32" if i % 3 else "bfloat16"
                                cases.append((f"wgmma/{gk}/{acc}/{layout}/"
                                              f"{'edge' if edge else 'al'}/{act or 'plain'}",
                                              1, m, n, k, cfg, act, out))
                                i += 1
            for bm, bn in ((64, 128), (128, 64)):  # the rank-3 maps' M edge inside a batch
                cases.append((f"wgmma-batched/{gk}/{acc}/m-edge", GRID_BATCH, 100, 136, 328,
                              dict(bm=bm, bn=bn, bk=128 if gk == "gkN" else 352,
                                   acc_dtype=acc), None, "float32"))
    # the unaligned bring-up shape at one interval, as the heuristic resolves it
    for acc in ("float32", "bfloat16"):
        for layout in ("kn", "nk"):
            for act in (None, "gelu"):
                cases.append((f"wgmma/gk1/1000^3/{acc}/{layout}/{act or 'plain'}", 1, 1000,
                              1000, 1000, dict(bm=64, bn=64, bk=1024, acc_dtype=acc,
                                               rhs_layout=layout), act, "float32"))
    cases.append(("wgmma-long/4096x4096x4096/float32", 1, 4096, 4096, 4096,
                  dict(bm=128, bn=128, bk=2048), None, "float32"))
    cases.append(("wgmma-long/128x8192x8192/float32", 1, 128, 8192, 8192,
                  dict(bm=64, bn=128, bk=4096), None, "float32"))
    return cases


def _check_route_mirror(torch, lib, mm, KernelConfig) -> tuple:
    """tl2_wgmma_route against ops.matmul.launch_route over shapes, tiles, bk (one interval
    and several), layouts and operand alignments (views 2, 8 and 16 bytes into one
    allocation); return (cases, wgmma cases).  Raises on the first disagreement."""
    buf = torch.zeros(64, dtype=torch.bfloat16, device="cuda")
    shapes = ((256, 256, 1024), (200, 1001, 328), (64, 8192, 8192), (96, 160, 1004),
              (128, 128, 64), (8192, 128, 64), (1000, 1000, 1000))
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
                                py = mm.launch_route(cfg, a, b, m, nn, k) == "wgmma"
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


def _check_staged_route_mirror(torch, lib, pl, KernelConfig) -> tuple:
    """tl2_staged_route against ops.pipelined.staged_route over shapes, tiles, depths,
    layouts and operand alignments; return (cases, ring cases).  Raises on the first
    disagreement."""
    buf = torch.zeros(64, dtype=torch.bfloat16, device="cuda")
    shapes = ((64, 8192, 8192), (64, 64, 12288), (96, 160, 1004), (128, 100, 2048),
              (128, 128, 2080))
    n = n_ring = 0
    for off_a in (0, 1, 8):
        for off_b in (0, 4):
            a, b = buf[off_a:], buf[off_b:]
            for m, nn, k in shapes:
                for bm in (32, 64, 128):
                    for bn in (32, 64, 128):
                        for depth in (2, 3, 4, 6, 8):
                            for layout in ("kn", "nk"):
                                cfg = KernelConfig(bm=bm, bn=bn, rhs_layout=layout,
                                                   pipeline_depth=depth)
                                py = pl.staged_route(cfg, a, b, m, nn, k) == "ring"
                                c = lib.tl2_staged_route(m, nn, k, bm, bn,
                                                         int(layout == "nk"), a.data_ptr(),
                                                         b.data_ptr())
                                if py != bool(c):
                                    raise AssertionError(
                                        f"staged route differs at {m}x{nn}x{k} {cfg} "
                                        f"offsets {off_a}, {off_b}: python {py}, C {c}")
                                n += 1
                                n_ring += py
    return n, n_ring


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


def _staged_cases(candidate_configs, KernelConfig, wgmma_tiles):
    """(name, m, n, k, cfg kwargs, out dtype name, route) of phase 2b; ``route`` is the
    staged body the case must launch ('ring' or 'mma_sync'), or None where gk == 1 takes
    the single-K kernel."""
    cases = []
    i = 0
    for bm in (32, 64, 128):
        for bn in (32, 64, 128):
            ring = bm in wgmma_tiles and bn in wgmma_tiles
            for depth in (2, 3, 4, 6, 8):
                if KernelConfig(bm=bm, bn=bn, pipeline_depth=depth).validate() is not None:
                    continue  # 128 x 128 at depth 8: a ring of more than 227 KB
                acc = ("float32", "bfloat16")[i % 2]
                layout = ("kn", "nk")[i // 2 % 2]
                kw = dict(bm=bm, bn=bn, bk=256, acc_dtype=acc, rhs_layout=layout,
                          pipeline_depth=depth, grid_order="nm" if i % 3 == 0 else "mn")
                out = "float32" if i % 3 else "bfloat16"
                # few tiles (the ring splits K) and, on the ring, many (one split)
                for m, n, k in [(256, 384, 2048)] + ([(2048, 1024, 2048)] if ring else []):
                    cases.append((f"staged/{bm}x{bn}/d{depth}/{acc}/{layout}/{m}x{n}x{k}",
                                  m, n, k, kw, out, "ring" if ring else "mma_sync"))
                i += 1
    for acc in ("float32", "bfloat16"):
        for layout in ("kn", "nk"):
            # gk = 3 < depth 8: the ring is clamped to 3 stages (slices)
            for (bm, bn), route in (((64, 128), "ring"), ((32, 128), "mma_sync")):
                kw = dict(bm=bm, bn=bn, bk=256, acc_dtype=acc, rhs_layout=layout,
                          pipeline_depth=8)
                cases.append((f"staged-clamp/{acc}/{layout}/{route}", 128, 256, 768, kw,
                              "float32", route))
            # gk == 1: the single-K kernel, not the ring
            kw = dict(bm=128, bn=64, bk=512, acc_dtype=acc, rhs_layout=layout, pipeline_depth=4)
            cases.append((f"staged-gk1/{acc}/{layout}", 128, 256, 512, kw, "bfloat16", None))
            # a K tail (K = 2080, K % 64 = 32): TMA zero-fills the last stage, with 11
            # splits and with one, and the 32-deep slices of the mma.sync body
            for (m, n), (bm, bn), route in (((128, 128), (64, 64), "ring"),
                                            ((2048, 1024), (64, 64), "ring"),
                                            ((128, 128), (32, 64), "mma_sync")):
                kw = dict(bm=bm, bn=bn, bk=160, acc_dtype=acc, rhs_layout=layout,
                          pipeline_depth=2)
                out = "bfloat16" if layout == "nk" else "float32"
                cases.append((f"staged-ktail/{acc}/{layout}/{m}x{n}x2080/{bm}x{bn}", m, n,
                              2080, kw, out, route))
    for m, n, k in TUNE_SHAPES:  # the tuning path's staged candidates, at its shapes
        for c in candidate_configs(m, n, k, "float32"):
            if c.pipeline_depth >= 2:
                kw = {f: getattr(c, f) for f in ("bm", "bn", "bk", "acc_dtype", "rhs_layout",
                                                 "pipeline_depth", "grid_order")}
                cases.append((f"staged-tune/{m}x{n}x{k}/{c.bm}x{c.bn}/{c.grid_order}/"
                              f"{c.rhs_layout}/d{c.pipeline_depth}", m, n, k, kw, "bfloat16",
                              "ring"))
    return cases


def _check_staged(torch, mm, pl, gen, m, n, k, cfg, out_name, zero_one, splits,
                  repeat=False):
    """Run the staged wrapper and its plain version (with ``splits``) on the same inputs;
    return max |diff| (raises if out of tolerance, or, with ``repeat``, if a second run on
    the same inputs differs in any bit)."""
    out_dtype = getattr(torch, out_name)
    a = _inputs(torch, gen, (m, k), zero_one)
    rhs = _inputs(torch, gen, (n, k) if cfg.rhs_layout == "nk" else (k, n), zero_one)
    got = pl.cuda_matmul_pipelined(a, rhs, cfg, out_dtype=out_dtype)
    want = pl.pipelined_reference(a, rhs, cfg.rhs_layout, out_dtype, splits)
    if repeat and not torch.equal(got, pl.cuda_matmul_pipelined(a, rhs, cfg,
                                                                out_dtype=out_dtype)):
        raise AssertionError("two runs on the same inputs differ")
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


def _script(repo: Path, name: str):
    """The module of scripts/<name>.py."""
    spec = importlib.util.spec_from_file_location(name, repo / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def _model_flops(seq: int, d: int, d_ff: int, heads: int) -> float:
    """FLOPs of the block's six products in one forward: QKV, the scores, the context,
    the output projection and the two FFN products (2 per multiply-add)."""
    hd = d // heads
    return 2.0 * seq * (3 * d * d + d * d + 2 * d * d_ff) + 2 * 2.0 * heads * seq * seq * hd


def _model_phase(torch, counters, zero_counters, use_db) -> tuple:
    """Phase model: the flagship block (``tpul2_torch.models.entry``, d_model 1024, d_ff
    4096, seq 512, 8 heads) served, trained and held against its plain versions; the FFN
    trained.  ``use_db('committed' | 'heuristic')`` picks the DB the dispatch resolves
    through.  Returns (record, launches of the model path's counted parts)."""
    import numpy as np

    from tpul2_torch.config import KernelConfig
    from tpul2_torch.harness import profiling
    from tpul2_torch.models import (BlockParams, block_forward, block_train_step,
                                    block_value_and_grad, init_ffn)
    from tpul2_torch.models import train_step as ffn_train_step
    from tpul2_torch.models.entry import D_FF, D_MODEL, N_HEADS, SEQ, entry

    lr = 5e-2
    out_tol, grad_tol, loss_tol = 0.05, 0.02, 1e-3
    rec = {"tolerances": {"output_rtol_atol": out_tol, "grad_rel_l2_per_tensor": grad_tol,
                          "loss_rtol": loss_tol}}
    launches = {key: 0 for key in counters()}

    def count(fn):
        """Run fn with the counters zeroed just before; add what it launched."""
        zero_counters()
        res = fn()
        torch.cuda.synchronize()
        got = counters()
        for key, v in got.items():
            launches[key] += v
        return res, got

    def finite(t, what):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"non-finite {what}")

    # does the card's torch differentiate aten::mm.dtype (the sentinel's f32 output)?
    probe = torch.ones((2, 2), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    try:
        torch.mm(probe, probe.detach(), out_dtype=torch.float32).sum().backward()
        rec["mm_dtype_has_derivative"] = True
    except (RuntimeError, NotImplementedError) as e:
        rec["mm_dtype_has_derivative"] = False
        rec["mm_dtype_derivative_error"] = str(e).splitlines()[0]
    print(f"  aten::mm.dtype derivative in torch {torch.__version__}: "
          f"{rec['mm_dtype_has_derivative']} (the sentinel goes through GemmVjp either way)")

    # (a) the committed DB: serve 8 forward requests, one at a time
    use_db("committed")
    fn, (params, x) = entry()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    y = torch.randn((SEQ, D_MODEL), generator=gen, device="cuda").to(torch.bfloat16)
    fn(params, x)
    torch.cuda.synchronize()

    def serve():
        times, out = [], None
        for _ in range(8):
            t0 = time.perf_counter()
            out = fn(params, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, times

    (out, req_ms), served = count(serve)
    if out.shape != (SEQ, D_MODEL) or out.dtype != torch.bfloat16:
        raise AssertionError(f"forward gave {tuple(out.shape)} {out.dtype}")
    finite(out, "forward output")
    rec["serve"] = {"requests": 8, "ms": req_ms, "p50_ms": float(np.percentile(req_ms, 50)),
                    "p99_ms": float(np.percentile(req_ms, 99)), "launches": served,
                    "launches_per_forward": {k: v / 8 for k, v in served.items() if v}}
    print(f"  (a) committed DB, 8 requests one at a time: p50 {rec['serve']['p50_ms']:.4f} ms, "
          f"p99 {rec['serve']['p99_ms']:.4f} ms (host clock to the card's end); launches "
          f"per forward {json.dumps(rec['serve']['launches_per_forward'])}")
    if served["single_k_wgmma"] <= 0 or served["multi_k_wgmma"] <= 0:
        raise AssertionError("the committed DB's forward did not run the 2-D wgmma single-K "
                             f"and multi-K bodies: {served}")

    # (b) training: 5 block steps on the fixed (x, y), then 3 FFN steps
    def train_block():
        p, losses = params, []
        for _ in range(5):
            p, loss = block_train_step(p, x, y, N_HEADS, lr=lr)
            losses.append(float(loss))
        return losses

    losses, trained = count(train_block)
    if not all(math.isfinite(v) for v in losses) or not losses[4] < losses[0]:
        raise AssertionError(f"block loss not finite and falling: {losses}")
    fgen = torch.Generator(device="cuda")
    fgen.manual_seed(8)
    ffn = init_ffn(fgen, D_MODEL, D_FF)
    fx, fy = (torch.randn((512, D_MODEL), generator=fgen, device="cuda").to(torch.bfloat16)
              for _ in range(2))

    def train_ffn():
        p, fl = ffn, []
        for _ in range(3):
            p, loss = ffn_train_step(p, fx, fy, lr=lr)
            fl.append(float(loss))
        return fl

    ffn_losses, ffn_trained = count(train_ffn)
    if not all(math.isfinite(v) for v in ffn_losses):
        raise AssertionError(f"FFN loss not finite: {ffn_losses}")
    rec["train"] = {"lr": lr, "block_losses": losses, "block_launches": trained,
                    "launches_per_block_step": {k: v / 5 for k, v in trained.items() if v},
                    "ffn_losses": ffn_losses, "ffn_launches": ffn_trained}
    print(f"  (b) 5 block steps (lr {lr}) loss {json.dumps(losses)}; launches per step "
          f"{json.dumps(rec['train']['launches_per_block_step'])}; 3 FFN steps (1024 x 4096, "
          f"batch 512) loss {json.dumps(ffn_losses)}")

    # (c) held against the plain versions (a CPU copy: the same configs resolve there, and
    # every wrapper runs its plain version) and against the vendor config on the card
    def run(p, xx, yy, config=None):
        out = block_forward(p, xx, N_HEADS, config=config)
        loss, grads = block_value_and_grad(p, xx, yy, N_HEADS, config=config)
        return out.float().cpu(), float(loss), [g.float().cpu() for g in grads]

    card = run(params, x, y)
    plain = run(BlockParams(*(p.cpu() for p in params)), x.cpu(), y.cpu())
    vendor = run(params, x, y, KernelConfig.vendor())
    rec["held"] = {}
    for name, ref in (("plain", plain), ("vendor", vendor)):
        out_err = (card[0] - ref[0]).abs()
        bad = int((out_err > out_tol + out_tol * ref[0].abs()).sum())
        rel = {f: ((g - r).norm() / r.norm()).item()
               for f, g, r in zip(BlockParams._fields, card[2], ref[2])}
        loss_rel = abs(card[1] - ref[1]) / abs(ref[1])
        rec["held"][name] = {"output_max_abs_diff": out_err.max().item(),
                             "output_beyond_tol": bad, "loss": [card[1], ref[1]],
                             "loss_rel_diff": loss_rel, "grad_rel_l2": rel}
        print(f"  (c) vs {name}: output max |diff| {out_err.max().item():.4g} ({bad} beyond "
              f"rtol = atol = {out_tol}), loss {card[1]:.6f} vs {ref[1]:.6f}, grad relative L2 "
              f"per tensor (<= {grad_tol}) {json.dumps({k: round(v, 6) for k, v in rel.items()})}")
        if bad or loss_rel > loss_tol or max(rel.values()) > grad_tol:
            raise AssertionError(f"the block on the card differs from the {name} version")
        for g in card[2]:
            finite(g, "grad")

    # (d) the heuristic (an empty DB): the attention products on the batched kernel
    use_db("heuristic")
    heur_out, heur = count(lambda: fn(params, x))
    heur_err = (heur_out.float().cpu() - plain[0]).abs()
    rec["heuristic"] = {"launches_per_forward": {k: v for k, v in heur.items() if v},
                        "output_max_abs_diff_vs_plain": heur_err.max().item()}
    print(f"  (d) heuristic forward: launches {json.dumps(rec['heuristic']['launches_per_forward'])}"
          f", output max |diff| vs plain {heur_err.max().item():.4g}")
    if heur["batched_single_k_wgmma"] <= 0:
        raise AssertionError(f"the heuristic's forward did not run the batched single-K wgmma "
                             f"body: {heur}")
    if int((heur_err > out_tol + out_tol * plain[0].abs()).sum()):
        raise AssertionError("the heuristic's forward differs from the plain version")

    # (f) forward and train-step ms under the committed DB, the heuristic and the vendor
    # config, in turns (CUDA events over back-to-back calls); the model FLOPs' share of peak
    fwd_flops = _model_flops(SEQ, D_MODEL, D_FF, N_HEADS)
    kinds = ("committed", "heuristic", "vendor")
    times = {k: {"forward_ms": [], "train_step_ms": []} for k in kinds}
    for kind in kinds + kinds[::-1]:
        use_db("heuristic" if kind == "heuristic" else "committed")
        config = KernelConfig.vendor() if kind == "vendor" else None
        times[kind]["forward_ms"].append(_time_ms(
            torch, lambda: block_forward(params, x, N_HEADS, config=config), reps=10))
        times[kind]["train_step_ms"].append(_time_ms(
            torch, lambda: block_train_step(params, x, y, N_HEADS, lr=lr, config=config),
            reps=5))
    name = torch.cuda.get_device_name(0)
    rec["times"] = {}
    for kind, t in times.items():
        fwd, step = float(np.mean(t["forward_ms"])), float(np.mean(t["train_step_ms"]))
        rec["times"][kind] = {**t, "forward_mean_ms": fwd, "train_step_mean_ms": step,
                              "forward_flops_share": profiling.flops_share(fwd_flops, fwd, name),
                              "train_flops_share": profiling.flops_share(3 * fwd_flops, step,
                                                                         name)}
        print(f"  (f) {kind}: forward {json.dumps(t['forward_ms'])} ms, train step "
              f"{json.dumps(t['train_step_ms'])} ms (in turns); model FLOPs share of peak "
              f"{rec['times'][kind]['forward_flops_share']} forward, "
              f"{rec['times'][kind]['train_flops_share']} train step")
    rec["model_flops"] = {"forward": fwd_flops, "train_step": 3 * fwd_flops}
    print(f"  model FLOPs: {fwd_flops / 1e9:.3f} GFLOP forward, {3 * fwd_flops / 1e9:.3f} "
          "GFLOP train step (the six products; the backward's two per product)")

    # one profiled forward and train step through the committed DB, and a train step
    # through the heuristic and the vendor config: device busy time, idle share, top ops
    steps = [("forward", "committed", None), ("train_step", "committed", None),
             ("train_step", "heuristic", None), ("train_step", "vendor", KernelConfig.vendor())]
    for what, kind, config in steps:
        use_db("heuristic" if kind == "heuristic" else "committed")
        prof = profiling.profile_step(
            (lambda c=config: block_forward(params, x, N_HEADS, config=c)) if what == "forward"
            else (lambda c=config: block_train_step(params, x, y, N_HEADS, lr=lr, config=c)))
        rec[f"profile_{what}_{kind}"] = prof
        print(f"  profiled {what} ({kind}): {prof['device_events']} device events, busy "
              f"{prof['device_busy_ms']} ms of {prof['wall_ms']:.4f} ms wall (unprofiled "
              f"{prof['wall_ms_unprofiled']:.4f}), idle share {prof['idle_share']}; top device "
              f"ops {json.dumps(prof['top_device_ops'][:6])}; top host ops "
              f"{json.dumps(prof['top_host_ops'][:6])}")
    use_db("committed")
    # profile_shape at the block's widest product (FFN-1, 512 x 4096 x 1024), its
    # candidate's timing traced
    trace_dir = Path(__file__).resolve().parent / "runs" / "chip_smoke" / "trace_ffn1"
    for f in trace_dir.glob("*.json"):
        f.unlink()
    rec["profile_shape_ffn1"] = profiling.profile_shape(SEQ, D_FF, D_MODEL, trials=3,
                                                        trace_dir=str(trace_dir))
    traces = list(trace_dir.glob("*.json"))
    print(f"  profile_shape {SEQ}x{D_FF}x{D_MODEL}: {json.dumps(rec['profile_shape_ffn1'])}; "
          f"{len(traces)} trace file(s)")
    if not traces:
        raise AssertionError("maybe_trace wrote no trace")
    return rec, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json_out", default=None, help="also write the detailed record here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from tpul2_torch import dispatch
    from tpul2_torch.autotune import __main__ as tune_cli
    from tpul2_torch.autotune import db as db_mod
    from tpul2_torch.config import (PIPELINE_DEPTHS, SMEM_LIMIT, KernelConfig,
                                    candidate_configs, heuristic_config)
    from tpul2_torch.dispatch import candidate_fn, resolve_config
    from tpul2_torch.harness import bench_utils as bu
    from tpul2_torch.ops import baselines
    from tpul2_torch.ops import batched as bmm
    from tpul2_torch.ops import matmul as mm
    from tpul2_torch.ops import pipelined as pl
    from tpul2_torch.ops._build import check_launch, load_library
    from tpul2_torch.utils.platform import device_info, require_hopper

    #: counter key -> (module, attribute): each body on each route, 2-D and batched
    count_attrs = {f"{prefix}{body}_k_{route}": (mod, f"LAUNCHES_{body.upper()}_K_"
                                                      f"{route.upper()}")
                   for prefix, mod in (("", mm), ("batched_", bmm))
                   for body in ("multi", "single") for route in ("wgmma", "mma_sync")}
    for key in ("ring", "mma_sync", "split"):
        count_attrs[f"staged_{key}"] = (pl, f"LAUNCHES_STAGED_{key.upper()}")

    def zero_counters():
        for mod, attr in count_attrs.values():
            setattr(mod, attr, 0)

    def counters() -> dict:
        return {key: getattr(mod, attr) for key, (mod, attr) in count_attrs.items()}

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
                ring = bm in mm.WGMMA_TILES and bn in mm.WGMMA_TILES
                for depth in PIPELINE_DEPTHS[1:]:
                    cfg = KernelConfig(bm=bm, bn=bn, pipeline_depth=depth)
                    kernel = (lib.tl2_wgmma_smem_bytes(bm, bn, depth) if ring
                              else lib.tl2_staged_smem_bytes(bm, bn, depth))
                    if kernel != cfg.smem_bytes():
                        raise AssertionError(f"staged smem model differs from the kernel at "
                                             f"{bm}x{bn} depth {depth} (ring {ring})")
                    if (cfg.validate() is None) != (kernel <= SMEM_LIMIT):
                        raise AssertionError(f"validate at {bm}x{bn} depth {depth} does not "
                                             f"follow the kernel's {kernel} bytes")
        for bm in mm.WGMMA_TILES:
            for bn in mm.WGMMA_TILES:
                if lib.tl2_wgmma_smem_bytes(bm, bn, mm.WGMMA_STAGES) != mm.wgmma_smem_bytes(
                        bm, bn):
                    raise AssertionError(f"wgmma smem model differs from the kernel at "
                                         f"{bm}x{bn}")
        n_route = _check_route_mirror(torch, lib, mm, KernelConfig)
        n_staged = _check_staged_route_mirror(torch, lib, pl, KernelConfig)
        print(f"  smem models and route rules agree with the kernels ({n_route[0]} route "
              f"cases, {n_route[1]} of them wgmma; {n_staged[0]} staged route cases, "
              f"{n_staged[1]} of them on the ring)")
        print(f"  build {lib.build_seconds:.1f} s (0.0 = library was current)")
        record["build_seconds"] = lib.build_seconds
        record["ptxas"] = regs

    max_err = {key: 0.0 for key in counters()}

    def pin_empty_db():
        """Resolve through the heuristic: TPUL2_TORCH_TUNEDB names a file that is not
        there, so the committed DB does not steer the phases that measure the heuristic."""
        path = repo / "runs" / "chip_smoke" / "tunedb_empty.json"
        path.unlink(missing_ok=True)
        os.environ[db_mod.ENV_VAR] = str(path)
        db_mod.reset_default_db()

    pin_empty_db()

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
            if name.startswith("wgmma") and (not key.endswith("wgmma") or (
                    "single_k" in key) != (-(-k // cfg.bk) == 1)):
                raise AssertionError(f"{name} took {key}, not the wgmma route of its body")
            max_err[key] = max(max_err[key], errs[1])
            print(f"  {name} {cfg.bm}x{cfg.bn} bk={cfg.bk} out={out}: {key}, 0/1 exact, "
                  f"normal max|diff| {errs[1]:.3g}")
        record["phase2_cases"] = len(cases)
        # the bf16 family's single interval with f32 output is the f32 sum: the kernel's
        # result must stand off its own bf16 rounding, as the f32 sum does
        m = n = k = 1000
        cfg = KernelConfig(bm=64, bn=64, bk=1024, acc_dtype="bfloat16")
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        got = mm.cuda_matmul(a, b, cfg, out_dtype=torch.float32)
        f32_sum = a.float() @ b.float()
        rounded = (got.bfloat16().float() - got).abs().max().item()
        record["bf16_family_gk1_f32_out"] = {
            "route": mm.launch_route(cfg, a, b, m, n, k),
            "max_diff_vs_f32_sum": (got - f32_sum).abs().max().item(),
            "max_diff_vs_own_bf16_rounding": rounded}
        print("  bf16 family, one interval, f32 out at 1000^3: "
              + json.dumps(record["bf16_family_gk1_f32_out"]))
        if record["bf16_family_gk1_f32_out"]["route"] != "wgmma" or rounded == 0.0:
            raise AssertionError("the bf16 family's single interval was rounded to bf16")
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
        cases = _staged_cases(candidate_configs, KernelConfig, mm.WGMMA_TILES)
        seen = set()
        for name, m, n, k, kw, out, route in cases:
            cfg = KernelConfig(**kw)
            depth = pl.staged_depth(cfg.pipeline_depth, k // cfg.bk)
            splits = (pl.staged_splits(m, n, k, cfg.bm, cfg.bn, depth) if route == "ring"
                      else 1)
            before = counters()
            errs = [_check_staged(torch, mm, pl, gen, m, n, k, cfg, out, zero_one, splits,
                                  repeat=splits > 1 and not zero_one)
                    for zero_one in (True, False)]
            moved = {key: v - before[key] for key, v in counters().items() if v != before[key]}
            if route is None:  # gk == 1: one single-K launch per input set, on either route
                want = {key: 2 for key in moved if key.startswith("single_k")} or {"single_k": 2}
            else:  # a split case runs its normal inputs twice
                runs = 3 if splits > 1 else 2
                want = {f"staged_{route}": runs} | ({"staged_split": runs} if splits > 1 else {})
            if moved != want:
                raise AssertionError(f"{name}: launches {moved}, expected {want}")
            if route is not None:
                seen.add((route, splits > 1))
                for key in want:
                    max_err[key] = max(max_err[key], errs[1])
            print(f"  {name} {cfg.bm}x{cfg.bn} bk={cfg.bk} out={out}: {route or 'single-K'}"
                  f"{f', {splits} splits, repeat bit-identical' if splits > 1 else ''}, 0/1 "
                  f"exact, normal max|diff| {errs[1]:.3g}")
        if seen != {("ring", True), ("ring", False), ("mma_sync", False)}:
            raise AssertionError(f"phase 2b missed a route or split: {seen}")
        record["phase2b_cases"] = len(cases)
        # precision of the f32 sums at the tuning shape, against an f64 product: the ring
        # (one split, as its shape gives), the same ring split 8 ways (launched directly),
        # the mma.sync body on a 32-edge tile, the plain version (cuBLAS f32) and one K
        # interval (bk = K) on the ring's tile, through the body the route picks for it
        m, n, k = TUNE_SHAPE
        cfg = next(KernelConfig(**kw) for _, *mnk, kw, _, _ in cases
                   if tuple(mnk) == TUNE_SHAPE)
        cfg = dataclasses.replace(cfg, rhs_layout="kn")
        mma_cfg = KernelConfig(bm=32, bn=64, bk=cfg.bk, pipeline_depth=4)
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        ref = a.double() @ b.double()
        one = KernelConfig(bm=cfg.bm, bn=cfg.bn, bk=k)
        split8 = torch.empty((m, n), dtype=torch.float32, device="cuda")
        pl.launch_staged(a, b, cfg, split8, cfg.pipeline_depth, m, n, k, "ring", 8)
        outs = {"staged_ring": pl.cuda_matmul_pipelined(a, b, cfg, out_dtype=torch.float32),
                "staged_ring_split8": split8,
                "staged_mma_sync": pl.cuda_matmul_pipelined(a, b, mma_cfg,
                                                            out_dtype=torch.float32),
                "plain": pl.pipelined_reference(a, b, "kn", torch.float32),
                f"one_interval_{mm.launch_route(one, a, b, m, n, k)}": mm.cuda_matmul(
                    a, b, one, out_dtype=torch.float32)}
        record["precision_vs_f64"] = {name: (x.double() - ref).abs().max().item()
                                      for name, x in outs.items()}
        print(f"  max |err| vs an f64 product at {m}x{n}x{k} ({cfg.bm}x{cfg.bn} depth "
              f"{cfg.pipeline_depth}; mma.sync 32x64 depth 4): "
              + json.dumps(record["precision_vs_f64"]))
        del a, b, ref, outs, split8

    eval_mod = _script(repo, "eval_one_shape_torch")
    host_time = _script(repo, "host_time_torch")  # alone_ms: device time, no host time

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
        for (m, n, k), acc in SLICE_SHAPES + [(sh, "float32") for sh in FEW_CTA_SHAPES]:
            base = repo / "runs" / "chip_smoke" / f"{m}x{n}x{k}_{acc}"
            record["slice"].append(run_slice(m, n, k, acc, base))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        for batch, m, n, k in UNALIGNED_SHAPES:
            cfg = resolve_config(m, n, k)
            if batch > 1:
                a = _inputs(torch, gen, (batch, m, k), True)
                b = _inputs(torch, gen, (batch, k, n), True)
                got = dispatch.batched_matmul(a, b, out_dtype=torch.float32)
            else:
                a, b = _inputs(torch, gen, (m, k), True), _inputs(torch, gen, (k, n), True)
                got = dispatch.matmul(a, b, out_dtype=torch.float32)
            want = mm.matmul_reference(a, b, cfg.bk, out_dtype=torch.float32)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"entry point at {batch}x{m}x{n}x{k} is not exact")
            print(f"  entry point {batch}x{m}x{n}x{k} {cfg.bm}x{cfg.bn} bk={cfg.bk} "
                  f"({mm.launch_route(cfg, a, b, m, n, k)}): exact on 0/1 inputs")
        # the entry point with a staged config on each route: a 32-edge tile (mma.sync)
        # and a ring tile whose one output tile splits K 48 ways
        for (m, n, k), (bm, bn) in (((64, 256, 8192), (32, 64)), ((64, 64, 12288), (64, 64))):
            cfg = KernelConfig(bm=bm, bn=bn, bk=1024, pipeline_depth=4)
            a, b = _inputs(torch, gen, (m, k), True), _inputs(torch, gen, (k, n), True)
            got = dispatch.matmul(a, b, config=cfg, out_dtype=torch.float32)
            route = pl.staged_route(cfg, a, b, m, n, k)
            splits = pl.staged_splits(m, n, k, bm, bn, 4) if route == "ring" else 1
            if not torch.equal(got, pl.pipelined_reference(a, b, "kn", torch.float32, splits)):
                raise AssertionError(f"staged entry point at {m}x{n}x{k} is not exact")
            print(f"  entry point {m}x{n}x{k} staged {bm}x{bn} depth 4 ({route}, {splits} "
                  "splits): exact on 0/1 inputs")
    launches = counters()

    with phase("4 launch counts"):
        print("  " + json.dumps(launches))
        missing = [key for key, v in launches.items() if v <= 0]
        if missing:
            raise AssertionError(f"main path never launched: {missing}")

    tuned = {}
    with phase("tune"):
        db_path = repo / "runs" / "chip_smoke" / "tunedb_h100.json"
        db_path.unlink(missing_ok=True)
        os.environ[db_mod.ENV_VAR] = str(db_path)
        db_mod.reset_default_db()
        record["tune"] = []
        for tm, tn, tk in TUNE_SHAPES:
            zero_counters()
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rc = tune_cli.main(["--mnk", str(tm), str(tn), str(tk), "--acc", "float32",
                                    "--max_candidates", "8", "--stage1_rounds", "3",
                                    "--stage2_rounds", "5", "--finalists", "4"])
            tune_launches = counters()
            if rc != 0:
                raise AssertionError(f"the tuner exited {rc} at {tm}x{tn}x{tk}")
            res = json.loads(printed.getvalue())
            print(f"  {tm}x{tn}x{tk} (device ms by CUDA graphs, then end to end):")
            for d in res["medians_ms"]:
                c = d["config"]
                name = (f"vendor {c['vendor_variant']}" if c["use_vendor"] else
                        f"{c['bm']}x{c['bn']} bk={c['bk']} {c['grid_order']} "
                        f"{c['rhs_layout']} depth={c['pipeline_depth']}")
                print(f"    {name}: device stage1 {d['stage1_ms']:.5f} ms, stage2 "
                      + ("-" if d["stage2_ms"] is None else f"{d['stage2_ms']:.5f} ms")
                      + f"; end to end {d['e2e_ms']:.5f} ms")
            if res["clock"] != "cuda_graph" or res["refused"]:
                raise AssertionError(f"clock {res['clock']}, refused {res['refused']}")
            best = KernelConfig(**res["best"])
            if not (best.use_vendor and best.vendor_variant == "torch_matmul") \
                    and res["speedup"] <= 1.10:
                raise AssertionError(f"{best} stored within the 10% margin of torch_matmul")
            # torch_matmul and cublas_nn are one library call: their device times, in turns
            # over fresh inputs, must agree within the tuner's 10% margin
            data = bu.fresh_inputs(np.random.default_rng(7), tm, tn, tk)
            same = {v: bu.GraphTimer(lambda a, b, b_t, v=v: baselines.vendor_product(
                v, a, b, b_t, torch.bfloat16), data, bu.bound_ms(tm, tn, tk))
                for v in ("torch_matmul", "cublas_nn")}
            same_ms = {v: [] for v in same}
            for r in range(10):
                bu.load_inputs(data, bu.fresh_inputs(np.random.default_rng(r), tm, tn, tk))
                for v in (("torch_matmul", "cublas_nn") if r % 2 else
                          ("cublas_nn", "torch_matmul")):
                    same_ms[v].append(same[v].time_ms())
            ratio = float(np.median(same_ms["cublas_nn"]) / np.median(same_ms["torch_matmul"]))
            print(f"    cublas_nn / torch_matmul device time {ratio:.4f} over 10 rounds in "
                  "turns (one library call: must be within 10%)")
            if abs(ratio - 1.0) > 0.10:
                raise AssertionError("two timings of one library call differ by > 10%")
            del data, same
            print(f"    winner: {json.dumps(res['best'])}, {res['best_tflops']:.2f} TFLOP/s, "
                  f"{res['speedup']:.4f}x vs torch_matmul "
                  f"({res['torch_matmul_tflops']:.2f} TFLOP/s); launches "
                  + json.dumps(tune_launches))
            staged = [d for d in res["medians_ms"] if d["config"]["pipeline_depth"] >= 2]
            if res["n_launched"] != res["n_candidates"]:
                raise AssertionError(f"only {res['n_launched']} of {res['n_candidates']} "
                                     "candidates launched")
            if len(staged) < 2:
                raise AssertionError(f"{len(staged)} staged candidates timed (need 2)")
            if not all(d["config"]["bm"] in mm.WGMMA_TILES
                       and d["config"]["bn"] in mm.WGMMA_TILES for d in staged):
                raise AssertionError("a staged candidate is not a ring tile")
            if tune_launches["staged_ring"] <= 0 or tune_launches["staged_mma_sync"] != 0:
                raise AssertionError("the staged candidates did not all launch on the ring")
            if ((tm, tn, tk) != TUNE_SHAPE) != (tune_launches["staged_split"] > 0):
                raise AssertionError(f"split launches {tune_launches['staged_split']} at "
                                     f"{tm}x{tn}x{tk}")
            entry = db_mod.TuneDB(path=db_path).load().get_entry(tm, tn, tk, "float32")
            if entry is None or KernelConfig(**entry["config"]) != KernelConfig(**res["best"]):
                raise AssertionError(f"the winner is not on disk: {entry}")
            if entry["timing_rev"] != 2 or set(entry["e2e_ms"]) != {"best", "torch_matmul"}:
                raise AssertionError(f"the entry lacks timing_rev 2 or its end-to-end "
                                     f"times: {entry}")
            print(f"    stored: timing_rev {entry['timing_rev']}, device ms "
                  f"{json.dumps(entry['device_ms'])}, end-to-end ms "
                  f"{json.dumps(entry['e2e_ms'])}, {entry['nvidia_smi']}")
            tuned[tm, tn, tk] = res
            record["tune"].append({**res, "launches": tune_launches})

    with phase("tuned dispatch"):
        db_path = repo / "runs" / "chip_smoke" / "tunedb_staged.json"
        db_path.unlink(missing_ok=True)
        db = db_mod.TuneDB(path=db_path)
        staged_cfgs = {}
        for shape, res in tuned.items():
            staged = [d for d in res["medians_ms"] if d["config"]["pipeline_depth"] >= 2]
            fastest = min(staged, key=lambda d: d["stage1_ms"])
            staged_cfgs[shape] = KernelConfig(**fastest["config"])
            reference_ms = next(d["stage1_ms"] for d in res["medians_ms"]
                                if d["config"]["use_vendor"]
                                and d["config"]["vendor_variant"] == "torch_matmul")
            for acc in ("float32", "bfloat16"):
                db.put(*shape, dataclasses.replace(staged_cfgs[shape], acc_dtype=acc),
                       2.0 * math.prod(shape) / fastest["stage1_ms"] * 1e-9, acc=acc,
                       extra={"speedup_vs_torch_matmul": reference_ms / fastest["stage1_ms"]})
            print(f"  stored {staged_cfgs[shape]} at {shape} (stage1 "
                  f"{fastest['stage1_ms']:.5f} ms)")
        db.save()
        os.environ[db_mod.ENV_VAR] = str(db_path)
        db_mod.reset_default_db()
        record["tuned_dispatch"] = []
        record["tuned_dispatch_launches"] = {}
        for (tm, tn, tk), staged_cfg in staged_cfgs.items():
            for acc in ("float32", "bfloat16"):
                got = resolve_config(tm, tn, tk, acc)
                if got != dataclasses.replace(staged_cfg, acc_dtype=acc):
                    raise AssertionError(f"dispatch resolved {got}, not the stored staged "
                                         "config")
            zero_counters()
            record["tuned_dispatch"] += [
                run_slice(tm, tn, tk, acc, repo / "runs" / "chip_smoke" /
                          f"staged_{tm}x{tn}x{tk}_{acc}") for acc in ("float32", "bfloat16")]
            path_launches = counters()
            print(f"  {tm}x{tn}x{tk} launches " + json.dumps(path_launches))
            split = (tm, tn, tk) != TUNE_SHAPE
            if (path_launches["staged_ring"] <= 0
                    or (path_launches["staged_split"] > 0) != split):
                raise AssertionError("the tuned dispatch path did not launch the staged ring"
                                     + (" with a split" if split else " without a split"))
            record["tuned_dispatch_launches"][f"{tm}x{tn}x{tk}"] = path_launches
        pin_empty_db()  # phase 5 and later resolve through the heuristic again
    # the launches of each staged body on its main paths: the staged entry points of
    # phase 3 and the tuned dispatch path
    for key in ("staged_ring", "staged_mma_sync", "staged_split"):
        launches[key] += sum(c[key] for c in record["tuned_dispatch_launches"].values())

    # Representative main-path call of each kernel body, timed against its plain version:
    # both routes of each multi-K body on the same tile and inputs, then the single-K ones.
    kernels = []
    kernel_keys = []  # the launch counter of each row
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
            if mm.launch_route(cfg, a, b, m, n, k) != "wgmma":
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
                kernel_keys.append(key)
        del a, b, out
        # the single-K bodies alone on both routes, in turns (wgmma, mma.sync, mma.sync,
        # wgmma): CUDA graphs of direct launches, since the entry point's host time exceeds
        # their device time; torch.matmul (torch.bmm) the same way
        record["single_k_alone"] = []
        fns = {"wgmma": lib.tl2_wgmma_bf16out, "mma_sync": lib.tl2_matmul_bf16out}
        for batch, m, n, k, acc in ((1, 8192, 128, 64, "float32"),
                                    (GATE_BATCH, 8192, 128, 64, "float32"),
                                    (1, 1000, 1000, 1000, "float32"),
                                    (1, 1000, 1000, 1000, "bfloat16")):
            batched = batch > 1
            lead = (batch,) if batched else ()
            cfg = resolve_config(m, n, k, acc)
            a = _inputs(torch, gen, (*lead, m, k), False)
            b = _inputs(torch, gen, (*lead, k, n), False)
            out = torch.empty((*lead, m, n), dtype=torch.bfloat16, device="cuda")
            if mm.launch_route(cfg, a, b, m, n, k) != "wgmma" or -(-k // cfg.bk) != 1:
                raise AssertionError(f"{cfg} is not a single-K wgmma launch at {m}x{n}x{k}")

            def direct(route, a=a, b=b, cfg=cfg, out=out, batch=batch, m=m, n=n, k=k):
                def make():  # the arguments name the capturing stream
                    call = mm.launch_args(a, b, cfg, out, None, None, batch, m, n, k)
                    return lambda: check_launch(fns[route](*call), route)
                return make

            library = torch.bmm if batched else torch.matmul
            if batched:
                plain = lambda: bmm.batched_matmul_reference(a, b, cfg.bk)  # noqa: E731
                wrapper = lambda: bmm.cuda_batched_matmul(a, b, cfg, out=out)  # noqa: E731
            else:
                plain = lambda: mm.matmul_reference(a, b, cfg.bk, acc)  # noqa: E731
                wrapper = lambda: mm.cuda_matmul(a, b, cfg, out=out)  # noqa: E731
            turns = [host_time.alone_ms(torch, direct(route))
                     for route in ("wgmma", "mma_sync", "mma_sync", "wgmma")]
            bound_ms, bound_by = _bound(batch, m, n, k)
            row = {"batch": batch, "mnk": [m, n, k], "acc": acc,
                   "config": f"{cfg.bm}x{cfg.bn} bk={cfg.bk}", "turns_ms": turns,
                   "wgmma_ms": (turns[0] + turns[3]) / 2,
                   "mma_sync_ms": (turns[1] + turns[2]) / 2,
                   "torch_alone_ms": host_time.alone_ms(torch, lambda: (lambda: library(a, b))),
                   "wrapper_back_to_back_ms": _time_ms(torch, wrapper),
                   "plain_ms": _time_ms(torch, plain), "bound_ms": bound_ms,
                   "bound_by": bound_by}
            record["single_k_alone"].append(row)
            print("  single-K alone " + json.dumps(row))
            if (m, n, k) != (8192, 128, 64):
                continue
            prefix = "batched_" if batched else ""
            for route, source in (("wgmma", "tpul2_torch/csrc/tl2_wgmma.cu"),
                                  ("mma_sync", "tpul2_torch/csrc/tl2_matmul.cu")):
                key = f"{prefix}single_k_{route}"
                kernels.append({
                    "name": (f"{'tl2_wgmma' if route == 'wgmma' else 'tl2_matmul mma.sync'}"
                             f"{' batched' if batched else ''} (single-K)"),
                    "route": "cuda", "source": source,
                    "replaces": ("tpul2/ops/batched.py:40" if batched
                                 else "tpul2/ops/matmul.py:136"),
                    "launches": launches[key], "max_abs_err": max_err[key],
                    "ms": row[f"{route}_ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": row["torch_alone_ms"]})
                kernel_keys.append(key)
        del a, b, out
        # the staged kernel alone at the tuning shape: the ring on the config the tuned path
        # dispatched against tl2_staged.cu's 32x64 at depth 4, in turns (CUDA graphs of
        # wrapper calls, so no host time enters)
        tm, tn, tk = TUNE_SHAPE
        ring_cfg = dataclasses.replace(staged_cfgs[TUNE_SHAPE], acc_dtype="float32")
        mma_cfg = KernelConfig(bm=32, bn=64, bk=ring_cfg.bk, pipeline_depth=4)
        a, b = _inputs(torch, gen, (tm, tk), False), _inputs(torch, gen, (tk, tn), False)
        b_t = b.t().contiguous()
        out = torch.empty((tm, tn), dtype=torch.bfloat16, device="cuda")

        def staged_call(cfg, a=a, b=b, b_t=b_t, out=out):
            rhs = b_t if cfg.rhs_layout == "nk" else b
            return lambda: (lambda: pl.cuda_matmul_pipelined(a, rhs, cfg, out=out))

        turns = [host_time.alone_ms(torch, staged_call(c))
                 for c in (ring_cfg, mma_cfg, mma_cfg, ring_cfg)]
        plain_ms = _time_ms(torch, lambda: pl.pipelined_reference(a, b))
        library_ms = host_time.alone_ms(torch, lambda: (lambda: torch.matmul(a, b)))
        bound_ms, bound_by = _bound(1, tm, tn, tk)
        record["staged_alone_turns_ms"] = {"ring": str(ring_cfg), "mma_sync": str(mma_cfg),
                                           "turns_ms": turns, "torch_alone_ms": library_ms}
        print(f"  staged alone at {tm}x{tn}x{tk} in turns (ring {ring_cfg.bm}x{ring_cfg.bn} "
              f"{ring_cfg.rhs_layout} d{ring_cfg.pipeline_depth}, mma.sync 32x64 d4, mma.sync, "
              f"ring) ms: {json.dumps(turns)}; torch.matmul alone {library_ms:.5f}")
        for route, cfg, ms in (("ring", ring_cfg, (turns[0] + turns[3]) / 2),
                               ("mma_sync", mma_cfg, (turns[1] + turns[2]) / 2)):
            kernels.append({
                "name": (f"{'tl2_wgmma_staged ring' if route == 'ring' else 'tl2_staged mma.sync'}"
                         f" ({cfg.bm}x{cfg.bn} {cfg.rhs_layout} depth {cfg.pipeline_depth}, "
                         f"{tm}x{tn}x{tk}, one split)"),
                "route": "cuda",
                "source": ("tpul2_torch/csrc/tl2_wgmma.cu" if route == "ring"
                           else "tpul2_torch/csrc/tl2_staged.cu"),
                "replaces": "tpul2/ops/pipelined.py:39",
                "launches": launches[f"staged_{route}"],
                "max_abs_err": max_err[f"staged_{route}"], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})
            kernel_keys.append(f"staged_{route}")
        # every depth on both routes (same inputs, alone): the 64x64 ring, 32x64 mma.sync
        sweep = {}
        for depth in PIPELINE_DEPTHS[1:]:
            sweep[depth] = {}
            for c in (KernelConfig(bm=64, bn=64, bk=ring_cfg.bk, pipeline_depth=depth),
                      dataclasses.replace(mma_cfg, pipeline_depth=depth)):
                key = f"{c.bm}x{c.bn} {pl.staged_route(c, a, b, tm, tn, tk)}"
                sweep[depth][key] = host_time.alone_ms(torch, staged_call(c))
        record["staged_depth_sweep_alone_ms"] = sweep
        print("  staged depth sweep alone (ms): " + json.dumps(sweep))
        # the skinny serving shape (same inputs): the heuristic's tile against the 32x64
        # mma.sync tile it picked before it stopped at the wgmma tiles and the 64x128 wgmma
        # tile, through the wrapper in turns, then each alone
        heuristic = resolve_config(tm, tn, tk, "float32")
        if heuristic.bm != 64 or mm.launch_route(heuristic, a, b, tm, tn, tk) != "wgmma":
            raise AssertionError(f"the heuristic's {heuristic} at {tm}x{tn}x{tk} is not a "
                                 "64-row wgmma tile")
        tiles = [heuristic] + [KernelConfig(bm=bm, bn=bn, bk=heuristic.bk)
                               for bm, bn in ((32, 64), (64, 128))]
        skinny = {f"{c.bm}x{c.bn} bk={c.bk}": {"route": mm.launch_route(c, a, b, tm, tn, tk),
                                               "ms": []} for c in tiles}
        for c in tiles + tiles[::-1]:
            skinny[f"{c.bm}x{c.bn} bk={c.bk}"]["ms"].append(
                _time_ms(torch, lambda c=c: mm.cuda_matmul(a, b, c)))
        out = torch.empty((tm, tn), dtype=torch.bfloat16, device="cuda")
        for c in tiles:
            fn = fns[mm.launch_route(c, a, b, tm, tn, tk)]

            def make(c=c, fn=fn):
                call = mm.launch_args(a, b, c, out, None, None, 1, tm, tn, tk)
                return lambda: check_launch(fn(*call), "skinny")

            skinny[f"{c.bm}x{c.bn} bk={c.bk}"]["alone_ms"] = host_time.alone_ms(torch, make)
        record["skinny_tiles"] = skinny
        print(f"  {tm}x{tn}x{tk} tiles in turns (ms): " + json.dumps(skinny))
        # the few-CTA streaming shapes: the heuristic config (both families), the fastest of
        # the tuner's staged candidates there (alone), and torch.matmul, each alone (a CUDA
        # graph of direct launches) and through the entry point (back to back), in turns
        record["few_cta"] = []
        for m, n, k in FEW_CTA_SHAPES:
            a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
            b_t = b.t().contiguous()
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            candidates = {c: host_time.alone_ms(torch, staged_call(c, a, b, b_t, out))
                          for c in candidate_configs(m, n, k, "float32") if c.pipeline_depth >= 2}
            best = min(candidates, key=candidates.get)
            depth = pl.staged_depth(best.pipeline_depth, k // best.bk)
            heur = {acc: heuristic_config(m, n, k, acc) for acc in ("float32", "bfloat16")}

            def direct(cfg, a=a, b=b, out=out, m=m, n=n, k=k):
                def make():
                    call = mm.launch_args(a, b, cfg, out, None, None, 1, m, n, k)
                    fn = fns[mm.launch_route(cfg, a, b, m, n, k)]
                    return lambda: check_launch(fn(*call), "heuristic")
                return make

            alone_fns = {"heuristic_f32": direct(heur["float32"]),
                         "heuristic_bf16": direct(heur["bfloat16"]),
                         "staged": staged_call(best, a, b, b_t, out),
                         "torch_matmul": lambda a=a, b=b: (lambda: torch.matmul(a, b))}
            entry_fns = {"heuristic_f32": lambda a=a, b=b, b_t=b_t, out=out: dispatch.matmul(
                             a, b, acc="float32", b_t=b_t, out=out),
                         "heuristic_bf16": lambda a=a, b=b, b_t=b_t, out=out: dispatch.matmul(
                             a, b, acc="bfloat16", b_t=b_t, out=out),
                         "staged": lambda a=a, b=b, b_t=b_t, out=out, c=best: dispatch.matmul(
                             a, b, config=c, b_t=b_t, out=out),
                         "torch_matmul": lambda a=a, b=b: torch.matmul(a, b)}
            order = list(alone_fns) + list(alone_fns)[::-1]
            alone = {key: [] for key in alone_fns}
            entry = {key: [] for key in alone_fns}
            for key in order:
                alone[key].append(host_time.alone_ms(torch, alone_fns[key]))
            for key in order:
                entry[key].append(_time_ms(torch, entry_fns[key]))
            bound_ms, bound_by = _bound(1, m, n, k)
            row = {"mnk": [m, n, k],
                   "heuristic": f"{heur['float32'].bm}x{heur['float32'].bn} "
                                f"bk={heur['float32'].bk}",
                   "heuristic_ctas": (m // heur["float32"].bm) * (n // heur["float32"].bn),
                   "staged": str(best), "staged_splits": pl.staged_splits(
                       m, n, k, best.bm, best.bn, depth),
                   "staged_candidates_alone_ms": {
                       f"{c.grid_order} {c.rhs_layout} d{c.pipeline_depth}": ms
                       for c, ms in candidates.items()},
                   "alone_ms": alone, "entry_ms": entry, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            record["few_cta"].append(row)
            print("  few-CTA " + json.dumps(row))
        # the split launch alone at 64x64x12288 on the tuned dispatch's config, and the
        # reduction alone on a workspace of its size
        m, n, k = FEW_CTA_SHAPES[0]
        split_cfg = dataclasses.replace(staged_cfgs[FEW_CTA_SHAPES[0]], acc_dtype="float32")
        depth = pl.staged_depth(split_cfg.pipeline_depth, k // split_cfg.bk)
        splits = pl.staged_splits(m, n, k, split_cfg.bm, split_cfg.bn, depth)
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        b_t = b.t().contiguous()
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        rhs = b_t if split_cfg.rhs_layout == "nk" else b
        bound_ms, bound_by = _bound(1, m, n, k)
        kernels.append({
            "name": (f"tl2_wgmma_staged ring, split K ({split_cfg.bm}x{split_cfg.bn} "
                     f"{split_cfg.rhs_layout} depth {split_cfg.pipeline_depth}, {m}x{n}x{k}, "
                     f"{splits} splits + reduction)"),
            "route": "cuda", "source": "tpul2_torch/csrc/tl2_wgmma.cu",
            "replaces": "tpul2/ops/pipelined.py:39", "launches": launches["staged_split"],
            "max_abs_err": max_err["staged_split"],
            "ms": host_time.alone_ms(torch, staged_call(split_cfg, a, b, b_t, out)),
            "plain_ms": _time_ms(torch, lambda: pl.pipelined_reference(
                a, rhs, split_cfg.rhs_layout, torch.bfloat16, splits)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": host_time.alone_ms(torch, lambda: (lambda: torch.matmul(a, b)))})
        kernel_keys.append("staged_split")
        ws = torch.randn((splits, m, n), generator=gen, device="cuda")

        def reduce_plain():
            acc = ws[0]
            for s in range(1, splits):
                acc = acc + ws[s]
            return acc.to(torch.bfloat16)

        def make_reduce():
            stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
            return lambda: check_launch(lib.tl2_splitk_reduce(
                ws.data_ptr(), out.data_ptr(), m, n, splits, 0, stream), "tl2_splitk_reduce")

        make_reduce()()
        reduce_err = (out.float() - reduce_plain().float()).abs().max().item()
        kernels.append({
            "name": f"tl2_splitk_reduce ({splits} x {m}x{n} f32 -> bf16, split order)",
            "route": "cuda", "source": "tpul2_torch/csrc/tl2_wgmma.cu",
            "replaces": "tpul2/ops/pipelined.py:39", "launches": launches["staged_split"],
            "max_abs_err": reduce_err, "ms": host_time.alone_ms(torch, make_reduce),
            "plain_ms": _time_ms(torch, reduce_plain),
            "bound_ms": (splits * m * n * 4 + m * n * 2) / PEAK_BYTES * 1e3,
            "bound_by": "bytes",
            "library_ms": host_time.alone_ms(torch, lambda: (lambda: torch.sum(ws, 0)))})
        kernel_keys.append("staged_split")
        if reduce_err != 0.0:
            raise AssertionError(f"the reduction differs from the split-order sum by "
                                 f"{reduce_err}")
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

    with phase("lt-autotune"):
        from tpul2_torch.ops import lt_autotune
        gen = torch.Generator(device="cuda")
        gen.manual_seed(6)
        record["lt_autotune"] = []
        for m, n, k in ((4096, 4096, 4096), TUNE_SHAPE):
            a, b = _inputs(torch, gen, (m, k), True), _inputs(torch, gen, (k, n), True)
            b_t = b.t().contiguous()
            want = torch.mm(a, b)
            for layout, rhs in (("nn", b), ("tn", b_t)):
                found = lt_autotune.search(m, n, k, layout)
                for algo in [-1] + list(range(found.n_algos)):
                    got = lt_autotune.lt_matmul(a, rhs, layout, algo=algo)
                    if not torch.equal(got, want):
                        raise AssertionError(f"cuBLASLt algo {algo} at {m}x{n}x{k} {layout} "
                                             "is not exact on 0/1 inputs")
                row = {"mnk": [m, n, k], "layout": layout, "n_algos": found.n_algos,
                       "n_skipped": found.n_skipped, "best": found.best,
                       "best_median_ms": found.medians_ms[found.best],
                       "medians_ms": found.medians_ms, "search_s": found.seconds,
                       "alone_ms": host_time.alone_ms(torch, lambda rhs=rhs, layout=layout: (
                           lambda: lt_autotune.lt_matmul(a, rhs, layout))),
                       "torch_matmul_alone_ms": host_time.alone_ms(
                           torch, lambda: (lambda: torch.matmul(a, b)))}
                record["lt_autotune"].append(row)
                print(f"  {m}x{n}x{k} {layout}: {found.n_algos} algos kept, {found.n_skipped} "
                      f"skipped, winner {found.best} ({row['best_median_ms']:.5f} ms in the "
                      f"search; alone {row['alone_ms']:.5f} ms, torch.matmul alone "
                      f"{row['torch_matmul_alone_ms']:.5f}); every algo exact on 0/1 inputs")

    with phase("sentinel"):
        m = n = k = 4096
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        b_t = b.t().contiguous()
        bias = torch.randn((n,), generator=gen, device="cuda")
        gelu = mm.ACTIVATIONS["gelu"]

        def old_f32():  # the sentinel before this change: f32 copies, an f32 GEMM
            return torch.matmul(a.float(), b.float())

        paths = {
            "f32_out": {"old": old_f32,
                        "new": lambda: baselines.vendor_product("torch_matmul", a, b, b_t,
                                                                torch.float32)},
            "bias_gelu": {"old": lambda: gelu(old_f32() + bias),
                          "new": lambda: dispatch.matmul(
                              a, b, config=KernelConfig.vendor(), bias=bias,
                              activation="gelu", out_dtype=torch.float32)}}
        record["sentinel"] = {}
        for name, fns in paths.items():
            turns = [_time_ms(torch, fns[key], reps=10) for key in ("old", "new", "new", "old")]
            record["sentinel"][name] = {"turns_ms": turns, "old_ms": (turns[0] + turns[3]) / 2,
                                        "new_ms": (turns[1] + turns[2]) / 2}
            print(f"  {name} at 4096^3 in turns (old, new, new, old) ms: {json.dumps(turns)}")
        za, zb = _inputs(torch, gen, (m, k), True), _inputs(torch, gen, (k, n), True)
        zbias = torch.randint(0, 2, (n,), generator=gen, device="cuda").float()
        old = torch.relu(za.float() @ zb.float() + zbias)
        new = dispatch.matmul(za, zb, config=KernelConfig.vendor(), bias=zbias,
                              activation="relu", out_dtype=torch.float32)
        if not torch.equal(old, new) or not torch.equal(
                baselines.vendor_product("cublas_tn", za, zb, zb.t().contiguous(),
                                         torch.float32), za.float() @ zb.float()):
            raise AssertionError("the bf16-in, f32-out sentinel is not exact on 0/1 inputs")
        print("  new path exact on 0/1 inputs against the old (f32 out, bias + relu)")
        del a, b, b_t, za, zb, old, new

    with phase("server slice"):
        record["server_slice"] = []
        zero_counters()
        for (m, n, k) in ((64, 8192, 8192), (1000, 1000, 1000)):
            for acc in ("float32", "bfloat16"):
                base = repo / "runs" / "chip_smoke" / f"server_{m}x{n}x{k}_{acc}"
                rc = eval_mod.main(["--mnk", str(m), str(n), str(k), "--acc", acc,
                                    "--mode", "server", "--target_qps", "100",
                                    "--warmup_seconds", "0.5", "--benchmark_seconds", "1.5",
                                    "--correctness_seconds", "20", "--correctness_iters",
                                    "3", "--base_dir", str(base)])
                gate = json.loads((base / "zero_one_correctness_check_result.json").read_text())
                res = json.loads((base / "benchmark_result_torch_matmul.json").read_text())
                if rc != 0 or not gate["pass"] or gate["mode"] != "server":
                    raise AssertionError(f"server slice failed at {m}x{n}x{k} {acc}")
                if res["mode"] != "server" or res["target_qps"] != 100.0 or not all(
                        key in res[pf] for pf in ("torch_matmul", "tpul2_torch")
                        for key in ("p50_ms", "p99_ms")):
                    raise AssertionError(f"server result lacks p50/p99 or target_qps: {res}")
                row = json.loads((base / "speedup_row.json").read_text())
                record["server_slice"].append({
                    "mnk": [m, n, k], "acc": acc, "speedups": row,
                    "candidate_p50_p99_ms": [res["tpul2_torch"]["p50_ms"],
                                             res["tpul2_torch"]["p99_ms"]],
                    "torch_matmul_p50_p99_ms": [res["torch_matmul"]["p50_ms"],
                                                res["torch_matmul"]["p99_ms"]],
                    "iters": res["tpul2_torch"]["iters"]})
                print(f"  {m}x{n}x{k} {acc} server: " + json.dumps(record["server_slice"][-1]))
        server_launches = counters()
        print("  launches " + json.dumps(server_launches))
        record["server_slice_launches"] = server_launches
        if server_launches["multi_k_wgmma"] <= 0 or server_launches["single_k_wgmma"] <= 0:
            raise AssertionError("the server slice did not run the wgmma ring")

    with phase("committed-DB slice"):
        committed = repo / "tpul2_torch" / "data" / "tunedb_h100.json"
        if not committed.exists():
            raise AssertionError(f"{committed} is missing")
        os.environ.pop(db_mod.ENV_VAR)
        db_mod.reset_default_db()
        db = db_mod.default_db()
        if db.path != committed:
            raise AssertionError(f"the default DB is {db.path}, not the committed one")
        from tpul2_torch.harness.suite import DEFAULT_SHAPES
        summary = {}
        for acc in ("float32", "bfloat16"):
            for mode in ("offline", "server"):
                cfgs = [resolve_config(*sh, acc, mode=mode) for sh in DEFAULT_SHAPES]
                entries = [db.get_entry(*sh, acc) for sh in DEFAULT_SHAPES]
                stored = [None if e is None else KernelConfig(**(
                    e.get("server", e) if mode == "server" else e)["config"])
                    for e in entries]
                summary[f"{acc}/{mode}"] = {
                    "entries": sum(e is not None for e in entries),
                    "server_entries": sum(e is not None and "server" in e for e in entries),
                    "sentinel": sum(c.use_vendor for c in cfgs),
                    "refused_by_card": sum(c.use_vendor and x is not None and not x.use_vendor
                                           for c, x in zip(cfgs, stored))}
        print("  of the 20 DEFAULT_SHAPES (resolved to the sentinel; stored kernel configs the "
              "card refuses): " + json.dumps(summary))
        record["committed_db"] = summary
        if any(v["entries"] != len(DEFAULT_SHAPES) for v in summary.values()):
            raise AssertionError("the committed DB does not cover DEFAULT_SHAPES")
        suite_mod = _script(repo, "run_suite_torch")
        out_dir = repo / "runs" / "chip_smoke" / "suite"
        for f in out_dir.glob("*"):
            f.unlink()
        shapes = "64,8192,8192;64,64,12288;8192,128,64"
        zero_counters()
        for acc in ("float32", "bfloat16"):
            rc = suite_mod.main(["eval", "--acc", acc, "--shapes", shapes, "--out_dir",
                                 str(out_dir), "--warmup_seconds", "0.5",
                                 "--benchmark_seconds", "1", "--correctness_iters", "2"])
            if rc != 0:
                raise AssertionError(f"run_suite_torch failed ({acc})")
            text = (out_dir / f"tpul2_torch_h100_{acc}_speedup_offline.csv").read_text()
            print("  " + text.replace("\n", "\n  ").rstrip())
            record[f"committed_db_csv_{acc}"] = text
        record["committed_db_launches"] = counters()
        print("  launches " + json.dumps(record["committed_db_launches"]))

    def use_db(kind: str) -> None:
        if kind == "heuristic":
            pin_empty_db()
        else:  # the committed tpul2_torch/data/tunedb_h100.json
            os.environ.pop(db_mod.ENV_VAR, None)
            db_mod.reset_default_db()

    with phase("model"):
        record["model"], model_launches = _model_phase(torch, counters, zero_counters, use_db)
    # each kernel row's launches: its main paths' and the model path's
    for row, key in zip(kernels, kernel_keys):
        row["launches"] += model_launches[key]

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
