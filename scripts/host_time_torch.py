#!/usr/bin/env python3
"""Host time per call of tpul2_torch's entry point on one card, split by step, and the
device time of each kernel body alone.

    python scripts/host_time_torch.py [--root DIR] [--reps 7] [--json_out PATH]
    python scripts/host_time_torch.py [--root DIR] --alone M,N,K,BM,BN,BK[,ACC[,A_OFF[,LAYOUT[,DEPTH[,BATCH]]]]] [...]

Imports the ``tpul2_torch`` package under ``--root`` (default: this checkout), so that
two trees can be compared on one card, each in a process of its own.  For each bring-up
shape (chip_smoke.py's SLICE_SHAPES) and the correctness gate's batched variant of the
thin shape (2 x 8192x128x64, ``dispatch.batched_matmul``), on the heuristic config (no
TuneDB), it reports:

host time per call, on the host clock, the median and the least of ``--reps`` batches of
20 calls enqueued with no wait between them (the card's queue absorbs them):
  entry_host_ms   the entry point: dispatch.candidate_fn(acc)(a, b, b_t), the slice's
                  candidate, or dispatch.batched_matmul;
  launch_host_ms  ops.matmul.launch_kernel with the resolved config: the wrapper below
                  check_operands (the route, the argument tuple, ctypes, the C launcher);
  direct_host_ms  the C launcher alone through ctypes with a prebuilt argument tuple, for
                  each body whose C route takes the shape (tl2_matmul_*out, on no route of
                  the package since its ring took every launch, always);
  torch_host_ms   torch.matmul (torch.bmm for the batched row);
steps_us, the steps of the entry point one at a time (microseconds per call, the median
of ``--reps`` batches of 2000 calls):
  resolve_config  dispatch.resolve_config as the tree has it (a memo hit where it has one)
  default_db      autotune.db.default_db()
  db_get          db.get(m, n, k, acc, 'bfloat16')
  neighbor        dispatch._neighbor_config: entries_near, even with an empty DB
  heuristic       config.heuristic_config
  validate        KernelConfig.validate()
  replace         dataclasses.replace(cfg, rhs_layout=...), which a tree pays where its
                  wrapper replaces the layout on every call
  check_operands  ops.matmul.check_operands
  empty           torch.empty of the output, as the wrapper allocates it
  import_load     the import of ops._build and load_library()
  device_ctx      entering and leaving torch.cuda.device(a.device)
  device_ctx_int  the same with the int index a.get_device()
  current_stream  torch.cuda.current_stream(a.device).cuda_stream
  raw_stream      torch._C._cuda_getCurrentRawStream(a.get_device()): the same handle
  route           the tree's route rule (launch_route, or multi_k_route before it)
  launch_args     ops.matmul.launch_args: the tuple of 21 arguments
  ctypes_21       a C launcher call that the launcher refuses at once (batch = 0): the
                  ctypes conversion of 21 arguments and the call
device time per call:
  entry_ms, torch_matmul_ms   back to back (CUDA events, 20 calls after 3 warm-up calls);
  alone_ms        {body: ms}: each body whose C route takes the shape, alone: 20 direct
                  launches captured in a CUDA graph and replayed 10 times between two
                  CUDA events, so that no host time enters;
  torch_alone_ms  torch.matmul (torch.bmm) the same way.
Prints one JSON object per shape, then the card's nvidia-smi name and power limit.

With ``--alone`` it times only the named configs (bf16 output, no epilogue, normal inputs
made from seed 3 for each config, so that every tree and every order of configs gets the
same ones; the f32 family unless ACC is bfloat16; A's base A_OFF elements into its
allocation, 1 being 2 bytes off 16, which hands A to the loads producer; LAYOUT 'kn' (the
default) or 'nk'; DEPTH > 0 a staged launch, tl2_wgmma_staged at that depth clamped to the
K intervals, with the split count the tree's ``ops.pipelined.staged_splits`` gives; BATCH
> 1 a batched launch), each body alone as above through the tree's tl2_wgmma launcher: one
JSON object per config with its ``alone_ms`` and ``sha256``, the digest of the output's
bytes after the timed launches (every launch writes the same values), so that two trees'
bits compare.  A wide block takes the tree's wide route, so two trees' wide kernels compare
on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

#: The bring-up shapes and families of chip_smoke.py, as (batch, m, n, k), acc.
SHAPES = [((1, 4096, 4096, 4096), "float32"), ((1, 64, 8192, 8192), "float32"),
          ((1, 8192, 128, 64), "float32"), ((1, 1000, 1000, 1000), "float32"),
          ((1, 1000, 1000, 1000), "bfloat16"), ((2, 8192, 128, 64), "float32")]
CALLS = 20
STEP_CALLS = 2000
REPLAYS = 10


def _host_ms(torch, fn, reps: int) -> dict:
    """Host milliseconds per call: median and least over ``reps`` batches of CALLS."""
    for _ in range(3):
        fn()
    per_call = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        per_call.append((time.perf_counter() - t0) / CALLS * 1e3)
    torch.cuda.synchronize()
    return {"median": statistics.median(per_call), "min": min(per_call)}


def _step_us(fn, reps: int) -> float:
    """Host microseconds per call of one step: the median of ``reps`` batches."""
    for _ in range(100):
        fn()
    per_call = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(STEP_CALLS):
            fn()
        per_call.append((time.perf_counter() - t0) / STEP_CALLS * 1e6)
    return statistics.median(per_call)


def _device_ms(torch, fn) -> float:
    """Mean device milliseconds per call over CALLS back-to-back calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def alone_ms(torch, make_fn) -> float:
    """Device milliseconds per call with no host time in it: CALLS calls of
    ``make_fn()`` (built on the capturing stream) captured in a CUDA graph, replayed
    REPLAYS times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn = make_fn()
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn = make_fn()
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (REPLAYS * CALLS)


def _launch_args(torch, a, rhs, cfg, out, batch: int, m: int, n: int, k: int) -> tuple:
    """The C launchers' argument list (tl2_matmul_*out and tl2_wgmma_*out share it), with
    no bias and no activation, on the current stream."""
    rhs_row = k if cfg.rhs_layout == "nk" else n

    def vec(t, row):
        return int(t.data_ptr() % 16 == 0 and row % 8 == 0)

    return (a.data_ptr(), rhs.data_ptr(), None, out.data_ptr(), batch, m, n, k, m * k,
            k * n, m * n, cfg.bm, cfg.bn, cfg.bk, int(cfg.rhs_layout == "nk"),
            int(cfg.acc_dtype == "bfloat16"), 0, int(cfg.grid_order == "nm"), vec(a, k),
            vec(rhs, rhs_row), torch.cuda.current_stream().cuda_stream)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose tpul2_torch is measured")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--json_out", default=None)
    ap.add_argument("--alone", action="append", default=[],
                    metavar="M,N,K,BM,BN,BK[,ACC[,A_OFF[,LAYOUT[,DEPTH[,BATCH]]]]]",
                    help="time only this config's kernel alone (repeatable)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("host_time_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from tpul2_torch import dispatch
    from tpul2_torch.autotune.db import default_db
    from tpul2_torch.config import KernelConfig, heuristic_config
    from tpul2_torch.ops import baselines
    from tpul2_torch.ops import matmul as mm
    from tpul2_torch.ops._build import check_launch, load_library
    from tpul2_torch.utils.platform import device_info

    baselines.pin_precision()
    info = device_info()
    lib = load_library()
    route_fn = getattr(mm, "launch_route", None) or mm.multi_k_route
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = []
    for spec in args.alone:
        fields = spec.split(",") + [""] * 5
        m, n, k, bm, bn, bk = map(int, fields[:6])
        acc = fields[6] or "float32"
        a_off = int(fields[7] or 0)
        layout = fields[8] or "kn"
        depth = int(fields[9] or 0)
        batch = int(fields[10] or 1)
        cfg = KernelConfig(bm=bm, bn=bn, bk=bk, acc_dtype=acc, rhs_layout=layout)
        lead = (batch,) if batch > 1 else ()
        gen.manual_seed(3)
        a = torch.randn((*lead, m, k), generator=gen, device="cuda").bfloat16()
        if a_off:
            a = torch.empty(a.numel() + a_off, dtype=a.dtype, device="cuda")[a_off:].view(
                a.shape).copy_(a)
        b = torch.randn((*lead, *((n, k) if layout == "nk" else (k, n))), generator=gen,
                        device="cuda").bfloat16()
        out = torch.empty((*lead, m, n), dtype=torch.bfloat16, device="cuda")
        label = f"{bm}x{bn} bk={bk} {acc} {layout}" + (f" A off {a_off}" if a_off else "")
        if depth:
            from tpul2_torch.ops import pipelined as pl
            clamped = pl.staged_depth(depth, k // bk)
            splits = 1 if cfg.wide else pl.staged_splits(m, n, k, bm, bn, clamped)
            ws = torch.empty((splits, m, n), dtype=torch.float32, device="cuda")
            label += f" staged depth {clamped}, {splits} splits"

            def make(a=a, b=b, out=out, ws=ws, m=m, n=n, k=k, d=clamped, s=splits):
                call = (a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), m, n, k, bm,
                        bn, d, s, int(layout == "nk"), 0, 0,
                        torch.cuda.current_stream().cuda_stream)
                return lambda: check_launch(lib.tl2_wgmma_staged(*call), "tl2_wgmma_staged")
        else:
            def make(a=a, b=b, out=out, cfg=cfg, m=m, n=n, k=k, batch=batch):
                call = _launch_args(torch, a, b, cfg, out, batch, m, n, k)
                return lambda: check_launch(lib.tl2_wgmma_bf16out(*call), "tl2_wgmma")

        ms = alone_ms(torch, make)
        digest = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        row = {"root": str(Path(args.root).resolve()), "batch": batch, "mnk": [m, n, k],
               "config": label, "alone_ms": ms, "sha256": digest}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del a, b, out
    if args.alone:
        print(info["nvidia_smi"])
        return 0
    for (batch, m, n, k), acc in SHAPES:
        batched = batch > 1
        cfg = dispatch.resolve_config(m, n, k, acc)
        lead = (batch,) if batched else ()
        a = torch.randn((*lead, m, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((*lead, k, n), generator=gen, device="cuda").bfloat16()
        b_t = b.transpose(-1, -2).contiguous()
        rhs = b_t if cfg.rhs_layout == "nk" else b
        out = torch.empty((*lead, m, n), dtype=torch.bfloat16, device="cuda")
        if batched:
            cand = functools.partial(dispatch.batched_matmul, a, b, acc=acc)
        else:
            cand = functools.partial(dispatch.candidate_fn(acc), a, b, b_t)
        library = torch.bmm if batched else torch.matmul
        row = {"root": str(Path(args.root).resolve()), "batch": batch, "mnk": [m, n, k],
               "acc": acc, "config": f"{cfg.bm}x{cfg.bn} bk={cfg.bk} {cfg.rhs_layout}",
               "entry_host_ms": _host_ms(torch, cand, args.reps),
               "launch_host_ms": _host_ms(torch, lambda: mm.launch_kernel(
                   a, rhs, cfg, out, None, None, batch, m, n, k), args.reps),
               "torch_host_ms": _host_ms(torch, lambda: library(a, b), args.reps),
               "entry_ms": _device_ms(torch, cand),
               "torch_matmul_ms": _device_ms(torch, lambda: library(a, b))}
        call = _launch_args(torch, a, rhs, cfg, out, batch, m, n, k)
        bodies = {"tl2_matmul": lib.tl2_matmul_bf16out}
        # the output's base joined the route's arguments with the wide route's predicated
        # stores; a tree from before takes the operands only
        out_arg = (None,) * (len(lib.tl2_wgmma_route.argtypes) - 9)
        if lib.tl2_wgmma_route(m, n, k, cfg.bm, cfg.bn, cfg.bk, int(cfg.rhs_layout == "nk"),
                               a.data_ptr(), rhs.data_ptr(), *out_arg):
            bodies["tl2_wgmma"] = lib.tl2_wgmma_bf16out
        row["direct_host_ms"] = {
            name: _host_ms(torch, lambda fn=fn, name=name: check_launch(fn(*call), name),
                           args.reps)
            for name, fn in bodies.items()}

        def direct(fn, name):
            def make():
                args_now = _launch_args(torch, a, rhs, cfg, out, batch, m, n, k)
                return lambda: check_launch(fn(*args_now), name)
            return make

        row["alone_ms"] = {name: alone_ms(torch, direct(fn, name))
                           for name, fn in bodies.items()}
        row["torch_alone_ms"] = alone_ms(torch, lambda: (lambda: library(a, b)))

        db = default_db()
        refused = (*call[:4], 0, *call[5:])   # batch = 0: refused before any work
        steps = {
            "resolve_config": lambda: dispatch.resolve_config(m, n, k, acc),
            "default_db": default_db,
            "db_get": lambda: db.get(m, n, k, acc, "bfloat16"),
            "neighbor": lambda: dispatch._neighbor_config(db, m, n, k, acc),
            "heuristic": lambda: heuristic_config(m, n, k, acc),
            "validate": cfg.validate,
            "replace": lambda: dataclasses.replace(cfg, rhs_layout=cfg.rhs_layout),
            "check_operands": lambda: mm.check_operands(a, rhs, cfg, torch.bfloat16, None,
                                                        None, None, batched=batched),
            "empty": lambda: torch.empty((*lead, m, n), dtype=torch.bfloat16, device=a.device),
            "import_load": _import_load,
            "device_ctx": lambda: _enter_device(torch, a.device),
            "device_ctx_int": lambda: _enter_device(torch, a.get_device()),
            "current_stream": lambda: torch.cuda.current_stream(a.device).cuda_stream,
            "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(a.get_device()),
            "route": lambda: route_fn(cfg, a, rhs, m, n, k),
            "launch_args": lambda: mm.launch_args(a, rhs, cfg, out, None, None, batch, m,
                                                  n, k),
            "ctypes_21": lambda: lib.tl2_wgmma_bf16out(*refused),
        }
        row["steps_us"] = {name: _step_us(fn, args.reps) for name, fn in steps.items()}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del a, b, b_t, rhs, out
    print(info["nvidia_smi"])
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps({"device": info, "shapes": rows}, indent=1))
    return 0


def _import_load():
    from tpul2_torch.ops._build import load_library
    load_library()


def _enter_device(torch, device):
    with torch.cuda.device(device):
        pass


if __name__ == "__main__":
    sys.exit(main())
