#!/usr/bin/env python3
"""Host time per call of tpul2_torch's entry point on one card, split by layer.

    python scripts/host_time_torch.py [--root DIR] [--reps 7] [--json_out PATH]

Imports the ``tpul2_torch`` package under ``--root`` (default: this checkout), so that
two trees can be compared on one card, each in a process of its own.  For each bring-up
shape (chip_smoke.py's SLICE_SHAPES), on the heuristic config (no TuneDB), it times
batches of 20 calls enqueued with no wait between them (the card's queue absorbs them)
on the host clock, and reports the median and the least of ``--reps`` batches, per call:
  entry_host_ms   dispatch.candidate_fn(acc)(a, b, b_t), the slice's candidate;
  launch_host_ms  ops.matmul.launch_kernel with the resolved config: the wrapper below
                  check_operands (the route, the argument tuple, ctypes, the C launcher);
  direct_host_ms  the C launcher alone through ctypes with a prebuilt argument tuple:
                  tl2_matmul_*out always, and tl2_wgmma_*out where the tree has it and
                  its route takes the shape (the difference is the C route check and
                  the two tensor maps it encodes per call);
  route_us        ops.matmul.multi_k_route alone, where the tree has it (1000 calls);
  torch_host_ms   torch.matmul;
and the device time per call of the entry point and of torch.matmul, back to back (CUDA
events, 20 calls after 3 warm-up calls).  Prints one JSON object per shape, then the
card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

#: The bring-up shapes and families of chip_smoke.py.
SHAPES = [((4096, 4096, 4096), "float32"), ((64, 8192, 8192), "float32"),
          ((8192, 128, 64), "float32"), ((1000, 1000, 1000), "float32"),
          ((1000, 1000, 1000), "bfloat16")]
CALLS = 20


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


def _launch_args(torch, a, rhs, cfg, out, m: int, n: int, k: int) -> tuple:
    """The C launchers' argument list (tl2_matmul_*out and tl2_wgmma_*out share it), with
    no bias and no activation, on the current stream."""
    rhs_row = k if cfg.rhs_layout == "nk" else n

    def vec(t, row):
        return int(t.data_ptr() % 16 == 0 and row % 8 == 0)

    return (a.data_ptr(), rhs.data_ptr(), None, out.data_ptr(), 1, m, n, k, m * k, k * n,
            m * n, cfg.bm, cfg.bn, cfg.bk, int(cfg.rhs_layout == "nk"),
            int(cfg.acc_dtype == "bfloat16"), 0, int(cfg.grid_order == "nm"), vec(a, k),
            vec(rhs, rhs_row), torch.cuda.current_stream().cuda_stream)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose tpul2_torch is measured")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--json_out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("host_time_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from tpul2_torch.dispatch import candidate_fn, resolve_config
    from tpul2_torch.ops import baselines
    from tpul2_torch.ops import matmul as mm
    from tpul2_torch.ops._build import check_launch, load_library
    from tpul2_torch.utils.platform import device_info

    baselines.pin_precision()
    info = device_info()
    lib = load_library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = []
    for (m, n, k), acc in SHAPES:
        cfg = resolve_config(m, n, k, acc)
        a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        b_t = b.t().contiguous()
        rhs = b_t if cfg.rhs_layout == "nk" else b
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        cand = candidate_fn(acc)
        row = {"root": str(Path(args.root).resolve()), "mnk": [m, n, k], "acc": acc,
               "config": f"{cfg.bm}x{cfg.bn} bk={cfg.bk} {cfg.rhs_layout}",
               "entry_host_ms": _host_ms(torch, lambda: cand(a, b, b_t), args.reps),
               "launch_host_ms": _host_ms(torch, lambda: mm.launch_kernel(
                   a, rhs, cfg, out, None, None, 1, m, n, k), args.reps),
               "torch_host_ms": _host_ms(torch, lambda: torch.matmul(a, b), args.reps),
               "entry_ms": _device_ms(torch, lambda: cand(a, b, b_t)),
               "torch_matmul_ms": _device_ms(torch, lambda: torch.matmul(a, b))}
        call = _launch_args(torch, a, rhs, cfg, out, m, n, k)
        direct = {"tl2_matmul": lambda: check_launch(lib.tl2_matmul_bf16out(*call),
                                                     "tl2_matmul")}
        if hasattr(mm, "multi_k_route") and mm.multi_k_route(cfg, a, rhs, m, n, k) == "wgmma":
            direct["tl2_wgmma"] = lambda: check_launch(lib.tl2_wgmma_bf16out(*call),
                                                       "tl2_wgmma")
        row["direct_host_ms"] = {name: _host_ms(torch, fn, args.reps)
                                 for name, fn in direct.items()}
        if hasattr(mm, "multi_k_route"):
            t0 = time.perf_counter()
            for _ in range(1000):
                mm.multi_k_route(cfg, a, rhs, m, n, k)
            row["route_us"] = (time.perf_counter() - t0) / 1000 * 1e6
        print(json.dumps(row))
        rows.append(row)
        del a, b, b_t, rhs, out
    print(info["nvidia_smi"])
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps({"device": info, "shapes": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
