#!/usr/bin/env python
"""Shape-suite runner of tpul2_torch: the 0/1 gate, then the offline or server bench, for
each shape of a list, one CSV row per shape in CUDA-L2's schema.

  eval  for each shape not yet in the CSV: the gate (stop the shape if it fails), then
        the bench against every baseline through the DB as it stands
        (``TPUL2_TORCH_TUNEDB`` or ``tpul2_torch/data/tunedb_h100.json``); append the row
        to ``<out_dir>/tpul2_torch_h100_<acc>_speedup_<mode>.csv`` and the shape's record
        (each function's median, p99 and IQR, the dispatched config, the device) to the
        ``.jsonl`` beside it.  Resumable: shapes already in the CSV are skipped.

The default list is ``harness.suite.DEFAULT_SHAPES``, the JAX harness's 20-shape sample
of the reference's grid.  A shape whose gate fails gets no row; its failure goes to the
sidecar and the run exits 1 after the other shapes.

Usage:
  python scripts/run_suite_torch.py eval --acc float32 --mode offline
  python scripts/run_suite_torch.py eval --acc bfloat16 --mode server --target_qps 100
  python scripts/run_suite_torch.py eval --device cpu --shapes "96,160,200" --out_dir /tmp/s
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def parse_shapes(spec: str) -> list:
    """'default', or 'm,n,k;m,n,k;...'."""
    from tpul2_torch.harness.suite import DEFAULT_SHAPES
    if spec == "default":
        return list(DEFAULT_SHAPES)
    return [tuple(int(x) for x in item.split(",")) for item in spec.split(";") if item]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ev = sub.add_parser("eval", help="gate + bench per shape into the CSV")
    ev.add_argument("--acc", choices=["float32", "bfloat16"], default="float32")
    ev.add_argument("--mode", choices=["offline", "server"], default="offline")
    ev.add_argument("--target_qps", type=float, default=None,
                    help="mean request rate of the server mode (required there, > 0)")
    ev.add_argument("--shapes", default="default", help="'default' or 'm,n,k;m,n,k;...'")
    ev.add_argument("--out_dir", default=str(REPO / "eval_results"))
    ev.add_argument("--warmup_seconds", type=float, default=1.0)
    ev.add_argument("--benchmark_seconds", type=float, default=3.0)
    ev.add_argument("--correctness_iters", type=int, default=10)
    ev.add_argument("--correctness_seconds", type=float, default=30.0)
    ev.add_argument("--seed", type=int, default=0)
    ev.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "server" and (args.target_qps is None or args.target_qps <= 0):
        ap.error("--mode server needs --target_qps > 0")
    return args


def cmd_eval(args) -> int:
    import torch

    from tpul2_torch.dispatch import resolve_config
    from tpul2_torch.harness import suite
    from tpul2_torch.harness.bench_offline import benchmark_offline_all
    from tpul2_torch.harness.bench_server import benchmark_server_all
    from tpul2_torch.harness.correctness import run_correctness_check
    from tpul2_torch.utils.platform import device_info

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run the plain versions)", file=sys.stderr)
        return 1
    info = device_info()
    device = info["nvidia_smi"] if args.device == "cuda" else "cpu"
    out = suite.csv_path(args.out_dir, args.acc, args.mode)
    sidecar = out.with_suffix(".jsonl")
    done = suite.done_shapes(out)
    shapes = [s for s in parse_shapes(args.shapes) if suite.mnk_name(*s) not in done]
    print(f"{len(shapes)} shapes to evaluate into {out} ({len(done)} done)", file=sys.stderr)
    failed = []
    for m, n, k in shapes:
        name = suite.mnk_name(m, n, k)
        t0 = time.perf_counter()
        gate = run_correctness_check(m, n, k, acc=args.acc, iterations=args.correctness_iters,
                                     time_cap_s=args.correctness_seconds, seed=args.seed,
                                     device=args.device, mode=args.mode)
        if not gate["pass"]:
            failed.append(name)
            suite.append_sidecar(sidecar, {"mnk": name, "acc": args.acc, "mode": args.mode,
                                           "gate_failure": gate.get("failure"),
                                           "device": info})
            print(f"{name}: gate FAILED ({gate.get('failure')}); no row", file=sys.stderr)
            continue
        bench = dict(acc=args.acc, warmup_seconds=args.warmup_seconds,
                     benchmark_seconds=args.benchmark_seconds, seed=args.seed,
                     device=args.device)
        if args.mode == "server":
            results = benchmark_server_all(m, n, k, args.target_qps, **bench)
        else:
            results = benchmark_offline_all(m, n, k, **bench)
        row = suite.row_from_speedups(name, {pf: r["speedup"] for pf, r in results.items()},
                                      device)
        cfg = dataclasses.asdict(resolve_config(m, n, k, args.acc, mode=args.mode))
        suite.append_row(out, row)
        suite.append_sidecar(sidecar, suite.sidecar_record(
            name, args.acc, args.mode, results, cfg, info, args.target_qps))
        print(f"{name}: {row} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"gate failed at {failed}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    return cmd_eval(args)


if __name__ == "__main__":
    sys.exit(main())
