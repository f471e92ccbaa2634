#!/usr/bin/env python
"""Evaluate one (M, N, K) shape with tpul2_torch: correctness gate -> benchmark -> summary.

The reference driver eval_one_file.sh on torch: wipe stale results, run the 0/1 gate and
stop on failure, benchmark the candidate against every torch baseline in one shuffled
loop, then write summary.md and speedup_row.json.  The gate runs first, as in the
reference.  ``--mode server`` runs the Poisson-arrival bench (``--target_qps`` required)
on the candidate's server twin, which dispatches each shape's server-regime winner; its
gate checks that twin.  ``--defend`` then runs the integrity defenses
(``harness.defense.run_all_defenses``) on the candidate and writes
``defense_result.json``; a failed defense fails the run.

Usage:
  python scripts/eval_one_shape_torch.py --mnk 4096 4096 4096 --acc float32
  python scripts/eval_one_shape_torch.py --mnk 64 8192 8192 --mode server --target_qps 100
  python scripts/eval_one_shape_torch.py --device cpu --mnk 96 160 200 --base_dir /tmp/e
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mnk", type=int, nargs=3, required=True, metavar=("M", "N", "K"))
    ap.add_argument("--acc", choices=["float32", "bfloat16"], default="float32",
                    help="accumulator family (ref: F32F16F16F32 / F16F16F16F16)")
    ap.add_argument("--warmup_seconds", type=float, default=2.0)
    ap.add_argument("--benchmark_seconds", type=float, default=10.0)
    ap.add_argument("--base_dir", type=str, default=None,
                    help="result directory (default: runs/eval_<M>x<N>x<K>_<acc> in the repo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--correctness_seconds", type=float, default=60.0)
    ap.add_argument("--correctness_iters", type=int, default=100)
    ap.add_argument("--skip_correctness", action="store_true")
    ap.add_argument("--perf_funcs", nargs="*", default=None,
                    help="subset of baselines (default: all)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--mode", choices=["offline", "server"], default="offline")
    ap.add_argument("--target_qps", type=float, default=None,
                    help="mean request rate of the server mode's Poisson arrivals "
                         "(required there, > 0)")
    ap.add_argument("--defend", action="store_true",
                    help="run the benchmark-integrity defenses on the candidate before "
                         "summarizing (SURVEY.md C8)")
    args = ap.parse_args(argv)
    if args.mode == "server" and (args.target_qps is None or args.target_qps <= 0):
        ap.error("--mode server needs --target_qps > 0")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from tpul2_torch.harness.bench_offline import benchmark_offline_all
    from tpul2_torch.harness.bench_server import benchmark_server_all
    from tpul2_torch.harness.correctness import CANDIDATE, run_correctness_check
    from tpul2_torch.harness.summarize import speedup_row, summarize_results
    from tpul2_torch.ops.baselines import BASELINES

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run the plain versions)", file=sys.stderr)
        return 1
    m, n, k = args.mnk
    base = Path(args.base_dir or REPO / "runs" / f"eval_{m}x{n}x{k}_{args.acc}_{args.mode}")
    base.mkdir(parents=True, exist_ok=True)
    for f in base.glob("benchmark_result_*.json"):  # stale results (ref :69)
        f.unlink()

    if not args.skip_correctness:  # gate first, hard stop on failure (ref :71-80)
        res = run_correctness_check(
            m, n, k, acc=args.acc, iterations=args.correctness_iters,
            time_cap_s=args.correctness_seconds, seed=args.seed, device=args.device,
            mode=args.mode, result_path=str(base / "zero_one_correctness_check_result.json"))
        if not res["pass"]:
            print(f"correctness check FAILED: {res.get('failure')}", file=sys.stderr)
            return 1
        print(f"correctness check passed ({res['stats']['iterations']} iterations, "
              f"density={res['stats']['density']:.3f}, "
              f"guard hits={res['stats']['guard_hits']})")

    perf_funcs = args.perf_funcs or list(BASELINES)
    random.Random(args.seed).shuffle(perf_funcs)
    bench = dict(perf_funcs=perf_funcs, acc=args.acc, warmup_seconds=args.warmup_seconds,
                 benchmark_seconds=args.benchmark_seconds, base_dir=str(base),
                 seed=args.seed, device=args.device)
    if args.mode == "server":
        results = benchmark_server_all(m, n, k, args.target_qps, **bench)
    else:
        results = benchmark_offline_all(m, n, k, **bench)
    for func in perf_funcs:
        r = results[func]
        print(f"{func}: speedup {r['speedup']:.4f}x ({r[CANDIDATE]['tflops_median']:.2f} vs "
              f"{r[func]['tflops_median']:.2f} TFLOPS, {r['device']})")

    if args.defend:
        import numpy as np

        from tpul2_torch.dispatch import candidate_fn
        from tpul2_torch.harness.bench_utils import fresh_inputs
        from tpul2_torch.harness.defense import run_all_defenses
        data = fresh_inputs(np.random.default_rng(args.seed), m, n, k, device=args.device)
        dres = run_all_defenses(candidate_fn(args.acc, args.mode), data)
        (base / "defense_result.json").write_text(json.dumps(dres, indent=1, default=str))
        if not dres["pass"]:
            print("defense checks FAILED:", file=sys.stderr)
            for r in dres["defenses"]:
                if not r["pass"]:
                    print(f"  {r['name']}: {r}", file=sys.stderr)
            return 1
        print(f"defense checks passed ({len(dres['defenses'])} defenses)")

    md = summarize_results(str(base), write_path=str(base / "summary.md"))
    print()
    print(md)
    (base / "speedup_row.json").write_text(json.dumps(speedup_row(str(base), (m, n, k)),
                                                      indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
