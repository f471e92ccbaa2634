"""Harness CLI of tpul2_torch: one subcommand per harness component.

The counterpart of ``python -m tpul2.harness`` (the reference's standalone argparse
scripts: zero_one_correctness_check.py, benchmarking_offline.py, benchmarking_server.py,
summarize_result.py), with the JAX CLI's subcommands and flags plus ``--device``
(default ``cuda``: without a card it raises; ``cpu`` runs the plain versions on the host
clock).  Every subcommand prints one JSON object.

  python -m tpul2_torch.harness correctness --mnk 512 512 512 --acc float32
  python -m tpul2_torch.harness offline --mnk 4096 4096 4096 \\
      --perf_func torch_matmul --base_dir /tmp/out
  python -m tpul2_torch.harness server --mnk 64 8192 8192 \\
      --perf_func cublaslt_autotuned_nn --target_qps 100 --base_dir /tmp/out
  python -m tpul2_torch.harness summarize --base_dir /tmp/out
  python -m tpul2_torch.harness defend --mnk 512 512 512 --acc float32
  python -m tpul2_torch.harness profile --mnk 4096 4096 4096 --trace_dir /tmp/trace
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tpul2_torch.harness", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_shape(p):
        p.add_argument("--mnk", type=int, nargs=3, required=True, metavar=("M", "N", "K"))
        p.add_argument("--acc", choices=["float32", "bfloat16"], default="float32")
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    c = sub.add_parser("correctness")
    add_shape(c)
    c.add_argument("--iterations", type=int, default=100)
    c.add_argument("--seconds", type=float, default=60.0)
    c.add_argument("--result_path", type=str, default=None)

    for mode in ("offline", "server"):
        b = sub.add_parser(mode)
        add_shape(b)
        b.add_argument("--perf_func", type=str, required=True)
        b.add_argument("--warmup_seconds", type=float, default=2.0)
        b.add_argument("--benchmark_seconds", type=float, default=10.0)
        b.add_argument("--base_dir", type=str, default=None)
        if mode == "server":
            b.add_argument("--target_qps", type=float, required=True)

    s = sub.add_parser("summarize")
    s.add_argument("--base_dir", type=str, required=True)
    s.add_argument("--out", type=str, default=None)

    d = sub.add_parser("defend")
    add_shape(d)

    pr = sub.add_parser("profile")
    add_shape(pr)
    pr.add_argument("--trace_dir", type=str, default=None)
    pr.add_argument("--trials", type=int, default=5)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    if args.cmd == "summarize":
        from tpul2_torch.harness.summarize import summarize_results
        md = summarize_results(args.base_dir, write_path=args.out)
        print(json.dumps({"base_dir": args.base_dir, "out": args.out, "markdown": md},
                         indent=1))
        return 0

    m, n, k = args.mnk
    if args.cmd == "correctness":
        from tpul2_torch.harness.correctness import run_correctness_check
        res = run_correctness_check(m, n, k, acc=args.acc, iterations=args.iterations,
                                    time_cap_s=args.seconds, result_path=args.result_path,
                                    device=args.device)
        print(json.dumps(res, indent=1, default=str))
        return 0 if res["pass"] else 1

    if args.cmd == "offline":
        from tpul2_torch.harness.bench_offline import benchmark_offline
        res = benchmark_offline(m, n, k, args.perf_func, acc=args.acc,
                                warmup_seconds=args.warmup_seconds,
                                benchmark_seconds=args.benchmark_seconds,
                                base_dir=args.base_dir, device=args.device)
    elif args.cmd == "server":
        from tpul2_torch.harness.bench_server import benchmark_server
        res = benchmark_server(m, n, k, args.perf_func, args.target_qps, acc=args.acc,
                               warmup_seconds=args.warmup_seconds,
                               benchmark_seconds=args.benchmark_seconds,
                               base_dir=args.base_dir, device=args.device)
    elif args.cmd == "profile":
        from tpul2_torch.harness.profiling import profile_shape
        res = profile_shape(m, n, k, acc=args.acc, trials=args.trials,
                            trace_dir=args.trace_dir, device=args.device)
    else:  # defend
        import numpy as np

        from tpul2_torch.dispatch import candidate_fn
        from tpul2_torch.harness.bench_utils import fresh_inputs
        from tpul2_torch.harness.defense import run_all_defenses
        from tpul2_torch.utils.platform import check_device
        check_device(args.device, "the defenses time the card")
        data = fresh_inputs(np.random.default_rng(0), m, n, k, device=args.device)
        res = run_all_defenses(candidate_fn(args.acc), data)
        print(json.dumps(res, indent=1, default=str))
        return 0 if res["pass"] else 1
    print(json.dumps(res, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
