#!/usr/bin/env python
"""Shape-suite runner of tpul2_torch: the grid's tuning into a DB, and one CSV row per shape
and family in CUDA-L2's schema through the DB named by ``--db`` (default
``tpul2_torch/data/tunedb_h100.json``).

  tune  the counterpart of ``scripts/run_suite.py tune``: the shapes of ``--dims`` cubed
        (the reference's grid by default) in ``--order`` (default lex, the JAX order),
        cut by ``--max_elems`` and ``--max_shapes``, or the ``--shapes`` list, tuned
        ``--chunk`` shapes at a time through ``autotune.search.tune_many`` into the DB
        named by ``--db`` (required: a copy, never the committed file).  The tuner stores
        each shape's winner as it finishes it, so a cut run resumes at the first untuned
        shape; a shape with a measured entry is skipped.  Offline entries only (server
        sub-entries: ``python -m tpul2_torch.autotune --mode server``).  Progress goes to
        stderr; stdout gets one JSON object: the newly tuned shapes, each winner, its
        speedup over torch_matmul and the fastest kernel candidate's time over
        torch_matmul's, and the seconds.

  eval --engine run_mode (the default)
        for each shape not yet in the CSV: the gate (stop the shape if it fails), then
        the bench against every baseline (``bench_offline._run_mode``, time-boxed);
        append the row to ``<out_dir>/tpul2_torch_h100_<acc>_speedup_<mode>.csv`` and the
        shape's record (each function's median, p99 and IQR, the dispatched config, the
        device) to the ``.jsonl`` beside it.  A shape whose gate fails gets no row; its
        failure goes to the sidecar and the run exits 1 after the other shapes.
  eval --engine lean
        the grid campaign (``harness.campaign``): both families from one set of baseline
        measurements with fixed counts (``harness.bench_suite``), a row per family and a
        record per shape in ``tpul2_torch_h100_all_speedup_<mode>.jsonl``.  ``--heal``
        repairs the DB named by ``--db`` (a copy, never the committed file): tainted rows
        are dropped within their journaled budgets and measured again, a losing entry is
        demoted to the fastest screened vendor variant and its row measured again.
        ``--defend`` runs the integrity defenses on each candidate; a row that fails one
        is not written and the run exits 1.  An eval that raises (a kernel config that
        does not build or launch) is recorded in the ``.failures`` file and the sidecar
        and ends the run; no row stands in for it.

Both engines resume: a shape already in the CSV is skipped.  The shape list is
``--shapes`` ('default' = ``harness.suite.DEFAULT_SHAPES``, the JAX harness's 20-shape
sample of the reference's grid, or 'm,n,k;m,n,k;...') or ``--grid reference``, the
reference's 1000-shape grid in ``--order`` (default stratified: every prefix keeps the
grid's band mix) cut at ``--max_shapes``.

Usage:
  cp tpul2_torch/data/tunedb_h100.json runs/db.json
  python scripts/run_suite_torch.py tune --db runs/db.json --max_shapes 100 --acc float32
  python scripts/run_suite_torch.py tune --db /tmp/db.json --device cpu --dims 64 96
  python scripts/run_suite_torch.py eval --acc float32 --mode offline
  python scripts/run_suite_torch.py eval --acc bfloat16 --mode server --target_qps 100
  python scripts/run_suite_torch.py eval --device cpu --shapes "96,160,200" --out_dir /tmp/s
  cp tpul2_torch/data/tunedb_h100.json runs/db.json
  python scripts/run_suite_torch.py eval --engine lean --grid reference --order stratified \
      --max_shapes 300 --heal --defend --db runs/db.json --out_dir eval_results/grid
"""

from __future__ import annotations

import argparse
import dataclasses
import os
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
    from tpul2_torch.harness.suite import REFERENCE_DIMS
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    tu = sub.add_parser("tune", help="tune the grid's shapes into a DB copy")
    tu.add_argument("--db", required=True,
                    help="the TuneDB file the winners go to (not the committed one)")
    tu.add_argument("--dims", type=int, nargs="*", default=REFERENCE_DIMS)
    tu.add_argument("--max_shapes", type=int, default=None)
    tu.add_argument("--max_elems", type=int, default=None,
                    help="skip shapes whose largest operand exceeds this element count")
    tu.add_argument("--order", choices=["lex", "cost", "stratified"], default="lex")
    tu.add_argument("--shapes", default=None,
                    help="'default' or 'm,n,k;m,n,k;...' tuned instead of the grid")
    tu.add_argument("--acc", choices=["float32", "bfloat16"], default="float32")
    tu.add_argument("--chunk", type=int, default=8)
    tu.add_argument("--max_candidates", type=int, default=16)
    tu.add_argument("--stage1_rounds", type=int, default=3)
    tu.add_argument("--stage2_rounds", type=int, default=6)
    tu.add_argument("--finalists", type=int, default=4)
    tu.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    tu.add_argument("--verbose", action="store_true")
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
    ev.add_argument("--engine", choices=["run_mode", "lean"], default="run_mode",
                    help="run_mode: gate + time-boxed bench per shape and family; lean: "
                         "the grid campaign, both families per measurement")
    ev.add_argument("--grid", choices=["reference"], default=None,
                    help="the reference's 1000-shape grid instead of --shapes")
    ev.add_argument("--order", choices=["lex", "cost", "stratified"], default="stratified")
    ev.add_argument("--max_shapes", type=int, default=None)
    ev.add_argument("--db", default=None,
                    help="the TuneDB dispatch reads (default: the committed "
                         "tpul2_torch/data/tunedb_h100.json)")
    ev.add_argument("--heal", action="store_true",
                    help="lean: repair tainted rows and losing DB entries (needs --db)")
    ev.add_argument("--defend", action="store_true",
                    help="lean: run the integrity defenses on each row's candidates")
    ev.add_argument("--trials", type=int, default=None,
                    help="lean: publication iterations per shape (requests in server mode)")
    args = ap.parse_args(argv)
    if args.cmd == "tune":
        from tpul2_torch.harness.campaign import refuse_committed_db
        try:
            args.db = refuse_committed_db(args.db, "tune")
        except ValueError as e:
            ap.error(str(e))
        return args
    if args.mode == "server" and (args.target_qps is None or args.target_qps <= 0):
        ap.error("--mode server needs --target_qps > 0")
    if args.engine == "run_mode" and (args.heal or args.defend or args.trials):
        ap.error("--heal, --defend and --trials belong to --engine lean")
    return args


def shape_list(args) -> list:
    from tpul2_torch.harness.suite import REFERENCE_DIMS, grid
    if args.grid == "reference":
        return grid(REFERENCE_DIMS, max_shapes=args.max_shapes, order=args.order)
    return parse_shapes(args.shapes)[:args.max_shapes]


def tune_shape_list(args) -> list:
    """``--shapes``, else the grid of ``--dims`` (``scripts/run_suite.py``'s ``grid`` in
    lex order)."""
    from tpul2_torch.harness.suite import grid
    if args.shapes:
        return parse_shapes(args.shapes)[:args.max_shapes]
    return grid(args.dims, args.max_shapes, args.max_elems, args.order)


def cmd_tune(args) -> int:
    import json

    import torch

    from tpul2_torch.autotune import search
    from tpul2_torch.autotune.db import TuneDB

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to tune the plain versions)", file=sys.stderr)
        return 1
    db = TuneDB(path=args.db).load()
    shapes = tune_shape_list(args)
    print(f"tuning {len(shapes)} shapes into {args.db} (DB has {len(db)} entries)",
          file=sys.stderr)
    t0 = time.time()
    tuned = []
    # chunk by chunk: the tuner saves the DB after every shape, so a cut run resumes
    for i in range(0, len(shapes), args.chunk):
        chunk = shapes[i:i + args.chunk]
        results = search.tune_many(chunk, acc=args.acc, db=db, device=args.device,
                                   skip_tuned=True, max_candidates=args.max_candidates,
                                   stage1_rounds=args.stage1_rounds,
                                   stage2_rounds=args.stage2_rounds,
                                   finalists=args.finalists, verbose=args.verbose)
        tuned += [{"mnk": [r.m, r.n, r.k], "best": dataclasses.asdict(r.best),
                   "speedup": r.speedup, "seconds": r.elapsed_s,
                   "kernel_vs_torch_matmul": search.fastest_kernel(r.medians_ms)[1]}
                  for r in results]
        print(f"[{time.time() - t0:.0f}s] {i + len(chunk)}/{len(shapes)} "
              f"({len(tuned)} newly tuned)", file=sys.stderr)
    print(json.dumps({"acc": args.acc, "shapes": len(shapes), "tuned": tuned,
                      "seconds": time.time() - t0, "db_entries": len(db)}))
    return 0


def cmd_eval_lean(args) -> int:
    from tpul2_torch.harness.campaign import COMMITTED_DB, run_campaign
    summary = run_campaign(shape_list(args), args.out_dir, mode=args.mode,
                           db_path=args.db or COMMITTED_DB, heal=args.heal,
                           defend=args.defend, trials=args.trials,
                           target_qps=args.target_qps or 100.0, seed=args.seed,
                           device=args.device)
    times = list(summary["shape_seconds"].values())
    print(f"{summary['rows']} rows in {summary['seconds']:.1f} s"
          + (f" ({sum(times) / len(times):.2f} s per shape)" if times else "")
          + f"; failed {summary['failed']}, healed {len(summary['healed'])} shapes, "
          f"defense failed {summary['defense_failed']}", flush=True)
    return 1 if summary["failed"] or summary["defense_failed"] else 0


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
    if args.engine == "lean":
        return cmd_eval_lean(args)
    if args.db:
        from tpul2_torch.autotune import db as db_mod
        os.environ[db_mod.ENV_VAR] = str(args.db)
        db_mod.reset_default_db()
    info = device_info()
    device = info["nvidia_smi"] if args.device == "cuda" else "cpu"
    out = suite.csv_path(args.out_dir, args.acc, args.mode)
    sidecar = out.with_suffix(".jsonl")
    done = suite.done_shapes(out)
    shapes = [s for s in shape_list(args) if suite.mnk_name(*s) not in done]
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
    return cmd_tune(args) if args.cmd == "tune" else cmd_eval(args)


if __name__ == "__main__":
    sys.exit(main())
