#!/usr/bin/env python
"""Re-tune the thin-K band's retune targets of the H100 port with a larger budget.

The counterpart of ``scripts/retune_thin_k.py``.  The thin-K rows that are neither at the
write-allocate roofline nor already winning (``scripts/thin_k_report_torch.py
--targets_out`` lists them) get a deeper search than the grid's tune gave them: the full
candidate set up to ``--max_candidates`` (which at the band's large shapes holds the wide
blocks, ``config.candidate_configs``), more finalists, longer stage-2 timing, through
``autotune.search.tune_shape(..., save="improve")``: a winner is stored where the shape has
no entry, or where it beats the stored TFLOP/s by more than the 10% noise margin (a
seeded ``measured: false`` entry stores 0.0, so any winner replaces it; the gain over it
prints as ``inf``).  The run stops at ``--budget_s`` between shapes and prints the targets
left, so that it can be resumed with them.

Two differences from the JAX tool:
  - ``--db`` is required and refuses the committed ``tpul2_torch/data/tunedb_h100.json``
    (``harness.campaign.refuse_committed_db``): the retune writes the DB it tunes, so it
    runs on a copy; the JAX tool writes its default DB;
  - the re-tuned shapes' rows are dropped (``drop_rows``, the JAX tool's) only from a
    ``--csv`` given, and never from one of the committed ``eval_results/tpul2_torch_h100_*``
    CSVs, which are refused: those are the published grid.  The JAX tool drops them from
    its default campaign CSV.

Each re-tuned shape prints the JAX tool's line (speedup over torch.matmul, TFLOP/s, gain
over the stored TFLOP/s), the winner's kind (a wide block, a ring tile or the sentinel),
and the fastest kernel candidate with its stage-1 time over torch_matmul's.
The last line of stdout is a JSON summary.

Usage (on the card):
  cp tpul2_torch/data/tunedb_h100.json runs/db.json
  python scripts/thin_k_report_torch.py --targets_out runs/targets.txt
  python scripts/retune_thin_k_torch.py --targets runs/targets.txt --db runs/db.json
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: The published grid's CSVs: never rewritten by a retune.
COMMITTED_RESULTS = REPO / "eval_results"
COMMITTED_PREFIX = "tpul2_torch_h100_"
#: The clock of the budget (a test may stand another in).
_clock = time.perf_counter


def drop_rows(path: Path, mnks: set) -> int:
    """Remove the rows of ``mnks`` from the CSV at ``path``; return how many went (the JAX
    tool's ``drop_rows``)."""
    if not path.exists():
        return 0
    with path.open() as f:
        rows = list(csv.DictReader(f))
        fieldnames = rows[0].keys() if rows else None
    keep = [r for r in rows if r["mnk"] not in mnks]
    if fieldnames is None or len(keep) == len(rows):
        return 0
    tmp = path.with_suffix(".tmp")
    with tmp.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(fieldnames))
        w.writeheader()
        w.writerows(keep)
    tmp.replace(path)
    return len(rows) - len(keep)


def refuse_committed_csv(path) -> Path:
    """``path`` resolved; raises ``ValueError`` where it is one of the committed
    ``eval_results/tpul2_torch_h100_*`` results."""
    path = Path(path).resolve()
    try:
        rel = path.relative_to(COMMITTED_RESULTS.resolve())
    except ValueError:
        return path
    if rel.parts and rel.parts[0].startswith(COMMITTED_PREFIX):
        raise ValueError(f"{path} is a committed result of the H100 grid; the retune drops "
                         "rows only from a copy")
    return path


def config_kind(cfg) -> str:
    """'sentinel', 'wide' (tl2_wgmma_wide.cu's block) or 'ring' (a ring tile)."""
    if cfg.use_vendor:
        return "sentinel"
    return "wide" if cfg.wide else "ring"


def describe(cfg) -> str:
    if cfg.use_vendor:
        return f"sentinel {cfg.vendor_variant}"
    return (f"{config_kind(cfg)} {cfg.bm}x{cfg.bn} bk={cfg.bk} {cfg.rhs_layout} "
            f"{cfg.grid_order} depth={cfg.pipeline_depth}")


def read_targets(path) -> list:
    shapes = []
    for ln in Path(path).read_text().splitlines():
        ln = ln.strip()
        if ln and not ln.startswith("#"):
            shapes.append(tuple(int(x) for x in ln.split(",")))
    return shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--targets", required=True,
                    help="'m,n,k' per line (thin_k_report_torch.py --targets_out)")
    ap.add_argument("--db", required=True,
                    help="the TuneDB to tune into: a copy, never the committed file")
    ap.add_argument("--acc", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--csv", default=None,
                    help="an offline CSV (a copy) whose re-tuned rows to drop")
    ap.add_argument("--max_candidates", type=int, default=32)
    ap.add_argument("--finalists", type=int, default=8)
    ap.add_argument("--stage1_rounds", type=int, default=4)
    ap.add_argument("--stage2_rounds", type=int, default=12)
    ap.add_argument("--budget_s", type=float, default=4800.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)

    from tpul2_torch.harness.campaign import refuse_committed_db
    try:
        db_path = refuse_committed_db(args.db, "retune_thin_k_torch")
        csv_path = refuse_committed_csv(args.csv) if args.csv else None
    except ValueError as e:
        ap.error(str(e))
    shapes = read_targets(args.targets)
    print(f"retune_thin_k_torch: {len(shapes)} shapes / {args.acc} into {db_path}",
          file=sys.stderr)
    if args.dry_run:
        print(json.dumps({"acc": args.acc, "targets": len(shapes), "dry_run": True}))
        return 0

    from tpul2_torch.autotune import search
    from tpul2_torch.autotune.db import TuneDB

    db = TuneDB(path=db_path).load()
    t0 = _clock()
    improved, retuned, failed, left = [], [], [], []
    for i, (m, n, k) in enumerate(shapes):
        if _clock() - t0 > args.budget_s:
            left = shapes[i:]
            print(f"budget reached after {len(retuned)} shapes; resumable with the "
                  f"{len(left)} targets left:", file=sys.stderr)
            for s in left:
                print(",".join(map(str, s)), file=sys.stderr)
            break
        mnk = f"{m}x{n}x{k}"
        before_tf = (db.get_entry(m, n, k, args.acc) or {}).get("tflops", 0.0)
        try:
            res = search.tune_shape(m, n, k, acc=args.acc, db=db, device=args.device,
                                    max_candidates=args.max_candidates,
                                    stage1_rounds=args.stage1_rounds,
                                    stage2_rounds=args.stage2_rounds,
                                    finalists=args.finalists, save="improve",
                                    verbose=False)
        except Exception as e:  # noqa: BLE001 - the JAX tool's: report and go on
            print(f"{mnk}: retune failed ({type(e).__name__}: {str(e)[:120]})",
                  file=sys.stderr)
            failed.append(mnk)
            continue
        gain = res.best_tflops / before_tf if before_tf else float("inf")
        if gain > 1.10:
            improved.append(mnk)
        kernel, ratio = search.fastest_kernel(res.medians_ms)
        row = {"mnk": mnk, "speedup": res.speedup, "best_tflops": res.best_tflops,
               "gain_vs_stored": gain, "kind": config_kind(res.best),
               "best": describe(res.best),
               "fastest_kernel": describe(kernel) if kernel else None,
               "kernel_vs_torch_matmul": ratio, "seconds": _clock() - t0}
        retuned.append(row)
        print(f"{mnk}/{args.acc}: {res.speedup:.3f}x vs torch.matmul, "
              f"{res.best_tflops:.1f} TFLOPS ({gain:.2f}x vs stored) {row['best']}; "
              f"fastest kernel {row['fastest_kernel']} at "
              f"{'-' if ratio is None else f'{ratio:.3f}'}x torch_matmul's time "
              f"[{row['seconds']:.0f}s]", file=sys.stderr)

    dropped = drop_rows(csv_path, {r["mnk"] for r in retuned}) if csv_path else 0
    print(f"retuned {len(retuned)} shapes ({len(improved)} improved >10%); dropped "
          f"{dropped} CSV rows for re-measurement", file=sys.stderr)
    print(json.dumps({"acc": args.acc, "db": str(db_path), "targets": len(shapes),
                      "retuned": retuned, "improved": improved, "failed": failed,
                      "left": [f"{m}x{n}x{k}" for m, n, k in left], "dropped": dropped,
                      "seconds": _clock() - t0}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
