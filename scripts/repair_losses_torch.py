#!/usr/bin/env python
"""Repair pass: re-tune the shapes where a tpul2_torch speedup CSV shows the candidate
losing, and drop their rows so that the next ``run_suite_torch.py eval`` measures them
again.

The counterpart of ``scripts/repair_losses.py``.  The torch_matmul sentinel competes in
every search, so a row below ``--threshold`` against any column means the stored config
is stale or was tuned under noise.  Each losing shape is tuned again
(``autotune.search.tune_many`` with a larger budget, into the DB named by ``--db``), then
its row leaves the CSV.  ``--dry_run`` lists the losing rows and changes nothing.  The
tuning rewrites the DB, so the script refuses the committed
``tpul2_torch/data/tunedb_h100.json``: pass a copy.

  python scripts/repair_losses_torch.py --csv eval_results/x.csv --db runs/db.json \\
      [--threshold 0.97] [--acc float32]
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tpul2_torch.harness.campaign import NON_SPEEDUP_COLUMNS  # noqa: E402


def losing_rows(rows: list, threshold: float) -> list:
    """The mnk names of the rows whose worst speedup column is below ``threshold``."""
    out = []
    for r in rows:
        vals = [float(v) for c, v in r.items() if c not in NON_SPEEDUP_COLUMNS and v]
        if vals and min(vals) < threshold:
            out.append(r["mnk"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--csv", required=True)
    ap.add_argument("--db", default=None,
                    help="the TuneDB to tune into (default: TPUL2_TORCH_TUNEDB; never the "
                         "committed one)")
    ap.add_argument("--threshold", type=float, default=0.97)
    ap.add_argument("--acc", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--stage2_rounds", type=int, default=30)
    ap.add_argument("--max_candidates", type=int, default=64)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)

    path = Path(args.csv)
    with path.open(newline="") as f:
        reader = csv.DictReader(f)
        fieldnames = reader.fieldnames
        rows = list(reader)
    losers = losing_rows(rows, args.threshold)
    print(f"{len(losers)} losing rows: {losers}", file=sys.stderr)
    if args.dry_run or not losers:
        return 0

    from tpul2_torch.autotune.db import TuneDB
    from tpul2_torch.autotune.search import tune_many
    from tpul2_torch.harness.campaign import refuse_committed_db
    db = TuneDB(path=args.db)
    try:
        refuse_committed_db(db.path, "the repair")
    except ValueError as e:
        ap.error(str(e))
    db.load()
    tune_many([tuple(int(x) for x in s.split("x")) for s in losers], acc=args.acc, db=db,
              device=args.device, skip_tuned=False, max_candidates=args.max_candidates,
              stage1_rounds=8, stage2_rounds=args.stage2_rounds, finalists=8, verbose=True)
    keep = [r for r in rows if r["mnk"] not in set(losers)]
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(keep)
    print(f"dropped {len(rows) - len(keep)} rows from {path}; run "
          f"scripts/run_suite_torch.py eval to measure them again", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
