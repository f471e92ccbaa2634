#!/usr/bin/env python
"""Store, for every shape of the reference's grid that has no entry in a tpul2_torch TuneDB,
the config dispatch picks for it today.

The counterpart of ``scripts/seed_tail_entries.py``.  For each grid shape and family with
no entry, the entry holds what ``dispatch.resolve_config`` would reach after the DB: the
nearest tuned neighbour's config (``dispatch._neighbor_config``: a sentinel carried as it
is, a kernel winner adapted to the shape, or its sentinel where its win is within noise),
else ``config.heuristic_config``.  Such an entry is marked ``scope: "transfer_static"``,
``measured: false`` and ``speedup_vs_torch_matmul: 1.0``, with the timing and space
revisions, so that it never passes for a measured win: ``dispatch._nearest_entry`` ranks
every measured neighbour ahead of it, a kernel config in it is too weak to carry to a
neighbour (1.0 < ``_neighbor_config``'s 1.05), ``run_suite_torch.py tune`` tunes the shape
anyway, and a lean row that measures it promotes it (``bench_suite._promote``).

Every decision is made against the DB as it was loaded, before the first put.  The JAX
script puts inside its loop, so each later shape's neighbour search sees the static
entries just seeded: seeded from one measured entry at 64^3, it stores 992 vendor
sentinels where dispatch would have run the heuristic kernel.  Here:

  - at every grid shape and family, ``resolve_config`` returns the same config before and
    after seeding (in both modes: no server sub-entry is added);
  - off the grid, a shape that had no neighbour within 2x can find a seeded one afterwards.
    A seeded kernel config there gives way to its sentinel (1.0 < 1.05), so such a shape
    moves from the heuristic kernel to the sentinel.  That is the JAX package's rule, kept
    as it is.

The script writes the DB, so it refuses the committed ``tpul2_torch/data/tunedb_h100.json``
except in a dry run: pass a copy.  Prints the counts by source (neighbour or heuristic) and
kind (sentinel or kernel) to stderr, and the same as one JSON object to stdout.

Usage:
  python scripts/seed_tail_entries_torch.py --db runs/db.json [--dry_run]
      [--accs float32 bfloat16]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def seed_plan(db, shapes, accs) -> list:
    """(m, n, k, acc, config, source) for every shape and family of ``shapes`` x ``accs``
    with no entry in ``db``, each decided against ``db`` as it stands (nothing is put)."""
    from tpul2_torch.config import heuristic_config
    from tpul2_torch.dispatch import _neighbor_config

    plan = []
    for acc in accs:
        for (m, n, k) in shapes:
            if db.get_entry(m, n, k, acc) is not None:
                continue
            cfg = _neighbor_config(db, m, n, k, acc)
            source = "neighbour"
            if cfg is None:
                cfg, source = heuristic_config(m, n, k, acc), "heuristic"
            plan.append((m, n, k, acc, cfg, source))
    return plan


def apply_plan(db, plan) -> None:
    """Put every seed of ``plan`` into ``db``, marked as static (unmeasured)."""
    from tpul2_torch.config import SPACE_REV
    from tpul2_torch.harness import bench_utils as bu

    for m, n, k, acc, cfg, _ in plan:
        db.put(m, n, k, cfg, 0.0, acc=acc,
               extra={"speedup_vs_torch_matmul": 1.0, "timing_rev": bu.TIMING_REV,
                      "space_rev": SPACE_REV, "scope": "transfer_static",
                      "measured": False})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--db", required=True, help="the TuneDB file (a copy, unless --dry_run)")
    ap.add_argument("--accs", nargs="+", default=["float32", "bfloat16"],
                    choices=["float32", "bfloat16"])
    ap.add_argument("--dry_run", action="store_true")
    args = ap.parse_args(argv)

    from tpul2_torch.autotune.db import TuneDB
    from tpul2_torch.harness.campaign import refuse_committed_db
    from tpul2_torch.harness.suite import REFERENCE_DIMS, grid

    if not args.dry_run:
        try:
            refuse_committed_db(args.db, "seeding")
        except ValueError as e:
            ap.error(str(e))
    t0 = time.perf_counter()
    db = TuneDB(path=args.db).load()
    before = len(db)
    plan = seed_plan(db, grid(REFERENCE_DIMS), args.accs)
    counts = {"neighbour": 0, "heuristic": 0, "sentinel": 0, "kernel": 0}
    for *_, cfg, source in plan:
        counts[source] += 1
        counts["sentinel" if cfg.use_vendor else "kernel"] += 1
    if not args.dry_run and plan:
        apply_plan(db, plan)
        db.save()
    seconds = time.perf_counter() - t0
    summary = {"seeded": len(plan), "counts": counts, "entries_before": before,
               "entries_after": len(db), "seconds": seconds, "dry_run": args.dry_run,
               "db": str(db.path)}
    print(f"seeded {len(plan)}: {counts} (DB {before} -> {len(db)} entries, "
          f"{seconds:.2f} s){' (dry run: nothing written)' if args.dry_run else ''}",
          file=sys.stderr)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
