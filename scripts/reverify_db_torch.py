#!/usr/bin/env python
"""Re-verify the stored kernel winners of a tpul2_torch TuneDB against torch.matmul; demote
the ones whose win does not reproduce.

The counterpart of ``scripts/reverify_db.py``: for every entry that is not the vendor
sentinel (optionally of one family), time the stored config and torch.matmul by device
time (``harness.bench_utils.GraphTimer``: two CUDA graphs of 10 and 110 calls, the
difference per extra call), over ``--trials`` rounds of fresh inputs in a shuffled order,
medians; record the reproduced speedup and the trial count in the entry, and where it is
below ``--demote_below`` replace the config with the torch_matmul sentinel, keeping the
old one as ``demoted_from``.  A config that cannot run at its shape is a failure: it goes
through ``harness.bench_suite.demote_uncompilable_entries`` (a launch probe after a card
canary, then a sentinel-only tuner race), whose entry keeps the error as
``demotion_reason``; a config the probe can launch is left as stored, with the error as
``reverify_error``; either way the script exits 1.  ``--dry_run`` prints the verdicts and
writes nothing.  The script rewrites the DB, so it refuses the committed
``tpul2_torch/data/tunedb_h100.json`` except in a dry run: pass a copy.

Usage:
  python scripts/reverify_db_torch.py --db runs/db.json [--acc float32]
      [--demote_below 1.0] [--trials 8] [--max_shapes N] [--dry_run]
"""

from __future__ import annotations

import argparse
import random
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--db", default=None,
                    help="the TuneDB file (default: TPUL2_TORCH_TUNEDB or the committed one, "
                         "which only --dry_run may read)")
    ap.add_argument("--acc", default=None, choices=["float32", "bfloat16"])
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--demote_below", type=float, default=1.0,
                    help="reproduced speedup below this -> the torch_matmul sentinel")
    ap.add_argument("--max_shapes", type=int, default=None)
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from tpul2_torch.autotune.db import TuneDB
    from tpul2_torch.autotune.search import _make_fn
    from tpul2_torch.config import KernelConfig
    from tpul2_torch.harness import bench_utils as bu
    from tpul2_torch.harness.bench_suite import demote_uncompilable_entries
    from tpul2_torch.harness.campaign import refuse_committed_db
    from tpul2_torch.utils.platform import check_device

    db = TuneDB(path=args.db)
    if not args.dry_run:
        try:
            refuse_committed_db(db.path, "reverify")
        except ValueError as e:
            ap.error(str(e))
    check_device(args.device, "the re-verification times the card")
    db.load()
    todo = [(mnk, acc, e) for mnk, acc, e in db.items()
            if not e["config"].get("use_vendor") and args.acc in (None, acc)]
    todo = todo[:args.max_shapes]
    print(f"re-verifying {len(todo)} stored kernel winners of {db.path}", file=sys.stderr)
    rng = np.random.default_rng(0)
    order_rng = random.Random(0)
    kept = demoted = failed = 0
    t0 = time.time()
    for (m, n, k), acc, e in todo:
        cfg = KernelConfig(**e["config"])
        name = f"{m}x{n}x{k}/{acc}"
        static = bu.fresh_inputs(rng, m, n, k, device=args.device)
        floor = bu.bound_ms(m, n, k)
        try:
            timers = {"cand": bu.GraphTimer(_make_fn(cfg, static[0].dtype), static, floor),
                      "torch": bu.GraphTimer(_make_fn(KernelConfig.vendor(), static[0].dtype),
                                             static, floor)}
            times = {key: [] for key in timers}
            order = list(timers)
            for _ in range(args.trials):
                bu.load_inputs(static, bu.fresh_inputs(rng, m, n, k, device=args.device))
                order_rng.shuffle(order)
                for key in order:
                    times[key].append(timers[key].time_ms())
            ms = {key: float(np.median(v)) for key, v in times.items()}
            reproduced = ms["torch"] / ms["cand"]
        except (RuntimeError, ValueError) as ex:  # the config cannot run at its shape
            failed += 1
            error = f"{type(ex).__name__}: {str(ex)[:160]}"
            if args.dry_run:
                verdict = "not written (dry run)"
            elif demote_uncompilable_entries(db, m, n, k, [acc], device=args.device):
                verdict = "demoted to the fastest sentinel (see demotion_reason)"
            else:
                e["reverify_error"] = error
                db.save()
                verdict = "the probe launches it: left as stored, reverify_error recorded"
            print(f"{name}: FAILED ({error}): {verdict}", file=sys.stderr)
            continue
        extra = {key: v for key, v in e.items() if key not in ("config", "tflops")}
        extra.update({"reverified_speedup": round(reproduced, 4),
                      "reverify_trials": args.trials})
        stored = e.get("speedup_vs_torch_matmul", float("nan"))
        if reproduced < args.demote_below:
            demoted += 1
            extra["demoted_from"] = e["config"]
            new_cfg = KernelConfig.vendor()
            tflops = bu.tflops(m, n, k, ms["torch"])
            verdict = "DEMOTED"
        else:
            kept += 1
            new_cfg, tflops, verdict = cfg, bu.tflops(m, n, k, ms["cand"]), "kept"
        print(f"{name}: stored {stored:.3f}x -> reproduced {reproduced:.3f}x  {verdict}",
              file=sys.stderr)
        if not args.dry_run:
            db.put(m, n, k, new_cfg, tflops, acc=acc, extra=extra)
            db.save()
    print(f"done in {time.time() - t0:.0f} s: {kept} kept, {demoted} demoted, {failed} "
          "failed to run" + (" (dry run: nothing written)" if args.dry_run else ""),
          file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
