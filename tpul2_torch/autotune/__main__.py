"""Autotuner CLI: tune shapes on the card and store the winners in the TuneDB.

  python -m tpul2_torch.autotune --mnk 64 8192 8192 --acc float32
  python -m tpul2_torch.autotune --mnk 4096 4096 4096 --max_candidates 32 -v
  python -m tpul2_torch.autotune --shapes default --acc bfloat16        # DEFAULT_SHAPES
  python -m tpul2_torch.autotune --shapes default --mode server --target_qps 100
  python -m tpul2_torch.autotune --device cpu --mnk 32 128 2048   # plain versions

Candidates are ranked by device time (``GraphTimer``).  ``--mode server`` ranks the
finalists once more by the server bench's per-call time (one call after a Poisson gap of
mean 1 / target_qps s) and stores the winner as the shape's ``server`` sub-entry.
The DB is ``TPUL2_TORCH_TUNEDB`` if set, else ``tpul2_torch/data/tunedb_h100.json``.
Prints the TuneResult as JSON (a list with ``--shapes``).  Without a card it fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpul2_torch.autotune", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--mnk", type=int, nargs=3, metavar=("M", "N", "K"))
    which.add_argument("--shapes", choices=["default"],
                       help="tune harness.suite.DEFAULT_SHAPES, one after another")
    ap.add_argument("--acc", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--mode", choices=["offline", "server"], default="offline")
    ap.add_argument("--target_qps", type=float, default=100.0,
                    help="server mode: mean request rate of the Poisson gaps")
    ap.add_argument("--max_candidates", type=int, default=24)
    ap.add_argument("--stage1_rounds", type=int, default=4)
    ap.add_argument("--stage2_rounds", type=int, default=8)
    ap.add_argument("--finalists", type=int, default=5)
    ap.add_argument("--no_save", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.mode == "server" and args.target_qps <= 0:
        ap.error("--mode server needs --target_qps > 0")

    from tpul2_torch.autotune.search import tune_many, tune_shape
    kw = dict(acc=args.acc, device=args.device, max_candidates=args.max_candidates,
              stage1_rounds=args.stage1_rounds, stage2_rounds=args.stage2_rounds,
              finalists=args.finalists, save=not args.no_save, mode=args.mode,
              target_qps=args.target_qps, verbose=args.verbose)
    if args.shapes:
        from tpul2_torch.harness.suite import DEFAULT_SHAPES
        res = tune_many(DEFAULT_SHAPES, **kw)
        print(json.dumps([dataclasses.asdict(r) for r in res], indent=1))
        return 0
    m, n, k = args.mnk
    res = tune_shape(m, n, k, **kw)
    print(json.dumps(dataclasses.asdict(res), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
