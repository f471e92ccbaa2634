"""Autotuner CLI: tune one shape on the card and store the winner in the TuneDB.

  python -m tpul2_torch.autotune --mnk 64 8192 8192 --acc float32
  python -m tpul2_torch.autotune --mnk 4096 4096 4096 --max_candidates 32 -v
  python -m tpul2_torch.autotune --device cpu --mnk 32 128 2048   # plain versions

The DB is ``TPUL2_TORCH_TUNEDB`` if set, else ``tpul2_torch/data/tunedb_h100.json``.
Prints the TuneResult as JSON.  Without a card it fails unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpul2_torch.autotune", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mnk", type=int, nargs=3, required=True, metavar=("M", "N", "K"))
    ap.add_argument("--acc", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--max_candidates", type=int, default=24)
    ap.add_argument("--stage1_rounds", type=int, default=4)
    ap.add_argument("--stage2_rounds", type=int, default=8)
    ap.add_argument("--finalists", type=int, default=5)
    ap.add_argument("--no_save", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from tpul2_torch.autotune.search import tune_shape
    m, n, k = args.mnk
    res = tune_shape(m, n, k, acc=args.acc, device=args.device,
                     max_candidates=args.max_candidates,
                     stage1_rounds=args.stage1_rounds, stage2_rounds=args.stage2_rounds,
                     finalists=args.finalists, save=not args.no_save,
                     verbose=args.verbose)
    print(json.dumps(dataclasses.asdict(res), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
