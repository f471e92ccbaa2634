"""The readings the check's limit is set from: the program's sound runs and its control,
at the cell's own size, many seeds in one process.  The benchmark's runs never run this.

    python3 gemmbench/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 \
        --seconds 3

For each seed it runs the cell as ``run.py`` does (set-up, a window of ``--seconds``, the
check) with the workload's ``call`` (the program), then for each control seed with its
``control``: the program's own path in the precision below the configuration's, the
bf16-accumulator family.  Each run prints one JSON line: the seed, which side, the widest
gap in bf16 steps and the largest relative error (``reference.compare``), the verdict
against the workload's limits, the widest by output, and the window's own numbers beside
them.  A seed may be any whole number.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    from gemmbench import bench
    if not torch.cuda.is_available():
        print("gemmbench control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for call, run_seeds in (("call", args.seeds), ("control", args.control_seeds)):
        for seed in run_seeds:
            out = bench.run(args.workload, seed, args.seconds, False, device,
                            time.perf_counter(), call=call)
            res = out["result"]
            widest = sorted(out["gaps"].items(), key=lambda kv: -kv[1])[:4]
            rel = sorted(out["rel_errs"].items(), key=lambda kv: -kv[1])[:2]
            print(json.dumps({"workload": args.workload, "side": call, "seed": seed,
                              "max_ulp_gap": max(out["gaps"].values(), default=None),
                              "max_rel_err": rel[0][1] if rel else None, "largest_rel": rel,
                              "correct": res["correct"], "checked": res["checked"],
                              "failed": res["failed"], "widest": widest,
                              "metrics": {k: v["value"] for k, v in res["metrics"].items()}}),
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
