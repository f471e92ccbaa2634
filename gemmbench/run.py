"""Run one cell of the benchmark of tpul2_torch on the card, print its result line.

    python3 gemmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It needs as many CUDA cards as the cell asks for and never
falls back to the CPU.  With ``--trace 0`` the line's metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read in a window of ``--seconds`` run
as the untraced one is, then a profiled part of fixed size (``torch.profiler``, twice).
The last line of standard output is one JSON object; the numbers compared by the check
are the last lines of standard error.  The exit code is 0 whenever a result is printed,
correct or not.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: Top-level module names that may not be loaded in the process that prints the result:
#: JAX and the JAX package, compared whole (tpul2_torch is the program).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpul2"})


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from gemmbench import bench, spec

    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gemmbench: cell {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = bench.run(args.workload, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"gemmbench: the process loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for err in out["errors"]:
        print(f"gemmbench: a call failed: {err}", file=sys.stderr)
    for what, gap in sorted(out["gaps"].items(), key=lambda kv: -kv[1])[:5]:
        print(f"gemmbench: widest gaps: {what} {gap!r} ulp", file=sys.stderr)
    for what, rel in sorted(out["rel_errs"].items(), key=lambda kv: -kv[1])[:3]:
        print(f"gemmbench: largest relative errors: {what} {rel!r}", file=sys.stderr)
    if out["gate_misses"]:
        print(f"gemmbench: {sum(out['gate_misses'].values())} burst gate(s) ended before the "
              f"host had enqueued their burst: {out['gate_misses']}", file=sys.stderr)
    res = out["result"]
    for key in ("device_ops", "idle_gaps"):
        for name, sec in res.get("breakdown", {}).get(key, [])[:6]:
            print(f"gemmbench: {key} {sec!r} s {name[:100]}", file=sys.stderr)
    marks = ", ".join(f"{k} at {v:.3f} s" for k, v in out["marks"].items())
    print(f"gemmbench: set-up {out['setup_s']!r} s ({marks}), run {time.perf_counter() - T_START!r} s, "
          f"outputs checked {len(out['gaps'])}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
