#!/usr/bin/env python
"""Aggregate tpul2_torch's per-shape speedup CSVs into summary tables.

The counterpart of ``scripts/aggregate_results.py`` over the port's CSVs (CUDA-L2's
columns, ``harness.suite.CSV_COLUMNS``): per column the arithmetic and geometric mean of
the speedups, the wins (> 1.001) and ties (0.999..1.001); then per band (thin-K, skinny,
square, other: ``harness.suite.band``) the geomean against torch.matmul, the best row and
the wins above 1.03.  The reference README's mean-speedup tables are computed the same way.

  python scripts/aggregate_results_torch.py eval_results/tpul2_torch_h100_grid/*.csv
"""

from __future__ import annotations

import csv
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tpul2_torch.harness.campaign import NON_SPEEDUP_COLUMNS  # noqa: E402
from tpul2_torch.harness.suite import band  # noqa: E402

BANDS = ("thin-K", "skinny", "square", "other")


def _rows(path: Path) -> list:
    with Path(path).open(newline="") as f:
        return list(csv.DictReader(f))


def _geomean(vals: list) -> float:
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def aggregate(path: Path) -> dict:
    """Per speedup column: n, mean, geomean, wins, ties."""
    rows = _rows(path)
    if not rows:
        return {}
    out = {}
    for c in (c for c in rows[0] if c not in NON_SPEEDUP_COLUMNS):
        vals = [float(r[c]) for r in rows if r.get(c)]
        if vals:
            out[c] = {"n": len(vals), "mean": sum(vals) / len(vals), "geomean": _geomean(vals),
                      "wins": sum(v > 1.001 for v in vals),
                      "ties": sum(0.999 <= v <= 1.001 for v in vals)}
    return out


def band_table(path: Path, col: str = "torch.matmul") -> dict:
    """Per band: n, geomean, max and wins > 1.03 of one column."""
    rows = _rows(path)
    out = {}
    for b in BANDS:
        vals = [float(r[col]) for r in rows if r.get(col) and band(r["mnk"]) == b]
        if vals:
            out[b] = {"n": len(vals), "geomean": _geomean(vals), "max": max(vals),
                      "wins": sum(v > 1.03 for v in vals)}
    return out


def tables(path: Path) -> str:
    """The markdown tables of one CSV (empty if it has no rows)."""
    agg = aggregate(path)
    if not agg:
        return ""
    lines = [f"## {Path(path).name} ({next(iter(agg.values()))['n']} shapes)", "",
             "| Baseline | Mean speedup | Geomean | wins | ties |", "|---|---|---|---|---|"]
    lines += [f"| {c} | {s['mean']:.4f}x | {s['geomean']:.4f}x | {s['wins']} | {s['ties']} |"
              for c, s in agg.items()]
    bands = band_table(path)
    if bands:
        lines += ["", "| Band (vs torch.matmul) | n | Geomean | Best | wins>1.03 |",
                  "|---|---|---|---|---|"]
        lines += [f"| {b} | {s['n']} | {s['geomean']:.4f}x | {s['max']:.4f}x | {s['wins']} |"
                  for b, s in bands.items()]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    paths = [Path(p) for p in (sys.argv[1:] if argv is None else argv)]
    if not paths:
        print("usage: aggregate_results_torch.py CSV [CSV...]", file=sys.stderr)
        return 2
    for p in paths:
        text = tables(p)
        if text:
            print("\n" + text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
