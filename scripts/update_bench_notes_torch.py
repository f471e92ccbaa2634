#!/usr/bin/env python
"""Regenerate ``eval_results/tpul2_torch_h100_NOTES.md`` from the port's CSVs.

The counterpart of ``scripts/update_bench_notes.py`` for tpul2_torch: the notes are
computed from the artifacts, so they cannot drift from them.  For each grid campaign
(``eval_results/tpul2_torch_h100_grid/``, with the heal loop, and
``eval_results/tpul2_torch_h100_grid_noheal/``, without it): the reference-grid coverage
per family and mode, the quality counts of the campaign's sidecar, journals and failure files (rows
re-measured after a heal, repair-journal entries per taint class, defenses, failures,
losses), and the aggregate and band tables; then the tables of the 20-shape suite's CSVs
(``eval_results/tpul2_torch_h100_*.csv`` and ``tpul2_torch_h100_heuristic/``).  It writes
that one file and nothing else; a value that is not there is written as "not measured".

  python scripts/update_bench_notes_torch.py
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from aggregate_results_torch import tables  # noqa: E402

from tpul2_torch.harness.campaign import load_failures, sidecar_path  # noqa: E402
from tpul2_torch.harness.suite import REFERENCE_DIMS  # noqa: E402

RESULTS = REPO / "eval_results"
NOTES = RESULTS / "tpul2_torch_h100_NOTES.md"
#: The campaigns: with the heal loop, and without it (the kernels as dispatch picks them).
GRID_DIRS = (RESULTS / "tpul2_torch_h100_grid", RESULTS / "tpul2_torch_h100_grid_noheal")
SUITE_DIRS = (RESULTS, RESULTS / "tpul2_torch_h100_heuristic")
MODES = ("offline", "server")
ACCS = ("float32", "bfloat16")


def _rel(path: Path) -> str:
    try:
        return str(path.resolve().relative_to(REPO))
    except ValueError:
        return str(path)


def _rows(path: Path) -> list:
    with path.open(newline="") as f:
        return list(csv.DictReader(f))


def coverage(path: Path) -> tuple:
    """(rows on the reference grid, the grid's size, rows off it)."""
    full = {f"{m}x{n}x{k}" for m in REFERENCE_DIMS for n in REFERENCE_DIMS
            for k in REFERENCE_DIMS}
    names = [r["mnk"] for r in _rows(path)]
    on = sum(name in full for name in names)
    return on, len(full), len(names) - on


def quality(grid_dir: Path, mode: str) -> list:
    """Lines of quality counts of one mode's campaign."""
    lines = []
    sidecar = sidecar_path(grid_dir, mode)
    records = ([json.loads(ln) for ln in sidecar.read_text().splitlines() if ln.strip()]
               if sidecar.exists() else [])
    errors = [r for r in records if "error" in r]
    records = [r for r in records if "error" not in r]
    if records:
        latest = {r["mnk"]: r for r in records}  # a shape measured again: its last record
        healed = sorted({r["mnk"] for r in records if r.get("remeasured_after_heal")})
        defended = {r["mnk"] for r in records if "defense" in r}
        failed_def = sorted({r["mnk"] for r in records if "defense" in r and not all(
            d["pass"] for d in r["defense"].values())})
        kernel = [r for r in latest.values() if r.get("launches")]
        first_kernel = [r for r in latest.values()
                        if (r.get("before_heal") or r).get("launches")]
        devices = sorted({r["device"] for r in records})
        shas = {(r.get("db") or {}).get("sha256") or "absent" for r in records}
        per_shape = [r["shape_seconds"] for r in records if "shape_seconds" in r]
        lines.append(f"- {len(latest)} shapes, {len(records)} measurements "
                     f"({', '.join(devices)}). A hand-written kernel ran in the first "
                     f"measurement of {len(first_kernel)} shapes and in the published one of "
                     f"{len(kernel)}; the others dispatched a vendor sentinel.")
        for acc in ACCS:
            for label, recs in (("first", [r.get("before_heal") or r for r in latest.values()]),
                                ("published", list(latest.values()))):
                lines.append(f"- {acc}, where the {label} measurement's config came from: "
                             + _sources([r.get("config_source", {}).get(acc)
                                         for r in recs]) + ".")
            for label, recs in (("a hand-written kernel", kernel),
                                ("a vendor sentinel", [r for r in latest.values()
                                                       if not r.get("launches")])):
                if recs:
                    gm = _geomean([r["speedups"][acc]["torch_matmul"] for r in recs])
                    lines.append(f"- {acc}, the {len(recs)} published rows that ran {label}: "
                                 f"geomean {gm:.4f}x torch.matmul.")
        lines.append(f"- Re-measured after a heal: {len(healed)} shapes"
                     + (f" ({', '.join(healed)})" if 0 < len(healed) <= 12 else "") + ".")
        pairs = [r for r in records if "before_heal" in r]
        for acc in ACCS:
            got = [(r["before_heal"]["speedups"][acc]["torch_matmul"],
                    r["speedups"][acc]["torch_matmul"])
                   for r in pairs if acc in r["healed"]]
            if got:
                lines.append(f"- {acc}, the {len(got)} healed measurements against torch.matmul: "
                             f"geomean {_geomean([b for b, _ in got]):.4f}x before the "
                             f"heal, {_geomean([a for _, a in got]):.4f}x after; "
                             f"{sum(a > b for b, a in got)} faster after.")
        lines.append(f"- Defenses run at {len(defended)} shapes; failed at "
                     f"{len(failed_def)}" + (f": {', '.join(failed_def)}" if failed_def
                                             else "") + ".")
        if per_shape:
            lines.append(f"- Seconds per measurement (eval, heal and defenses): mean "
                         f"{sum(per_shape) / len(per_shape):.2f}, total "
                         f"{sum(per_shape):.0f}.")
        last = records[-1].get("db") or {}
        lines.append(f"- The DB file went through {len(shas)} state(s) (a heal rewrites it); "
                     f"the last measurement ran through `{Path(last.get('path', 'absent')).name}` "
                     f"at sha256 {(last.get('sha256') or 'absent')[:16]} (from the sidecar; a "
                     "healed copy is not committed).")
    failures = sidecar.with_suffix(".failures")
    n_fail = len(failures.read_text().splitlines()) if failures.exists() else 0
    lines.append(f"- Failed evaluations recorded: {n_fail} "
                 f"({len(load_failures(failures))} shapes given up after repeated failures)"
                 + "".join(f"; {r['mnk']}: {r['error']}" for r in errors[-5:]) + ".")
    for acc in ACCS:
        journal = grid_dir / f"tpul2_torch_h100_{acc}_speedup_{mode}.csv.repairs.json"
        if journal.exists():
            j = json.loads(journal.read_text())
            counts = {c: sum(rec.get(c, 0) for rec in j.values())
                      for c in ("loss", "inconsistent", "implausible")}
            lines.append(f"- {acc} repair journal: {len(j)} shapes, re-measurements "
                         f"by taint {counts}.")
    return lines


def _sources(sources: list) -> str:
    """Counts of ``dispatch.config_source`` records: the shape's own entry or a
    neighbour's (each split by whether a heal stored it), the heuristic; records written
    before the field existed count as not recorded."""
    counts: dict = {}
    for src in sources:
        key = (src or {}).get("source", "not recorded")
        if (src or {}).get("scope", "") in ("heal_demote", "server_heal"):
            key += " (a heal entry)"
        counts[key] = counts.get(key, 0) + 1
    return ", ".join(f"{key} {n}" for key, n in sorted(counts.items()))


def _geomean(vals: list) -> float:
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def losses(path: Path, threshold: float = 0.97) -> int:
    return sum(float(r["torch.matmul"]) < threshold for r in _rows(path))


def _grid_section(grid_dir: Path) -> list:
    out = [f"## The reference-grid campaign (`{_rel(grid_dir)}`)", ""]
    grid_csvs = [grid_dir / f"tpul2_torch_h100_{acc}_speedup_{mode}.csv"
                 for mode in MODES for acc in ACCS]
    grid_csvs = [p for p in grid_csvs if p.exists()]
    if not grid_csvs:
        return out + ["No campaign CSV: not measured.", ""]
    for p in grid_csvs:
        on, full, extra = coverage(p)
        devices = sorted({r["device"] for r in _rows(p)})
        out.append(f"- `{p.name}`: {on}/{full} reference-grid shapes"
                   + (f" (+{extra} off the grid)" if extra else "")
                   + f", {losses(p)} below 0.97x torch.matmul; measured on "
                   + (", ".join(devices) or "not measured") + ".")
    for mode in MODES:
        if any(mode in p.name for p in grid_csvs):
            out += ["", f"Quality ({mode}):", ""] + quality(grid_dir, mode)
    for p in grid_csvs:
        out += ["", tables(p)]
    return out


def render(grid_dirs=GRID_DIRS, suite_dirs=SUITE_DIRS) -> str:
    out = ["# tpul2_torch on the H100: campaign results", "",
           "Generated by `python scripts/update_bench_notes_torch.py` from the CSVs named "
           "below; do not edit by hand.  Every speedup is a baseline's per-call time over "
           "the candidate's (> 1 means the candidate is faster); each row's `device` "
           "column names the card and its power limit.", ""]
    for grid_dir in grid_dirs:
        out += _grid_section(Path(grid_dir))
    out += ["", "## The 20-shape suite (`harness.suite.DEFAULT_SHAPES`)", ""]
    suite_csvs = [p for d in suite_dirs
                  for p in sorted(Path(d).glob("tpul2_torch_h100_*_speedup_*.csv"))]
    if not suite_csvs:
        out.append("No suite CSV: not measured.")
    for p in suite_csvs:
        out += [f"From `{_rel(p)}`:", "", tables(p)]
    return "\n".join(out).rstrip() + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid_dirs", nargs="+", default=[str(d) for d in GRID_DIRS])
    ap.add_argument("--out", default=str(NOTES))
    args = ap.parse_args(argv)
    text = render(args.grid_dirs)
    Path(args.out).write_text(text)
    print(f"{args.out} regenerated ({len(text)} chars)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
