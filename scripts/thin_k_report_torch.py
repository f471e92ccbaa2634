#!/usr/bin/env python
"""Thin-K band analysis of the H100 port: per-shape roofline shares and retune targets.

The counterpart of ``scripts/thin_k_report.py``.  The thin-K band (K <= 512 with
max(M, N) >= 2048, ``harness.suite.band``) is bound by the output's writes.  This tool
says, shape by shape from an offline CSV and its JSONL sidecar (the latest record per
shape), how close the candidate and torch.matmul come to the card's roofline:

  share_naive = t_bound / t_measured, t_bound = max(FLOPs / peak, bytes / HBM rate), each
      operand read once and the output written once (``harness.bench_utils.bound_ms``);
  share_wa    = the same with the output's bytes times ``--wa_factor``: where a streamed
      store of C first fills the line from HBM, a C-write-bound shape moves wa_factor
      times the output's bytes (v5e's was ~2).  The default, WA_FACTOR, is the H100's as
      chip_smoke.py phase thin-K measures it: read-only over write-only GB/s.

Both the candidate (``tpul2_torch_<acc>``, the dispatched entry point) and the baseline
(``torch_matmul``) write bf16 C (``dispatch.matmul`` defaults its output to the operands'
dtype; ``ops.baselines.torch_matmul`` is ``torch.matmul``), in both families: the bound
counts 2 output bytes.  The peaks are ``harness.profiling.DEVICE_PEAKS``, by the card
named in each record's ``device`` field; a card with no published peaks is refused.

A shape whose candidate share_wa is at least ``--physics_bar`` is at the wall; one below
it that is not already winning (speedup below ``--win_bar``) is a retune target
(``scripts/retune_thin_k_torch.py`` reads the list).

Usage (the default reads the committed no-heal grid of the H100, eval_results/
tpul2_torch_h100_grid_noheal/):
  python scripts/thin_k_report_torch.py [--acc float32] [--csv ...] [--detail ...]
      [--targets_out targets.txt] [--out_csv rows.csv] [--markdown]
The last line of stdout is a JSON summary, with the rows split by what the candidate ran
(a kernel or the sentinel, from the sidecar's configs) and, among them, the large ones.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tpul2_torch.harness.profiling import DEVICE_PEAKS  # noqa: E402
from tpul2_torch.harness.suite import band  # noqa: E402

#: The write-allocate factor of the NVIDIA H100 80GB HBM3 at 700.00 W: its read-only
#: GB/s over its write-only GB/s over the same 2 GiB (chip_smoke.py phase thin-K (a),
#: medians of three turns: 3112.3 GB/s read-only, 3283.4 write-only).  Below 1: the card
#: writes whole lines without filling them first, and streams writes faster than reads.
WA_FACTOR = 0.948
#: Output bytes of what the grid measured: bf16 C, candidate and baseline alike.
OUT_BYTES = 2
GRID_DIR = REPO / "eval_results" / "tpul2_torch_h100_grid_noheal"
DEFAULT_DETAIL = GRID_DIR / "tpul2_torch_h100_all_speedup_offline.jsonl"
BASELINE = "torch_matmul"
BASELINE_COLUMN = "torch.matmul"


def default_csv(acc: str) -> Path:
    return GRID_DIR / f"tpul2_torch_h100_{acc}_speedup_offline.csv"


def card_peaks(device: str):
    """The published peaks of the card a record names (``"<name>, <limit> W"`` as
    nvidia-smi gives it, or the bare name); raises ``ValueError`` for any other card."""
    name = device.rsplit(", ", 1)[0] if device.endswith(" W") else device
    if name not in DEVICE_PEAKS:
        raise ValueError(f"no published peaks for the card {device!r} "
                         f"(harness.profiling.DEVICE_PEAKS has {sorted(DEVICE_PEAKS)})")
    return DEVICE_PEAKS[name]


def bound_ms(m: int, n: int, k: int, peaks, wa_factor: float = 1.0,
             out_bytes: int = OUT_BYTES) -> float:
    """``bench_utils.bound_ms`` at ``peaks``, with the output's bytes times
    ``wa_factor`` (1.0: the naive bound)."""
    t_bytes = ((m * k + k * n) * 2 + wa_factor * m * n * out_bytes) / peaks.bytes * 1e3
    return max(t_bytes, 2.0 * m * n * k / peaks.flops * 1e3)


def latest_records(detail_path) -> dict:
    """The sidecar's latest record per mnk (a re-measurement appends a fresh one)."""
    details = {}
    for line in Path(detail_path).read_text().splitlines():
        try:
            r = json.loads(line)
        except ValueError:
            continue
        details[r["mnk"]] = r
    return details


def analyze(csv_path, detail_path, acc, physics_bar: float = 0.85, win_bar: float = 1.05,
            wa_factor: float = WA_FACTOR):
    """Per-shape thin-K roofline shares for one family.

    Returns (rows, targets, missing): rows are dicts sorted by ascending candidate
    write-allocate share; targets are (m, n, k) below the physics bar that are not already
    winning; missing counts band rows of the CSV with no sidecar record of the candidate."""
    details = latest_records(detail_path)
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    cand = f"tpul2_torch_{acc}"
    out_rows, targets = [], []
    missing = 0
    for r in rows:
        if band(r["mnk"]) != "thin-K":
            continue
        m, n, k = map(int, r["mnk"].split("x"))
        d = details.get(r["mnk"])
        if d is None or cand not in d.get("per_func", {}):
            missing += 1
            continue
        peaks = card_peaks(d["device"])
        cand_ms = d["per_func"][cand]["ms"]
        base_ms = d["per_func"][BASELINE]["ms"]
        rec = {
            "mnk": r["mnk"],
            "speedup": float(r[BASELINE_COLUMN]),
            "cand_share_naive": bound_ms(m, n, k, peaks) / cand_ms,
            "cand_share_wa": bound_ms(m, n, k, peaks, wa_factor) / cand_ms,
            "torch_share_wa": bound_ms(m, n, k, peaks, wa_factor) / base_ms,
            "torch_share_naive": bound_ms(m, n, k, peaks) / base_ms,
            "ran": ("sentinel" if d.get("configs", {}).get(acc, {}).get("use_vendor")
                    else "kernel"),
        }
        out_rows.append(rec)
        if rec["cand_share_wa"] < physics_bar and rec["speedup"] < win_bar:
            targets.append((m, n, k))
    out_rows.sort(key=lambda x: x["cand_share_wa"])
    return out_rows, targets, missing


def write_rows_csv(path, rows) -> None:
    """The rows as a CSV (the columns of eval_results/thin_k_roofline_*.csv, with
    torch_share_wa for xla_share_wa)."""
    fields = ["mnk", "speedup", "cand_share_naive", "cand_share_wa", "torch_share_wa"]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)


def breakdown(rows) -> dict:
    """The rows by what the candidate ran (the sidecar's config: a kernel or the sentinel)
    and, among them, the large ones (M·N >= 4096^2): their count, geomean speedup over
    torch.matmul and median naive roofline shares of the candidate and torch.matmul."""
    def stats(part):
        if not part:
            return {"rows": 0}
        logs = [math.log(r["speedup"]) for r in part]
        return {"rows": len(part), "geomean_speedup": math.exp(sum(logs) / len(logs)),
                "median_cand_share_naive": statistics.median(
                    r["cand_share_naive"] for r in part),
                "median_torch_share_naive": statistics.median(
                    r["torch_share_naive"] for r in part)}

    def large(r):
        m, n, _ = map(int, r["mnk"].split("x"))
        return m * n >= 4096 * 4096

    return {ran: {"all": stats([r for r in rows if r["ran"] == ran]),
                  "large": stats([r for r in rows if r["ran"] == ran and large(r)])}
            for ran in ("kernel", "sentinel")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--csv", default=None,
                    help="offline CSV (default: the committed no-heal grid's, of --acc)")
    ap.add_argument("--detail", default=str(DEFAULT_DETAIL), help="its JSONL sidecar")
    ap.add_argument("--acc", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--physics_bar", type=float, default=0.85,
                    help="candidate share_wa at/above this = at the wall")
    ap.add_argument("--win_bar", type=float, default=1.05,
                    help="rows already winning at least this much are not retune targets")
    ap.add_argument("--wa_factor", type=float, default=WA_FACTOR,
                    help="the output's write-allocate factor (default: the H100's, measured)")
    ap.add_argument("--targets_out", default=None, help="write 'm,n,k' retune targets here")
    ap.add_argument("--out_csv", default=None, help="write the per-shape rows here")
    ap.add_argument("--markdown", action="store_true",
                    help="print the per-shape markdown table")
    args = ap.parse_args(argv)

    csv_path = args.csv or default_csv(args.acc)
    out_rows, targets, missing = analyze(csv_path, args.detail, args.acc,
                                         physics_bar=args.physics_bar, win_bar=args.win_bar,
                                         wa_factor=args.wa_factor)
    at_wall = sum(1 for r in out_rows if r["cand_share_wa"] >= args.physics_bar)
    winning = sum(1 for r in out_rows if r["speedup"] >= args.win_bar)
    print(f"thin-K rows analyzed: {len(out_rows)} (missing detail: {missing})",
          file=sys.stderr)
    print(f"  at the write-allocate roofline (share_wa >= {args.physics_bar}, wa_factor "
          f"{args.wa_factor}): {at_wall}", file=sys.stderr)
    print(f"  already winning >= {args.win_bar}x: {winning}", file=sys.stderr)
    print(f"  retune targets (below bar, not winning): {len(targets)}", file=sys.stderr)

    if args.markdown:
        print("| mnk | speedup | cand naive | cand +WA | torch.matmul +WA |")
        print("|---|---|---|---|---|")
        for r in out_rows:
            print(f"| {r['mnk']} | {r['speedup']:.3f}x | {r['cand_share_naive']:.0%} | "
                  f"{r['cand_share_wa']:.0%} | {r['torch_share_wa']:.0%} |")
    if args.targets_out:
        Path(args.targets_out).write_text(
            "\n".join(f"{m},{n},{k}" for m, n, k in targets) + "\n")
        print(f"wrote {len(targets)} targets to {args.targets_out}", file=sys.stderr)
    if args.out_csv:
        write_rows_csv(args.out_csv, out_rows)
    print(json.dumps({"acc": args.acc, "csv": str(csv_path), "rows": len(out_rows),
                      "missing": missing, "at_wall": at_wall, "winning": winning,
                      "targets": len(targets), "wa_factor": args.wa_factor,
                      "by_config": breakdown(out_rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
