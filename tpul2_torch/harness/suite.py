"""The shape suite and its CSVs: ``DEFAULT_SHAPES``, the CUDA-L2 rows and their writers.

``DEFAULT_SHAPES`` is a copy of the JAX harness's band-stratified 20-shape sample of the
reference's 10^3 grid (``bench.py:53-78``): 6 thin-K, 3 skinny large-K, 1 square and 10
others, in the grid's band proportions.  A row of
``eval_results/tpul2_torch_h100_<acc>_speedup_<mode>.csv`` holds the candidate's speedup
over each baseline in CUDA-L2's column order (the reference's ``eval_results/*.csv``):
``mnk, torch.matmul, cuBLAS-{tn,nn,max}, cuBLASLt-heuristic-{tn,nn,max},
cuBLASLt-auto-tuning-{tn,nn,max}``, where ``-max`` is the layout with the lower speedup
(the worst case for the candidate) and the port's ``cublaslt_{nn,tn}`` are the heuristic
columns; then ``device``, the nvidia-smi name and power limit the row was measured at.
A JSONL sidecar beside each CSV keeps, per shape, every function's median, p99 and IQR,
the dispatched config and the device record.

The campaign's shape list is the reference's grid (``REFERENCE_DIMS`` cubed, SURVEY.md
C14), ordered by ``grid`` and classified by ``band``: copies of ``scripts/run_suite.py``'s
``grid`` and ``scripts/aggregate_results.py``'s ``band``, which the tests hold equal.
"""

from __future__ import annotations

import csv
import itertools
import json
from pathlib import Path

#: The reference's grid edges: the campaign's shapes are this list cubed (1000 shapes).
REFERENCE_DIMS = [64, 128, 256, 512, 1024, 2048, 4096, 8192, 12288, 16384]

DEFAULT_SHAPES = [
    # thin-K (6)
    (8192, 128, 64),
    (12288, 64, 64),
    (2048, 512, 64),
    (2048, 128, 512),
    (64, 4096, 512),
    (64, 8192, 64),
    # skinny, large-K (3)
    (64, 4096, 4096),
    (8192, 128, 8192),
    (64, 8192, 8192),
    # square (1)
    (256, 256, 256),
    # other (10)
    (64, 64, 4096),
    (64, 256, 8192),
    (512, 128, 64),
    (256, 64, 256),
    (128, 64, 4096),
    (64, 64, 12288),
    (1024, 128, 64),
    (128, 1024, 256),
    (1024, 256, 128),
    (1024, 64, 64),
]

#: perf_func -> CSV column (the counterpart of ``scripts/run_suite.py:_LEAN_COLS``).
SPEEDUP_COLUMNS = {
    "torch_matmul": "torch.matmul",
    "cublas_tn": "cuBLAS-tn",
    "cublas_nn": "cuBLAS-nn",
    "cublaslt_tn": "cuBLASLt-heuristic-tn",
    "cublaslt_nn": "cuBLASLt-heuristic-nn",
    "cublaslt_autotuned_tn": "cuBLASLt-auto-tuning-tn",
    "cublaslt_autotuned_nn": "cuBLASLt-auto-tuning-nn",
}
_MAX_PAIRS = [("cuBLAS", "cuBLAS-tn", "cuBLAS-nn"),
              ("cuBLASLt-heuristic", "cuBLASLt-heuristic-tn", "cuBLASLt-heuristic-nn"),
              ("cuBLASLt-auto-tuning", "cuBLASLt-auto-tuning-tn", "cuBLASLt-auto-tuning-nn")]
CSV_COLUMNS = ["mnk", "torch.matmul",
               "cuBLAS-tn", "cuBLAS-nn", "cuBLAS-max",
               "cuBLASLt-heuristic-tn", "cuBLASLt-heuristic-nn", "cuBLASLt-heuristic-max",
               "cuBLASLt-auto-tuning-tn", "cuBLASLt-auto-tuning-nn",
               "cuBLASLt-auto-tuning-max", "device"]


def csv_path(out_dir, acc: str, mode: str, gen: str = "h100") -> Path:
    return Path(out_dir) / f"tpul2_torch_{gen}_{acc}_speedup_{mode}.csv"


def mnk_name(m: int, n: int, k: int) -> str:
    return f"{m}x{n}x{k}"


def row_from_speedups(mnk: str, speedups: dict, device: str) -> dict:
    """One CSV row from the speedup over each baseline (perf_func -> speedup).

    Each speedup is rounded to 4 places and each ``-max`` is the lower of its family's
    rounded pair, as ``scripts/run_suite.py:_row_from_lean`` builds its rows.  A missing
    baseline raises: a row never holds an empty or None column."""
    missing = [pf for pf in SPEEDUP_COLUMNS if speedups.get(pf) is None]
    if missing:
        raise ValueError(f"{mnk}: no speedup for {missing}")
    row = {"mnk": mnk}
    for pf, col in SPEEDUP_COLUMNS.items():
        row[col] = round(float(speedups[pf]), 4)
    for fam, tn, nn in _MAX_PAIRS:
        row[f"{fam}-max"] = round(min(row[tn], row[nn]), 4)
    row["device"] = device
    return {col: row[col] for col in CSV_COLUMNS}


def done_shapes(path: Path) -> set:
    """The mnk names already in the CSV (the suite resumes after them)."""
    if not Path(path).exists():
        return set()
    with Path(path).open(newline="") as f:
        return {r["mnk"] for r in csv.DictReader(f)}


def append_row(path: Path, row: dict) -> None:
    """Append one row, writing the header first into a new file; refuse a file whose
    header is not ``CSV_COLUMNS``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    new = not path.exists() or path.stat().st_size == 0
    if not new:
        with path.open(newline="") as f:
            header = next(csv.reader(f), None)
        if header != CSV_COLUMNS:
            raise ValueError(f"{path} has the columns {header}, not {CSV_COLUMNS}")
    with path.open("a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
        if new:
            w.writeheader()
        w.writerow(row)


def sidecar_record(mnk: str, acc: str, mode: str, results: dict, config: dict,
                   device: dict, target_qps=None) -> dict:
    """The sidecar line of one shape: each function's median, p99 and IQR (ms), the
    speedups, the dispatched config and the device record."""
    from tpul2_torch.harness.correctness import CANDIDATE
    first = next(iter(results.values()))
    funcs = {CANDIDATE: first[CANDIDATE]}
    funcs.update({pf: r[pf] for pf, r in results.items()})
    return {"mnk": mnk, "acc": acc, "mode": mode, "target_qps": target_qps,
            "funcs": {name: {key: s[key] for key in ("median_ms", "p50_ms", "p99_ms",
                                                     "iqr_ms", "iters")}
                      for name, s in funcs.items()},
            "speedups": {pf: r["speedup"] for pf, r in results.items()},
            "config": config, "device": device}


def append_sidecar(path: Path, record: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as f:
        f.write(json.dumps(record) + "\n")


def band(mnk: str) -> str:
    """The shape's band: 'square', 'thin-K', 'skinny' or 'other'.  The tuned library's
    wins concentrate in the thin-K and skinny streaming bands; squares are the vendor
    library's home ground."""
    m, n, k = (int(x) for x in mnk.split("x"))
    if m == n == k:
        return "square"
    if k <= 512 and max(m, n) >= 2048:
        return "thin-K"
    if (m <= 256 and min(n, k) >= 2048) or (n <= 256 and min(m, k) >= 2048):
        return "skinny"
    return "other"


def order_shapes(shapes, order: str = "lex") -> list:
    """``shapes`` in ``order``.

    'lex' is sorted order (itertools.product's, for a grid); 'cost' puts cheap shapes
    first (by m·n·k); 'stratified' merges the bands' cost-ascending lists in proportion,
    so that every prefix keeps the band mix of ``shapes`` and a run cut by the clock is
    not all one band."""
    if order not in ("lex", "cost", "stratified"):
        raise ValueError(f"order must be 'lex', 'cost' or 'stratified', got {order!r}")
    if order == "lex":
        return sorted(shapes)
    by_cost = sorted(shapes, key=lambda s: (s[0] * s[1] * s[2], s))
    if order == "cost":
        return by_cost
    buckets: dict = {}
    for s in by_cost:
        buckets.setdefault(band(mnk_name(*s)), []).append(s)
    merged = sorted((i / len(bl), i, b, s) for b, bl in sorted(buckets.items())
                    for i, s in enumerate(bl))
    return [s for _, _, _, s in merged]


def grid(dims, max_shapes=None, max_elems=None, order: str = "lex") -> list:
    """The (m, n, k) shapes of ``dims`` cubed, in ``order``: 'lex' is itertools.product's
    order, 'cost' and 'stratified' are ``order_shapes``'.  ``max_elems`` drops shapes whose
    largest operand holds more elements; ``max_shapes`` keeps the first ones."""
    shapes = list(itertools.product(dims, dims, dims))
    if max_elems:
        shapes = [s for s in shapes
                  if max(s[0] * s[2], s[2] * s[1], s[0] * s[1]) <= max_elems]
    shapes = order_shapes(shapes, order) if order != "lex" else shapes
    if max_shapes:
        shapes = shapes[:max_shapes]
    return shapes
