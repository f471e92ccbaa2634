"""Result summary: markdown table and the worst-case '-max' rows.

Counterpart of ``tpul2/harness/summarize.py`` (reference ``summarize_result.py``): read the
``benchmark_result_*.json`` files of a run directory, map them to display names, and for
each baseline family with an nn/tn pair add a ``-max`` row holding the layout with the
LOWER candidate speedup (the worst case for the candidate).  A server run's table also
gives p50 and p99 of the per-call times, the serving metric, and its ``target_qps``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from tpul2_torch.harness.correctness import CANDIDATE

DISPLAY_NAMES = {
    "torch_matmul": "torch.matmul",
    "cublas_nn": "cuBLAS-nn",
    "cublas_tn": "cuBLAS-tn",
    "cublaslt_nn": "cuBLASLt-nn",
    "cublaslt_tn": "cuBLASLt-tn",
    "cublaslt_autotuned_nn": "cuBLASLt-auto-tuning-nn",
    "cublaslt_autotuned_tn": "cuBLASLt-auto-tuning-tn",
}

#: Baseline families with nn/tn layout pairs, each of which gets a worst-case row.
_MAX_FAMILIES = ["cublas", "cublaslt", "cublaslt_autotuned"]

_ROW_ORDER = [
    "torch.matmul",
    "cuBLAS-tn", "cuBLAS-nn", "cuBLAS-max",
    "cuBLASLt-tn", "cuBLASLt-nn", "cuBLASLt-max",
    "cuBLASLt-auto-tuning-tn", "cuBLASLt-auto-tuning-nn", "cuBLASLt-auto-tuning-max",
]


def load_results(base_dir) -> dict:
    out = {}
    for f in sorted(Path(base_dir).glob("benchmark_result_*.json")):
        r = json.loads(f.read_text())
        out[r["perf_func"]] = r
    return out


def _with_max_rows(by_disp: dict, worse) -> dict:
    for fam in _MAX_FAMILIES:
        tn = by_disp.get(DISPLAY_NAMES[f"{fam}_tn"])
        nn = by_disp.get(DISPLAY_NAMES[f"{fam}_nn"])
        if tn is not None and nn is not None:
            fam_disp = DISPLAY_NAMES[f"{fam}_tn"].rsplit("-", 1)[0]
            by_disp[f"{fam_disp}-max"] = worse(tn, nn)
    return by_disp


def summarize_results(base_dir, write_path: Optional[str] = None) -> str:
    """Build the summary table; return (and optionally write) the markdown."""
    results = load_results(base_dir)
    rows = {}
    for func, r in results.items():
        rows[DISPLAY_NAMES.get(func, func)] = {
            "baseline_tflops": r[func]["tflops_mean"],
            "candidate_tflops": r[CANDIDATE]["tflops_mean"],
            "speedup": r["speedup"],
            "baseline_p": (r[func].get("p50_ms"), r[func].get("p99_ms")),
            "candidate_p": (r[CANDIDATE].get("p50_ms"), r[CANDIDATE].get("p99_ms")),
        }
    rows = _with_max_rows(rows, lambda tn, nn: dict(tn if tn["speedup"] <= nn["speedup"]
                                                    else nn))
    header = next(iter(results.values()), None)
    server = header is not None and header["mode"] == "server"
    lines = []
    if header:
        m, n, k = header["mnk"]
        qps = f" · target_qps={header['target_qps']}" if server else ""
        lines.append(f"### {header['mode']} · M={m} N={n} K={k} · acc={header['acc']} · "
                     f"{header['in_dtype']} · {header['device']}{qps}")
        lines.append("")
    if server:
        lines.append(f"| Baseline | Baseline TFLOPS | {CANDIDATE} TFLOPS | Speedup | "
                     f"Baseline p50 / p99 ms | {CANDIDATE} p50 / p99 ms |")
        lines.append("|---|---|---|---|---|---|")
    else:
        lines.append(f"| Baseline | Baseline TFLOPS | {CANDIDATE} TFLOPS | Speedup |")
        lines.append("|---|---|---|---|")
    ordered = [r for r in _ROW_ORDER if r in rows] + [r for r in rows if r not in _ROW_ORDER]
    for name in ordered:
        v = rows[name]
        line = (f"| {name} | {v['baseline_tflops']:.3f} | "
                f"{v['candidate_tflops']:.3f} | {v['speedup']:.4f}x |")
        if server:
            line += (f" {v['baseline_p'][0]:.5f} / {v['baseline_p'][1]:.5f} | "
                     f"{v['candidate_p'][0]:.5f} / {v['candidate_p'][1]:.5f} |")
        lines.append(line)
    md = "\n".join(lines)
    if write_path:
        Path(write_path).write_text(md + "\n")
    return md


def speedup_row(base_dir, mnk) -> dict:
    """One CSV row of per-shape speedups: 'mnk, torch.matmul, cuBLAS-{tn,nn,max}, ...'."""
    results = load_results(base_dir)
    by_disp = _with_max_rows({DISPLAY_NAMES.get(f, f): r["speedup"]
                              for f, r in results.items()}, min)
    row = {"mnk": "x".join(map(str, mnk))}
    for name in _ROW_ORDER:
        if name in by_disp:
            row[name] = by_disp[name]
    return row
