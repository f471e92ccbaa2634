#!/usr/bin/env python3
"""A stage timeline of the ring's consumer on one card: where a CTA's time goes, unit by unit.

    python scripts/ring_timeline_torch.py [--root DIR ...] [--out_dir runs/timeline]
                                          [--json_out PATH]

For each tree under ``--root`` (default: this checkout; repeatable, so that two trees
compare in one process), builds its ``tpul2_torch/csrc/tl2_wgmma.cu`` apart with
``TL2_RING_TIMELINE`` defined (nvcc, beside stubs for the other instance files) into a
library under ``--out_dir``, and launches its 128 x 128 TMA instance through
``tl2_wgmma_bf16out`` at the ring rows of PERF.md: 4096^3 at bk 1024 and 16384^2 x 64 at bk
64 (f32 family, 'kn', bf16 output, normal inputs).  The package's own library is not
touched.

With the macro defined, the first consumer thread of each warpgroup of the first 264 CTAs
keeps ``clock64`` stamps (in shared memory, copied out after the epilogue, so that they
cost a few instructions; ``tl2_wgmma.cuh``'s stage timeline) at five points of each unit (a
64-deep stage): before its wait for the stage's full barrier (s0), after it (s1), after the
unit's wgmmas are committed (s2), after the wait that completes them (s3), after the
product is folded into the sum (s4); and before and after the epilogue.  Per unit it
reports the mean ns of:
  gap     s0 - the previous unit's s4   between units
  data    s1 - s0   waiting for the stage to land (TMA)
  issue   s2 - s1   issuing the four k16 wgmmas
  wait    s3 - s2   waiting for the unit's wgmmas
  fold    s4 - s3   releasing the stage and adding the product into the sum
and per CTA the epilogue's ns and the consumer's whole span.  Cycles become ns by each
CTA's %globaltimer span over its clock64 span.  The kernel's ms per launch (CUDA events
over 20 launches, stamps on) is printed beside.  One JSON object per (tree, row), then the
card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
#: (m, n, k, bk) of each row: the 128 x 128 tile, f32 family.
ROWS = [(4096, 4096, 4096, 1024), (16384, 16384, 64, 64)]
TILE = 128
CTAS = 264          # CTAs stamped (tl2_wgmma.cuh's TIMELINE_CTAS)
SLOTS = 4 + 5 * 64  # stamps per consumer warpgroup (TIMELINE_SLOTS)

_STUBS = r"""
// The other instance files' launchers, absent from this build: refused.
#include "tl2_wgmma.cuh"
namespace tl2wg {
TL2_WGMMA_LAUNCHER(launch_wide_lsu) { return cudaErrorInvalidValue; }
TL2_WGMMA_LAUNCHER(launch_n32) { return cudaErrorInvalidValue; }
TL2_WGMMA_LAUNCHER(launch_swap) { return cudaErrorInvalidValue; }
cudaError_t launch_wide_block(const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,
                              const WgParams&, int, int, int, cudaStream_t) {
  return cudaErrorInvalidValue;
}
}  // namespace tl2wg
"""


def build(root: Path, out: Path, nvcc: str) -> Path:
    """root's ring with the stamps in, and stubs for the rest: out/libtl2_timeline.so."""
    csrc, lib = root / "tpul2_torch" / "csrc", out / "libtl2_timeline.so"
    stubs = out / "tl2_timeline_stubs.cu"
    stubs.write_text(_STUBS)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-DTL2_RING_TIMELINE", "-I", str(csrc)]
    objs = [out / "tl2_wgmma.o", out / "tl2_timeline_stubs.o"]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for obj, src in zip(objs, (csrc / "tl2_wgmma.cu", stubs))]
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed:\n{log}")
    subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)], check=True)
    return lib


def summarize(stamps, units: int) -> dict:
    """Mean ns per unit of each segment, the epilogue's and the span's, over the stamped
    consumer warpgroups."""
    seg = {"gap": [], "data": [], "issue": [], "wait": [], "fold": [], "epilogue": [],
           "span": []}
    for row in stamps:
        g0, g1 = int(row[2]), int(row[3])
        s = [[int(row[4 + 5 * u + j]) for j in range(5)] for u in range(units)]
        c0, c1 = s[0][0], int(row[1])
        if not (g1 > g0 and c1 > c0):
            continue
        ns = (g1 - g0) / (c1 - c0)  # this CTA's ns per cycle
        for u in range(units):
            if u:
                seg["gap"].append((s[u][0] - s[u - 1][4]) * ns)
            seg["data"].append((s[u][1] - s[u][0]) * ns)
            seg["issue"].append((s[u][2] - s[u][1]) * ns)
            seg["wait"].append((s[u][3] - s[u][2]) * ns)
            seg["fold"].append((s[u][4] - s[u][3]) * ns)
        seg["epilogue"].append((int(row[1]) - int(row[0])) * ns)
        seg["span"].append((g1 - g0))
    return {key: statistics.mean(v) if v else None for key, v in seg.items()} | {
        "samples": len(seg["span"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", action="append", default=[], help="tree to measure (repeatable)")
    ap.add_argument("--out_dir", default=str(REPO / "runs" / "timeline"))
    ap.add_argument("--json_out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("ring_timeline_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from tpul2_torch.utils.platform import device_info, nvcc_path

    nvcc = nvcc_path()
    if nvcc is None:
        print("ring_timeline_torch: nvcc not found", file=sys.stderr)
        return 1
    rows = []
    for i, root in enumerate(args.root or [str(REPO)]):
        root = Path(root).resolve()
        out = Path(args.out_dir) / f"tree{i}"
        out.mkdir(parents=True, exist_ok=True)
        lib = ctypes.CDLL(str(build(root, out, nvcc)))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.tl2_wgmma_bf16out
        fn.argtypes = [P, P, P, P, I, I, I, I, LL, LL, LL, I, I, I, I, I, I, I, I, I, P]
        fn.restype = I
        lib.tl2_timeline_set.argtypes = [P]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        for m, n, k, bk in ROWS:
            a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
            c = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            stamps = torch.zeros((CTAS * 2, SLOTS), dtype=torch.int64, device="cuda")
            call = (a.data_ptr(), b.data_ptr(), None, c.data_ptr(), 1, m, n, k, m * k, k * n,
                    m * n, TILE, TILE, bk, 0, 0, 0, 0, 1, 1,
                    torch.cuda.current_stream().cuda_stream)
            if lib.tl2_timeline_set(stamps.data_ptr()):
                raise SystemExit("cudaMemcpyToSymbol failed")
            for _ in range(3):
                if fn(*call):
                    raise SystemExit(f"launch refused at {m}x{n}x{k}")
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(20):
                fn(*call)
            end.record()
            end.synchronize()
            stamps.zero_()
            fn(*call)
            torch.cuda.synchronize()
            row = {"root": str(root), "mnk": [m, n, k], "bk": bk,
                   "tile": f"{TILE}x{TILE}", "ms": start.elapsed_time(end) / 20,
                   "ns_per_unit": summarize(stamps.cpu().tolist(), -(-k // 64))}
            print(json.dumps(row), flush=True)
            rows.append(row)
            lib.tl2_timeline_set(None)
            del a, b, c, stamps
    info = device_info()
    print(info["nvidia_smi"])
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps({"device": info, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
