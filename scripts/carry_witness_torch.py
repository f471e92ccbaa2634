#!/usr/bin/env python3
"""The bf16 family's K carry on one card: how far the ring's result lies from the plain
version, and whether every element beyond ``ops.matmul.allowed_error`` is a rounding of
the running sum to the other bf16 neighbour rather than a fault.

    python scripts/carry_witness_torch.py [--seeds 24] [--json_out PATH]

For each case (normal inputs made on the card from the case's seed, f32 or bf16 out, no
epilogue) it runs the wrapper (ops.matmul.cuda_matmul / cuda_matmul_tn) and holds the
result against two references:
  plain   ops.matmul.matmul_reference: each bk interval's product in f32 (the library's
          order), the running sum rounded to bf16 after every interval;
  ring    chip_smoke._ring_order_reference: the same rounding points, each interval summed
          in the ring's own f32 order (64-deep stages, each exact and rounded to f32);
          ``ring16`` chains each stage's four k16 steps as wgmma does.
Cases: 33x785x769 on the 128x64 tile at bk 128 (7 intervals, the last one 1 deep; the
loads producer reads both operands in 'nk' and B in 'kn') over ``--seeds`` seeds and both
layouts, then a few seeds each of 200x300x1001 (64x128, bk 256), 256x384x1024 (128x64,
bk 256) and 17x200x328 (32x64, bk 96: the mid-stage rounding).  Per case it prints one
JSON object: the elements beyond allowed_error against plain (``beyond``), the ring
reference's own (``ring_beyond``), the kernel's elements that differ from ring and from
ring16 (``mism64``, ``mism16``), and ``bad_not_ring``, the elements beyond allowed_error
whose bits are not ring's (a fault).  For each element beyond, the running sum after
every interval in both orders.  Then the totals and the card's nvidia-smi name and power
limit.  Exits 1 if ``bad_not_ring`` is not 0.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _carries(torch, a, b, bk, step, order):
    """The running sum after every interval (f32 tensors), in the plain or ring order."""
    k = a.shape[-1]
    out, carry, part = [], 0.0, 0.0
    if order == "plain":
        for ks in range(0, k, bk):
            carry = (carry + a[:, ks:ks + bk].float() @ b[ks:ks + bk, :].float()
                     ).bfloat16().float()
            out.append(carry)
        return out
    for ks in range(0, k, step):
        ke = min(ks + step, k)
        part = part + (a[:, ks:ke].double() @ b[ks:ke, :].double()).float()
        if ke % bk == 0 or ke == k:
            carry, part = (carry + part).bfloat16().float(), 0.0
            out.append(carry)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--json_out", default=None)
    args = ap.parse_args(argv)

    import torch
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from tpul2_torch.config import KernelConfig
    from tpul2_torch.ops import baselines
    from tpul2_torch.ops import matmul as mm
    from tpul2_torch.utils.platform import device_info, require_hopper

    require_hopper()
    baselines.pin_precision()  # full-f32 library GEMMs in the plain version
    cases = [(33, 785, 769, 128, 64, 128, layout, (torch.bfloat16, torch.float32)[s % 2], s)
             for s in range(args.seeds) for layout in ("nk", "kn")]
    for s in range(4):
        for layout in ("nk", "kn"):
            cases += [(200, 300, 1001, 64, 128, 256, layout, torch.float32, 100 + s),
                      (256, 384, 1024, 128, 64, 256, layout, torch.float32, 200 + s),
                      (17, 200, 328, 32, 64, 96, layout, torch.float32, 300 + s)]
    keys = ("beyond", "ring_beyond", "mism64", "mism16", "bad_not_ring")
    tot = {"cases": 0, "elements": 0, "cases_beyond": 0, **{key: 0 for key in keys}}
    rows = []
    for m, n, k, bm, bn, bk, layout, out, seed in cases:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        a = cs._inputs(torch, gen, (m, k), False)
        rhs = cs._inputs(torch, gen, (n, k) if layout == "nk" else (k, n), False)
        cfg = KernelConfig(bm=bm, bn=bn, bk=bk, acc_dtype="bfloat16", rhs_layout=layout)
        wrapper = mm.cuda_matmul_tn if layout == "nk" else mm.cuda_matmul
        got = wrapper(a, rhs, cfg, out_dtype=out).float()
        want = mm.matmul_reference(a, rhs, bk, "bfloat16", layout, out_dtype=out).float()
        tol = mm.allowed_error(a, rhs, bk, "bfloat16", layout, out)
        ring = cs._ring_order_reference(torch, mm, a, rhs, bk, layout, out_dtype=out).float()
        ring16 = cs._ring_order_reference(torch, mm, a, rhs, bk, layout, out_dtype=out,
                                          chain16=True).float()
        beyond = (got - want).abs() > tol
        row = {"case": f"{m}x{n}x{k} {bm}x{bn} bk={bk} {layout} out={str(out)[6:]} "
                       f"seed {seed}",
               "route": mm.launch_route(cfg, a, rhs, m, n, k),
               "beyond": int(beyond.sum()), "max_diff": float((got - want).abs().max()),
               "ring_beyond": int(((ring - want).abs() > tol).sum()),
               "mism64": int((got != ring).sum()), "mism16": int((got != ring16).sum()),
               "max_diff_vs_ring": float((got - ring).abs().max()),
               "bad_not_ring": int((beyond & (got != ring)).sum())}
        if row["beyond"]:
            b = rhs.t() if layout == "nk" else rhs
            step = mm.WGMMA_KSTAGE if bk % mm.WGMMA_KSTAGE == 0 else mm.WGMMA_KSTAGE // 2
            pc = _carries(torch, a, b, bk, step, "plain")
            rc = _carries(torch, a, b, bk, step, "ring")
            row["elements"] = [{"at": [i, j], "kernel": got[i, j].item(),
                                "plain": want[i, j].item(), "ring": ring[i, j].item(),
                                "tol": tol[i, j].item(),
                                "plain_sums": [c[i, j].item() for c in pc],
                                "ring_sums": [c[i, j].item() for c in rc]}
                               for i, j in beyond.nonzero().tolist()[:4]]
        print(json.dumps(row), flush=True)
        rows.append(row)
        tot["cases"] += 1
        tot["elements"] += got.numel()
        tot["cases_beyond"] += row["beyond"] > 0
        for key in keys:
            tot[key] += row[key]
    info = device_info()
    print("TOTAL " + json.dumps(tot))
    print(info["nvidia_smi"])
    if args.json_out:
        Path(args.json_out).write_text(json.dumps({"total": tot, "cases": rows,
                                                   "device": info}, indent=1))
    return 1 if tot["bad_not_ring"] else 0


if __name__ == "__main__":
    sys.exit(main())
