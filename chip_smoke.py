#!/usr/bin/env python3
"""Chip smoke test of tpul2_torch on one H100: build, check and drive the main path.

Run from the repository root, on a machine with one Hopper card:

    python3 chip_smoke.py [--json_out PATH]

Phases (each prints one line; any failure raises and the exit code is non-zero):
  0  require an sm_90 card; print the environment record and nvidia-smi's name/power line
  1  build csrc/*.cu for sm_90a (nvcc, one process per source, at first use), print the
     build time and ptxas report, and each ring instance's (tl2_wgmma_kernel: tile, layout,
     family, producer) registers and spills, failing where any ring instance spills
     (record["ring_ptxas"]); the shared-memory models of config.py must equal the
     ring's own counts for every tile at its carry depth (config.carry_stages against
     tl2_wgmma_carry_stages) and at every staged depth, and validate must refuse exactly
     what exceeds 227 KB; tl2_wgmma_route must agree with ops.matmul.launch_route (1
     'wgmma', 2 'wgmma_lsu') and launch_store (+ 8 for the TMA store) over a grid of shapes
     (M and N of 1, 8, 17, 31, 32 among them), all nine tiles and narrower blocks ('kn'
     column blocks off 16 bytes among them), bk (96 and 160, single intervals included),
     layouts and the alignments of the operands and the output, and tl2_staged_route with
     ops.pipelined.staged_route and launch_store over shapes, tiles, depths, layouts,
     alignments and the output each launch writes; the wide route's models
     (config.wide_streamed, wide_stages and wide_smem_bytes in both modes against
     tl2_wgmma_wide_streamed, _stages and _smem_bytes, validate taking every block) and
     its route (3 'wgmma_wide', 4 'wgmma_wide_lsu', launch_route against tl2_wgmma_route)
     over wide blocks up to 16384 rows, bk, layouts and the alignments of A, the RHS and
     the output.  The mma.sync bodies' C entries
     (tl2_matmul_*out, tl2_staged) are wrapped to count every call made through the
     library: the package makes none (the "mma_sync" count of every path must be 0), and
     this script launches them only through the unwrapped functions
  native  the native tuning cache (tpul2_torch/native, standalone: dispatch does not read
     it): its g++ build time; the committed DB's 40 entries put into the cache, saved to a
     file and loaded back must answer every exact key as the JSON does; then the host
     microseconds of one exact-key lookup in the cache, in the JSON DB (TuneDB.get) and of
     a resolve_config memo hit, and the ms of loading the cache's file against the JSON.
     No kernel launches
  2  kernel vs plain torch version on the card over the grid
     {f32, bf16 acc} x {kn, nk} x {gk == 1, gk > 1} x {aligned, unaligned}
     x {no epilogue, bias + gelu|silu|tanh}, plus batched (B = 3), at the main-path
     shapes, and with long K intervals (bk = K = 8192, bk = 4096); the 32-edge tiles over
     {f32, bf16 acc} x {kn, nk} x {gk == 1, gk > 1, bk % 64 == 32} x {bm 32, bn 32, both}
     x {TMA, loads on A, loads on B} x {plain, bias + act} at M, N of 1..32, plus batched
     (B = 3), each required to take its producer, its tile's counter and (bf16 family,
     bk 96) the mid-stage rounding; the loads producer launched directly on aligned
     operands (vec_a / vec_b = 0) on every tile, both layouts and families, which must
     give the TMA producer's bits; then the wgmma route
     over {K carry (bk 128), one interval (bk >= K)} x {f32, bf16 acc} x {kn, nk}
     x {64, 128}^2 tiles x {aligned, M/N/K edges with K % 64 != 0} x {plain, bias + act},
     batched (B = 3) with M % BM != 0 for both, 1000^3 at one interval over families,
     layouts and epilogues, and long intervals (4096^3 at bk 2048, 128x8192x8192 at
     bk 4096), each case required to take the wgmma route and the body its gk names:
     0/1 inputs must agree exactly (the epilogue cases then use bias + relu, since no
     library's tanh is correctly rounded), normal inputs within ops.matmul.allowed_error
     (which holds a single interval to the f32 terms in both families), where a bf16
     carry's element beyond it must carry the bits of the ring-order reference (the same
     rounding points, the kernel's f32 order: one interval rounded to the other bf16
     neighbour, the gap grown on later intervals' grids; 33x785x769 at bk 128 over 7
     intervals, both layouts, is in the grid for it, and 'kn' from seed 9, where the
     plain version's order lies beyond); the bf16
     family's single interval with f32 output must also differ from its own bf16
     rounding; and the max |error| against an f64 product at 4096^3 of both multi-K
     bodies and of cuBLAS's f32 product
  2b the staged kernel vs its plain version (with the launch's split count) on the ring:
     every tile x depth {2, 3, 4, 6, 8} that fits, at a shape of few tiles (split K) and
     of many (one split), the 32-edge tiles included, families, layouts and out dtypes
     spread over them; the depth clamp (gk < depth), gk == 1 (which must not launch it),
     a K tail (K % 64 != 0) with and without a split, an A base 2 bytes off 16 (the loads
     producer), and the tuning shapes' and 32x14336x4096's staged candidates; each case
     must take the ring (and split where its shape says): 0/1 inputs exact, normal inputs
     within allowed_error(..., bk=K, acc_dtype='float32'), a split case run twice on the
     same inputs bit-identical; then the max |error| against an f64 product at
     64x8192x8192 of the ring, a split of it (8 splits, launched directly), the 32x64
     ring, tl2_staged.cu's mma.sync body on it (launched directly) and one K interval
  3  the slice: scripts/eval_one_shape_torch.py's main() for the bring-up shapes and the
     few-CTA streaming shapes (gate with guard bands -> offline bench -> summary); every
     gate must pass; then the entry points (dispatch.matmul, dispatch.batched_matmul) at
     shapes with K % 8 != 0, which TMA cannot read, with one K interval and with several,
     at decode shapes (the swapped and width-32 tiles, 2-D and batched), with a bf16
     config whose bk is 96 (a rounding point mid-stage), at 'kn' blocks whose columns start
     off 16 bytes (bn 100 and 300 at N = 600, ring and wide: the loads producer reads B),
     dispatch.matmul with a wide block
     (256x1024, one interval, 'kn' and 'nk', bias + relu, M and N off the block), with
     the other wide variants (the bf16 family's carry with a resident and a streamed A, a
     4096-row block, batched at one interval and with a carry, the loads producer at
     K % 8 != 0 and with A 2 bytes off 16, 2-D and batched), with the JAX space's edges (a
     ring block narrower than its tile, 2-D and batched, the swapped wide walk, narrow
     columns, an unaligned cover, bn above 16384) and with staged configs (a 32-edge tile
     and a ring tile whose few tiles split K, an A base 2 bytes off 16, a staged wide
     block): exact on 0/1 inputs
  4  the launch counters, zeroed just before phase 3, must show that each body ran with
     both producers, single-K and multi-K, 2-D and batched, the wide route with both
     producers, single-K and multi-K, 2-D and batched, a streamed A and a block above
     2048 rows, the width-32, swapped and mid-stage launches, the JAX space's narrow and
     unaligned edges, both stores of C (TMA and predicated; every counter of
     ops.COUNTERS), and the staged ring with both
     producers, a split, a 32-edge tile and a wide block; and no mma.sync launch: the
     bring-up shapes and the gate's batched variants
     take TMA (64x8192x8192 at the heuristic's 64x64 tile included), the K % 8 != 0
     shapes the loads producer
  tune  `python -m tpul2_torch.autotune` (its main()) for each tuning shape (64x8192x8192,
     64x64x12288) f32 into runs/chip_smoke/tunedb_h100.json, with few candidates and
     rounds, ranked by device time (GraphTimer): each candidate's device and end-to-end
     time per call is printed; every candidate must launch and capture, at least two
     staged candidates must be timed, every staged candidate must be a ring tile and
     launch on the ring (no mma.sync launch), 64x64x12288's must split K, the winner must be
     torch_matmul or beat it by more than 10%, torch_matmul and cublas_nn (one library
     call) must time within 10% of each other over 10 rounds in turns, and the entry must
     be on disk with timing_rev 2
  tuned dispatch  a DB holding each tuning shape's fastest staged candidate for both
     families (runs/chip_smoke/tunedb_staged.json, via TPUL2_TORCH_TUNEDB), then
     eval_one_shape_torch's main() for both: every gate must pass with 0 guard hits, and
     the staged ring (with a split at 64x64x12288) must launch on this path
  5  per-kernel times on the card against the plain version and torch.matmul, with the
     bound of each (the larger of bytes over 3.35 TB/s and FLOPs over 989 TFLOP/s): the
     multi-K ring at 4096^3 (and 2 x 4096^3) against tl2_matmul.cu's mma.sync body on the
     same 128x128 tile (launched directly), timed in turns; the single-K ring against it
     alone (a CUDA graph of direct launches, so no host time enters; torch.matmul the
     same way) at 8192x128x64 (and 2 x), and at 1000^3 in both families; the staged ring
     alone at 64x8192x8192 on the dispatched tile against tl2_staged.cu's 32x64 at depth
     4 (launched directly), in turns, and at every depth (64x64 and 32x64 on the ring,
     32x64 on tl2_staged.cu); for each few-CTA shape, alone and through the entry
     point in turns, the heuristic config (both families), the fastest of the tuner's
     staged candidates there (split K) and torch.matmul, beside the bound; the split
     launch and the reduction alone at 64x64x12288; the heuristic's 64x64 wgmma tile
     against the 32x64 ring tile and the 64x128 one at 64x8192x8192, through the wrapper
     in turns and alone; and for each bring-up shape the entry point's time back to back
     and its host time per call.  The mma.sync bodies' times go to the reference line
     ({"reference_kernels": ...}), not the kernel line: they are on no path
  decode  the small-batch serving regime, each shape in turns alone (CUDA graphs of direct
     launches) and through the entry point (back to back): the ring on the heuristic's
     config, tl2_matmul.cu's mma.sync body on the same config (launched directly), the
     64-row (or 64-wide) ring tile over zero rows, and torch.matmul / torch.bmm, beside
     the bound: 1x4096x4096 and 16x4096x4096 (f32 and bf16 acc), 8x4096x14336, 32 heads
     x (16x128)@(128x4096) (bf16 and f32 out), 512x50257x768 'kn' (GPT-2 logits, N odd:
     the loads producer; bf16 and f32 out) and 14336x32x4096 'nk' (W @ X^T, width 32);
     then at 32x14336x4096 the heuristic's carry and the fastest staged 32x64 candidate
     on the ring against tl2_staged.cu on the same config; and the flagship block's
     forward at seq 16 (d_model 1024, d_ff 4096, 8 heads) through the committed DB: 8
     requests (p50, p99), launches per route with no mma.sync launch, the output held
     against a CPU copy (plain versions, rtol = atol = 0.05)
  lt-autotune  the cuBLASLt auto-tuning baseline's search (csrc/tl2_lt_autotune.cu) at
     4096^3 and 64x8192x8192 per layout: the algos kept and skipped, the winner, its time
     alone beside torch.matmul's; exact on 0/1 inputs against torch.mm, the winner and
     every algo kept
  sentinel  the dispatch sentinel's f32 output and bias + gelu at 4096^3, the old path (f32
     copies, an f32 GEMM) against the new one (one bf16-in, f32-out library GEMM), timed
     in turns; exact on 0/1 inputs, the old against the new
  server slice  eval_one_shape_torch's main() with --mode server --target_qps 100 at two
     shapes in both families, through the heuristic (an empty DB): every gate must pass,
     each result JSON must carry p50/p99 and target_qps, and the launch counters (zeroed
     just before) must show the wgmma ring ran
  committed-DB slice  scripts/run_suite_torch.py's main() over a few DEFAULT_SHAPES
     through tpul2_torch/data/tunedb_h100.json (both families, offline): the CSV rows are
     printed, with how many of the 20 shapes resolve to the sentinel in each family and
     mode, and how many stored kernel configs the card refuses (resolved to the sentinel)
  campaign  the integrity and campaign layer: harness.defense.run_all_defenses on the
     honest candidate, 3 runs each, in both families at 4096^3 and 512x4096x1024 through
     the heuristic and at 64x8192x8192 through the committed DB, once at 4096^3 with a
     side stream as the current stream, and the stream check's honest spread at four
     host-bound suite shapes, all passing; five cheats flagged (a product at 8192^3 on a
     side stream returned with no wait, a helper thread left running, a Tensor subclass
     and a meta output, an fp16 output, a patched torch.cuda.Event.elapsed_time), with
     each run's event and sync ms, ratio and floor; each `python -m tpul2_torch.harness`
     subcommand at 1000^3 (exit 0, JSON out), the first as a subprocess, the other five
     through the CLI's main() in this process; the lean engine
     (harness.campaign) over the stratified grid's first 24 shapes plus 4096^3 and
     16384^3 through the committed DB, both families offline, the first 4 at 100 qps,
     with the seconds per shape, and at 4096^3 through the heuristic the median of 3
     lean speedups against torch.matmul within 10% of the median of 3 _run_mode ones,
     read in turns (ABBA), with each engine's spread; the heal at 512x4096x1024 on a DB
     copy with no entry for it (the row before launches a wgmma body and loses, the heal
     stores a screened vendor config, the re-measured row launches no kernel and is
     faster, the repair journal holds the shape once); and demote_uncompilable_entries'
     launch probe of a stored staged config, which must keep it
  grid tune  the grid-scale tools on a copy of the committed DB
     (runs/chip_smoke/gridtune_db.json): scripts/run_suite_torch.py tune (its main()) in
     both families at 8 candidates, 3 + 5 rounds and 4 finalists over the stratified
     grid's first four shapes (one per band), 2048^3 and 1024x8192x2048, first over the
     first three, then over all six: the second run must tune only the new ones, with the
     ring launched and no mma.sync body; scripts/seed_tail_entries_torch.py, which must
     leave resolve_config unchanged at every grid shape of both families and modes (its
     counts by source and kind, its seconds); scripts/correctness_campaign_torch.py
     --no_demote over the copy's kernel entries in stratified order for 60 s (no failure,
     no guard hit; the entries checked, those left for the budget, the seconds per
     entry), then once more, which must gate none that the first gated (none at all
     where the first was not cut); and the six shapes through the lean engine
     (harness.campaign, no heal) through the committed DB and through the copy: per
     family each row's config source, whether a kernel or the sentinel ran, and the
     geomean against torch.matmul
  thin-K  the thin-K band and the wide blocks (tl2_wgmma_wide.cu): (a) the write-allocate
     factor, the median GB/s of a read-only pass (sum) over that of a write-only pass
     (fill) over 2 GiB, three turns of 10 passes each between CUDA events; (b) the wide
     route against its plain version, 0/1 inputs exact and normal inputs within
     allowed_error, at 16384x16384x64 'kn' bf16 out, 8192x16384x512 'nk' bias + gelu,
     4096x16384x128 f32 out (a 512-row block's walk), 1024x2048x256 'nk' (1024 rows),
     1000x1000x200 and 200x264x128 (edges the output's tensor map clips), each launch
     counted on the wide route; (c) alone (CUDA graphs of direct launches) in turns at
     16384x16384x64 and 8192x8192x256: the wide block, the 128x128 single-K ring, then
     torch.matmul, the plain version and the bound; (d) scripts/thin_k_report_torch.py on
     the committed no-heal grid in both families (300 thin-K rows each, none missing):
     rows, at the wall, winning, targets; (e) scripts/retune_thin_k_torch.py over the
     report's 6 largest f32 targets (by M·N, then the thinnest K) into a copy of the
     committed DB (runs/chip_smoke/thin_k/retune_db.json) at 12 candidates, 2 + 4 rounds,
     3 finalists and a 40 s budget (each shape's winner, its fastest kernel candidate and
     that candidate's time over torch_matmul's), then the lean engine (harness.campaign)
     over the retuned shapes through the committed DB and the copy: each shape's speedup
     against torch.matmul and config (wide, ring or sentinel) before and after; the
     counters (zeroed before the retune) must show the wide route launched
  wide  the JAX space's wide blocks everywhere (tl2_wgmma_wide.cu and its seven sibling
     instance files): (a) each variant against its plain version in both output dtypes,
     0/1 inputs exact and normal inputs within allowed_error (a bf16 carry's element
     beyond it on the ring-order reference's bits): the K carry with a resident A
     (1024x2048x512, both families) and a streamed A (12288^3 at the JAX entry's 512x2048
     bk 4096, f32; 2048^3 bf16 'nk'), one interval with a streamed A (1024^3, both
     families), rounding points mid-stage (bk 96), a 16384-row block, batched at gk 1
     and gk 2 (4x1024x2048x512), and the loads producer and predicated stores (K = 60,
     N = 4095, A 2 bytes off 16 with a streamed carry, out= off 16 bytes, batched at
     K = 1001), each launched once on its route's counter; the loads producer forced on
     aligned operands gives TMA's bits; (b) the main path: a DB copy of the JAX DB's 214
     kernel entries, all of which validate (from_jax; the two bm = 16 ones on the swapped
     wide walk) through scripts/correctness_campaign_torch.py --no_demote (all pass, no
     guard hit), then dispatch.matmul at each entry's shape through the copy (every entry
     resolves to its own config, every wide one launches the wide route: no sentinel),
     dispatch.batched_matmul at four entries and dispatch.matmul with A 2 bytes off 16
     (the loads producer) at three, exact against the plain version; (c) each new row
     alone (CUDA graphs of direct launches, two turns) beside torch.matmul or torch.bmm
     alone, the plain version and the bound
  jax space  every block edge of the JAX space (the ring's blocks narrower than their tile,
     the swapped wide walk of bm <= 32, narrow columns beside a wide bm, unaligned covers,
     bn above 16384, staged wide blocks): (a) at 1x4096x4096, 8x4096x4096, 16x11008x4096,
     32x4096x14336, 48x4096x4096, 8192x1x4096, 1024x64x64, 12288x64x64, 1000^3,
     4096x24576x64 and 64x32000x4096, every distinct (bm, bn, bk, depth, rhs) of the port's
     uncapped candidate space (which holds the JAX tuner's) in both families, one launch
     each on 0/1 inputs held to the f32 truth by the gate's comparison and one on normal
     inputs within allowed_error of its plain version (one per shape, family, bk and
     staging; a bf16 carry's element beyond it on the ring-order bits); (b) the main path:
     a DB copy of tests/data/jax_decode_db.json (the JAX heuristic's configs at the decode
     shapes of Llama-3-8B's projections, 16x11008x4096 and the flagship block's GEMMs at
     seq 16), the JAX DB's two bm = 16 entries and one block per remaining variant (bn 64
     beside bm 256, the 1000^3 cover, bn 24576, the staged 64x32000 pick), each through
     dispatch.matmul / dispatch.batched_matmul on its own config and exact against its
     plain version, then the block's forward at seq 16 through the copy against a CPU copy
     (rtol = atol = 0.05); every new variant's counter must be > 0; (c) each new variant
     alone (CUDA graphs of direct launches, two turns) beside torch.matmul / torch.bmm, the
     plain version and the bound
  model  the flagship block (tpul2_torch.models.entry: d_model 1024, d_ff 4096, seq 512,
     8 heads) through the committed DB: 8 forward requests one at a time (p50/p99), 5
     block_train_steps on a fixed seeded (x, y) whose loss must be finite and fall, 3 FFN
     train_steps (1024 x 4096, batch 512); the block's output, loss and grads held
     against the same block on a CPU copy (every GEMM on its plain version, the same
     configs) and against the vendor config on the card (output rtol = atol = 0.05, loss
     rtol 1e-3, each grad within 0.02 relative L2); the forward again through the
     heuristic (an empty DB); the counters (zeroed before each counted part) must show
     the 2-D wgmma single-K and multi-K bodies under the committed DB and the batched
     single-K wgmma body under the heuristic; then forward and train-step ms under the
     committed DB, the heuristic and the vendor config in turns, the model FLOPs' share
     of peak (harness.profiling's table), one profiled forward and train step (device
     busy time, idle share, top device ops) and a profiled train step through the
     heuristic and the vendor config, and profile_shape at FFN-1's shape with a trace;
     each kernel row's launches add the model path's
  parallel  tpul2_torch.parallel on a world of one rank over NCCL (one card; NCCL refuses two
     ranks on one device) and make_mesh(1): the five strategies (dp, tp, kshard,
     kshard_scatter, 2d) at 4096^3 and 64x8192x8192 in both families, through the
     committed DB and the heuristic, and at 64x8192x8192 with an explicit staged config
     (64x64 ring tile, depth 4): exact on 0/1 inputs (density 0.1) against the unsharded
     dispatch.matmul and the plain product; the counters (zeroed before each group of
     strategy calls) must show the wgmma carry and the staged ring; then
     make_sharded_train_step at full width (d_model 1024, d_ff 4096, batch 512, lr 1.0,
     heuristic) for 3 steps against train_step on the same inputs (loss rtol 1e-3, each
     weight's update within 0.1 relative L2), its loss falling and its counters showing the
     single-K and multi-K wgmma bodies, both steps' ms back to back in turns, and one
     profile_step of each (device busy ms, idle share, top device and host ops); each
     kernel row's launches add the parallel layer's
Phases 2 to 5 and the server slice measure the heuristic: they run with
TPUL2_TORCH_TUNEDB naming an empty file, so the committed DB does not steer them.
The last two lines are the per-kernel JSON record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import sys
import time
from pathlib import Path

#: Bring-up shapes (bench.py DEFAULT_SHAPES and its large-square probe) and families.
SLICE_SHAPES = [
    ((4096, 4096, 4096), "float32"),   # square headline, multi-K
    ((64, 8192, 8192), "float32"),     # skinny serving shape, long K loop
    ((8192, 128, 64), "float32"),      # thin-K: gk == 1
    ((1000, 1000, 1000), "float32"),   # unaligned: predicated edges
    ((1000, 1000, 1000), "bfloat16"),
]
GATE_BATCH = 2   # the gate's batched variant (harness.correctness.gate_kernel_variants)
GRID_BATCH = 3
#: (batch, m, n, k) with K % 8 != 0, whose rows TMA cannot read: the entry points send
#: them to the mma.sync bodies, with one K interval (bk 1024 >= K) and with two.
UNALIGNED_SHAPES = [(1, 200, 300, 1001), (1, 200, 300, 2001), (GATE_BATCH, 200, 300, 1001),
                    (GATE_BATCH, 200, 300, 2001)]
#: (batch, m, n, k, rhs layout) of phase 3's decode-size entry-point calls: single-request
#: and 16-token decode (the swapped tile), the transposed up-projection W @ X^T with 32
#: tokens (width 32), and decode attention: 32 heads' scores (batched, swapped) and the
#: flagship block's scores at seq 16 (batched, 32 x 32).
DECODE_ENTRY_SHAPES = [(1, 1, 4096, 4096, "kn"), (1, 16, 3072, 1024, "nk"),
                       (1, 14336, 32, 4096, "nk"), (32, 16, 4096, 128, "kn"),
                       (8, 16, 16, 128, "kn")]
#: Phase decode's shapes: (name, batch, m, n, k, rhs layout, acc, out dtype).
DECODE_SHAPES = [
    ("1x4096x4096", 1, 1, 4096, 4096, "kn", "float32", "bfloat16"),
    ("16x4096x4096", 1, 16, 4096, 4096, "kn", "float32", "bfloat16"),
    ("16x4096x4096/bf16acc", 1, 16, 4096, 4096, "kn", "bfloat16", "bfloat16"),
    ("8x4096x14336", 1, 8, 4096, 14336, "kn", "float32", "bfloat16"),
    ("32x(16x128)@(128x4096)", 32, 16, 4096, 128, "kn", "float32", "bfloat16"),
    ("32x(16x128)@(128x4096)/f32out", 32, 16, 4096, 128, "kn", "float32", "float32"),
    ("512x50257x768/kn", 1, 512, 50257, 768, "kn", "float32", "bfloat16"),
    ("512x50257x768/kn/f32out", 1, 512, 50257, 768, "kn", "float32", "float32"),
    ("14336x32x4096/nk", 1, 14336, 32, 4096, "nk", "float32", "bfloat16"),
]
#: Phase decode's staged shape: the Llama-3-8B FFN up-projection at 32-batch decode.
DECODE_STAGED_SHAPE = (32, 14336, 4096)
#: The tuning path's shape: the skinny serving shape, where the kStage axis competes.
TUNE_SHAPE = (64, 8192, 8192)
#: Streaming shapes of bench.py's DEFAULT_SHAPES whose heuristic grid has few CTAs (1, 1,
#: 2, 4 and 64 of 132 SMs): where the staged ring splits K.
FEW_CTA_SHAPES = [(64, 64, 12288), (64, 64, 4096), (128, 64, 4096), (64, 256, 8192),
                  (64, 4096, 4096)]
#: The shapes the tune phase tunes: the skinny one (no split) and a one-CTA one (48 splits).
TUNE_SHAPES = [TUNE_SHAPE, FEW_CTA_SHAPES[0]]
#: Published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, HBM rate.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)", flush=True)
        raise
    print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def _inputs(torch, gen, shape, zero_one: bool):
    if zero_one:
        return torch.randint(0, 2, shape, generator=gen, device="cuda").to(torch.bfloat16)
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _grid_cases():
    """(name, batch, m, n, k, cfg kwargs, activation, out dtype name) of phase 2."""
    tiles = [(bm, bn) for bm in (32, 64, 128) for bn in (32, 64, 128)]
    cases = []
    i = 0
    for acc in ("float32", "bfloat16"):
        for gk in ("gk1", "gkN"):
            for aligned in (True, False):
                if aligned:
                    m, n, k, bk = (256, 384, 256, 256) if gk == "gk1" else (256, 384, 1024, 256)
                else:  # odd K takes the scalar loads, N % 8 != 0 the scalar 'kn' loads
                    m, n, k, bk = (200, 300, 203, 224) if gk == "gk1" else (200, 300, 1001, 256)
                for layout in ("kn", "nk"):
                    for epilogue in (False, True):
                        act = ("gelu", "gelu", "silu", "tanh")[i % 4] if epilogue else None
                        bm, bn = tiles[i % len(tiles)]
                        cfg = dict(bm=bm, bn=bn, bk=bk, acc_dtype=acc, rhs_layout=layout,
                                   grid_order="nm" if i % 2 else "mn")
                        out = "float32" if i % 3 else "bfloat16"
                        cases.append((f"2d/{acc}/{layout}/{gk}/{'al' if aligned else 'un'}/"
                                      f"{act or 'plain'}", 1, m, n, k, cfg, act, out))
                        i += 1
                bm, bn = tiles[i % len(tiles)]
                cases.append((f"batched/{acc}/{gk}/{'al' if aligned else 'un'}", GRID_BATCH,
                              m, n, k, dict(bm=bm, bn=bn, bk=bk, acc_dtype=acc), None,
                              "float32"))
                i += 1
    return cases


def _wgmma_cases():
    """(name, batch, m, n, k, cfg kwargs, activation, out dtype name) of phase 2's wgmma
    route grid; each must take the wgmma route: a K carry (bk 128) and one interval
    (bk >= K; at the edge shape 352, not a multiple of 64)."""
    cases = []
    i = 0
    for gk in ("gkN", "gk1"):
        for acc in ("float32", "bfloat16"):
            for layout in ("kn", "nk"):
                for bm in (64, 128):
                    for bn in (64, 128):
                        for edge in (False, True):
                            # edges: M % BM, N % BN != 0 and a K tail of 8 (K % 64 != 0)
                            m, n, k = (200, 264, 328) if edge else (256, 384, 512)
                            bk = 128 if gk == "gkN" else -(-k // 32) * 32
                            for epilogue in (False, True):
                                act = ("gelu", "silu", "tanh")[i % 3] if epilogue else None
                                cfg = dict(bm=bm, bn=bn, bk=bk, acc_dtype=acc,
                                           rhs_layout=layout,
                                           grid_order="nm" if i % 2 else "mn")
                                out = "float32" if i % 3 else "bfloat16"
                                cases.append((f"wgmma/{gk}/{acc}/{layout}/"
                                              f"{'edge' if edge else 'al'}/{act or 'plain'}",
                                              1, m, n, k, cfg, act, out))
                                i += 1
            for bm, bn in ((64, 128), (128, 64)):  # the rank-3 maps' M edge inside a batch
                cases.append((f"wgmma-batched/{gk}/{acc}/m-edge", GRID_BATCH, 100, 136, 328,
                              dict(bm=bm, bn=bn, bk=128 if gk == "gkN" else 352,
                                   acc_dtype=acc), None, "float32"))
    # the unaligned bring-up shape at one interval, as the heuristic resolves it
    for acc in ("float32", "bfloat16"):
        for layout in ("kn", "nk"):
            for act in (None, "gelu"):
                cases.append((f"wgmma/gk1/1000^3/{acc}/{layout}/{act or 'plain'}", 1, 1000,
                              1000, 1000, dict(bm=64, bn=64, bk=1024, acc_dtype=acc,
                                               rhs_layout=layout), act, "float32"))
    cases.append(("wgmma-long/4096x4096x4096/float32", 1, 4096, 4096, 4096,
                  dict(bm=128, bn=128, bk=2048), None, "float32"))
    cases.append(("wgmma-long/128x8192x8192/float32", 1, 128, 8192, 8192,
                  dict(bm=64, bn=128, bk=4096), None, "float32"))
    return cases


def _ring_source(cfg, route: str) -> str:
    """The file that instantiates the ring's kernel for cfg's tile on ``route`` (the
    launcher tl2_wgmma.cu picks; the kernel's body is tl2_wgmma.cuh)."""
    if cfg.bn == 32:
        name = "tl2_wgmma_n32.cu"
    elif cfg.bm == 32:
        name = "tl2_wgmma_swap.cu"
    else:
        name = "tl2_wgmma_lsu.cu" if route.endswith("lsu") else "tl2_wgmma.cu"
    return f"tpul2_torch/csrc/{name}"


#: A ring instance's mangled name: tl2_wgmma_kernel<BM, BN, RHS_NK, ACC_BF16, LOADS>.
_RING_KERNEL = re.compile(r"tl2_wgmma_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])ELb([01])E")


def _ring_ptxas(build_log: str) -> dict:
    """Registers and spills of every ring instance (tl2_wgmma_kernel) from the build's ptxas
    report, printed one line each, by tile, layout, family and producer; raises where any
    spills (the consumer's products, sum and carry must stay in registers) or where the
    report names no ring instance."""
    from tpul2_torch.ops._build import ptxas_report
    out = {}
    for name, rep in ptxas_report(build_log).items():
        m = _RING_KERNEL.search(name)
        if m:
            bm, bn, nk, bf16, loads = m.groups()
            label = (f"{bm}x{bn} {'nk' if nk == '1' else 'kn'} {'bf16' if bf16 == '1' else 'f32'}"
                     f"{' loads' if loads == '1' else ''}")
            out[label] = rep
    if not out:
        raise AssertionError("the build's ptxas report names no ring instance")
    for label, rep in sorted(out.items()):
        print(f"  ring {label}: {rep.get('registers')} registers at entry, "
              f"{rep.get('spill_stores')} / {rep.get('spill_loads')} bytes spilled "
              "(stores / loads)")
    spilled = [label for label, rep in out.items()
               if rep.get("spill_stores") or rep.get("spill_loads")]
    if spilled:
        raise AssertionError(f"ring instances spill registers: {sorted(spilled)}")
    return out


#: The C route codes of each route name.
ROUTE_CODES = {"wgmma": 1, "wgmma_lsu": 2, "ring": 1, "ring_lsu": 2, "wgmma_wide": 3,
               "wgmma_wide_lsu": 4}


def _route_code(mm, cfg, a, b, m: int, n: int, k: int, out=None) -> int:
    """The C route code ops.matmul's rules give: launch_route's, with ROUTE_TMA_STORE where
    launch_store names the TMA store."""
    store = mm.launch_store(cfg, m, n, out) == "tma"
    return ROUTE_CODES[mm.launch_route(cfg, a, b, m, n, k, out)] | (
        mm.ROUTE_TMA_STORE if store else 0)


def _check_route_mirror(torch, lib, mm, KernelConfig) -> tuple:
    """tl2_wgmma_route against ops.matmul.launch_route and launch_store over shapes
    (decode-size M and N among them), ring blocks (the tiles and the narrower blocks of the
    JAX space, 'kn' column blocks off 16 bytes among them: bn 1 and 100), bk (one interval
    and several, mid-stage rounding points included), layouts and the alignments of the
    operands and the output (views 2, 8 and 16 bytes into one allocation, a fresh output);
    return (cases, TMA cases, TMA-store cases).  Raises on the first disagreement."""
    buf = torch.zeros(64, dtype=torch.bfloat16, device="cuda")
    shapes = ((256, 256, 1024), (200, 1001, 328), (64, 8192, 8192), (96, 160, 1004),
              (128, 128, 64), (8192, 128, 64), (1000, 1000, 1000), (1, 4096, 4096),
              (8, 4096, 14336), (17, 31, 328), (31, 17, 1001), (32, 8, 256), (4096, 1, 96),
              (600, 600, 256))
    n = n_wgmma = n_store = 0
    for off_a in (0, 1, 8):
        for off_b in (0, 4):
            for off_c in (None, 0, 4):
                a, b = buf[off_a:], buf[off_b:]
                c = None if off_c is None else buf[off_c:]
                for m, nn, k in shapes:
                    for bm in (1, 16, 32, 48, 64, 128):
                        for bn in (1, 16, 32, 64, 100, 128):
                            for bk in (64, 96, 128, 160, 256, 1024, 8192):
                                for layout in ("kn", "nk"):
                                    cfg = KernelConfig(bm=bm, bn=bn, bk=bk, rhs_layout=layout)
                                    want = _route_code(mm, cfg, a, b, m, nn, k, c)
                                    got = lib.tl2_wgmma_route(
                                        m, nn, k, bm, bn, bk, int(layout == "nk"),
                                        a.data_ptr(), b.data_ptr(),
                                        None if c is None else c.data_ptr())
                                    if want != got:
                                        raise AssertionError(
                                            f"route rule differs at {m}x{nn}x{k} {cfg} offsets "
                                            f"{off_a}, {off_b}, {off_c}: python {want}, C {got}")
                                    n += 1
                                    n_wgmma += want & 7 == 1
                                    n_store += bool(want & mm.ROUTE_TMA_STORE)
    return n, n_wgmma, n_store


def _check_wide_mirror(torch, lib, mm, config) -> tuple:
    """The wide route's models against the kernel's: ``config.wide_streamed``,
    ``wide_stages`` and ``wide_smem_bytes`` (both modes, every depth up to a staged
    launch's 8, the swapped walk's height and unaligned heights included) against
    tl2_wgmma_wide_streamed / _stages / _smem_bytes, and ``validate`` taking every block
    (one mode always fits); then tl2_wgmma_route against ops.matmul.launch_route for wide
    blocks over shapes (K and N off 8 among them), blocks (up to 16384 rows and 32000
    columns, the swapped walk, narrow columns and unaligned covers among them), bk (one
    interval and several, 96 mid-stage), layouts and the alignments of A, the RHS and the
    output: 3 'wgmma_wide' or 4 'wgmma_wide_lsu' on both sides; and ``config.wide_ctas`` at
    the card's SM count against tl2_wgmma_wide_ctas, the launcher's rule, at every shape and
    block, 2-D and batched.  Returns (route cases, TMA cases among them, CTA-count cases)."""
    for bm in (1, 16, 32, 48, 64, 100, 128, 256, 1000, 2048, 16384):
        for k in (32, 64, 128, 256, 512, 576, 1024, 1280, 1344, 4096, 16384):
            stages = lib.tl2_wgmma_wide_stages(bm, k)
            streamed = lib.tl2_wgmma_wide_streamed(bm, k)
            cfg = config.KernelConfig(bm=bm, bn=256, bk=k)
            same = all(lib.tl2_wgmma_wide_smem_bytes(bm, k, s, mode)
                       == config.wide_smem_bytes(bm, k, s, bool(mode))
                       for s in range(config.PIPELINE_DEPTHS[-1] + 1) for mode in (0, 1))
            kernel = lib.tl2_wgmma_wide_smem_bytes(bm, k, stages, streamed)
            if (stages != config.wide_stages(bm, k) or bool(streamed) != config.wide_streamed(
                    bm, k) or not same or cfg.validate() is not None
                    or stages < config.WIDE_MIN_STAGES or kernel > config.SMEM_LIMIT):
                raise AssertionError(f"the wide smem model differs from the kernel at bm {bm} "
                                     f"k {k}: {stages} stages, streamed {streamed}, {kernel} "
                                     "bytes")
    buf = torch.zeros(64, dtype=torch.bfloat16, device="cuda")
    shapes = ((16384, 16384, 64), (8192, 16384, 512), (1000, 1000, 200), (200, 264, 128),
              (2048, 2048, 100), (2048, 1001, 64), (128, 4096, 1024), (16384, 256, 60),
              (16, 11008, 4096), (4096, 24576, 64), (8192, 1, 4096), (300, 500, 256))
    n = n_tma = 0
    for off_a in (0, 1):
        for off_b in (0, 8):
            for off_c in (0, 4):
                a, b, c = buf[off_a:], buf[off_b:], buf[off_c:]
                for m, nn, k in shapes:
                    for bm, bn in ((64, 256), (128, 2048), (256, 128), (2048, 16384),
                                   (512, 512), (16384, 256), (16, 11008), (1, 512),
                                   (256, 64), (2048, 1), (1000, 1000), (200, 300),
                                   (128, 24576), (48, 32000)):
                        for bk in (64, 96, 256, 1024):
                            for layout in ("kn", "nk"):
                                cfg = config.KernelConfig(bm=bm, bn=bn, bk=bk,
                                                          rhs_layout=layout)
                                code = lib.tl2_wgmma_route(m, nn, k, bm, bn, bk,
                                                           int(layout == "nk"), a.data_ptr(),
                                                           b.data_ptr(), c.data_ptr())
                                want = _route_code(mm, cfg, a, b, m, nn, k, c)
                                if cfg.validate() is not None or want != code:
                                    raise AssertionError(
                                        f"wide route differs at {m}x{nn}x{k} {cfg} offsets "
                                        f"{off_a}, {off_b}, {off_c}: python {want}, C {code}")
                                n += 1
                                n_tma += code & 7 == 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_ctas = 0
    for m, nn, _ in shapes:
        for bm, bn in ((64, 256), (128, 2048), (256, 128), (2048, 16384), (512, 512),
                       (16384, 256), (16, 11008), (1, 512), (256, 64), (2048, 1), (1000, 1000),
                       (200, 300), (128, 24576), (48, 32000)):
            for batch in (1, 3):
                got = lib.tl2_wgmma_wide_ctas(m, nn, bm, bn, batch)
                want = config.wide_ctas(m, nn, bm, bn, batch, sms)
                if got != want:
                    raise AssertionError(f"wide_ctas differs at {batch}x{m}x{nn} {bm}x{bn}: "
                                         f"C {got}, python {want}")
                n_ctas += 1
    return n, n_tma, n_ctas


def _second_count(torch, cfg, batch: int, m: int, n: int) -> int:
    """The witness's CTA count beside the rule's for a wide launch: one CTA a block (each CTA
    then walks one whole block), or where that is the rule's own count, one CTA fewer; 0
    for a launch of one item, which has no other count."""
    from tpul2_torch.config import wide_walk
    walk = wide_walk(m, n, cfg.bm, cfg.bn, batch, cfg.grid_order == "nm")
    rule = min(walk.items, torch.cuda.get_device_properties(0).multi_processor_count)
    blocks = walk.items // (walk.strips * walk.cols)  # over the batch
    return blocks if blocks != rule else rule - 1


def _witness_launch(torch, lib, mm, a, rhs, cfg, out, bias, act, batch: int, m: int, n: int,
                    k: int, ctas: int, depth: int = 0) -> None:
    """The wide launch the wrapper makes (``ops.matmul.launch_args``) at ``ctas`` CTAs
    instead of the rule's, into ``out`` (tl2_wgmma_wide_witness; depth > 0: the staged wide
    launch at that depth).  Not counted: no path takes it."""
    from tpul2_torch.ops._build import check_launch
    args = mm.launch_args(a, rhs, cfg, out, bias, act, batch, m, n, k)
    check_launch(lib.tl2_wgmma_wide_witness(*args, int(out.dtype == torch.float32), depth, ctas),
                 f"tl2_wgmma_wide_witness ({cfg} at {ctas} CTAs)")


def _bits(torch, t):
    """t's bits as integers of its width (bit-identity: -0.0 and 0.0 differ, NaN is NaN)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _check_staged_route_mirror(torch, lib, pl, mm, KernelConfig) -> tuple:
    """tl2_staged_route against ops.pipelined.staged_route and ops.matmul.launch_store over
    shapes, ring blocks (narrow ones included) and wide blocks (codes 3 and 4), depths,
    layouts, operand alignments and outputs (16-byte aligned, as the staged wrapper takes
    them; N % 8 != 0 among the shapes): the store is asked of the output the launch writes, a
    split launch's f32 workspace or the output; return (cases, TMA cases, TMA-store cases).
    Raises on the first disagreement."""
    buf = torch.zeros(64, dtype=torch.bfloat16, device="cuda")
    ws = torch.zeros(8, dtype=torch.float32, device="cuda")  # a fresh workspace's base
    shapes = ((64, 8192, 8192), (64, 64, 12288), (96, 160, 1004), (128, 100, 2048),
              (128, 128, 2080), (32, 14336, 4096), (16, 4096, 4096))
    n = n_ring = n_store = 0
    for off_a in (0, 1, 8):
        for off_b in (0, 4):
            for off_c in (0, 8):
                a, b, c = buf[off_a:], buf[off_b:], buf[off_c:]
                for m, nn, k in shapes:
                    for bm in (16, 32, 64, 128, 256):
                        for bn in (16, 32, 64, 128, 11008):
                            for depth in (2, 3, 4, 6, 8):
                                for layout in ("kn", "nk"):
                                    cfg = KernelConfig(bm=bm, bn=bn, rhs_layout=layout,
                                                       pipeline_depth=depth)
                                    route = pl.staged_route(cfg, a, b, m, nn, k)
                                    split = not cfg.wide and pl.staged_splits(
                                        m, nn, k, bm, bn, depth) > 1
                                    out = ws if split else c
                                    tma_store = mm.launch_store(cfg, m, nn, out) == "tma"
                                    want = ROUTE_CODES[route] | (
                                        mm.ROUTE_TMA_STORE if tma_store else 0)
                                    got = lib.tl2_staged_route(m, nn, k, bm, bn,
                                                               int(layout == "nk"),
                                                               a.data_ptr(), b.data_ptr(),
                                                               out.data_ptr())
                                    if want != got:
                                        raise AssertionError(
                                            f"staged route differs at {m}x{nn}x{k} {cfg} "
                                            f"offsets {off_a}, {off_b}, {off_c}, split {split}: "
                                            f"python {want}, C {got}")
                                    n += 1
                                    n_ring += route in ("ring", "wgmma_wide")
                                    n_store += tma_store
    return n, n_ring, n_store


def _offset(torch, t, off: int):
    """A copy of t whose base lies ``off`` elements into its allocation (off 1: 2 bytes off
    16, which TMA cannot read)."""
    if not off:
        return t
    return torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)[off:].view(
        t.shape).copy_(t)


def _ring_order_reference(torch, mm, a, rhs, bk, rhs_layout, bias=None, act=None,
                          out_dtype=None, chain16=False):
    """The bf16 family's K carry (matmul_reference's function and rounding points) summed
    in the ring's own f32 order: each 64-deep stage's product (32-deep halves where
    bk % 64 == 32) taken exactly (f64) and rounded to f32, the stages of an interval added
    in f32 in K order, the running sum rounded to bf16 after every interval.  With
    ``chain16`` a stage is four k16 steps instead, each rounded to f32 as it joins the
    stage's sum (wgmma's own chain).  Returns the f32 value before the cast."""
    b = rhs.transpose(-1, -2) if rhs_layout == "nk" else rhs
    k = a.shape[-1]
    step = mm.WGMMA_KSTAGE if bk % mm.WGMMA_KSTAGE == 0 else mm.WGMMA_KSTAGE // 2
    carry = part = 0.0
    for ks in range(0, k, step):
        ke = min(ks + step, k)
        if chain16:
            st = 0.0
            for k16 in range(ks, ke, 16):
                e16 = min(k16 + 16, ke)
                st = (st + a[..., k16:e16].double() @ b[..., k16:e16, :].double()).float()
        else:
            st = (a[..., ks:ke].double() @ b[..., ks:ke, :].double()).float()
        part = part + st
        if ke % bk == 0 or ke == k:
            carry = (carry + part).bfloat16().float()
            part = 0.0
    if bias is not None:
        carry = carry + bias.float()
    out = mm.ACTIVATIONS[act](carry)
    return out if out_dtype is None else out.to(out_dtype)


def _check_case(torch, mods, gen, batch, m, n, k, cfg, act, out_name, zero_one,
                offsets=(0, 0), out_offset=0, witness=None):
    """Run kernel and plain version on the same inputs (A and the RHS ``offsets``
    elements into their allocations; with ``out_offset`` the kernel writes through out=
    that many elements into its allocation); return (max |diff|, the elements beyond
    allowed_error that carry the ring-order reference's bits).  Raises if out of
    tolerance.  ``witness``, (the library, a list), at a wide block: the same launch again
    at ``_second_count`` CTAs into an output of the same alignment, which must hold the
    rule's bits; the count goes on the list."""
    KernelConfig, mm, bmm = mods
    out_dtype = getattr(torch, out_name)
    batched = batch > 1
    a = _inputs(torch, gen, (batch, m, k) if batched else (m, k), zero_one)
    rhs_shape = (n, k) if cfg.rhs_layout == "nk" else (k, n)
    rhs = _inputs(torch, gen, (batch, *rhs_shape) if batched else rhs_shape, zero_one)
    a, rhs = _offset(torch, a, offsets[0]), _offset(torch, rhs, offsets[1])
    if zero_one and act is not None:
        act = "relu"  # exact on integers; tanh-based epilogues are checked on normal inputs
    bias = None
    if act is not None:
        bias = (torch.randint(0, 2, (n,), generator=gen, device="cuda").float() if zero_one
                else torch.randn((n,), generator=gen, device="cuda"))
    out = None
    if out_offset:
        out = _offset(torch, torch.zeros((batch, m, n) if batched else (m, n), dtype=out_dtype,
                                         device="cuda"), out_offset)
    if batched:
        got = bmm.cuda_batched_matmul(a, rhs, cfg, out_dtype=out_dtype, out=out)
        want = bmm.batched_matmul_reference(a, rhs, cfg.bk, cfg.acc_dtype, out_dtype)
    elif act is None:
        wrapper = mm.cuda_matmul_tn if cfg.rhs_layout == "nk" else mm.cuda_matmul
        got = wrapper(a, rhs, cfg, out_dtype=out_dtype, out=out)
        want = mm.matmul_reference(a, rhs, cfg.bk, cfg.acc_dtype, cfg.rhs_layout,
                                   out_dtype=out_dtype)
    else:
        b = rhs.t().contiguous() if cfg.rhs_layout == "nk" else rhs
        got = mm.cuda_matmul_fused(a, b, bias=bias, activation=act, config=cfg,
                                   out_dtype=out_dtype, out=out,
                                   b_t=rhs if cfg.rhs_layout == "nk" else None)
        want = mm.matmul_reference(a, rhs, cfg.bk, cfg.acc_dtype, cfg.rhs_layout, bias, act,
                                   out_dtype)
    second = _second_count(torch, cfg, batch, m, n) if witness and cfg.wide else 0
    if second:
        lib, counts = witness
        again = _offset(torch, torch.full((batch, m, n) if batched else (m, n), float("nan"),
                                          dtype=out_dtype, device="cuda"), out_offset)
        _witness_launch(torch, lib, mm, a, rhs, cfg, again, bias, act, batch, m, n, k, second)
        if not torch.equal(_bits(torch, again), _bits(torch, got)):
            raise AssertionError(f"{cfg} at {batch}x{m}x{n}x{k}: {second} CTAs give other "
                                 "bits than the rule's count")
        counts.append(second)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite kernel output")
    witnessed = 0
    if zero_one:
        # exact: every sum is an integer below 2^24, so both round identically
        if diff.max().item() != 0.0:
            raise AssertionError(f"0/1 inputs: max |diff| {diff.max().item()} != 0")
    else:
        tol = mm.allowed_error(a, rhs, cfg.bk, cfg.acc_dtype, cfg.rhs_layout, out_dtype,
                               bias, act)
        bad = diff > tol
        if bad.any() and cfg.acc_dtype == "bfloat16" and -(-k // cfg.bk) > 1:
            # a bf16 carry can round one interval to the neighbouring bf16 value of the
            # plain version's, and the gap can grow past allowed_error's one ulp as later
            # intervals round it on coarser or finer grids: such an element must carry the
            # ring-order reference's bits (the same rounding points in the kernel's f32
            # order), and nothing else may leave the tolerance
            ring = _ring_order_reference(torch, mm, a, rhs, cfg.bk, cfg.rhs_layout, bias, act,
                                         out_dtype)
            witnessed = int(bad.sum().item())
            bad = bad & (got.float() != ring.float())
        if bad.any():
            raise AssertionError(f"normal inputs: {int(bad.sum().item())} elements beyond "
                                 f"tolerance, max |diff| {diff.max().item()}")
    return diff.max().item(), witnessed


def _narrow_cases(mm) -> list:
    """(name, batch, m, n, k, cfg kwargs, activation, out dtype name, operand offsets) of
    phase 2's 32-edge grid: {f32, bf16 acc} x {kn, nk} x {gk == 1, gk > 1, bk % 64 == 32}
    x {bm 32, bn 32, both} x {TMA, loads on A, loads on B} x {plain, bias + act}, M and N
    of the 32 edges cycling through 1, 8, 17, 31, 32 (K 328: a K tail of 8), then batched
    (B = 3, 'kn') for each tile kind, producer and K loop.  A producer's operand lies 2
    bytes off 16 (an offset of one element); 'kn' rows of an odd N take the loads
    producer on B whatever the case's offsets."""
    edges = (1, 8, 17, 31, 32)
    acts = ("gelu", "silu", "tanh", "relu")
    producers = (("tma", (0, 0)), ("lsu_a", (1, 0)), ("lsu_b", (0, 1)))
    k = 328
    cases, i = [], 0
    for acc in ("float32", "bfloat16"):
        for layout in ("kn", "nk"):
            for loop, bk in (("gk1", 352), ("gkN", 128), ("mid", 96)):
                for kind in ("bm32", "bn32", "both"):
                    tile = {"bm32": (32, (64, 128)[i % 2]), "bn32": ((64, 128)[i % 2], 32),
                            "both": (32, 32)}[kind]
                    for prod, offs in producers:
                        for epilogue in (False, True):
                            e = edges[i % len(edges)]
                            m = e if tile[0] == 32 else 136
                            n = e if tile[1] == 32 else 200
                            act = acts[i % len(acts)] if epilogue else None
                            cfg = dict(bm=tile[0], bn=tile[1], bk=bk, acc_dtype=acc,
                                       rhs_layout=layout, grid_order="nm" if i % 3 else "mn")
                            out = "float32" if i % 2 else "bfloat16"
                            cases.append((f"narrow/{acc}/{layout}/{loop}/{kind}/{prod}/"
                                          f"{act or 'plain'}", 1, m, n, k, cfg, act, out, offs))
                            i += 1
    for kind, tile, (m, n) in (("bm32", (32, 64), (17, 200)), ("bn32", (64, 32), (100, 31)),
                               ("both", (32, 32), (16, 16))):
        for prod, offs in producers:
            for loop, bk in (("gk1", 352), ("gkN", 128)):
                cases.append((f"narrow-batched/{kind}/{prod}/{loop}", GRID_BATCH, m, n, k,
                              dict(bm=tile[0], bn=tile[1], bk=bk, acc_dtype="bfloat16"), None,
                              "float32", offs))
    return cases


def _store_want(mm, cfg, m: int, n: int) -> dict:
    """The store counter a launch into a fresh output moves (ops.matmul.launch_store)."""
    return {mm.STORE_COUNTER[mm.launch_store(cfg, m, n)].removeprefix("LAUNCHES_").lower(): 1}


def _narrow_want(mm, cfg, batch, m, n, k, route) -> dict:
    """The counters a 32-edge case moves per launch: its body's on its route, its tile
    kind's, its store's, and the mid-stage rounding's (bf16 family, bk % 64 == 32, gk > 1)."""
    gk = -(-k // cfg.bk)
    want = {f"{'batched_' if batch > 1 else ''}{'multi' if gk > 1 else 'single'}_k_{route}": 1,
            "width32" if cfg.bn == 32 else "swapped": 1, **_store_want(mm, cfg, m, n)}
    if cfg.acc_dtype == "bfloat16" and cfg.bk % mm.WGMMA_KSTAGE and gk > 1:
        want["midstage"] = 1
    return want


def _check_producers_agree(torch, lib, mm, KernelConfig, gen) -> int:
    """The loads producer launched directly on aligned operands (vec_a / vec_b = 0: on A,
    on B, on both) on every tile, both layouts and families (a K carry, f32 out), against
    the TMA producer: the same stages and wgmmas, so the same bits.  Returns the cases."""
    m, n, k = 96, 200, 520
    cases = 0
    for bm in (32, 64, 128):
        for bn in (32, 64, 128):
            for layout in ("kn", "nk"):
                for acc in ("float32", "bfloat16"):
                    cfg = KernelConfig(bm=bm, bn=bn, bk=128, acc_dtype=acc, rhs_layout=layout)
                    a = _inputs(torch, gen, (m, k), False)
                    rhs = _inputs(torch, gen, (n, k) if layout == "nk" else (k, n), False)
                    outs = []
                    for vec_a, vec_b in ((1, 1), (0, 1), (1, 0), (0, 0)):
                        out = torch.empty((m, n), dtype=torch.float32, device="cuda")
                        args = list(mm.launch_args(a, rhs, cfg, out, None, None, 1, m, n, k))
                        args[18], args[19] = vec_a, vec_b
                        err = lib.tl2_wgmma_f32out(*args)
                        if err:
                            raise AssertionError(f"direct launch {cfg} vec {vec_a}{vec_b}: {err}")
                        outs.append(out)
                    torch.cuda.synchronize()
                    if not all(torch.equal(outs[0], o) for o in outs[1:]):
                        raise AssertionError(f"the loads producer's bits differ from TMA's "
                                             f"at {cfg}")
                    cases += 1
    return cases


def _staged_cases(candidate_configs, KernelConfig, wgmma_tiles):
    """(name, m, n, k, cfg kwargs, out dtype name, route, A's offset) of phase 2b;
    ``route`` is the staged ring's producer the case must take ('ring' or 'ring_lsu'),
    'wide' for a wide block (JAX's kStage pick: the wide walk's staged sum, unsplit), or
    None where gk == 1 takes the single-K kernel."""
    cases = []
    i = 0
    for bm in (32, 64, 128):
        for bn in (32, 64, 128):
            ring = bm in wgmma_tiles and bn in wgmma_tiles
            for depth in (2, 3, 4, 6, 8):
                if KernelConfig(bm=bm, bn=bn, pipeline_depth=depth).validate() is not None:
                    continue  # 128 x 128 at depth 8: a ring of more than 227 KB
                acc = ("float32", "bfloat16")[i % 2]
                layout = ("kn", "nk")[i // 2 % 2]
                kw = dict(bm=bm, bn=bn, bk=256, acc_dtype=acc, rhs_layout=layout,
                          pipeline_depth=depth, grid_order="nm" if i % 3 == 0 else "mn")
                out = "float32" if i % 3 else "bfloat16"
                # few tiles (the ring splits K) and many (one split)
                for m, n, k in [(256, 384, 2048) if ring else (128, 128, 2048),
                                (2048, 1024, 2048)]:
                    cases.append((f"staged/{bm}x{bn}/d{depth}/{acc}/{layout}/{m}x{n}x{k}",
                                  m, n, k, kw, out, "ring", 0))
                i += 1
    for acc in ("float32", "bfloat16"):
        for layout in ("kn", "nk"):
            # gk = 3 < depth 8: the ring is clamped to 3 stages
            for bm, bn in ((64, 128), (32, 128)):
                kw = dict(bm=bm, bn=bn, bk=256, acc_dtype=acc, rhs_layout=layout,
                          pipeline_depth=8)
                cases.append((f"staged-clamp/{acc}/{layout}/{bm}x{bn}", 128, 256, 768, kw,
                              "float32", "ring", 0))
            # gk == 1: the single-K kernel, not the ring
            kw = dict(bm=128, bn=64, bk=512, acc_dtype=acc, rhs_layout=layout, pipeline_depth=4)
            cases.append((f"staged-gk1/{acc}/{layout}", 128, 256, 512, kw, "bfloat16", None, 0))
            # a K tail (K = 2080, K % 64 = 32): TMA zero-fills the last stage, with a split
            # and without, on a wide tile and a swapped one
            for (m, n), (bm, bn) in (((128, 128), (64, 64)), ((2048, 1024), (64, 64)),
                                     ((128, 128), (32, 64))):
                kw = dict(bm=bm, bn=bn, bk=160, acc_dtype=acc, rhs_layout=layout,
                          pipeline_depth=2)
                out = "bfloat16" if layout == "nk" else "float32"
                cases.append((f"staged-ktail/{acc}/{layout}/{m}x{n}x2080/{bm}x{bn}", m, n,
                              2080, kw, out, "ring", 0))
            # A's base 2 bytes off 16: the loads producer fills A's part of the ring
            for bm, bn in ((64, 64), (32, 64), (64, 32)):
                kw = dict(bm=bm, bn=bn, bk=256, acc_dtype=acc, rhs_layout=layout,
                          pipeline_depth=4)
                cases.append((f"staged-lsu/{acc}/{layout}/{bm}x{bn}", 128, 128, 2048, kw,
                              "float32", "ring_lsu", 1))
    # the staged candidates of the tuning shapes and of 32-token decode (32-edge tiles, and
    # JAX's own pick there: the 32 x 14336 cover on the wide walk)
    for m, n, k in TUNE_SHAPES + [DECODE_STAGED_SHAPE]:
        for c in candidate_configs(m, n, k, "float32"):
            if c.pipeline_depth >= 2:
                kw = {f: getattr(c, f) for f in ("bm", "bn", "bk", "acc_dtype", "rhs_layout",
                                                 "pipeline_depth", "grid_order")}
                cases.append((f"staged-tune/{m}x{n}x{k}/{c.bm}x{c.bn}/{c.grid_order}/"
                              f"{c.rhs_layout}/d{c.pipeline_depth}", m, n, k, kw, "bfloat16",
                              "wide" if c.wide else "ring", 0))
    return cases


def _check_staged(torch, mm, pl, gen, m, n, k, cfg, out_name, zero_one, splits,
                  repeat=False, offset_a=0):
    """Run the staged wrapper and its plain version (with ``splits``) on the same inputs
    (A ``offset_a`` elements into its allocation); return max |diff| (raises if out of
    tolerance, or, with ``repeat``, if a second run on the same inputs differs in any
    bit)."""
    out_dtype = getattr(torch, out_name)
    a = _offset(torch, _inputs(torch, gen, (m, k), zero_one), offset_a)
    rhs = _inputs(torch, gen, (n, k) if cfg.rhs_layout == "nk" else (k, n), zero_one)
    got = pl.cuda_matmul_pipelined(a, rhs, cfg, out_dtype=out_dtype)
    want = pl.pipelined_reference(a, rhs, cfg.rhs_layout, out_dtype, splits)
    if repeat and not torch.equal(got, pl.cuda_matmul_pipelined(a, rhs, cfg,
                                                                out_dtype=out_dtype)):
        raise AssertionError("two runs on the same inputs differ")
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite kernel output")
    diff = (got.float() - want.float()).abs()
    if zero_one:
        if diff.max().item() != 0.0:
            raise AssertionError(f"0/1 inputs: max |diff| {diff.max().item()} != 0")
    else:
        tol = mm.allowed_error(a, rhs, k, "float32", cfg.rhs_layout, out_dtype)
        bad = (diff > tol).sum().item()
        if bad:
            raise AssertionError(f"normal inputs: {bad} elements beyond tolerance, "
                                 f"max |diff| {diff.max().item()}")
    return diff.max().item()


def _bound(batch: int, m: int, n: int, k: int, out_bytes: int = 2) -> tuple:
    """(ms, 'bytes' | 'operations'): the least time the card could take for the product:
    each bf16 input read once and the output written once at PEAK_BYTES, or the FLOPs at
    PEAK_FLOPS, whichever is larger."""
    t_ops = 2.0 * batch * m * n * k / PEAK_FLOPS * 1e3
    t_bytes = batch * ((m * k + k * n) * 2 + m * n * out_bytes) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _script(repo: Path, name: str):
    """The module of scripts/<name>.py."""
    spec = importlib.util.spec_from_file_location(name, repo / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device milliseconds per call over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _model_flops(seq: int, d: int, d_ff: int, heads: int) -> float:
    """FLOPs of the block's six products in one forward: QKV, the scores, the context,
    the output projection and the two FFN products (2 per multiply-add)."""
    hd = d // heads
    return 2.0 * seq * (3 * d * d + d * d + 2 * d * d_ff) + 2 * 2.0 * heads * seq * seq * hd


def _model_phase(torch, counters, zero_counters, use_db) -> tuple:
    """Phase model: the flagship block (``tpul2_torch.models.entry``, d_model 1024, d_ff
    4096, seq 512, 8 heads) served, trained and held against its plain versions; the FFN
    trained.  ``use_db('committed' | 'heuristic')`` picks the DB the dispatch resolves
    through.  Returns (record, launches of the model path's counted parts)."""
    import numpy as np

    from tpul2_torch.config import KernelConfig
    from tpul2_torch.harness import profiling
    from tpul2_torch.models import (BlockParams, block_forward, block_train_step,
                                    block_value_and_grad, init_ffn)
    from tpul2_torch.models import train_step as ffn_train_step
    from tpul2_torch.models.entry import D_FF, D_MODEL, N_HEADS, SEQ, entry

    lr = 5e-2
    out_tol, grad_tol, loss_tol = 0.05, 0.02, 1e-3
    rec = {"tolerances": {"output_rtol_atol": out_tol, "grad_rel_l2_per_tensor": grad_tol,
                          "loss_rtol": loss_tol}}
    launches = {key: 0 for key in counters()}

    def count(fn):
        """Run fn with the counters zeroed just before; add what it launched."""
        zero_counters()
        res = fn()
        torch.cuda.synchronize()
        got = counters()
        for key, v in got.items():
            launches[key] += v
        return res, got

    def finite(t, what):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"non-finite {what}")

    # does the card's torch differentiate aten::mm.dtype (the sentinel's f32 output)?
    probe = torch.ones((2, 2), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    try:
        torch.mm(probe, probe.detach(), out_dtype=torch.float32).sum().backward()
        rec["mm_dtype_has_derivative"] = True
    except (RuntimeError, NotImplementedError) as e:
        rec["mm_dtype_has_derivative"] = False
        rec["mm_dtype_derivative_error"] = str(e).splitlines()[0]
    print(f"  aten::mm.dtype derivative in torch {torch.__version__}: "
          f"{rec['mm_dtype_has_derivative']} (the sentinel goes through GemmVjp either way)")

    # (a) the committed DB: serve 8 forward requests, one at a time
    use_db("committed")
    fn, (params, x) = entry()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    y = torch.randn((SEQ, D_MODEL), generator=gen, device="cuda").to(torch.bfloat16)
    fn(params, x)
    torch.cuda.synchronize()

    def serve():
        times, out = [], None
        for _ in range(8):
            t0 = time.perf_counter()
            out = fn(params, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, times

    (out, req_ms), served = count(serve)
    if out.shape != (SEQ, D_MODEL) or out.dtype != torch.bfloat16:
        raise AssertionError(f"forward gave {tuple(out.shape)} {out.dtype}")
    finite(out, "forward output")
    rec["serve"] = {"requests": 8, "ms": req_ms, "p50_ms": float(np.percentile(req_ms, 50)),
                    "p99_ms": float(np.percentile(req_ms, 99)), "launches": served,
                    "launches_per_forward": {k: v / 8 for k, v in served.items() if v}}
    print(f"  (a) committed DB, 8 requests one at a time: p50 {rec['serve']['p50_ms']:.4f} ms, "
          f"p99 {rec['serve']['p99_ms']:.4f} ms (host clock to the card's end); launches "
          f"per forward {json.dumps(rec['serve']['launches_per_forward'])}")
    if served["single_k_wgmma"] <= 0 or served["multi_k_wgmma"] <= 0:
        raise AssertionError("the committed DB's forward did not run the 2-D wgmma single-K "
                             f"and multi-K bodies: {served}")

    # (b) training: 5 block steps on the fixed (x, y), then 3 FFN steps
    def train_block():
        p, losses = params, []
        for _ in range(5):
            p, loss = block_train_step(p, x, y, N_HEADS, lr=lr)
            losses.append(float(loss))
        return losses

    losses, trained = count(train_block)
    if not all(math.isfinite(v) for v in losses) or not losses[4] < losses[0]:
        raise AssertionError(f"block loss not finite and falling: {losses}")
    fgen = torch.Generator(device="cuda")
    fgen.manual_seed(8)
    ffn = init_ffn(fgen, D_MODEL, D_FF)
    fx, fy = (torch.randn((512, D_MODEL), generator=fgen, device="cuda").to(torch.bfloat16)
              for _ in range(2))

    def train_ffn():
        p, fl = ffn, []
        for _ in range(3):
            p, loss = ffn_train_step(p, fx, fy, lr=lr)
            fl.append(float(loss))
        return fl

    ffn_losses, ffn_trained = count(train_ffn)
    if not all(math.isfinite(v) for v in ffn_losses):
        raise AssertionError(f"FFN loss not finite: {ffn_losses}")
    rec["train"] = {"lr": lr, "block_losses": losses, "block_launches": trained,
                    "launches_per_block_step": {k: v / 5 for k, v in trained.items() if v},
                    "ffn_losses": ffn_losses, "ffn_launches": ffn_trained}
    print(f"  (b) 5 block steps (lr {lr}) loss {json.dumps(losses)}; launches per step "
          f"{json.dumps(rec['train']['launches_per_block_step'])}; 3 FFN steps (1024 x 4096, "
          f"batch 512) loss {json.dumps(ffn_losses)}")

    # (c) held against the plain versions (a CPU copy: the same configs resolve there, and
    # every wrapper runs its plain version) and against the vendor config on the card
    def run(p, xx, yy, config=None):
        out = block_forward(p, xx, N_HEADS, config=config)
        loss, grads = block_value_and_grad(p, xx, yy, N_HEADS, config=config)
        return out.float().cpu(), float(loss), [g.float().cpu() for g in grads]

    card = run(params, x, y)
    plain = run(BlockParams(*(p.cpu() for p in params)), x.cpu(), y.cpu())
    vendor = run(params, x, y, KernelConfig.vendor())
    rec["held"] = {}
    for name, ref in (("plain", plain), ("vendor", vendor)):
        out_err = (card[0] - ref[0]).abs()
        bad = int((out_err > out_tol + out_tol * ref[0].abs()).sum())
        rel = {f: ((g - r).norm() / r.norm()).item()
               for f, g, r in zip(BlockParams._fields, card[2], ref[2])}
        loss_rel = abs(card[1] - ref[1]) / abs(ref[1])
        rec["held"][name] = {"output_max_abs_diff": out_err.max().item(),
                             "output_beyond_tol": bad, "loss": [card[1], ref[1]],
                             "loss_rel_diff": loss_rel, "grad_rel_l2": rel}
        print(f"  (c) vs {name}: output max |diff| {out_err.max().item():.4g} ({bad} beyond "
              f"rtol = atol = {out_tol}), loss {card[1]:.6f} vs {ref[1]:.6f}, grad relative L2 "
              f"per tensor (<= {grad_tol}) {json.dumps({k: round(v, 6) for k, v in rel.items()})}")
        if bad or loss_rel > loss_tol or max(rel.values()) > grad_tol:
            raise AssertionError(f"the block on the card differs from the {name} version")
        for g in card[2]:
            finite(g, "grad")

    # (d) the heuristic (an empty DB): the attention products on the batched kernel
    use_db("heuristic")
    heur_out, heur = count(lambda: fn(params, x))
    heur_err = (heur_out.float().cpu() - plain[0]).abs()
    rec["heuristic"] = {"launches_per_forward": {k: v for k, v in heur.items() if v},
                        "output_max_abs_diff_vs_plain": heur_err.max().item()}
    print(f"  (d) heuristic forward: launches {json.dumps(rec['heuristic']['launches_per_forward'])}"
          f", output max |diff| vs plain {heur_err.max().item():.4g}")
    if heur["batched_single_k_wgmma"] <= 0:
        raise AssertionError(f"the heuristic's forward did not run the batched single-K wgmma "
                             f"body: {heur}")
    if int((heur_err > out_tol + out_tol * plain[0].abs()).sum()):
        raise AssertionError("the heuristic's forward differs from the plain version")

    # (f) forward and train-step ms under the committed DB, the heuristic and the vendor
    # config, in turns (CUDA events over back-to-back calls); the model FLOPs' share of peak
    fwd_flops = _model_flops(SEQ, D_MODEL, D_FF, N_HEADS)
    kinds = ("committed", "heuristic", "vendor")
    times = {k: {"forward_ms": [], "train_step_ms": []} for k in kinds}
    for kind in kinds + kinds[::-1]:
        use_db("heuristic" if kind == "heuristic" else "committed")
        config = KernelConfig.vendor() if kind == "vendor" else None
        times[kind]["forward_ms"].append(_time_ms(
            torch, lambda: block_forward(params, x, N_HEADS, config=config), reps=10))
        times[kind]["train_step_ms"].append(_time_ms(
            torch, lambda: block_train_step(params, x, y, N_HEADS, lr=lr, config=config),
            reps=5))
    name = torch.cuda.get_device_name(0)
    rec["times"] = {}
    for kind, t in times.items():
        fwd, step = float(np.mean(t["forward_ms"])), float(np.mean(t["train_step_ms"]))
        rec["times"][kind] = {**t, "forward_mean_ms": fwd, "train_step_mean_ms": step,
                              "forward_flops_share": profiling.flops_share(fwd_flops, fwd, name),
                              "train_flops_share": profiling.flops_share(3 * fwd_flops, step,
                                                                         name)}
        print(f"  (f) {kind}: forward {json.dumps(t['forward_ms'])} ms, train step "
              f"{json.dumps(t['train_step_ms'])} ms (in turns); model FLOPs share of peak "
              f"{rec['times'][kind]['forward_flops_share']} forward, "
              f"{rec['times'][kind]['train_flops_share']} train step")
    rec["model_flops"] = {"forward": fwd_flops, "train_step": 3 * fwd_flops}
    print(f"  model FLOPs: {fwd_flops / 1e9:.3f} GFLOP forward, {3 * fwd_flops / 1e9:.3f} "
          "GFLOP train step (the six products; the backward's two per product)")

    # one profiled forward and train step through the committed DB, and a train step
    # through the heuristic and the vendor config: device busy time, idle share, top ops
    steps = [("forward", "committed", None), ("train_step", "committed", None),
             ("train_step", "heuristic", None), ("train_step", "vendor", KernelConfig.vendor())]
    for what, kind, config in steps:
        use_db("heuristic" if kind == "heuristic" else "committed")
        prof = profiling.profile_step(
            (lambda c=config: block_forward(params, x, N_HEADS, config=c)) if what == "forward"
            else (lambda c=config: block_train_step(params, x, y, N_HEADS, lr=lr, config=c)))
        rec[f"profile_{what}_{kind}"] = prof
        print(f"  profiled {what} ({kind}): {prof['device_events']} device events, busy "
              f"{prof['device_busy_ms']} ms of {prof['wall_ms']:.4f} ms wall (unprofiled "
              f"{prof['wall_ms_unprofiled']:.4f}), idle share {prof['idle_share']}; top device "
              f"ops {json.dumps(prof['top_device_ops'][:6])}; top host ops "
              f"{json.dumps(prof['top_host_ops'][:6])}")
    use_db("committed")
    # profile_shape at the block's widest product (FFN-1, 512 x 4096 x 1024), its
    # candidate's timing traced
    trace_dir = Path(__file__).resolve().parent / "runs" / "chip_smoke" / "trace_ffn1"
    for f in trace_dir.glob("*.json"):
        f.unlink()
    rec["profile_shape_ffn1"] = profiling.profile_shape(SEQ, D_FF, D_MODEL, trials=3,
                                                        trace_dir=str(trace_dir))
    traces = list(trace_dir.glob("*.json"))
    print(f"  profile_shape {SEQ}x{D_FF}x{D_MODEL}: {json.dumps(rec['profile_shape_ffn1'])}; "
          f"{len(traces)} trace file(s)")
    if not traces:
        raise AssertionError("maybe_trace wrote no trace")
    return rec, launches


def _decode_phase(torch, lib, mma, counters, zero_counters, use_db, host_time) -> tuple:
    """Phase decode: the small-batch serving regime on the ring against tl2_matmul.cu /
    tl2_staged.cu (launched directly through ``mma``), the 64-row ring tile and the library,
    then the flagship block's forward at seq 16.  Returns (record, kernel rows, their
    counter keys, reference rows, launches of the block forward)."""
    import numpy as np

    from tpul2_torch import dispatch
    from tpul2_torch.config import candidate_configs, heuristic_config
    from tpul2_torch.models import BlockParams, block_forward
    from tpul2_torch.models.entry import N_HEADS
    from tpul2_torch.models.entry import entry as block_entry
    from tpul2_torch.ops import batched as bmm
    from tpul2_torch.ops import matmul as mm
    from tpul2_torch.ops import pipelined as pl
    from tpul2_torch.ops._build import check_launch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    rec = {"l2_note": "B of the 4096 x 4096 shapes (33.5 MB) fits the 50 MB L2, so a repeated "
                      "launch reads it from L2; the 14336 shapes' B (117 MB) does not: they "
                      "are the bytes-bound rows", "shapes": []}
    rows, keys, refs = [], [], []
    #: the kernel line's decode rows: shape name -> (counter, the Pallas body it stands for)
    row_of = {"16x4096x4096": ("swapped", "tpul2/ops/matmul.py:96"),
              "32x(16x128)@(128x4096)": ("batched_single_k_wgmma", "tpul2/ops/batched.py:40"),
              "512x50257x768/kn": ("multi_k_wgmma_lsu", "tpul2/ops/matmul.py:96"),
              "14336x32x4096/nk": ("width32", "tpul2/ops/matmul.py:96")}
    use_db("heuristic")

    def turns_of(fns: dict, timer) -> dict:
        """Each fn timed twice, in turns (a b c .. c b a); the mean per key."""
        got = {key: [] for key in fns}
        for key in list(fns) + list(fns)[::-1]:
            got[key].append(timer(fns[key]))
        return {key: float(np.mean(v)) for key, v in got.items()} | {"turns": got}

    for name, batch, m, n, k, layout, acc, out_name in DECODE_SHAPES:
        out_dtype = getattr(torch, out_name)
        out_f32 = out_dtype == torch.float32
        lead = (batch,) if batch > 1 else ()
        cfg = dataclasses.replace(heuristic_config(m, n, k, acc), rhs_layout=layout)
        a = _inputs(torch, gen, (*lead, m, k), False)
        b = _inputs(torch, gen, (*lead, k, n), False)
        b_t = b.transpose(-1, -2).contiguous() if layout == "nk" else None
        rhs = b_t if layout == "nk" else b
        out = torch.empty((*lead, m, n), dtype=out_dtype, device="cuda")
        ring_fn = lib.tl2_wgmma_f32out if out_f32 else lib.tl2_wgmma_bf16out
        mma_fn = mma["tl2_matmul_f32out" if out_f32 else "tl2_matmul_bf16out"]

        def direct(fn, c, a=a, rhs=rhs, out=out, batch=batch, m=m, n=n, k=k):
            def make():
                call = mm.launch_args(a, rhs, c, out, None, None, batch, m, n, k)
                return lambda: check_launch(fn(*call), "decode")
            return make

        if batch > 1:
            library = (lambda a=a, b=b: torch.bmm(a, b, out_dtype=torch.float32)) if out_f32 \
                else (lambda a=a, b=b: torch.bmm(a, b))
            entry_fn = lambda a=a, b=b, out=out: dispatch.batched_matmul(  # noqa: E731
                a, b, acc=acc, out=out)
            plain = lambda a=a, b=b: bmm.batched_matmul_reference(  # noqa: E731
                a, b, cfg.bk, acc, out_dtype)
        else:
            library = (lambda a=a, b=b: torch.mm(a, b, out_dtype=torch.float32)) if out_f32 \
                else (lambda a=a, b=b: torch.matmul(a, b))
            entry_fn = lambda a=a, b=b, b_t=b_t, out=out, c=cfg: dispatch.matmul(  # noqa: E731
                a, b, acc=acc, b_t=b_t, config=c if c.rhs_layout == "nk" else None, out=out)
            plain = lambda a=a, rhs=rhs, c=cfg: mm.matmul_reference(  # noqa: E731
                a, rhs, c.bk, acc, c.rhs_layout, out_dtype=out_dtype)
        alone_fns = {"ring": direct(ring_fn, cfg), "mma_sync": direct(mma_fn, cfg)}
        alt = None
        if 32 in (cfg.bm, cfg.bn):  # the 64-row (64-wide) ring tile over zero rows
            alt = dataclasses.replace(cfg, bm=max(cfg.bm, 64), bn=max(cfg.bn, 64))
            alone_fns["ring_64"] = direct(ring_fn, alt)
        alone_fns["torch"] = lambda library=library: library
        alone = turns_of(alone_fns, lambda make: host_time.alone_ms(torch, make))
        entry = turns_of({"ring": entry_fn, "torch": library}, lambda f: _time_ms(torch, f))
        # the ring's output on these normal inputs against the plain version
        got = entry_fn()
        want = plain()
        err = (got.float() - want.float()).abs()
        tol = mm.allowed_error(a, rhs, cfg.bk, acc, cfg.rhs_layout, out_dtype)
        if not torch.isfinite(got.float()).all() or int((err > tol).sum()):
            raise AssertionError(f"decode {name}: the ring differs from its plain version")
        direct(mma_fn, cfg)()()
        mma_err = (out.float() - want.float()).abs().max().item()
        bound_ms, bound_by = _bound(batch, m, n, k, 4 if out_f32 else 2)
        route = mm.launch_route(cfg, a, rhs, m, n, k)
        row = {"name": name, "batch": batch, "mnk": [m, n, k], "layout": layout, "acc": acc,
               "out": out_name, "config": f"{cfg.bm}x{cfg.bn} bk={cfg.bk}", "route": route,
               "tile": ("swapped" if cfg.bm == 32 and cfg.bn > 32 else "width32"
                        if cfg.bn == 32 else "wide"),
               "alt_config": None if alt is None else f"{alt.bm}x{alt.bn} bk={alt.bk}",
               "alone_ms": alone, "entry_ms": entry, "plain_ms": _time_ms(torch, plain),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "max_abs_err": err.max().item(), "mma_sync_max_abs_err": mma_err}
        rec["shapes"].append(row)
        print("  decode " + json.dumps(row))
        common = {"route": "cuda", "plain_ms": row["plain_ms"], "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": alone["torch"]}
        if name in row_of:
            key, replaces = row_of[name]
            rows.append({"name": f"tl2_wgmma {row['tile']} {route} ({cfg.bm}x{cfg.bn} "
                                 f"bk={cfg.bk}, {name})",
                         "source": _ring_source(cfg, route), "replaces": replaces,
                         "launches": 0, "max_abs_err": row["max_abs_err"],
                         "ms": alone["ring"], **common})
            keys.append(key)
            refs.append({"name": f"tl2_matmul mma.sync ({cfg.bm}x{cfg.bn} bk={cfg.bk}, {name})",
                         "source": "tpul2_torch/csrc/tl2_matmul.cu", "replaces": replaces,
                         "launches": 0, "max_abs_err": mma_err, "ms": alone["mma_sync"],
                         **common})
        del a, b, b_t, rhs, out

    # the staged 32 x 64 candidates at 32-token decode: the fastest on the ring (with its
    # split) against tl2_staged.cu on the same config, then the heuristic's carry
    m, n, k = DECODE_STAGED_SHAPE
    a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
    b_t = b.t().contiguous()
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    staged = [c for c in candidate_configs(m, n, k) if c.pipeline_depth >= 2]
    staged = [c for c in staged if (c.bm, c.bn) == (32, 64)] or staged

    def ring_call(c):
        rhs = b_t if c.rhs_layout == "nk" else b
        return lambda: (lambda: pl.cuda_matmul_pipelined(a, rhs, c, out=out))

    def mma_call(c):
        rhs = b_t if c.rhs_layout == "nk" else b

        def make():
            args = (a.data_ptr(), rhs.data_ptr(), out.data_ptr(), m, n, k, c.bm, c.bn,
                    c.pipeline_depth, int(c.rhs_layout == "nk"), int(c.grid_order == "nm"), 0,
                    torch._C._cuda_getCurrentRawStream(0))
            return lambda: check_launch(mma["tl2_staged"](*args), "tl2_staged")
        return make

    cands = {str(c): host_time.alone_ms(torch, ring_call(c)) for c in staged}
    best = min(staged, key=lambda c: cands[str(c)])
    depth = pl.staged_depth(best.pipeline_depth, k // best.bk)
    splits = pl.staged_splits(m, n, k, best.bm, best.bn, depth)
    heur = heuristic_config(m, n, k)
    alt = dataclasses.replace(heur, bm=64)

    def carry(c):
        def make():
            call = mm.launch_args(a, b, c, out, None, None, 1, m, n, k)
            return lambda: check_launch(lib.tl2_wgmma_bf16out(*call), "carry")
        return make

    alone = turns_of({"staged_ring": ring_call(best), "staged_mma_sync": mma_call(best),
                      "carry_ring": carry(heur), "carry_ring_64": carry(alt),
                      "torch": lambda: (lambda: torch.matmul(a, b))},
                     lambda make: host_time.alone_ms(torch, make))
    entry = turns_of({"staged": lambda: dispatch.matmul(a, b, config=best, b_t=b_t, out=out),
                      "heuristic": lambda: dispatch.matmul(a, b, b_t=b_t, out=out),
                      "torch": lambda: torch.matmul(a, b)}, lambda f: _time_ms(torch, f))
    rhs = b_t if best.rhs_layout == "nk" else b
    got = pl.cuda_matmul_pipelined(a, rhs, best)
    want = pl.pipelined_reference(a, rhs, best.rhs_layout, torch.bfloat16, splits)
    err = (got.float() - want.float()).abs()
    if int((err > mm.allowed_error(a, rhs, k, "float32", best.rhs_layout,
                                   torch.bfloat16)).sum()):
        raise AssertionError("the staged 32-edge ring differs from its plain version")
    mma_call(best)()()
    mma_err = (out.float() - pl.pipelined_reference(a, rhs, best.rhs_layout).float()
               ).abs().max().item()
    bound_ms, bound_by = _bound(1, m, n, k)
    plain_ms = _time_ms(torch, lambda: pl.pipelined_reference(a, rhs, best.rhs_layout,
                                                              torch.bfloat16, splits))
    rec["staged"] = {"mnk": [m, n, k], "candidates_alone_ms": cands, "best": str(best),
                     "splits": splits, "heuristic": f"{heur.bm}x{heur.bn} bk={heur.bk}",
                     "alone_ms": alone, "entry_ms": entry, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": err.max().item(), "mma_sync_max_abs_err": mma_err}
    print("  decode staged " + json.dumps(rec["staged"]))
    common = {"route": "cuda", "replaces": "tpul2/ops/pipelined.py:39", "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": alone["torch"]}
    rows.append({"name": (f"tl2_wgmma_staged ring, 32-edge tile ({best.bm}x{best.bn} "
                          f"{best.rhs_layout} depth {best.pipeline_depth}, {m}x{n}x{k}, "
                          f"{splits} split(s))"),
                 "source": _ring_source(best, "ring"), "launches": 0,
                 "max_abs_err": err.max().item(), "ms": alone["staged_ring"], **common})
    keys.append("staged_narrow")
    refs.append({"name": (f"tl2_staged mma.sync ({best.bm}x{best.bn} {best.rhs_layout} depth "
                          f"{best.pipeline_depth}, {m}x{n}x{k})"),
                 "source": "tpul2_torch/csrc/tl2_staged.cu", "launches": 0,
                 "max_abs_err": mma_err, "ms": alone["staged_mma_sync"], **common})
    del a, b, b_t, out

    # the flagship block's forward at seq 16, through the committed DB (no entry within 2x
    # of a 16-token product, so the heuristic's decode tiles), against a CPU copy
    use_db("committed")
    _, (params, x) = block_entry()
    x16 = x[:16].contiguous()
    block_forward(params, x16, N_HEADS)
    torch.cuda.synchronize()
    zero_counters()
    times = []
    for _ in range(8):
        t0 = time.perf_counter()
        got = block_forward(params, x16, N_HEADS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = counters()
    plain = block_forward(BlockParams(*(p.cpu() for p in params)), x16.cpu(), N_HEADS)
    err = (got.float().cpu() - plain.float()).abs()
    bad = int((err > 0.05 + 0.05 * plain.float().abs()).sum())
    rec["block_seq16"] = {"requests": 8, "ms": times, "p50_ms": float(np.percentile(times, 50)),
                          "p99_ms": float(np.percentile(times, 99)),
                          "launches_per_forward": {key: v / 8 for key, v in launches.items()
                                                   if v},
                          "output_max_abs_diff_vs_plain": err.max().item(),
                          "output_beyond_tol": bad}
    print("  block forward at seq 16 (committed DB) " + json.dumps(rec["block_seq16"]))
    if bad or not torch.isfinite(got.float()).all():
        raise AssertionError("the block at seq 16 differs from its plain version")
    if launches["mma_sync"] or not (launches["swapped"] and launches["width32"]):
        raise AssertionError(f"the block at seq 16 did not run on the decode tiles only: "
                             f"{launches}")
    use_db("heuristic")
    return rec, rows, keys, refs, launches


#: Phase parallel's strategy shapes (the bring-up square and the skinny serving shape) and
#: the density of their 0/1 inputs: at 0.1 every sum, K = 8192 included, stays below 256
#: with a wide margin, so both families and the bf16 output are exact.
PARALLEL_SHAPES = [(4096, 4096, 4096), (64, 8192, 8192)]
PARALLEL_DENSITY = 0.1
#: The staged config phase parallel passes at 64x8192x8192 (a 64x64 ring tile, 4 stages).
PARALLEL_STAGED = dict(bm=64, bn=64, bk=1024, pipeline_depth=4)
#: The sharded FFN step: the model entry's widths, its lr (large enough that a step moves
#: most bf16 weights at full width) and steps, and the tolerances against the single-device
#: step.
FFN_SHARDED_LR, FFN_SHARDED_STEPS = 1.0, 3
FFN_LOSS_RTOL, FFN_UPDATE_REL_L2 = 1e-3, 0.1


def _median_us(fn, reps: int) -> float:
    """Median host microseconds of one call over ``reps`` calls."""
    import statistics
    times = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        times.append((time.perf_counter_ns() - t0) / 1e3)
    return statistics.median(times)


def _native_phase(repo: Path, use_db) -> dict:
    """Phase native: the g++ build of the tuning cache, the committed DB's entries through
    the cache and its file against the JSON, and the host cost of an exact-key lookup in
    the cache against the JSON DB's and a resolve_config memo hit's, and of loading the
    cache's file against the JSON.  Host code only: no kernel launches."""
    from tpul2_torch.autotune import db as db_mod
    from tpul2_torch.config import KernelConfig
    from tpul2_torch.dispatch import resolve_config
    from tpul2_torch.native import NativeTuneCache, build
    from tpul2_torch.utils.platform import nvidia_smi_name_power

    rec = {}
    t0 = time.perf_counter()
    lib = build.load_native()
    rec["build_seconds"] = lib.build_seconds
    rec["load_seconds"] = time.perf_counter() - t0
    print(f"  g++ build {lib.build_seconds:.3f} s (0.0 = library was current), load "
          f"{rec['load_seconds']:.3f} s: {build.LIB_PATH.name}")

    committed = repo / "tpul2_torch" / "data" / "tunedb_h100.json"
    entries = json.loads(committed.read_text())["entries"]
    db = db_mod.TuneDB(path=committed).load()
    nc = NativeTuneCache()
    keys = []
    for key, e in entries.items():
        mnk, acc, dt = key.split("/")
        keys.append((*(int(x) for x in mnk.split("_")), acc, dt))
        nc.put(*keys[-1][:3], KernelConfig(**e["config"]), acc=acc, in_dtype=dt,
               tflops=e.get("tflops", 0.0))
    path = repo / "runs" / "chip_smoke" / "native" / "tunedb_h100.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    nc.save(path)
    back = NativeTuneCache().load(path)
    bad = [key for key in keys if back.get(*key) != db.get(*key)]
    rec["committed"] = {"entries": len(entries), "cache_size": len(back), "mismatches": bad}
    print(f"  committed DB: {len(entries)} entries through the cache and its file, "
          f"mismatches {bad}")
    if bad or len(back) != len(entries) or len(entries) != 40:
        raise AssertionError("the cache does not answer the committed DB's 40 entries")

    use_db("committed")
    default = db_mod.default_db()

    def native_gets():
        for key in keys:
            back.get(*key)

    def json_gets():
        for key in keys:
            db.get(*key)

    def memo_hits():
        for key in keys:
            resolve_config(*key)

    memo_hits()
    per = len(keys)
    native_us = _median_us(native_gets, 50) / per
    json_us = _median_us(json_gets, 50) / per
    hit_us = _median_us(memo_hits, 50) / per
    load_bin = _median_us(lambda: NativeTuneCache().load(path), 20)
    load_json = _median_us(lambda: db_mod.TuneDB(path=committed).load(), 20)
    rec["host_us"] = {"native_get": native_us, "json_get": json_us,
                      "resolve_memo_hit": hit_us, "cache_file_load_ms": load_bin / 1e3,
                      "json_load_ms": load_json / 1e3, "memo_entries": len(default.memo)}
    print(f"  host time per call (median of 50 passes over the 40 keys): exact-key lookup "
          f"{native_us:.3f} us in the native cache, {json_us:.3f} us in the JSON DB; "
          f"resolve_config memo hit {hit_us:.3f} us; load: cache file {load_bin / 1e3:.4f} "
          f"ms, JSON (TuneDB.load) {load_json / 1e3:.4f} ms ({nvidia_smi_name_power()})")
    return rec


def _parallel_phase(torch, repo: Path, counters, zero_counters, use_db) -> tuple:
    """Phase parallel: a world of one rank on NCCL (the machine has one card, and NCCL
    refuses two ranks on one device), make_mesh(1), the five sharded strategies at full
    size through the committed DB and the heuristic and once with an explicit staged
    config, exact on 0/1 inputs against the unsharded dispatch.matmul and the plain
    product; then the sharded FFN step at full width against train_step.  Returns (record,
    the launches of the counted parts)."""
    import torch.distributed as dist

    from tpul2_torch import parallel as par
    from tpul2_torch.config import KernelConfig
    from tpul2_torch.dispatch import matmul
    from tpul2_torch.harness import profiling
    from tpul2_torch.models import init_ffn, make_sharded_train_step, train_step
    from tpul2_torch.models.entry import D_FF, D_MODEL, SEQ
    from tpul2_torch.utils.platform import nvidia_smi_name_power

    rec = {"tolerances": {"ffn_loss_rtol": FFN_LOSS_RTOL,
                          "ffn_update_rel_l2_per_tensor": FFN_UPDATE_REL_L2}}
    launches = {key: 0 for key in counters()}
    rendezvous = repo / "runs" / "chip_smoke" / "nccl_rendezvous"
    rendezvous.parent.mkdir(parents=True, exist_ok=True)
    rendezvous.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}", rank=0,
                            world_size=1)
    try:
        mesh = par.make_mesh(1)
        rec["mesh"] = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
                       "backend": dist.get_backend()}
        print(f"  mesh {rec['mesh']}")
        strategies = {
            "dp_matmul": lambda a, b, **kw: par.dp_matmul(a, b, mesh, **kw),
            "tp_matmul": lambda a, b, **kw: par.tp_matmul(a, b, mesh, **kw),
            "kshard_matmul": lambda a, b, **kw: par.kshard_matmul(a, b, mesh, **kw),
            "kshard_scatter_matmul": lambda a, b, **kw: par.kshard_scatter_matmul(
                a, b, mesh, **kw),
            "sharded_matmul_2d": lambda a, b, **kw: par.sharded_matmul_2d(a, b, mesh, **kw)}
        gen = torch.Generator(device="cuda")
        gen.manual_seed(11)
        inputs = {}
        for m, n, k in PARALLEL_SHAPES:
            a = (torch.rand((m, k), generator=gen, device="cuda") < PARALLEL_DENSITY)
            b = (torch.rand((k, n), generator=gen, device="cuda") < PARALLEL_DENSITY)
            a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
            inputs[(m, n, k)] = (a, b, (a.float() @ b.float()).to(torch.bfloat16))
        runs = [(db, acc, shape, None) for db in ("committed", "heuristic")
                for acc in ("float32", "bfloat16") for shape in PARALLEL_SHAPES]
        runs += [("heuristic", acc, (64, 8192, 8192),
                  KernelConfig(**PARALLEL_STAGED, acc_dtype=acc))
                 for acc in ("float32", "bfloat16")]
        rec["strategies"] = []
        for db, acc, shape, config in runs:
            use_db(db)
            a, b, plain = inputs[shape]
            whole = matmul(a, b, acc=acc, config=config)  # the comparison: not counted
            zero_counters()
            outs = {name: fn(a, b, acc=acc, config=config)
                    for name, fn in strategies.items()}
            torch.cuda.synchronize()
            got = counters()
            for key, v in got.items():
                launches[key] += v
            wrong = [name for name, out in outs.items()
                     if not (torch.equal(out, whole) and torch.equal(out, plain))]
            if not torch.equal(whole, plain):
                wrong.append("unsharded")
            label = "staged" if config is not None else db
            row = {"shape": list(shape), "acc": acc, "config": label, "wrong": wrong,
                   "launches": {key: v for key, v in got.items() if v}}
            rec["strategies"].append(row)
            print(f"  {shape[0]}x{shape[1]}x{shape[2]} {acc} ({label}): 5 strategies + the "
                  f"unsharded product, exact on 0/1 inputs: {not wrong}; launches "
                  f"{json.dumps(row['launches'])}")
            if wrong:
                raise AssertionError(f"{wrong} differ from the plain product ({row})")
        need = ("multi_k_wgmma", "staged_ring")
        if any(launches[key] <= 0 for key in need):
            raise AssertionError(f"the strategies did not launch {need}: {launches}")

        # the sharded FFN step at full width (heuristic: FFN-1 on the single-K body, FFN-2
        # on the K carry) against train_step on the same inputs
        use_db("heuristic")
        fgen = torch.Generator(device="cuda")
        fgen.manual_seed(12)
        params = init_ffn(fgen, D_MODEL, D_FF)
        x, y = (torch.randn((SEQ, D_MODEL), generator=fgen, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        step, shard_fn = make_sharded_train_step(mesh, lr=FFN_SHARDED_LR)
        blocks = shard_fn(params, x, y)

        def sharded():
            w1, w2, xs, ys = blocks
            losses = []
            for _ in range(FFN_SHARDED_STEPS):
                w1, w2, loss = step(w1, w2, xs, ys)
                losses.append(float(loss))
            return (w1, w2), losses

        def single():
            p, losses = params, []
            for _ in range(FFN_SHARDED_STEPS):
                p, loss = train_step(p, x, y, lr=FFN_SHARDED_LR)
                losses.append(float(loss))
            return tuple(p), losses

        zero_counters()
        (sw, sl) = sharded()
        torch.cuda.synchronize()
        ffn_launches = counters()
        for key, v in ffn_launches.items():
            launches[key] += v
        (rw, rl) = single()
        loss_rel = [abs(s - r) / abs(r) for s, r in zip(sl, rl)]
        upd, differ, identical = {}, {}, True
        for name, s, r, p0 in zip(("w1", "w2"), sw, rw, params):
            ds, dr = s.float() - p0.float(), r.float() - p0.float()
            upd[name] = ((ds - dr).norm() / dr.norm()).item()
            differ[name] = (s != r).float().mean().item()
            identical = identical and torch.equal(s, r)
        rec["ffn"] = {"d_model": D_MODEL, "d_ff": D_FF, "batch": SEQ, "lr": FFN_SHARDED_LR,
                      "sharded_losses": sl, "single_losses": rl, "loss_rel_diff": loss_rel,
                      "update_rel_l2": upd, "weights_differing_share": differ,
                      "bit_identical": identical and sl == rl,
                      "launches": {key: v for key, v in ffn_launches.items() if v}}
        print(f"  sharded FFN step ({D_MODEL} x {D_FF}, batch {SEQ}, lr {FFN_SHARDED_LR}, "
              f"heuristic): loss {json.dumps(sl)} against train_step's {json.dumps(rl)} "
              f"(relative {json.dumps([round(v, 8) for v in loss_rel])}, <= {FFN_LOSS_RTOL}); "
              f"update relative L2 {json.dumps(upd)} (<= {FFN_UPDATE_REL_L2}); share of "
              f"weights differing {json.dumps(differ)}; bit-identical "
              f"{rec['ffn']['bit_identical']}; launches {json.dumps(rec['ffn']['launches'])}")
        if not rec["ffn"]["bit_identical"]:
            print("  (not bit-identical: the sharded step keeps FFN-2's output in f32 into the "
                  "loss, the JAX sharded step's layout, where train_step's ffn_forward rounds "
                  "it to bf16; the all-reduce over one rank adds nothing)")
        if not all(math.isfinite(v) for v in sl) or not sl[-1] < sl[0]:
            raise AssertionError(f"the sharded step's loss is not finite and falling: {sl}")
        if max(loss_rel) > FFN_LOSS_RTOL or max(upd.values()) > FFN_UPDATE_REL_L2:
            raise AssertionError("the sharded step differs from train_step")
        if ffn_launches["single_k_wgmma"] <= 0 or ffn_launches["multi_k_wgmma"] <= 0:
            raise AssertionError(f"the sharded step did not run the single-K and multi-K "
                                 f"wgmma bodies: {ffn_launches}")

        # the sharded step's ms against train_step's, back to back, in turns
        times = {"sharded": [], "single": []}
        for kind in ("single", "sharded", "sharded", "single"):
            fn = ((lambda: step(*blocks)) if kind == "sharded"
                  else (lambda: train_step(params, x, y, lr=FFN_SHARDED_LR)))
            times[kind].append(_time_ms(torch, fn, reps=10))
        rec["ffn"]["step_ms"] = times
        print(f"  step ms (CUDA events over 10 back-to-back steps, in turns): sharded "
              f"{json.dumps(times['sharded'])}, train_step {json.dumps(times['single'])} "
              f"({nvidia_smi_name_power()})")
        rec["ffn"]["profile"] = {
            "sharded": profiling.profile_step(lambda: step(*blocks)),
            "single": profiling.profile_step(
                lambda: train_step(params, x, y, lr=FFN_SHARDED_LR))}
        for kind, prof in rec["ffn"]["profile"].items():
            print(f"  profile_step {kind}: wall {prof['wall_ms']:.3f} ms (unprofiled "
                  f"{prof['wall_ms_unprofiled']:.3f}), device busy {prof['device_busy_ms']} "
                  f"ms, idle share {prof['idle_share']}")
            print(f"    top device ops {json.dumps(prof['top_device_ops'][:6])}")
            print(f"    top host ops {json.dumps(prof['top_host_ops'][:6])}")
    finally:
        dist.destroy_process_group()
    return rec, launches


#: Phase campaign's shapes: the heuristic's multi-K (4096^3) and single-K (FFN-1's
#: 512x4096x1024) wgmma routes, and the skinny serving shape through the committed DB.
CAMPAIGN_HEURISTIC_SHAPES = [(4096, 4096, 4096), (512, 4096, 1024)]
CAMPAIGN_DB_SHAPE = (64, 8192, 8192)
#: Host-bound suite shapes (bench.py's DEFAULT_SHAPES) where the stream check's honest
#: spread is read, through the committed DB.
SPREAD_SHAPES = [(8192, 128, 64), (64, 64, 4096), (1024, 64, 64), (256, 256, 256)]
#: The heal's shape: FFN-1's product, where the heuristic's single-K tile runs at 0.35x
#: torch.matmul by device time (PERF.md), on a DB copy with no entry for it.
HEAL_SHAPE = (512, 4096, 1024)
#: Lean rows of phase campaign: the stratified grid's first shapes, and the big squares.
LEAN_PREFIX = 24
LEAN_EXTRA = [(4096, 4096, 4096), (16384, 16384, 16384)]
#: The order of the lean and _run_mode reads at 4096^3 (ABBA: neither engine always first).
LEAN_VS_RUN_MODE_TURNS = ("lean", "run_mode", "run_mode", "lean", "lean", "run_mode")


def _stream_numbers(res: dict) -> dict:
    d = next(d for d in res["defenses"] if d["name"] == "stream_injection")
    return {key: d[key] for key in ("event_ms", "sync_ms", "ratio", "floor_ms",
                                    "runs_flagged")}


def _heal_demo(campaign, out: Path, db_path: Path, shape: tuple) -> dict:
    """A lean row of ``shape`` through a DB with no entry for it, then two heal runs: the
    first drops the losing row (the repair journal), measures it again, stores a screened
    vendor config and publishes the re-measured row; the second finds the journal's
    budget spent.  Returns the rows before and after, the entries and the journal."""
    import json

    mnk = "x".join(map(str, shape))
    sidecar = campaign.sidecar_path(out, "offline")

    def last() -> dict:
        return json.loads(sidecar.read_text().splitlines()[-1])

    campaign.run_campaign([shape], out, db_path=db_path)
    before = last()
    campaign.run_campaign([shape], out, db_path=db_path, heal=True)
    after = last()
    campaign.run_campaign([shape], out, db_path=db_path, heal=True)
    db = json.loads(db_path.read_text())["entries"]
    journals = {acc: json.loads(Path(str(campaign.suite.csv_path(out, acc, "offline"))
                                     + ".repairs.json").read_text())
                for acc in ("float32", "bfloat16")}
    return {"mnk": mnk, "before": {key: before[key] for key in ("speedups", "configs",
                                                                "launches")},
            "after": {key: after[key] for key in ("speedups", "configs", "launches",
                                                  "healed", "remeasured_after_heal")},
            "entries": {acc: db.get(f"{shape[0]}_{shape[1]}_{shape[2]}/{acc}/bfloat16")
                        for acc in ("float32", "bfloat16")},
            "journals": journals}


def _campaign_phase(torch, repo: Path, counters, zero_counters, use_db) -> tuple:
    """Phase campaign: the integrity defenses on the honest candidate and on five cheats,
    each CLI subcommand (the first as a subprocess), the lean engine over a prefix of the stratified
    grid (and its agreement with ``_run_mode`` at 4096^3), and the heal at FFN-1's shape.
    Returns (record, the launches of the phase)."""
    import json
    import shutil
    import subprocess
    import threading

    import numpy as np

    from tpul2_torch.autotune.db import TuneDB
    from tpul2_torch.dispatch import candidate_fn
    from tpul2_torch.harness import bench_suite, campaign, defense, suite
    from tpul2_torch.harness.bench_offline import benchmark_offline_all
    from tpul2_torch.harness.bench_utils import fresh_inputs

    work = repo / "runs" / "chip_smoke" / "campaign"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    rec = {"defense": {"honest": [], "cheats": {}}}
    zero_counters()

    # ---- 1. defenses: the honest candidate passes every run, each cheat is flagged ----
    def honest(shape, acc, label, runs=3):
        data = fresh_inputs(np.random.default_rng(0), *shape)
        for r in range(runs):
            res = defense.run_all_defenses(candidate_fn(acc), data)
            row = {"mnk": list(shape), "acc": acc, "db": label, "run": r,
                   "pass": res["pass"], "failed": [d["name"] for d in res["defenses"]
                                                   if not d["pass"]],
                   **_stream_numbers(res)}
            rec["defense"]["honest"].append(row)
            print("  honest " + json.dumps(row))
            if not res["pass"]:
                raise AssertionError(f"the honest candidate failed a defense: {res}")

    use_db("heuristic")
    for shape in CAMPAIGN_HEURISTIC_SHAPES:
        for acc in ("float32", "bfloat16"):
            honest(shape, acc, "heuristic")
    use_db("committed")
    for acc in ("float32", "bfloat16"):
        honest(CAMPAIGN_DB_SHAPE, acc, "committed")
    # the stream check's honest spread at the host-bound suite shapes (the floor's reason)
    spread = []
    for shape in SPREAD_SHAPES:
        res = defense.defend_against_stream_injection(
            candidate_fn("float32"), fresh_inputs(np.random.default_rng(0), *shape), runs=5)
        spread.append({"mnk": list(shape), "pass": res["pass"],
                       "hidden_ms": [r["hidden_ms"] for r in res["runs"]],
                       "event_ms": res["event_ms"], "sync_ms": res["sync_ms"],
                       "sync_cost_ms": [r["sync_cost_ms"] for r in res["runs"]]})
        print("  honest spread " + json.dumps(spread[-1]))
        if not res["pass"]:
            raise AssertionError(f"the honest candidate failed the stream check: {res}")
    rec["defense"]["honest_spread"] = spread
    rec["defense"]["honest_max_hidden_ms"] = max(
        max(r["hidden_ms"]) for r in spread + [{"hidden_ms": [0.0]}])
    use_db("heuristic")
    data = fresh_inputs(np.random.default_rng(0), 4096, 4096, 4096)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        res = defense.run_all_defenses(candidate_fn("float32"), data)
    torch.cuda.synchronize()
    row = {"mnk": [4096] * 3, "acc": "float32", "stream": "side", "pass": res["pass"],
           **_stream_numbers(res)}
    rec["defense"]["honest_side_stream"] = row
    print("  honest on a side stream " + json.dumps(row))
    if not res["pass"]:
        raise AssertionError(f"the honest candidate failed a defense on a side stream: {res}")

    cheat_stream = torch.cuda.Stream()

    def stream_cheat(a, b, b_t):  # the product on a side stream, returned with no wait
        cheat_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(cheat_stream):
            return torch.matmul(a, b)

    def thread_cheat(a, b, b_t):  # leaves a helper thread running
        threading.Thread(target=time.sleep, args=(3.0,), daemon=True).start()
        return torch.matmul(a, b)

    class Lazy(torch.Tensor):
        pass

    def subclass_cheat(a, b, b_t):
        return torch.matmul(a, b).as_subclass(Lazy)

    def meta_cheat(a, b, b_t):
        return torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device="meta")

    def fp16_cheat(a, b, b_t):
        return torch.matmul(a, b).half()

    big = fresh_inputs(np.random.default_rng(1), 8192, 8192, 8192)
    cheats = [("stream_injection", "side-stream GEMM at 8192^3", stream_cheat, big),
              ("thread_injection", "helper thread", thread_cheat, data),
              ("lazy_evaluation", "Tensor subclass", subclass_cheat, data),
              ("lazy_evaluation", "meta output", meta_cheat, data),
              ("precision_downgrade", "fp16 output", fp16_cheat, data)]
    for check, label, fn, args in cheats:
        res = defense.run_all_defenses(fn, args)
        flagged = [d["name"] for d in res["defenses"] if not d["pass"]]
        row = {"check": check, "flagged_by": flagged, **_stream_numbers(res)}
        rec["defense"]["cheats"][label] = row
        print(f"  cheat {label}: " + json.dumps(row))
        if res["pass"] or check not in flagged:
            raise AssertionError(f"the {label} cheat was not flagged by {check}: {res}")
    # where the floor bites: the same cheat at smaller products (reported, not required)
    rec["defense"]["stream_cheat_sizes"] = []
    for size in (1024, 2048, 4096):
        res = defense.defend_against_stream_injection(
            stream_cheat, fresh_inputs(np.random.default_rng(2), size, size, size))
        row = {"mnk": [size] * 3, "flagged": not res["pass"],
               **{key: res[key] for key in ("event_ms", "sync_ms", "ratio", "runs_flagged")}}
        rec["defense"]["stream_cheat_sizes"].append(row)
        print("  stream cheat at a smaller product " + json.dumps(row))
    original = torch.cuda.Event.elapsed_time
    torch.cuda.Event.elapsed_time = lambda self, end: 1e-3
    try:
        res = defense.run_all_defenses(candidate_fn("float32"), data)
    finally:
        torch.cuda.Event.elapsed_time = original
    flagged = [d["name"] for d in res["defenses"] if not d["pass"]]
    rec["defense"]["cheats"]["patched Event.elapsed_time"] = {
        "check": "monkey_patching", "flagged_by": flagged, **_stream_numbers(res)}
    print("  cheat patched Event.elapsed_time: flagged by " + json.dumps(flagged))
    if res["pass"] or "monkey_patching" not in flagged or \
            not defense.defend_against_monkey_patching()["pass"]:
        raise AssertionError(f"the patched elapsed_time was not flagged or not restored: {res}")
    del big

    # ---- 2. the CLI: each subcommand once at 1000^3; the first as a subprocess (the
    # `python -m` entry), the others through the same main() in this process, which saves
    # a process start (~8 s on the card's host) each ----
    shape = ["--mnk", "1000", "1000", "1000"]
    base = work / "cli"
    cmds = {
        "correctness": ["correctness", *shape, "--iterations", "3", "--seconds", "30"],
        "offline": ["offline", *shape, "--perf_func", "torch_matmul", "--warmup_seconds",
                    "0.2", "--benchmark_seconds", "0.5", "--base_dir", str(base)],
        "server": ["server", *shape, "--perf_func", "cublaslt_autotuned_nn", "--target_qps",
                   "100", "--warmup_seconds", "0.2", "--benchmark_seconds", "0.5",
                   "--base_dir", str(base / "server")],
        "profile": ["profile", *shape, "--trials", "3"],
        "summarize": ["summarize", "--base_dir", str(base)],
        "defend": ["defend", *shape],
    }
    from tpul2_torch.harness import __main__ as harness_cli
    rec["cli"] = {}
    t0 = time.perf_counter()
    for i, (name, argv) in enumerate(cmds.items()):
        t1 = time.perf_counter()
        if i == 0:
            proc = subprocess.run([sys.executable, "-m", "tpul2_torch.harness", *argv],
                                  cwd=repo, capture_output=True, text=True, timeout=300)
            rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        else:
            printed, errs = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(errs):
                rc = harness_cli.main(argv)
            stdout, stderr = printed.getvalue(), errs.getvalue()
        try:
            out = json.loads(stdout)
        except json.JSONDecodeError:
            out = None
        rec["cli"][name] = {"rc": rc, "json": out is not None, "subprocess": i == 0,
                            "seconds": time.perf_counter() - t1}
        print(f"  cli {name}{' (subprocess)' if i == 0 else ''}: rc {rc}, JSON "
              f"{out is not None}, {rec['cli'][name]['seconds']:.1f} s")
        if rc != 0 or out is None:
            raise AssertionError(f"python -m tpul2_torch.harness {name} failed:\n"
                                 f"{stdout[-2000:]}\n{stderr[-4000:]}")
    rec["cli_seconds"] = time.perf_counter() - t0

    # ---- 3. the lean engine ----
    shapes = suite.grid(suite.REFERENCE_DIMS, order="stratified")[:LEAN_PREFIX] + LEAN_EXTRA
    lean_dir = work / "lean"
    rec["lean"] = {}
    for mode, todo in (("offline", shapes), ("server", shapes[:4])):
        summary = campaign.run_campaign(todo, lean_dir, mode=mode, target_qps=100.0,
                                        db_path=campaign.COMMITTED_DB)
        times = summary["shape_seconds"]
        if summary["rows"] != len(todo) or summary["failed"]:
            raise AssertionError(f"lean {mode}: {summary}")
        rows = {acc: suite.done_shapes(suite.csv_path(lean_dir, acc, mode))
                for acc in ("float32", "bfloat16")}
        if any(len(r) != len(todo) for r in rows.values()):
            raise AssertionError(f"lean {mode}: rows missing {rows}")
        rec["lean"][mode] = {"rows": summary["rows"], "seconds": summary["seconds"],
                             "seconds_per_shape": sum(times.values()) / len(times),
                             "shape_seconds": times}
        print(f"  lean {mode}: {summary['rows']} shapes x 2 families in "
              f"{summary['seconds']:.1f} s ({rec['lean'][mode]['seconds_per_shape']:.2f} s "
              "per shape): " + json.dumps({k: round(v, 2) for k, v in times.items()}))
        for acc in ("float32", "bfloat16"):
            text = suite.csv_path(lean_dir, acc, mode).read_text()
            rec["lean"][mode][f"csv_{acc}"] = text
    use_db("heuristic")
    # the pair is read in turns (ABBA), each loop with every baseline, so that the two
    # loops interleave the same calls and the check's margin is a measured spread
    reads = {"lean": [], "run_mode": []}
    for turn in LEAN_VS_RUN_MODE_TURNS:
        if turn == "lean":
            lean = bench_suite.eval_shape_lean(4096, 4096, 4096, accs=("float32",))
            reads["lean"].append(lean["speedups"]["float32"]["torch_matmul"])
        else:
            run_mode = benchmark_offline_all(4096, 4096, 4096, warmup_seconds=0.5,
                                             benchmark_seconds=3.0)
            reads["run_mode"].append(run_mode["torch_matmul"]["speedup"])
    sp_lean = float(np.median(reads["lean"]))
    sp_rm = float(np.median(reads["run_mode"]))
    rec["lean_vs_run_mode_4096"] = {
        "turns": list(LEAN_VS_RUN_MODE_TURNS), "reads": reads,
        "lean_speedup": sp_lean, "run_mode_speedup": sp_rm,
        "apart": abs(sp_lean / sp_rm - 1.0),
        # (max - min) / median of each engine's reads
        "spread": {name: (max(v) - min(v)) / float(np.median(v)) for name, v in reads.items()},
        "lean_ms": {k: lean["per_func"][k]["ms"] for k in ("torch_matmul",
                                                           "tpul2_torch_float32")},
        "run_mode_ms": {"torch_matmul": run_mode["torch_matmul"]["torch_matmul"]["per_call_ms"],
                        "tpul2_torch": run_mode["torch_matmul"]["tpul2_torch"]["per_call_ms"]},
        "lean_launches": lean["launches"]}
    print("  4096^3 through the heuristic, speedup vs torch.matmul (median of "
          f"{len(reads['lean'])} reads in turns): lean {sp_lean:.4f}, _run_mode {sp_rm:.4f} "
          + json.dumps(rec["lean_vs_run_mode_4096"]))
    if abs(sp_lean / sp_rm - 1.0) > 0.10:
        raise AssertionError("the lean engine and _run_mode disagree by more than 10% at "
                             "4096^3")

    # ---- 4. the heal, on a DB copy with no entry for the shape ----
    heal_db = work / "tunedb_heal.json"
    shutil.copy(campaign.COMMITTED_DB, heal_db)
    entries = json.loads(heal_db.read_text())
    for acc in ("float32", "bfloat16"):
        entries["entries"].pop(f"{HEAL_SHAPE[0]}_{HEAL_SHAPE[1]}_{HEAL_SHAPE[2]}/{acc}/"
                               "bfloat16", None)
    heal_db.write_text(json.dumps(entries, indent=1, sort_keys=True))
    demo = _heal_demo(campaign, work / "heal", heal_db, HEAL_SHAPE)
    if any(demo["before"]["speedups"][acc]["torch_matmul"] >= 0.97
           for acc in ("float32", "bfloat16")):
        # the shape did not lose: heal the kernel-route lean row that loses the most
        lean_rows = [json.loads(ln) for ln in campaign.sidecar_path(
            lean_dir, "offline").read_text().splitlines()]
        worst = min((r for r in lean_rows if r["launches"]),
                    key=lambda r: max(r["speedups"][a]["torch_matmul"]
                                      for a in ("float32", "bfloat16")))
        print(f"  {demo['mnk']} did not lose ({demo['before']['speedups']}); healing "
              f"{worst['mnk']} instead")
        rec["heal_first_choice"] = demo
        demo = _heal_demo(campaign, work / "heal_fallback", heal_db,
                          tuple(int(x) for x in worst["mnk"].split("x")))
    rec["heal"] = demo
    for acc in ("float32", "bfloat16"):
        b = demo["before"]["speedups"][acc]["torch_matmul"]
        a = demo["after"]["speedups"][acc]["torch_matmul"]
        entry = demo["entries"][acc]
        print(f"  heal {demo['mnk']} {acc}: torch.matmul speedup {b:.4f} -> {a:.4f}; row "
              f"before " + json.dumps(demo["before"]["speedups"][acc]) + " after "
              + json.dumps(demo["after"]["speedups"][acc]) + f"; entry {entry['config']}")
        if not any(k.startswith("single_k") or k.startswith("multi_k")
                   for k in demo["before"]["launches"]):
            raise AssertionError(f"the row before the heal launched no kernel: {demo}")
        if b >= 0.97:
            raise AssertionError(f"the row before the heal does not lose ({acc}): {demo}")
        if not entry["config"]["use_vendor"] or entry["scope"] != "heal_demote":
            raise AssertionError(f"the heal stored no screened vendor config ({acc}): {entry}")
        if demo["after"]["launches"] or not demo["after"]["remeasured_after_heal"]:
            raise AssertionError(f"the re-measured row launched a kernel: {demo['after']}")
        if a <= b:
            raise AssertionError(f"the healed row is not faster ({acc}): {b} -> {a}")
        journal = demo["journals"][acc]
        if list(journal) != [demo["mnk"]] or journal[demo["mnk"]]["loss"] != 1:
            raise AssertionError(f"the repair journal does not hold the shape once: {journal}")

    # the uncompilable-entry probe launches a stored staged config, and keeps it
    from tpul2_torch.config import candidate_configs
    staged = next(c for c in candidate_configs(*TUNE_SHAPE, max_candidates=8)
                  if c.pipeline_depth >= 2)
    probe_db = TuneDB(path=work / "tunedb_probe.json")
    for acc in ("float32", "bfloat16"):
        probe_db.put(*TUNE_SHAPE, dataclasses.replace(staged, acc_dtype=acc), 0.0, acc=acc)
    demoted = bench_suite.demote_uncompilable_entries(probe_db, *TUNE_SHAPE,
                                                      ["float32", "bfloat16"])
    rec["uncompilable_probe"] = {"mnk": list(TUNE_SHAPE), "config": dataclasses.asdict(staged),
                                 "demoted": demoted}
    print(f"  stored staged config {staged} at {TUNE_SHAPE} probed on the card: demoted "
          f"{demoted}")
    if demoted:
        raise AssertionError("the probe demoted a staged config that runs")
    launches = counters()
    rec["launches"] = launches
    print("  launches " + json.dumps(launches))
    for key in ("multi_k_wgmma", "single_k_wgmma", "staged_ring"):
        if launches[key] <= 0:
            raise AssertionError(f"phase campaign launched no {key}")
    return rec, launches


#: Phase grid tune: the stratified grid's first shapes (one per band) and two shapes that
#: ran the heuristic kernel in the no-heal grid; the tuner's reduced budget; the gate's.
GRID_TUNE_PREFIX = 4
GRID_TUNE_EXTRA = [(2048, 2048, 2048), (1024, 8192, 2048)]
GRID_TUNE_FIRST = 3
GRID_TUNE_BUDGET = ["--max_candidates", "8", "--stage1_rounds", "3", "--stage2_rounds", "5",
                    "--finalists", "4"]
GRID_GATE_BUDGET_S = 60.0


def _grid_tune_phase(repo: Path, counters, zero_counters) -> tuple:
    """Phase grid tune: tune a grid prefix into a DB copy and resume, seed the rest of the
    grid, gate the copy's kernel entries on the card, and run the tuned shapes through the
    lean engine through the committed DB and through the copy.  Returns (record, the
    launches of the phase)."""
    import json
    import shutil
    import statistics

    from tpul2_torch.autotune import db as db_mod
    from tpul2_torch.dispatch import resolve_config
    from tpul2_torch.harness import campaign, suite

    t_phase = time.perf_counter()
    work = repo / "runs" / "chip_smoke" / "gridtune"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    db_path = repo / "runs" / "chip_smoke" / "gridtune_db.json"
    shutil.copy(campaign.COMMITTED_DB, db_path)
    run_suite, seed, gate = (_script(repo, name) for name in (
        "run_suite_torch", "seed_tail_entries_torch", "correctness_campaign_torch"))

    def main_json(mod, argv, log=None) -> tuple:
        """The script's exit code and the JSON object of its last stdout line; its stderr
        goes to ``log`` where given (the gate prints a line per entry)."""
        printed, errs = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(
                errs if log else sys.stderr):
            rc = mod.main(argv)
        if log:
            with log.open("a") as f:
                f.write(errs.getvalue())
        return rc, json.loads(printed.getvalue().strip().splitlines()[-1])

    prefix = suite.grid(suite.REFERENCE_DIMS, order="stratified")[:GRID_TUNE_PREFIX]
    if len({suite.band(suite.mnk_name(*s)) for s in prefix}) != GRID_TUNE_PREFIX:
        raise AssertionError(f"the stratified prefix is not one shape per band: {prefix}")
    shapes = prefix + GRID_TUNE_EXTRA
    rec = {"shapes": [list(s) for s in shapes], "tune": [], "launches": {}}

    # ---- 1. tune the first shapes, then all of them: the second run tunes the new ones ----
    zero_counters()
    t0 = time.perf_counter()
    for todo in (shapes[:GRID_TUNE_FIRST], shapes):
        spec = ";".join(",".join(map(str, s)) for s in todo)
        for acc in ("float32", "bfloat16"):
            rc, out = main_json(run_suite, ["tune", "--db", str(db_path), "--shapes", spec,
                                            "--acc", acc, *GRID_TUNE_BUDGET])
            tuned = [tuple(t["mnk"]) for t in out["tuned"]]
            want = todo if len(todo) == GRID_TUNE_FIRST else shapes[GRID_TUNE_FIRST:]
            if rc != 0 or tuned != [tuple(s) for s in want]:
                raise AssertionError(f"tune ({acc}, {len(todo)} shapes) exited {rc} and tuned "
                                     f"{tuned}, not {want}")
            for t in out["tuned"]:
                b = t["best"]
                row = {"mnk": t["mnk"], "acc": acc, "speedup": t["speedup"],
                       "kernel_vs_torch_matmul": t["kernel_vs_torch_matmul"],
                       "seconds": t["seconds"],
                       "best": (f"vendor {b['vendor_variant']}" if b["use_vendor"] else
                                f"{b['bm']}x{b['bn']} bk={b['bk']} {b['rhs_layout']} "
                                f"depth={b['pipeline_depth']}")}
                rec["tune"].append(row)
                print("  tuned " + json.dumps(row))
    rec["tune_seconds"] = time.perf_counter() - t0
    launches = rec["launches"]["tune"] = counters()
    ring = sum(v for key, v in launches.items() if key != "mma_sync")
    print(f"  tune: {len(rec['tune'])} shapes x families tuned in {rec['tune_seconds']:.1f} s "
          f"({rec['tune_seconds'] / len(rec['tune']):.2f} s each); launches "
          + json.dumps(launches))
    if ring <= 0 or launches["mma_sync"]:
        raise AssertionError(f"the tune launched {ring} ring kernels and "
                             f"{launches['mma_sync']} mma.sync bodies")

    # ---- 2. seed the rest of the grid: dispatch's decisions are unchanged ----
    grid = suite.grid(suite.REFERENCE_DIMS)
    old_env = os.environ.get(db_mod.ENV_VAR)

    def decisions() -> dict:
        os.environ[db_mod.ENV_VAR] = str(db_path)
        db_mod.reset_default_db()
        try:
            return {(s, acc, mode): resolve_config(*s, acc, mode=mode) for s in grid
                    for acc in ("float32", "bfloat16") for mode in ("offline", "server")}
        finally:
            if old_env is None:
                os.environ.pop(db_mod.ENV_VAR)
            else:
                os.environ[db_mod.ENV_VAR] = old_env
            db_mod.reset_default_db()

    before = decisions()
    rc, out = main_json(seed, ["--db", str(db_path)])
    after = decisions()
    changed = [key for key in before if before[key] != after[key]]
    rec["seed"] = out
    print(f"  seed: {out['seeded']} entries {json.dumps(out['counts'])} in "
          f"{out['seconds']:.3f} s; DB {out['entries_before']} -> {out['entries_after']}; "
          f"resolve_config changed at {len(changed)} of {len(before)} grid decisions")
    if rc != 0 or changed or out["entries_after"] != 2 * len(grid):
        raise AssertionError(f"seeding exited {rc}, changed {changed[:5]}, {out}")

    # ---- 3. gate the copy's kernel entries on the card, then resume ----
    argv = ["--db", str(db_path), "--no_demote", "--order", "stratified", "--budget_s",
            str(GRID_GATE_BUDGET_S), "--jsonl", str(work / "gate.jsonl"), "--out",
            str(work / "gate.json")]
    zero_counters()
    log = work / "gate.log"
    rc, first = main_json(gate, argv, log)
    run = first["run"]
    rc2, second = main_json(gate, argv, log)
    launches = rec["launches"]["gate"] = counters()
    gated = [(r["mnk"], r["acc"]) for r in map(json.loads, (work / "gate.jsonl").read_text()
                                                 .splitlines())]
    rec["gate"] = {"first": first, "second": second["run"]}
    bands = collections.Counter(suite.band(mnk) for mnk, _ in gated)
    print(f"  gate: {run['checked']} of {first['total_kernel_entries']} kernel entries checked "
          f"in {run['seconds']:.1f} s ({run['seconds_per_entry']:.4f} s per entry), "
          f"{run['skipped_for_budget']} left for the budget; by band {json.dumps(bands)}; "
          f"failed {len(first['failed'])}, guard hits {first['guard_hits']}; the second "
          f"invocation checked {second['run']['checked']} ({len(gated)} records, "
          f"{len(set(gated))} entries); launches " + json.dumps(launches))
    if rc != 0 or first["failed"] or first["guard_hits"] or not run["checked"]:
        raise AssertionError(f"the gate failed: {first['failed'][:3]}\n"
                             + log.read_text()[-4000:])
    # the second run gates only what the first left for the budget, nothing twice
    again, left = second["run"]["checked"], run["skipped_for_budget"]
    if rc2 != 0 or len(gated) != len(set(gated)) or again > left:
        raise AssertionError(f"the resumed gate checked {again} entries after {left} were "
                             "left")
    if launches["mma_sync"]:
        raise AssertionError("the gate launched an mma.sync body")

    # ---- 4. the tuned shapes through the lean engine: the committed DB, then the copy ----
    zero_counters()
    rec["lean"] = {}
    for label, path in (("committed", campaign.COMMITTED_DB), ("tuned", db_path)):
        out_dir = work / f"lean_{label}"
        summary = campaign.run_campaign(shapes, out_dir, db_path=path)
        if summary["rows"] != len(shapes) or summary["failed"]:
            raise AssertionError(f"lean through the {label} DB: {summary}")
        rows = [json.loads(ln) for ln in
                campaign.sidecar_path(out_dir, "offline").read_text().splitlines()]
        rec["lean"][label] = {}
        for acc in ("float32", "bfloat16"):
            per = [{"mnk": r["mnk"], "source": r["config_source"][acc]["source"],
                    "scope": r["config_source"][acc].get("scope"),
                    "ran": "sentinel" if r["configs"][acc]["use_vendor"] else "kernel",
                    "speedup": r["speedups"][acc]["torch_matmul"]} for r in rows]
            geo = statistics.geometric_mean(p["speedup"] for p in per)
            rec["lean"][label][acc] = {"rows": per, "geomean_vs_torch_matmul": geo}
            print(f"  lean through the {label} DB, {acc}: geomean {geo:.4f}x torch.matmul; "
                  + "; ".join(f"{p['mnk']} {p['source']}"
                              + (f" ({p['scope']})" if p["scope"] else "")
                              + f" -> {p['ran']} {p['speedup']:.4f}" for p in per))
    launches = rec["launches"]["lean"] = counters()
    if launches["mma_sync"]:
        raise AssertionError("the lean rows launched an mma.sync body")
    total = {key: sum(part[key] for part in rec["launches"].values()) for key in launches}
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  phase grid tune: {rec['seconds']:.1f} s")
    return rec, total


#: Phase 3's entry-point calls with the wide variants: (batch, (m, n, k), config, A's offset
#: in elements): the bf16 family's carry with a resident and a streamed A, a 4096-row
#: block, batched at one interval and with a carry, and the loads producer (K % 8 != 0 and
#: an A base 2 bytes off 16) 2-D and batched, one interval and a carry; then the JAX
#: space's edges: a ring block narrower than its tile (bm 16, 2-D, and 16 x 16 batched),
#: the swapped wide walk (bm 16, the bf16 carry), narrow columns (bn 64 beside bm 256), an
#: unaligned cover (200 x 300) and bn above 16384.
PHASE3_WIDE = [
    (1, (512, 1024, 512), dict(bm=256, bn=512, bk=128, acc_dtype="bfloat16"), 0),
    (1, (512, 1024, 2048), dict(bm=256, bn=1024, bk=512, acc_dtype="bfloat16"), 0),
    (1, (4096, 256, 64), dict(bm=4096, bn=256, bk=64), 0),
    (2, (256, 1024, 512), dict(bm=256, bn=512, bk=512), 0),
    (2, (256, 1024, 512), dict(bm=256, bn=512, bk=256, acc_dtype="bfloat16"), 0),
    (1, (300, 1024, 1001), dict(bm=256, bn=512, bk=1024), 0),
    (1, (300, 1024, 512), dict(bm=256, bn=512, bk=128), 1),
    (2, (300, 1024, 1001), dict(bm=256, bn=512, bk=1024), 0),
    (2, (300, 1024, 1001), dict(bm=256, bn=512, bk=256, acc_dtype="bfloat16"), 0),
    (1, (48, 300, 256), dict(bm=16, bn=128, bk=128), 0),
    (8, (16, 16, 128), dict(bm=16, bn=16, bk=128), 0),
    (1, (16, 1024, 512), dict(bm=16, bn=512, bk=128, acc_dtype="bfloat16"), 0),
    (1, (512, 64, 64), dict(bm=256, bn=64, bk=64), 0),
    (1, (300, 500, 256), dict(bm=200, bn=300, bk=128), 0),
    (1, (64, 16512, 64), dict(bm=64, bn=16512, bk=64), 0),
]
#: Phase thin-K: the write-allocate probe's bytes, its passes of each kind, and the wide
#: route's cases against its plain version: (name, m, n, k, cfg kwargs, activation, out
#: dtype name).  The bm > 128 walks, both layouts and output dtypes, bias + gelu and the
#: TMA-clipped edges (M, N not multiples of the block) are among them.
WA_BYTES = 1 << 31
WA_PASSES = 10
THIN_K_CASES = [
    ("16384x16384x64 kn bf16", 16384, 16384, 64, dict(bm=128, bn=2048), None, "bfloat16"),
    ("8192x16384x512 nk bias+gelu", 8192, 16384, 512,
     dict(bm=128, bn=1024, rhs_layout="nk"), "gelu", "bfloat16"),
    ("4096x16384x128 f32 out, bm 512 walk", 4096, 16384, 128, dict(bm=512, bn=512), None,
     "float32"),
    ("1024x2048x256 nk f32, bm 1024 walk", 1024, 2048, 256,
     dict(bm=1024, bn=256, rhs_layout="nk", grid_order="nm"), "silu", "float32"),
    ("1000x1000x200 clipped edges", 1000, 1000, 200, dict(bm=256, bn=384), "tanh", "bfloat16"),
    ("200x264x128 bm 64, clipped", 200, 264, 128, dict(bm=64, bn=256, rhs_layout="nk"),
     "relu", "float32"),
]
#: Phase thin-K (c): the wide block timed at each shape (the JAX space's stripes).
THIN_K_TIMED = [((16384, 16384, 64), dict(bm=128, bn=2048)),
                ((8192, 8192, 256), dict(bm=128, bn=1024))]
#: Phase thin-K (e): the retune's targets, its search and its budget.
THIN_K_RETUNE_TARGETS = 6
THIN_K_RETUNE = ["--max_candidates", "12", "--finalists", "3", "--stage1_rounds", "2",
                 "--stage2_rounds", "4", "--budget_s", "40"]


def _write_allocate(torch) -> dict:
    """(a): GB/s of a write-only pass (fill) and a read-only pass (sum) over the same
    WA_BYTES, in turns (write, read, read, write, write, read), WA_PASSES passes a turn
    between CUDA events after a warm-up; the medians of each kind and their ratio: the
    output's write-allocate factor (read GB/s over write GB/s)."""
    import statistics
    buf = torch.empty(WA_BYTES // 4, dtype=torch.float32, device="cuda")
    fns = {"write": lambda: buf.fill_(1.0), "read": lambda: buf.sum()}
    turns = {"write": [], "read": []}
    for fn in fns.values():
        fn()
    for name in ("write", "read", "read", "write", "write", "read"):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(WA_PASSES):
            fns[name]()
        end.record()
        end.synchronize()
        turns[name].append(WA_BYTES * WA_PASSES / (start.elapsed_time(end) * 1e-3) / 1e9)
    del buf
    rates = {f"{name}_gb_s": statistics.median(v) for name, v in turns.items()}
    rates.update(bytes=WA_BYTES, turns_gb_s=turns,
                 wa_factor=rates["read_gb_s"] / rates["write_gb_s"])
    return rates


def _thin_k_phase(torch, repo: Path, lib, mods, counters, zero_counters, host_time) -> tuple:
    """Phase thin-K: (a) the write-allocate factor, (b) the wide route against its plain
    version, (c) its time alone beside the 128 x 128 single-K ring, torch.matmul and the
    bound, (d) scripts/thin_k_report_torch.py on the committed no-heal grid in both
    families, (e) scripts/retune_thin_k_torch.py over the report's largest targets into a
    copy of the committed DB, then the lean engine over the retuned shapes through the
    committed DB and the copy.  Returns (record, kernel rows, their counter keys, the
    launches of (e))."""
    import shutil

    from tpul2_torch.config import wide_streams, wide_walk
    from tpul2_torch.harness import campaign
    from tpul2_torch.ops._build import check_launch
    KernelConfig, mm, _ = mods
    t_phase = time.perf_counter()
    rec = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    work = repo / "runs" / "chip_smoke" / "thin_k"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # ---- (a) the write-allocate factor ----
    rec["write_allocate"] = _write_allocate(torch)
    wa = rec["write_allocate"]
    print(f"  (a) {WA_BYTES} bytes, {WA_PASSES} passes a turn, medians of 3: write-only "
          f"{wa['write_gb_s']:.1f} GB/s, read-only {wa['read_gb_s']:.1f} GB/s; write-allocate "
          f"factor {wa['wa_factor']:.4f}; turns {json.dumps(wa['turns_gb_s'])}")

    # ---- (b) the wide route against its plain version ----
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    before = counters()["single_k_wgmma_wide"]
    rec["cases"] = []
    max_err = 0.0
    seconds_of = []
    for name, m, n, k, kw, act, out_name in THIN_K_CASES:
        cfg = KernelConfig(bk=-(-k // 32) * 32, **kw)
        errs = []
        for zero_one in (True, False):
            err, _ = _check_case(torch, mods, gen, 1, m, n, k, cfg, act, out_name, zero_one,
                                 witness=(lib, seconds_of))
            errs.append(err)
        max_err = max(max_err, errs[1])
        rec["cases"].append({"name": name, "config": dataclasses.asdict(cfg),
                             "zero_one_diff": errs[0], "normal_max_abs_err": errs[1]})
        print(f"  (b) {name} {cfg.bm}x{cfg.bn} bk={cfg.bk}: 0/1 diff {errs[0]}, normal max "
              f"|diff| {errs[1]:.6g} within allowed_error")
    print(f"  (b) {len(seconds_of)} of them bit-identical at a second CTA count {seconds_of}")
    rec["bit_identical_launches"] = len(seconds_of)
    launched = counters()["single_k_wgmma_wide"] - before
    if launched != 2 * len(THIN_K_CASES):
        raise AssertionError(f"the wide route launched {launched} times for "
                             f"{2 * len(THIN_K_CASES)} checks")
    rec["max_abs_err"] = max_err

    # ---- (c) alone: the wide block, the 128 x 128 single-K ring, torch.matmul ----
    rows, keys = [], []
    rec["timed"] = []
    for (m, n, k), kw in THIN_K_TIMED:
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        wide, ring = KernelConfig(bk=k, **kw), KernelConfig(bm=128, bn=128, bk=k)
        routes = (mm.launch_route(wide, a, b, m, n, k), mm.launch_route(ring, a, b, m, n, k))
        if routes != ("wgmma_wide", "wgmma"):
            raise AssertionError(f"the timed configs take {routes} at {m}x{n}x{k}")

        def direct(cfg, a=a, b=b, out=out, m=m, n=n, k=k):
            def make():  # the arguments name the capturing stream
                call = mm.launch_args(a, b, cfg, out, None, None, 1, m, n, k)
                return lambda: check_launch(lib.tl2_wgmma_bf16out(*call), "tl2_wgmma")
            return make

        def make_blocks(a=a, b=b, out=out, cfg=wide, m=m, n=n, k=k):
            walk = wide_walk(m, n, cfg.bm, cfg.bn)
            return lambda: _witness_launch(torch, lib, mm, a, b, cfg, out, None, None, 1, m, n,
                                           k, walk.items // (walk.strips * walk.cols))

        turns = [host_time.alone_ms(torch, direct(cfg)) for cfg in (wide, ring, ring, wide)]
        _, per_block = _timed_turns(torch, host_time, direct(wide), make_blocks)
        bound_ms, bound_by = _bound(1, m, n, k)
        library = host_time.alone_ms(torch, lambda: (lambda: torch.matmul(a, b)))
        row = {"mnk": [m, n, k], "wide": f"{wide.bm}x{wide.bn} bk={k}", "turns_ms": turns,
               "wide_ms": (turns[0] + turns[3]) / 2,
               "ring_128x128_ms": (turns[1] + turns[2]) / 2, "torch_alone_ms": library,
               "ctas": min(wide_walk(m, n, wide.bm, wide.bn).items, sms),
               "one_cta_a_block_ms": per_block,
               "plain_ms": _time_ms(torch, lambda: mm.matmul_reference(a, b, k), reps=5),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rec["timed"].append(row)
        print(f"  (c) {m}x{n}x{k} alone in turns (wide, ring, ring, wide) ms: "
              f"{json.dumps(turns)}; the wide block at {row['ctas']} CTAs, at one CTA a block "
              f"{per_block:.5f}; torch.matmul {row['torch_alone_ms']:.5f}, plain "
              f"{row['plain_ms']:.5f}, bound {bound_ms:.5f} ({bound_by})")
        common = {"route": "cuda", "replaces": "tpul2/ops/matmul.py:136",
                  "plain_ms": row["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": row["torch_alone_ms"]}
        source = ("tl2_wgmma_wide_stream.cu" if wide_streams(wide.bm, k, True)
                  else "tl2_wgmma_wide.cu")  # TMA reads A: streamed at thin K
        rows.append({"name": f"tl2_wgmma_wide (single-K, {row['wide']}, {m}x{n}x{k})",
                     "source": f"tpul2_torch/csrc/{source}", "max_abs_err": max_err,
                     "ms": row["wide_ms"], **common})
        keys.append("single_k_wgmma_wide")
        if (m, n, k) == THIN_K_TIMED[0][0]:
            check_launch(lib.tl2_wgmma_bf16out(*mm.launch_args(a, b, ring, out, None, None, 1,
                                                               m, n, k)), "tl2_wgmma")
            torch.cuda.synchronize()
            err = (out.float() - mm.matmul_reference(a, b, k).float()).abs().max().item()
            rows.append({"name": f"tl2_wgmma (single-K, 128x128, {m}x{n}x{k})",
                         "source": _ring_source(ring, "wgmma"), "max_abs_err": err,
                         "ms": row["ring_128x128_ms"], **common})
            keys.append("single_k_wgmma")
        del a, b, out

    # ---- (d) the report on the committed no-heal grid ----
    report = _script(repo, "thin_k_report_torch")
    rec["report"] = {}
    targets = {}
    for acc in ("float32", "bfloat16"):
        path = work / f"targets_{acc}.txt"
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(io.StringIO()):
            rc = report.main(["--acc", acc, "--targets_out", str(path)])
        summary = json.loads(printed.getvalue().strip().splitlines()[-1])
        if rc != 0 or summary["rows"] != 300 or summary["missing"]:
            raise AssertionError(f"the report ({acc}) exited {rc}: {summary}")
        rec["report"][acc] = summary
        targets[acc] = [tuple(map(int, ln.split(","))) for ln in path.read_text().split()]
        print(f"  (d) report {acc}: {summary['rows']} thin-K rows, {summary['at_wall']} at the "
              f"wall, {summary['winning']} winning, {summary['targets']} targets "
              f"(wa_factor {summary['wa_factor']})")

    # ---- (e) the retune on a copy, then the lean engine through both DBs ----
    retune = _script(repo, "retune_thin_k_torch")
    db_path = work / "retune_db.json"
    shutil.copy(campaign.COMMITTED_DB, db_path)
    acc = "float32"
    # the largest outputs first (the band is bound by C's writes), the thinnest K among them
    largest = sorted(targets[acc], key=lambda s: (-s[0] * s[1], s[2], s))
    largest = largest[:THIN_K_RETUNE_TARGETS]
    target_file = work / "retune_targets.txt"
    target_file.write_text("".join(f"{m},{n},{k}\n" for m, n, k in largest))
    zero_counters()
    printed, errs = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(errs):
        rc = retune.main(["--targets", str(target_file), "--db", str(db_path), "--acc", acc,
                          *THIN_K_RETUNE])
    out = json.loads(printed.getvalue().strip().splitlines()[-1])
    (work / "retune.log").write_text(errs.getvalue())
    for ln in errs.getvalue().splitlines():
        print(f"  (e) {ln}")
    if rc != 0 or not out["retuned"] or out["failed"]:
        raise AssertionError(f"the retune exited {rc}: {out}")
    rec["retune"] = out
    shapes = [tuple(map(int, r["mnk"].split("x"))) for r in out["retuned"]]
    rec["lean"] = {}
    for label, path in (("committed", campaign.COMMITTED_DB), ("retuned", db_path)):
        out_dir = work / f"lean_{label}"
        summary = campaign.run_campaign(shapes, out_dir, accs=(acc,), db_path=path)
        if summary["rows"] != len(shapes) or summary["failed"]:
            raise AssertionError(f"lean through the {label} DB: {summary}")
        rows_lean = [json.loads(ln) for ln in
                     campaign.sidecar_path(out_dir, "offline").read_text().splitlines()]
        rec["lean"][label] = {r["mnk"]: {
            "speedup": r["speedups"][acc]["torch_matmul"],
            "kind": retune.config_kind(KernelConfig(**r["configs"][acc])),
            "config": retune.describe(KernelConfig(**r["configs"][acc]))} for r in rows_lean}
    for mnk, after in rec["lean"]["retuned"].items():
        prior = rec["lean"]["committed"][mnk]
        print(f"  (e) {mnk} {acc}: {prior['speedup']:.4f}x torch.matmul through the committed "
              f"DB ({prior['config']}) -> {after['speedup']:.4f}x through the retuned copy "
              f"({after['config']})")
    launches = rec["launches"] = counters()
    print("  (e) launches of the retune and the lean rows " + json.dumps(launches))
    if launches["single_k_wgmma_wide"] <= 0 or launches["mma_sync"]:
        raise AssertionError("the retune's path launched no wide block (or an mma.sync body)")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  phase thin-K: {rec['seconds']:.1f} s")
    return rec, rows, keys, launches


#: Phase wide (a): each variant of the wide route against its plain version: (name, batch,
#: m, n, k, cfg kwargs, activation, (A offset, RHS offset, out offset) in elements, its
#: route, its counter key), each in both output dtypes.
WIDE_CASES = [
    ("resident carry, bf16 family", 1, 1024, 2048, 512,
     dict(bm=1024, bn=2048, bk=256, acc_dtype="bfloat16"), None, (0, 0, 0), "wgmma_wide",
     "multi_k_wgmma_wide"),
    ("resident carry, f32 family, nk, bias + gelu", 1, 1024, 2048, 512,
     dict(bm=1024, bn=2048, bk=256, rhs_layout="nk"), "gelu", (0, 0, 0), "wgmma_wide",
     "multi_k_wgmma_wide"),
    ("streamed carry, f32 family (the JAX entry of 12288^3)", 1, 12288, 12288, 12288,
     dict(bm=512, bn=2048, bk=4096), None, (0, 0, 0), "wgmma_wide", "multi_k_wgmma_wide"),
    ("streamed carry, bf16 family, nk, bias + relu", 1, 2048, 2048, 2048,
     dict(bm=512, bn=1024, bk=512, acc_dtype="bfloat16", rhs_layout="nk"), "relu",
     (0, 0, 0), "wgmma_wide", "multi_k_wgmma_wide"),
    ("streamed single-K 1024^3", 1, 1024, 1024, 1024, dict(bm=1024, bn=1024, bk=1024),
     None, (0, 0, 0), "wgmma_wide", "single_k_wgmma_wide"),
    ("streamed single-K, bf16 family (one interval: the f32 sum)", 1, 1024, 1024, 1024,
     dict(bm=1024, bn=1024, bk=1024, acc_dtype="bfloat16"), None, (0, 0, 0), "wgmma_wide",
     "single_k_wgmma_wide"),
    ("mid-stage rounding bk 96, bf16 family", 1, 300, 520, 1000,
     dict(bm=256, bn=256, bk=96, acc_dtype="bfloat16"), None, (0, 0, 0), "wgmma_wide",
     "multi_k_wgmma_wide"),
    ("bm 16384", 1, 16384, 256, 128, dict(bm=16384, bn=256, bk=128), None, (0, 0, 0),
     "wgmma_wide", "single_k_wgmma_wide"),
    ("batched gk 1", 4, 1024, 2048, 512, dict(bm=1024, bn=2048, bk=512), None, (0, 0, 0),
     "wgmma_wide", "batched_single_k_wgmma_wide"),
    ("batched gk 2, bf16 family", 4, 1024, 2048, 512,
     dict(bm=1024, bn=2048, bk=256, acc_dtype="bfloat16"), None, (0, 0, 0), "wgmma_wide",
     "batched_multi_k_wgmma_wide"),
    ("loads producer: K = 60, kn", 1, 4096, 4096, 60, dict(bm=256, bn=1024, bk=64), None,
     (0, 0, 0), "wgmma_wide_lsu", "single_k_wgmma_wide_lsu"),
    ("loads producer, predicated stores: N = 4095", 1, 4096, 4095, 64,
     dict(bm=256, bn=1024, bk=64), "relu", (0, 0, 0), "wgmma_wide_lsu",
     "single_k_wgmma_wide_lsu"),
    ("loads producer: A 2 bytes off 16, streamed carry, bf16 family, nk", 1, 1000, 1024, 1500,
     dict(bm=256, bn=512, bk=256, acc_dtype="bfloat16", rhs_layout="nk"), None, (1, 0, 0),
     "wgmma_wide_lsu", "multi_k_wgmma_wide_lsu"),
    ("predicated stores: out= 2 elements off 16 bytes", 1, 1000, 1024, 200,
     dict(bm=256, bn=512, bk=224), "gelu", (0, 0, 2), "wgmma_wide_lsu",
     "single_k_wgmma_wide_lsu"),
    ("loads producer batched, K = 1001, carry", 3, 300, 1024, 1001,
     dict(bm=256, bn=512, bk=256), None, (0, 0, 0), "wgmma_wide_lsu",
     "batched_multi_k_wgmma_wide_lsu"),
]
#: Phase wide (c): the rows timed alone: (name, batch, m, n, k, cfg kwargs, A offset, out
#: dtype name, source file, the replaced Pallas function's file:line, counter key).
WIDE_TIMED = [
    ("K carry, resident A, 1024x2048 bk 256, bf16 family", 1, 1024, 2048, 512,
     dict(bm=1024, bn=2048, bk=256, acc_dtype="bfloat16"), 0, "bfloat16",
     "tl2_wgmma_wide_bf16.cu", "tpul2/ops/matmul.py:96", "multi_k_wgmma_wide"),
    ("K carry, streamed A, 512x2048 bk 4096, f32 family", 1, 12288, 12288, 12288,
     dict(bm=512, bn=2048, bk=4096), 0, "float32", "tl2_wgmma_wide_stream.cu",
     "tpul2/ops/matmul.py:96", "wide_streamed"),
    ("single-K, streamed A, 1024x1024", 1, 1024, 1024, 1024,
     dict(bm=1024, bn=1024, bk=1024), 0, "float32", "tl2_wgmma_wide_stream.cu",
     "tpul2/ops/matmul.py:136", "wide_streamed"),
    ("single-K, bm 16384, 16384x256", 1, 16384, 256, 128, dict(bm=16384, bn=256, bk=128), 0,
     "bfloat16", "tl2_wgmma_wide_stream.cu", "tpul2/ops/matmul.py:136", "wide_tall"),
    ("batched, gk 1, 1024x2048", 4, 1024, 2048, 512, dict(bm=1024, bn=2048, bk=512), 0,
     "bfloat16", "tl2_wgmma_wide.cu", "tpul2/ops/batched.py:40",
     "batched_single_k_wgmma_wide"),
    ("batched, gk 2, 1024x2048 bk 256, bf16 family", 4, 1024, 2048, 512,
     dict(bm=1024, bn=2048, bk=256, acc_dtype="bfloat16"), 0, "bfloat16",
     "tl2_wgmma_wide_bf16.cu", "tpul2/ops/batched.py:25", "batched_multi_k_wgmma_wide"),
    ("loads producer, K = 60, 256x1024", 1, 4096, 4096, 60, dict(bm=256, bn=1024, bk=64), 0,
     "bfloat16", "tl2_wgmma_wide_lsu.cu", "tpul2/ops/matmul.py:136",
     "single_k_wgmma_wide_lsu"),
    ("loads producer, A 2 bytes off 16, K carry, 256x1024 bk 256, bf16 family", 1, 4096,
     4096, 1024, dict(bm=256, bn=1024, bk=256, acc_dtype="bfloat16"), 1, "bfloat16",
     "tl2_wgmma_wide_lsu_bf16_stream.cu", "tpul2/ops/matmul.py:96", "multi_k_wgmma_wide_lsu"),
]
#: Phase wide (b): dispatch.batched_matmul through the DB copy at the JAX entries of these
#: shapes and families, batch WIDE_DB_BATCH; dispatch.matmul with A 2 bytes off 16 (the
#: loads producer) at these.
WIDE_DB_BATCHED = [((1024, 2048, 512), "bfloat16"), ((1024, 2048, 512), "float32"),
                   ((2048, 4096, 128), "float32"), ((1024, 1024, 1024), "float32")]
WIDE_DB_BATCH = 2
WIDE_DB_UNALIGNED = [((1024, 2048, 512), "bfloat16"), ((2048, 8192, 64), "float32"),
                     ((512, 12288, 512), "float32")]


def _timed_turns(torch, host_time, make, make_blocks) -> tuple:
    """A wide row alone (``host_time.alone_ms``) at the rule's CTA count and at one CTA a
    block, in turns (rule, blocks, blocks, rule): (the rule's two times, the mean of the
    other two)."""
    turns = [host_time.alone_ms(torch, fn) for fn in (make, make_blocks, make_blocks, make)]
    return [turns[0], turns[3]], (turns[1] + turns[2]) / 2


def _jax_db_entries(repo: Path, KernelConfig) -> list:
    """((m, n, k), acc, KernelConfig.from_jax(config)) of every kernel entry of the JAX
    package's tuned DB, read as data (tpul2/data/tunedb_v5e.json; no JAX import)."""
    entries = json.loads((repo / "tpul2" / "data" / "tunedb_v5e.json").read_text())["entries"]
    out = []
    for key, entry in sorted(entries.items()):
        if entry["config"].get("use_xla"):
            continue
        shape, acc = key.split("/")[:2]  # M_N_K / acc / input dtype
        out.append((tuple(map(int, shape.split("_"))), acc,
                    KernelConfig.from_jax(entry["config"])))
    return out


def _wide_phase(torch, repo: Path, lib, mods, counters, zero_counters, host_time) -> tuple:
    """Phase wide: the JAX space's wide blocks everywhere (tl2_wgmma_wide.cu and its
    instance files).  (a) each variant against its plain version, both output dtypes, and
    the loads producer forced on aligned operands against TMA's bits; (b) the main path: a
    DB copy of the JAX DB's kernel entries through scripts/correctness_campaign_torch.py
    --no_demote, then dispatch.matmul at each entry's shape through it (and batched
    dispatch, and the loads producer, at a few); (c) each new row alone in a CUDA graph
    beside torch.matmul / torch.bmm, the plain version and the bound.  Returns (record,
    kernel rows, their counter keys, the launches of (b))."""
    import shutil

    from tpul2_torch import config as config_mod
    from tpul2_torch import dispatch
    from tpul2_torch.autotune import db as db_mod
    from tpul2_torch.ops._build import check_launch
    KernelConfig, mm, bmm = mods
    t_phase = time.perf_counter()
    rec = {"cases": []}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    work = repo / "runs" / "chip_smoke" / "wide"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)

    # ---- (a) each variant against its plain version, and at a second CTA count ----
    seconds_of = []
    for name, batch, m, n, k, kw, act, offs, route, key in WIDE_CASES:
        cfg = KernelConfig(**kw)
        probe_a = _offset(torch, torch.zeros(8, dtype=torch.bfloat16, device="cuda"), offs[0])
        probe_c = _offset(torch, torch.zeros(8, device="cuda"), offs[2])
        got_route = mm.launch_route(cfg, probe_a, probe_a, m, n, k, probe_c if offs[2] else None)
        if got_route != route:
            raise AssertionError(f"{name}: route {got_route}, expected {route}")
        for out_name in ("bfloat16", "float32"):
            before = counters()[key]
            errs = []
            counts = []
            for zero_one in (True, False):
                err, witnessed = _check_case(torch, mods, gen, batch, m, n, k, cfg, act,
                                             out_name, zero_one, offs[:2], offs[2],
                                             witness=(lib, counts))
                errs.append(err)
            if counters()[key] - before != 2:
                raise AssertionError(f"{name}: {counters()[key] - before} launches on {key}")
            rule = config_mod.wide_ctas(m, n, cfg.bm, cfg.bn, batch, sms)
            seconds_of += counts
            rec["cases"].append({"name": name, "out": out_name, "config": kw, "route": route,
                                 "zero_one_diff": errs[0], "normal_max_abs_err": errs[1],
                                 "ring_order_witnessed": witnessed, "ctas": rule,
                                 "second_ctas": counts})
            print(f"  (a) {name} ({batch}x{m}x{n}x{k}, {cfg.bm}x{cfg.bn} bk={cfg.bk}, {route}, "
                  f"{out_name} out): 0/1 diff {errs[0]}, normal max |diff| {errs[1]:.6g} within "
                  f"allowed_error" + (f" ({witnessed} elements on the ring-order bits)"
                                      if witnessed else "")
                  + f"; {rule} CTAs, bit-identical at {counts}")
    print(f"  (a) {len(seconds_of)} wide launches bit-identical at the rule's CTA count and at "
          "a second count")
    rec["bit_identical_launches"] = len(seconds_of)
    # the loads producer forced on aligned operands (vec_a / vec_b = 0): TMA's bits
    for m, n, k, kw in ((1024, 2048, 512, dict(bm=1024, bn=2048, bk=256, acc_dtype="bfloat16")),
                        (2048, 2048, 2048, dict(bm=512, bn=1024, bk=512, rhs_layout="nk"))):
        cfg = KernelConfig(**kw)
        a = _inputs(torch, gen, (m, k), False)
        rhs = _inputs(torch, gen, (n, k) if cfg.rhs_layout == "nk" else (k, n), False)
        outs = []
        for vec in (1, 0):
            out = torch.empty((m, n), dtype=torch.float32, device="cuda")
            args = list(mm.launch_args(a, rhs, cfg, out, None, None, 1, m, n, k))
            args[18] = args[19] = vec
            check_launch(lib.tl2_wgmma_f32out(*args), "tl2_wgmma (wide)")
            outs.append(out)
        torch.cuda.synchronize()
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"the wide loads producer differs from TMA at {m}x{n}x{k}")
        print(f"  (a) {m}x{n}x{k} {cfg.bm}x{cfg.bn} bk={cfg.bk} {cfg.rhs_layout}: the loads "
              "producer forced on aligned operands gives TMA's bits")

    # ---- (b) the main path: the JAX DB's entries through a DB copy ----
    entries = _jax_db_entries(repo, KernelConfig)
    runnable = [(s, acc, cfg) for s, acc, cfg in entries if cfg.validate() is None]
    refused = [(s, acc, cfg.validate()) for s, acc, cfg in entries if cfg.validate()]
    db_path = work / "jax_db.json"
    db = db_mod.TuneDB(path=db_path)
    for (m, n, k), acc, cfg in runnable:
        db.put(m, n, k, cfg, 0.0, acc=acc, extra={"scope": "from_jax"})
    db.save()
    print(f"  (b) {len(entries)} kernel entries of the JAX DB: {len(runnable)} validate, "
          f"{len(refused)} refused" + "".join(f"; {s} {acc}: {err}" for s, acc, err in refused))
    if len(runnable) != JAX_DB_RUNNABLE:
        raise AssertionError(f"{len(runnable)} JAX entries validate, not {JAX_DB_RUNNABLE}")
    gate = _script(repo, "correctness_campaign_torch")
    zero_counters()
    t0 = time.perf_counter()
    printed, errs = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(errs):
        rc = gate.main(["--db", str(db_path), "--no_demote", "--jsonl", str(work / "gate.jsonl"),
                        "--out", str(work / "gate.json")])
    (work / "gate.log").write_text(errs.getvalue())
    summary = json.loads(printed.getvalue().strip().splitlines()[-1])
    rec["campaign"] = {"summary": summary, "seconds": time.perf_counter() - t0}
    print(f"  (b) correctness campaign --no_demote over the copy: {summary['passed']} of "
          f"{summary['total_kernel_entries']} kernel entries pass, failed "
          f"{len(summary['failed'])}, guard hits {summary['guard_hits']} "
          f"({rec['campaign']['seconds']:.1f} s)")
    if (rc != 0 or summary["failed"] or summary["guard_hits"]
            or summary["passed"] != len(runnable)):
        raise AssertionError(f"the campaign over the JAX entries failed: {summary}\n"
                             + errs.getvalue()[-4000:])
    campaign_counts = counters()
    os.environ[db_mod.ENV_VAR] = str(db_path)
    db_mod.reset_default_db()
    try:
        zero_counters()
        t0 = time.perf_counter()
        sentinels = []
        for (m, n, k), acc, cfg in runnable:
            got_cfg = dispatch.resolve_config(m, n, k, acc)
            if got_cfg != cfg:
                sentinels.append(((m, n, k), acc, got_cfg))
                continue
            a = _inputs(torch, gen, (m, k), True)
            b = _inputs(torch, gen, (k, n), True)
            out = dispatch.matmul(a, b, acc=acc, out_dtype=torch.float32)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"dispatch at {m}x{n}x{k} {acc}: non-finite output")
            del a, b, out
        torch.cuda.synchronize()
        dispatch_counts = counters()
        wide_launches = sum(v for key, v in dispatch_counts.items() if "_wgmma_wide" in key)
        rec["dispatch"] = {"launches": dispatch_counts, "wide_launches": wide_launches,
                           "sentinels": [str(x) for x in sentinels],
                           "seconds": time.perf_counter() - t0}
        print(f"  (b) dispatch.matmul at the {len(runnable)} shapes through the copy: "
              f"{wide_launches} wide launches, {len(sentinels)} resolved to another config; "
              "launches " + json.dumps({k: v for k, v in dispatch_counts.items() if v}))
        ring_entries = sum(1 for _, _, cfg in runnable if not cfg.wide)
        if sentinels or wide_launches != len(runnable) - ring_entries:
            raise AssertionError(f"dispatch through the copy: {sentinels[:5]}, "
                                 f"{wide_launches} wide launches")
        # batched dispatch and the loads producer through the same DB
        for (m, n, k), acc in WIDE_DB_BATCHED:
            cfg = dispatch.resolve_config(m, n, k, acc)
            a = _inputs(torch, gen, (WIDE_DB_BATCH, m, k), True)
            b = _inputs(torch, gen, (WIDE_DB_BATCH, k, n), True)
            got = dispatch.batched_matmul(a, b, acc=acc, out_dtype=torch.float32)
            if not cfg.wide or not torch.equal(got, bmm.batched_matmul_reference(
                    a, b, cfg.bk, cfg.acc_dtype, torch.float32)):
                raise AssertionError(f"batched dispatch at {m}x{n}x{k} {acc} ({cfg})")
            print(f"  (b) dispatch.batched_matmul {WIDE_DB_BATCH}x{m}x{n}x{k} {acc}: "
                  f"{cfg.bm}x{cfg.bn} bk={cfg.bk}, exact against its plain version")
        for (m, n, k), acc in WIDE_DB_UNALIGNED:
            cfg = dispatch.resolve_config(m, n, k, acc)
            a = _offset(torch, _inputs(torch, gen, (m, k), True), 1)
            b = _inputs(torch, gen, (k, n), True)
            route = mm.launch_route(cfg, a, b, m, n, k)
            got = dispatch.matmul(a, b, acc=acc, out_dtype=torch.float32)
            if route != "wgmma_wide_lsu" or not torch.equal(got, mm.matmul_reference(
                    a, b, cfg.bk, cfg.acc_dtype, out_dtype=torch.float32)):
                raise AssertionError(f"unaligned dispatch at {m}x{n}x{k} {acc} ({route})")
            print(f"  (b) dispatch.matmul {m}x{n}x{k} {acc}, A 2 bytes off 16: {route}, "
                  "exact against its plain version")
    finally:
        os.environ.pop(db_mod.ENV_VAR, None)
        db_mod.reset_default_db()
    launches = {key: campaign_counts[key] + v for key, v in counters().items()}
    rec["launches"] = launches
    print("  (b) launches of the campaign and the dispatch " + json.dumps(launches))
    missing = [key for key in ("multi_k_wgmma_wide", "single_k_wgmma_wide", "wide_streamed",
                               "wide_tall", "batched_single_k_wgmma_wide",
                               "batched_multi_k_wgmma_wide", "single_k_wgmma_wide_lsu",
                               "multi_k_wgmma_wide_lsu") if launches[key] <= 0]
    if missing or launches["mma_sync"]:
        raise AssertionError(f"the main path launched none of {missing} (or an mma.sync body)")

    # ---- (c) alone: each new row beside torch.matmul / torch.bmm and the plain version ----
    rows, keys = [], []
    rec["timed"] = []
    for name, batch, m, n, k, kw, a_off, out_name, src, replaces, key in WIDE_TIMED:
        cfg = KernelConfig(**kw)
        lead = (batch,) if batch > 1 else ()
        a = _offset(torch, _inputs(torch, gen, (*lead, m, k), False), a_off)
        b = _inputs(torch, gen, (*lead, k, n), False)
        out_dtype = getattr(torch, out_name)
        out = torch.empty((*lead, m, n), dtype=out_dtype, device="cuda")
        fn = lib.tl2_wgmma_f32out if out_name == "float32" else lib.tl2_wgmma_bf16out

        def make(a=a, b=b, out=out, cfg=cfg, batch=batch, m=m, n=n, k=k, fn=fn):
            call = mm.launch_args(a, b, cfg, out, None, None, batch, m, n, k)
            return lambda: check_launch(fn(*call), "tl2_wgmma (wide)")

        def make_blocks(a=a, b=b, out=out, cfg=cfg, batch=batch, m=m, n=n, k=k):
            walk = config_mod.wide_walk(m, n, cfg.bm, cfg.bn, batch)
            blocks = walk.items // (walk.strips * walk.cols)
            return lambda: _witness_launch(torch, lib, mm, a, b, cfg, out, None, None, batch,
                                           m, n, k, blocks)

        turns, per_block = _timed_turns(torch, host_time, make, make_blocks)
        library = host_time.alone_ms(torch, lambda a=a, b=b: (lambda: torch.matmul(a, b)))
        plain_ms = _time_ms(torch, lambda a=a, b=b, cfg=cfg: mm.matmul_reference(
            a, b, cfg.bk, cfg.acc_dtype, out_dtype=out_dtype), reps=3)
        # `out` holds the kernel's result on these inputs (every timed launch wrote it)
        err = (out.float() - mm.matmul_reference(a, b, cfg.bk, cfg.acc_dtype,
                                                 out_dtype=out_dtype).float()).abs().max().item()
        bound_ms, bound_by = _bound(batch, m, n, k, 4 if out_name == "float32" else 2)
        ctas = config_mod.wide_ctas(m, n, cfg.bm, cfg.bn, batch, sms)
        row = {"name": name, "mnk": [batch, m, n, k], "turns_ms": turns, "max_abs_err": err,
               "ms": sum(turns) / 2, "torch_alone_ms": library, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "ctas": ctas,
               "one_cta_a_block_ms": per_block,
               "route": mm.launch_route(cfg, a[0] if batch > 1 else a,
                                        b[0] if batch > 1 else b, m, n, k)}
        rec["timed"].append(row)
        print(f"  (c) {name} at {batch}x{m}x{n}x{k} ({row['route']}, {out_name} out, {ctas} "
              f"CTAs) alone ms {json.dumps(turns)}; one CTA a block {per_block:.5f}; "
              f"torch.{'bmm' if batch > 1 else 'matmul'} {library:.5f}, plain {plain_ms:.5f}, "
              f"bound {bound_ms:.5f} ({bound_by})")
        rows.append({"name": f"tl2_wgmma_wide ({name}, {batch}x{m}x{n}x{k})" if batch > 1
                     else f"tl2_wgmma_wide ({name}, {m}x{n}x{k})",
                     "route": "cuda", "source": f"tpul2_torch/csrc/{src}", "replaces": replaces,
                     "max_abs_err": err, "ms": row["ms"], "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library})
        keys.append(key)
        del a, b, out
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  phase wide: {rec['seconds']:.1f} s")
    return rec, rows, keys, launches


#: The JAX DB's kernel entries that validate after from_jax: all 214, the two bm = 16 ones
#: on the swapped wide walk (tests/test_torch_wide_carry.py holds the same count on the CPU).
JAX_DB_RUNNABLE = 214


#: Phase jax space (a): the shapes whose whole uncapped candidate space (the JAX space's,
#: tests/test_torch_jax_space.py) is launched: decode sizes of Llama-3-8B and Llama-2-7B,
#: M = 48, N = 1, N = 64 at two heights, 1000^3, a bn cover above 16384, a 32000 vocab.
JAX_SPACE_SHAPES = [(1, 4096, 4096), (8, 4096, 4096), (16, 11008, 4096), (32, 4096, 14336),
                    (48, 4096, 4096), (8192, 1, 4096), (1024, 64, 64), (12288, 64, 64),
                    (1000, 1000, 1000), (4096, 24576, 64), (64, 32000, 4096)]
#: Phase jax space (b): the DB copy's main path beside tests/data/jax_decode_db.json (the JAX
#: heuristic at the decode shapes and the block's at seq 16) and the JAX DB's two bm = 16
#: entries: one JAX-space block per variant the decode shapes do not reach, f32 family.
JAX_SPACE_DB_EXTRA = [((1024, 64, 64), dict(bm=256, bn=64, bk=64)),
                      ((1000, 1000, 1000), dict(bm=1000, bn=1000, bk=1024)),
                      ((4096, 24576, 64), dict(bm=128, bn=24576, bk=64)),
                      ((64, 32000, 4096), dict(bm=64, bn=32000, bk=512, pipeline_depth=2))]
#: Phase jax space (c): one row per new variant, timed alone: (name, batch, m, n, k, cfg
#: kwargs, source file, the replaced Pallas function's file:line, counter key).
JAX_SPACE_TIMED = [
    ("narrow ring block 16x128 (the swapped 32x128 tile), bk 1024", 1, 16, 4096, 4096,
     dict(bm=16, bn=128, bk=1024), "tl2_wgmma_swap.cu", "tpul2/ops/matmul.py:96",
     "ring_narrow"),
    ("batched narrow ring block 16x16 (the block's scores at seq 16)", 8, 16, 16, 128,
     dict(bm=16, bn=16, bk=128), "tl2_wgmma_n32.cu", "tpul2/ops/batched.py:40",
     "ring_narrow"),
    ("swapped wide walk 1x512, bk 1024 (the JAX heuristic)", 1, 1, 4096, 4096,
     dict(bm=1, bn=512, bk=1024), "tl2_wgmma_wide_swap.cu", "tpul2/ops/matmul.py:96",
     "wide_swapped"),
    ("swapped wide walk 16x256, bk 4096, bf16 family (the JAX DB's entry)", 1, 16, 11008,
     4096, dict(bm=16, bn=256, bk=4096, acc_dtype="bfloat16"), "tl2_wgmma_wide_swap.cu",
     "tpul2/ops/matmul.py:136", "wide_swapped"),
    ("narrow columns 256x64", 1, 1024, 64, 64, dict(bm=256, bn=64, bk=64),
     "tl2_wgmma_wide_stream.cu", "tpul2/ops/matmul.py:136", "wide_narrow_n"),
    ("clipped cover 1000x1000, one interval", 1, 1000, 1000, 1000,
     dict(bm=1000, bn=1000, bk=1024), "tl2_wgmma_wide_stream.cu", "tpul2/ops/matmul.py:136",
     "wide_clipped"),
    ("bn above 16384: 128x24576", 1, 4096, 24576, 64, dict(bm=128, bn=24576, bk=64),
     "tl2_wgmma_wide_stream.cu", "tpul2/ops/matmul.py:136", "wide_long"),
    ("staged wide 16x11008, depth 2 (JAX's kStage pick)", 1, 16, 11008, 4096,
     dict(bm=16, bn=11008, bk=1024, pipeline_depth=2), "tl2_wgmma_wide_swap.cu",
     "tpul2/ops/pipelined.py:39", "staged_wide"),
]
#: The counters of the new variants, each of which the main path must launch.
JAX_SPACE_KEYS = ("ring_narrow", "wide_swapped", "wide_narrow_n", "wide_clipped", "wide_long",
                  "staged_wide")


def _jax_space_sweep(torch, lib, mods, pl, gen, m: int, n: int, k: int, acc: str,
                     blocks: list) -> dict:
    """Phase jax space (a) at one shape and family: each block (one config per (bm, bn,
    bk, depth, rhs)) launched on 0/1 inputs, held to the f32 truth by the gate's comparison
    (harness.correctness: its density, every element within the family's exact bound
    equal), and on normal inputs within allowed_error of its plain version, one plain
    output per (bk, staged).  A bf16 carry's element beyond the tolerance must carry the
    ring-order reference's bits.  Each wide launch runs again at ``_second_count`` CTAs
    (one CTA a block) and must give the same bits.  Returns the counts."""
    from tpul2_torch.harness.correctness import EXACT_BOUND, zero_one_density
    KernelConfig, mm, bmm = mods
    p = zero_one_density(k, "float32" if acc == "float32" else acc)
    a01 = (torch.rand((m, k), generator=gen, device="cuda") < p).to(torch.bfloat16)
    b01 = (torch.rand((k, n), generator=gen, device="cuda") < p).to(torch.bfloat16)
    an = _inputs(torch, gen, (m, k), False)
    bn_ = _inputs(torch, gen, (k, n), False)
    rhs = {True: {"kn": b01, "nk": b01.t().contiguous()},
           False: {"kn": bn_, "nk": bn_.t().contiguous()}}
    truth = a01.float() @ b01.float()
    out = torch.empty((m, n), dtype=torch.float32, device="cuda")
    again = torch.empty_like(out)
    plain, tols = {}, {}
    pending, other_bits = [], []
    for cfg in blocks:
        staged = cfg.pipeline_depth >= 2
        key = (k if staged else cfg.bk, staged)
        if key not in plain:
            bk, fam = key[0], "float32" if staged else acc
            plain[key] = mm.matmul_reference(an, bn_, bk, fam, out_dtype=torch.float32)
            tols[key] = mm.allowed_error(an, bn_, bk, fam, "kn", torch.float32)
        bound = EXACT_BOUND["float32" if staged or acc == "float32" else acc]
        for zero_one in (True, False):
            a = a01 if zero_one else an
            r = rhs[zero_one][cfg.rhs_layout]
            if staged:
                pl.cuda_matmul_pipelined(a, r, cfg, out=out)
            else:
                (mm.cuda_matmul_tn if cfg.rhs_layout == "nk" else mm.cuda_matmul)(
                    a, r, cfg, out=out)
            second = _second_count(torch, cfg, 1, m, n) if cfg.wide else 0
            if second:
                # the wrapper's launch at another count: a staged one at its clamped depth,
                # or (one K interval) the single-K launch the wrapper then makes
                depth = pl.staged_depth(cfg.pipeline_depth, k // cfg.bk) if staged else 0
                again.fill_(float("nan"))
                _witness_launch(torch, lib, mm, a, r, dataclasses.replace(cfg, pipeline_depth=0)
                                if depth < 2 else cfg, again, None, None, 1, m, n, k, second,
                                depth if depth >= 2 else 0)
                other_bits.append((_bits(torch, again) != _bits(torch, out)).sum())
            if zero_one:
                bad = ((out != truth) & (truth.abs() <= bound)).sum()
            else:
                bad = ((out - plain[key]).abs() > tols[key]).sum()
            pending.append((cfg, zero_one, bad))
    torch.cuda.synchronize()
    differ = sum(int(x.item()) for x in other_bits)
    if differ:
        raise AssertionError(f"jax space {m}x{n}x{k} {acc}: {differ} elements differ between "
                             "the rule's CTA count and one CTA a block")
    witnessed = ring_tile_bits = 0
    orders = {}
    for cfg, zero_one, bad in pending:
        nbad = int(bad.item())
        if not nbad:
            continue
        if zero_one or cfg.pipeline_depth or acc != "bfloat16" or -(-k // cfg.bk) <= 1:
            raise AssertionError(f"jax space {m}x{n}x{k} {acc} {cfg}: {nbad} elements wrong "
                                 f"on {'0/1' if zero_one else 'normal'} inputs")
        # the bf16 carry's neighbour rounding (phase 2's rule): the ring-order bits, in
        # either of its f32 orders (each 64-deep stage exact, or its four k16 steps
        # chained); an element off both must carry the bits of the 128 x 128 ring tile at
        # the same bk, which the tensor cores' own order gives
        r = rhs[False][cfg.rhs_layout]
        wrapper = mm.cuda_matmul_tn if cfg.rhs_layout == "nk" else mm.cuda_matmul
        if (cfg.bk, cfg.rhs_layout) not in orders:
            orders[cfg.bk, cfg.rhs_layout] = (
                _ring_order_reference(torch, mm, an, bn_, cfg.bk, "kn"),
                _ring_order_reference(torch, mm, an, bn_, cfg.bk, "kn", chain16=True),
                wrapper(an, r, KernelConfig(bm=128, bn=128, bk=cfg.bk, acc_dtype="bfloat16",
                                            rhs_layout=cfg.rhs_layout),
                        out_dtype=torch.float32))
        ring, ring16, tile = orders[cfg.bk, cfg.rhs_layout]
        got = wrapper(an, r, cfg, out_dtype=torch.float32)
        beyond = (got - plain[(cfg.bk, False)]).abs() > tols[(cfg.bk, False)]
        off = beyond & (got != ring) & (got != ring16)
        if bool((off & (got != tile)).any()):
            raise AssertionError(f"jax space {m}x{n}x{k} {acc} {cfg}: elements beyond "
                                 "allowed_error off the ring-order bits and the ring tile's")
        witnessed += int((beyond & ~off).sum().item())
        ring_tile_bits += int(off.sum().item())
    return {"blocks": len(blocks), "launches": 2 * len(blocks), "plain_outputs": len(plain),
            "ring_order_witnessed": witnessed, "ring_tile_bits": ring_tile_bits,
            "bit_identical": len(other_bits)}


def _jax_space_phase(torch, repo: Path, lib, mods, counters, zero_counters, host_time) -> tuple:
    """Phase jax space: every block edge of the JAX space on the card.  (a) at each of
    JAX_SPACE_SHAPES, every distinct block of the port's uncapped candidate space (which
    holds the JAX tuner's, tests/test_torch_jax_space.py) in both families, against the
    truth and its plain version; (b) the main path: a DB copy holding the JAX heuristic's
    configs at the decode shapes and the block's at seq 16 (tests/data/jax_decode_db.json),
    the JAX DB's two bm = 16 entries and one block per remaining variant, through
    dispatch.matmul / dispatch.batched_matmul (each resolving to its own config) and the
    block's forward at seq 16; (c) each new variant alone in a CUDA graph beside
    torch.matmul / torch.bmm, the plain version and the bound.  Returns (record, kernel
    rows, their counter keys, the launches of (b))."""
    import numpy as np

    from tpul2_torch import dispatch
    from tpul2_torch.autotune import db as db_mod
    from tpul2_torch.config import candidate_configs, wide_walk
    from tpul2_torch.models import BlockParams, block_forward
    from tpul2_torch.models.entry import N_HEADS
    from tpul2_torch.models.entry import entry as block_entry
    from tpul2_torch.ops import pipelined as pl
    from tpul2_torch.ops._build import check_launch
    KernelConfig, mm, bmm = mods
    t_phase = time.perf_counter()
    rec = {"sweep": []}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)

    # ---- (a) the JAX space at the sample shapes ----
    zero_counters()
    total = identical = 0
    for m, n, k in JAX_SPACE_SHAPES:
        for acc in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            blocks, seen = [], set()
            for cfg in candidate_configs(m, n, k, acc, max_candidates=10**6):
                key = (cfg.bm, cfg.bn, cfg.bk, cfg.pipeline_depth, cfg.rhs_layout)
                if cfg.use_vendor or key in seen:
                    continue
                if cfg.validate() is not None:
                    raise AssertionError(f"jax space {m}x{n}x{k}: {cfg} refused")
                seen.add(key)
                blocks.append(cfg)
            got = _jax_space_sweep(torch, lib, mods, pl, gen, m, n, k, acc, blocks)
            got.update(mnk=[m, n, k], acc=acc, seconds=time.perf_counter() - t0)
            rec["sweep"].append(got)
            total += got["blocks"]
            identical += got["bit_identical"]
            print(f"  (a) {m}x{n}x{k} {acc}: {got['blocks']} blocks, {got['launches']} launches "
                  f"correct ({got['plain_outputs']} plain outputs; beyond allowed_error: "
                  f"{got['ring_order_witnessed']} elements on the ring-order bits, "
                  f"{got['ring_tile_bits']} on the 128x128 ring tile's; {got['bit_identical']} "
                  f"wide launches bit-identical at one CTA a block; {got['seconds']:.1f} s)",
                  flush=True)
    sweep_counts = counters()
    rec["sweep_launches"] = {key: v for key, v in sweep_counts.items() if v}
    rec["bit_identical_launches"] = identical
    print(f"  (a) {total} blocks of the JAX space, 0 refused, every launch correct; {identical} "
          "wide launches bit-identical at the rule's CTA count and at a second; launches "
          + json.dumps(rec["sweep_launches"]))
    if sweep_counts["mma_sync"] or any(sweep_counts[key] <= 0 for key in JAX_SPACE_KEYS):
        raise AssertionError(f"the sweep missed a variant: {rec['sweep_launches']}")

    # ---- (b) the main path through a DB copy ----
    work = repo / "runs" / "chip_smoke" / "jax_space"
    work.mkdir(parents=True, exist_ok=True)
    db_path = work / "decode_db.json"
    db_path.unlink(missing_ok=True)
    db = db_mod.TuneDB(path=db_path)
    rows = json.loads((repo / "tests" / "data" / "jax_decode_db.json").read_text())["rows"]
    want = {}
    for row in rows:
        cfg = KernelConfig(**row["config"])
        db.put(row["m"], row["n"], row["k"], cfg, 0.0, acc=row["acc"],
               extra={"scope": "jax_heuristic"})
        want[(row["m"], row["n"], row["k"], row["acc"])] = (cfg, row["batch"])
    for (m, n, k), acc, cfg in _jax_db_entries(repo, KernelConfig):
        if cfg.bm == 16:  # the JAX DB's bm = 16 entries
            db.put(m, n, k, cfg, 0.0, acc=acc, extra={"scope": "from_jax"})
            want[(m, n, k, acc)] = (cfg, 1)
    for (m, n, k), kw in JAX_SPACE_DB_EXTRA:
        cfg = KernelConfig(**kw)
        db.put(m, n, k, cfg, 0.0, acc="float32", extra={"scope": "jax_space"})
        want[(m, n, k, "float32")] = (cfg, 1)
    db.save()
    os.environ[db_mod.ENV_VAR] = str(db_path)
    db_mod.reset_default_db()
    try:
        zero_counters()
        t0 = time.perf_counter()
        for (m, n, k, acc), (cfg, batch) in want.items():
            got_cfg = dispatch.resolve_config(m, n, k, acc)
            if got_cfg != cfg:
                raise AssertionError(f"{m}x{n}x{k} {acc} resolved to {got_cfg}, not {cfg}")
            lead = (batch,) if batch > 1 else ()
            a = _inputs(torch, gen, (*lead, m, k), True)
            b = _inputs(torch, gen, (*lead, k, n), True)
            if batch > 1:
                got = dispatch.batched_matmul(a, b, acc=acc, out_dtype=torch.float32)
                plain = bmm.batched_matmul_reference(a, b, cfg.bk, acc, torch.float32)
            else:
                got = dispatch.matmul(a, b, acc=acc, out_dtype=torch.float32)
                plain = (pl.pipelined_reference(a, b, "kn", torch.float32)
                         if cfg.pipeline_depth else
                         mm.matmul_reference(a, b, cfg.bk, acc, out_dtype=torch.float32))
            if not torch.equal(got, plain):
                raise AssertionError(f"dispatch at {m}x{n}x{k} {acc} ({cfg}) differs from its "
                                     "plain version")
        torch.cuda.synchronize()
        dispatch_seconds = time.perf_counter() - t0
        # the flagship block's forward at seq 16 through the copy, against a CPU copy
        _, (params, x) = block_entry()
        x16 = x[:16].contiguous()
        got = block_forward(params, x16, N_HEADS)
        torch.cuda.synchronize()
        plain = block_forward(BlockParams(*(t.cpu() for t in params)), x16.cpu(), N_HEADS)
        err = (got.float().cpu() - plain.float()).abs()
        beyond = int((err > 0.05 + 0.05 * plain.float().abs()).sum())
        launches = counters()
    finally:
        os.environ.pop(db_mod.ENV_VAR, None)
        db_mod.reset_default_db()
    rec["main_path"] = {"entries": len(want), "dispatch_seconds": dispatch_seconds,
                        "block_seq16_max_abs_diff_vs_plain": err.max().item(),
                        "block_seq16_beyond_tol": beyond,
                        "launches": {key: v for key, v in launches.items() if v}}
    print(f"  (b) {len(want)} entries of the DB copy (the JAX heuristic at the decode shapes, "
          f"the JAX DB's bm = 16 entries, one per remaining variant) through dispatch, each "
          f"on its own config and exact against its plain version ({dispatch_seconds:.1f} s); "
          f"the block at seq 16 through the copy: max |diff| vs plain {err.max().item():.4g}, "
          f"{beyond} beyond rtol = atol = 0.05; launches "
          + json.dumps(rec["main_path"]["launches"]))
    missing = [key for key in JAX_SPACE_KEYS if launches[key] <= 0]
    if beyond or not torch.isfinite(got.float()).all() or missing or launches["mma_sync"]:
        raise AssertionError(f"the main path: {beyond} block elements beyond tolerance, "
                             f"variants {missing} not launched, {launches['mma_sync']} mma.sync")

    # ---- (c) each new variant alone ----
    rows_out, keys = [], []
    rec["timed"] = []
    for name, batch, m, n, k, kw, src, replaces, key in JAX_SPACE_TIMED:
        cfg = KernelConfig(**kw)
        lead = (batch,) if batch > 1 else ()
        a = _inputs(torch, gen, (*lead, m, k), False)
        b = _inputs(torch, gen, (*lead, k, n), False)
        out = torch.empty((*lead, m, n), dtype=torch.bfloat16, device="cuda")
        if cfg.pipeline_depth:
            depth = pl.staged_depth(cfg.pipeline_depth, k // cfg.bk)

            def make(a=a, b=b, out=out, cfg=cfg, m=m, n=n, k=k, depth=depth):
                stream = torch._C._cuda_getCurrentRawStream(a.get_device())
                return lambda: check_launch(lib.tl2_wgmma_staged(
                    a.data_ptr(), b.data_ptr(), out.data_ptr(), None, m, n, k, cfg.bm, cfg.bn,
                    depth, 1, 0, 0, 0, stream), "tl2_wgmma_staged (wide)")

            def reference(a=a, b=b):
                return pl.pipelined_reference(a, b, "kn", torch.bfloat16)
        else:
            def make(a=a, b=b, out=out, cfg=cfg, batch=batch, m=m, n=n, k=k):
                call = mm.launch_args(a, b, cfg, out, None, None, batch, m, n, k)
                return lambda: check_launch(lib.tl2_wgmma_bf16out(*call), "tl2_wgmma")

            def reference(a=a, b=b, cfg=cfg):
                return mm.matmul_reference(a, b, cfg.bk, cfg.acc_dtype, out_dtype=torch.bfloat16)
        ctas = per_block = None
        if cfg.wide:  # the rule's CTA count in turns with one CTA a block
            walk = wide_walk(m, n, cfg.bm, cfg.bn, batch)
            ctas = min(walk.items, sms)
            depth = pl.staged_depth(cfg.pipeline_depth, k // cfg.bk) if cfg.pipeline_depth else 0

            def make_blocks(a=a, b=b, out=out, cfg=cfg, batch=batch, m=m, n=n, k=k,
                            blocks=walk.items // (walk.strips * walk.cols), depth=depth):
                return lambda: _witness_launch(torch, lib, mm, a, b, cfg, out, None, None,
                                               batch, m, n, k, blocks, depth)

            turns, per_block = _timed_turns(torch, host_time, make, make_blocks)
        else:
            turns = [host_time.alone_ms(torch, make) for _ in range(2)]
        library = host_time.alone_ms(torch, lambda a=a, b=b: (lambda: torch.matmul(a, b)))
        plain_ms = _time_ms(torch, reference, reps=3)
        # `out` holds the kernel's result on these inputs (every timed launch wrote it)
        err = (out.float() - reference().float()).abs().max().item()
        bound_ms, bound_by = _bound(batch, m, n, k, 2)
        route = (pl.staged_route(cfg, a, b, m, n, k) if cfg.pipeline_depth else
                 mm.launch_route(cfg, a[0] if batch > 1 else a, b[0] if batch > 1 else b,
                                 m, n, k))
        row = {"name": name, "mnk": [batch, m, n, k], "turns_ms": turns, "max_abs_err": err,
               "ms": sum(turns) / 2, "torch_alone_ms": library, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "route": route, "ctas": ctas,
               "one_cta_a_block_ms": per_block}
        rec["timed"].append(row)
        print(f"  (c) {name} at {batch}x{m}x{n}x{k} ({route}, bfloat16 out"
              + (f", {ctas} CTAs" if ctas else "") + f") alone ms {json.dumps(turns)}"
              + (f"; one CTA a block {per_block:.5f}" if ctas else "")
              + f"; torch.{'bmm' if batch > 1 else 'matmul'} {library:.5f}, plain "
              f"{plain_ms:.5f}, bound {bound_ms:.5f} ({bound_by}), max |err| {err:.4g}")
        label = f"{batch}x{m}x{n}x{k}" if batch > 1 else f"{m}x{n}x{k}"
        rows_out.append({"name": f"{'tl2_wgmma_staged' if cfg.pipeline_depth else 'tl2_wgmma'} "
                                 f"({name}, {label})",
                         "route": "cuda", "source": f"tpul2_torch/csrc/{src}",
                         "replaces": replaces, "max_abs_err": err, "ms": row["ms"],
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library})
        keys.append(key)
        del a, b, out
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  phase jax space: {rec['seconds']:.1f} s")
    return rec, rows_out, keys, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json_out", default=None, help="also write the detailed record here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from tpul2_torch import dispatch
    from tpul2_torch.autotune import __main__ as tune_cli
    from tpul2_torch.autotune import db as db_mod
    from tpul2_torch.config import (PIPELINE_DEPTHS, SMEM_LIMIT, KernelConfig,
                                    candidate_configs, heuristic_config)
    from tpul2_torch.dispatch import candidate_fn, resolve_config
    from tpul2_torch.harness import bench_utils as bu
    from tpul2_torch.ops import baselines, launch_counts, zero_launch_counts
    from tpul2_torch.ops import batched as bmm
    from tpul2_torch.ops import matmul as mm
    from tpul2_torch.ops import pipelined as pl
    from tpul2_torch.ops._build import check_launch, load_library
    from tpul2_torch.utils.platform import device_info, require_hopper

    # every wrapper's counter (tpul2_torch.ops.COUNTERS), and "mma_sync": the calls made
    # through the library into the mma.sync bodies' C entries, which phase 1 wraps
    tripwire = {"mma_sync": 0}

    def zero_counters():
        zero_launch_counts()
        tripwire["mma_sync"] = 0

    def counters() -> dict:
        return {**launch_counts(), **tripwire}

    record = {}
    with phase("0 device"):
        require_hopper()
        info = device_info()
        if not info["nvidia_smi"]:
            raise RuntimeError("nvidia-smi gave no name/power.limit line")
        baselines.pin_precision()  # full-f32 library GEMMs for the plain versions too
        print(json.dumps(info))
        print(info["nvidia_smi"])
        record["device"] = info

    with phase("1 build"):
        lib = load_library()
        regs = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln or "entry function" in ln or "spill" in ln]
        for ln in regs:
            print(f"  ptxas: {ln}")
        record["ring_ptxas"] = _ring_ptxas(lib.build_log)
        # the mma.sync bodies: this script's direct launches go through `mma`; a call
        # through the library's attribute (what a package path would make) is counted
        mma = {name: getattr(lib, name)
               for name in ("tl2_matmul_bf16out", "tl2_matmul_f32out", "tl2_staged")}

        def counted(fn):
            def call(*args):
                tripwire["mma_sync"] += 1
                return fn(*args)
            return call

        for name, fn in mma.items():
            setattr(lib, name, counted(fn))
        depths = {}
        for bm in (1, 16, 32, 48, 64, 100, 128):
            for bn in (1, 16, 32, 48, 64, 100, 128):
                stages = lib.tl2_wgmma_carry_stages(bm, bn)
                if bm in (32, 64, 128) and bn in (32, 64, 128):
                    depths[f"{bm}x{bn}"] = stages
                kernel = lib.tl2_wgmma_smem_bytes(bm, bn, stages)
                if stages != mm.carry_stages(bm, bn) or kernel != KernelConfig(
                        bm=bm, bn=bn).smem_bytes() or kernel > SMEM_LIMIT:
                    raise AssertionError(f"the carry ring's depth or smem model differs from "
                                         f"the kernel at {bm}x{bn}: {stages}, {kernel}")
                for depth in PIPELINE_DEPTHS[1:]:
                    cfg = KernelConfig(bm=bm, bn=bn, pipeline_depth=depth)
                    kernel = lib.tl2_wgmma_smem_bytes(bm, bn, depth)
                    if kernel != cfg.smem_bytes():
                        raise AssertionError(f"staged smem model differs from the kernel at "
                                             f"{bm}x{bn} depth {depth}")
                    if (cfg.validate() is None) != (kernel <= SMEM_LIMIT):
                        raise AssertionError(f"validate at {bm}x{bn} depth {depth} does not "
                                             f"follow the kernel's {kernel} bytes")
        n_route = _check_route_mirror(torch, lib, mm, KernelConfig)
        n_staged = _check_staged_route_mirror(torch, lib, pl, mm, KernelConfig)
        from tpul2_torch import config as config_mod
        n_wide = _check_wide_mirror(torch, lib, mm, config_mod)
        print(f"  carry ring depths {json.dumps(depths)}; smem models and route rules agree "
              f"with the kernels ({n_route[0]} route cases, {n_route[1]} of them TMA, "
              f"{n_route[2]} storing C by TMA; "
              f"{n_staged[0]} staged route cases, {n_staged[1]} of them TMA, {n_staged[2]} "
              f"storing C by TMA; {n_wide[0]} wide "
              f"route cases, {n_wide[1]} of them TMA; {n_wide[2]} wide CTA counts)")
        record["carry_stages"] = depths
        print(f"  build {lib.build_seconds:.1f} s (0.0 = library was current)")
        record["build_seconds"] = lib.build_seconds
        record["ptxas"] = regs

    max_err = {key: 0.0 for key in counters()}

    def pin_empty_db():
        """Resolve through the heuristic: TPUL2_TORCH_TUNEDB names a file that is not
        there, so the committed DB does not steer the phases that measure the heuristic."""
        path = repo / "runs" / "chip_smoke" / "tunedb_empty.json"
        path.unlink(missing_ok=True)
        os.environ[db_mod.ENV_VAR] = str(path)
        db_mod.reset_default_db()

    def use_db(kind: str) -> None:
        if kind == "heuristic":
            pin_empty_db()
        else:  # the committed tpul2_torch/data/tunedb_h100.json
            os.environ.pop(db_mod.ENV_VAR, None)
            db_mod.reset_default_db()

    with phase("native"):
        record["native"] = _native_phase(repo, use_db)

    pin_empty_db()

    with phase("2 kernel vs plain"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        mods = (KernelConfig, mm, bmm)
        cases = _grid_cases()
        for (sh, acc) in SLICE_SHAPES:  # main-path shapes with their resolved configs
            m, n, k = sh
            c = resolve_config(m, n, k, acc)
            kw = dict(bm=c.bm, bn=c.bn, bk=c.bk, acc_dtype=acc)
            cases.append((f"slice/{m}x{n}x{k}/{acc}", 1, m, n, k, kw, None, "bfloat16"))
            cases.append((f"slice-batched/{m}x{n}x{k}/{acc}", GATE_BATCH, m, n, k, kw, None,
                          "bfloat16"))
        # long K intervals, up to bk = K: the tuner's candidate space offers them, and the
        # f32 sum over one interval must stay inside allowed_error on normal inputs
        m, n, k = TUNE_SHAPE
        for bk, layout, acc in ((k, "kn", "float32"), (k // 2, "nk", "float32"),
                                (k // 2, "kn", "bfloat16")):
            kw = dict(bm=32, bn=64, bk=bk, acc_dtype=acc, rhs_layout=layout)
            cases.append((f"long-interval/{m}x{n}x{k}/{acc}/{layout}", 1, m, n, k, kw, None,
                          "float32"))
        cases.append(("long-interval/4096x4096x4096/float32", 1, 4096, 4096, 4096,
                      dict(bm=128, bn=128, bk=4096), None, "float32"))
        cases += _wgmma_cases()
        # a bf16 carry over 7 intervals with the loads producer on both operands ('nk', odd
        # K) or on B ('kn'): one interval of 1 (K 769) and M 33 of a 128-row tile
        for layout in ("nk", "kn"):
            cases.append((f"odd/33x785x769/bfloat16/{layout}", 1, 33, 785, 769,
                          dict(bm=128, bn=64, bk=128, acc_dtype="bfloat16", rhs_layout=layout),
                          None, "float32"))
        n_witnessed = 0
        for name, batch, m, n, k, kw, act, out in cases:
            cfg = KernelConfig(**kw)
            before = counters()
            errs, witnessed = zip(*(_check_case(torch, mods, gen, batch, m, n, k, cfg, act,
                                                out, zero_one) for zero_one in (True, False)))
            n_witnessed += sum(witnessed)
            key = next(key for key, v in counters().items() if v != before[key])
            if name.startswith("wgmma") and (not key.endswith("wgmma") or (
                    "single_k" in key) != (-(-k // cfg.bk) == 1)):
                raise AssertionError(f"{name} took {key}, not the wgmma route of its body")
            max_err[key] = max(max_err[key], errs[1])
            print(f"  {name} {cfg.bm}x{cfg.bn} bk={cfg.bk} out={out}: {key}, 0/1 exact, "
                  f"normal max|diff| {errs[1]:.3g}")
        # the 32-edge tiles: each case must move its route's, its tile kind's and (bf16,
        # bk 96) the mid-stage counter, once per input set
        narrow = _narrow_cases(mm)
        for name, batch, m, n, k, kw, act, out, offs in narrow:
            cfg = KernelConfig(**kw)
            before = counters()
            errs, witnessed = zip(*(_check_case(torch, mods, gen, batch, m, n, k, cfg, act,
                                                out, zero_one, offs)
                                    for zero_one in (True, False)))
            n_witnessed += sum(witnessed)
            moved = {key: v - before[key] for key, v in counters().items() if v != before[key]}
            lead = (batch,) if batch > 1 else ()
            probe_a = _offset(torch, torch.empty((*lead, m, k), dtype=torch.bfloat16,
                                                 device="cuda"), offs[0])
            probe_b = _offset(torch, torch.empty(
                (*lead, *((n, k) if cfg.rhs_layout == "nk" else (k, n))),
                dtype=torch.bfloat16, device="cuda"), offs[1])
            route = mm.launch_route(cfg, probe_a, probe_b, m, n, k)
            want = {key: 2 * v
                    for key, v in _narrow_want(mm, cfg, batch, m, n, k, route).items()}
            if moved != want:
                raise AssertionError(f"{name}: launches {moved}, expected {want}")
            for key in want:
                max_err[key] = max(max_err[key], errs[1])
            print(f"  {name} {batch}x{m}x{n}x{k} {cfg.bm}x{cfg.bn} bk={cfg.bk} out={out}: "
                  f"{'+'.join(want)}, 0/1 exact, normal max|diff| {errs[1]:.3g}")
        # the case of scripts/carry_witness_torch.py whose plain version lies beyond
        # allowed_error (33x785x769 'kn', seed 9: one element, 0.1875 against 0.1817)
        wgen = torch.Generator(device="cuda")
        wgen.manual_seed(9)
        odd = KernelConfig(bm=128, bn=64, bk=128, acc_dtype="bfloat16", rhs_layout="kn")
        err, witnessed = _check_case(torch, mods, wgen, 1, 33, 785, 769, odd, None,
                                     "float32", False)
        n_witnessed += witnessed
        print(f"  odd/33x785x769/bfloat16/kn seed 9: normal max|diff| {err:.3g}, "
              f"{witnessed} beyond allowed_error with the ring-order reference's bits")
        record["phase2_cases"] = len(cases) + len(narrow) + 1
        record["phase2_witnessed"] = n_witnessed
        print(f"  {n_witnessed} elements beyond allowed_error, each with the ring-order "
              f"reference's bits (a bf16 carry rounded to the other neighbour)")
        n_agree = _check_producers_agree(torch, lib, mm, KernelConfig, gen)
        print(f"  the loads producer on A, on B and on both gave the TMA producer's bits "
              f"({n_agree} direct cases: every tile, both layouts and families)")
        # the bf16 family's single interval with f32 output is the f32 sum: the kernel's
        # result must stand off its own bf16 rounding, as the f32 sum does
        m = n = k = 1000
        cfg = KernelConfig(bm=64, bn=64, bk=1024, acc_dtype="bfloat16")
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        got = mm.cuda_matmul(a, b, cfg, out_dtype=torch.float32)
        f32_sum = a.float() @ b.float()
        rounded = (got.bfloat16().float() - got).abs().max().item()
        record["bf16_family_gk1_f32_out"] = {
            "route": mm.launch_route(cfg, a, b, m, n, k),
            "max_diff_vs_f32_sum": (got - f32_sum).abs().max().item(),
            "max_diff_vs_own_bf16_rounding": rounded}
        print("  bf16 family, one interval, f32 out at 1000^3: "
              + json.dumps(record["bf16_family_gk1_f32_out"]))
        if record["bf16_family_gk1_f32_out"]["route"] != "wgmma" or rounded == 0.0:
            raise AssertionError("the bf16 family's single interval was rounded to bf16")
        # precision of both multi-K bodies at the headline shape against an f64 product,
        # beside cuBLAS's f32 product (the plain version's sum)
        m = n = k = 4096
        cfg = resolve_config(m, n, k, "float32")
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        ref = a.double() @ b.double()
        body = torch.empty((m, n), dtype=torch.float32, device="cuda")
        check_launch(mma["tl2_matmul_f32out"](*mm.launch_args(a, b, cfg, body, None, None,
                                                              1, m, n, k)), "tl2_matmul")
        outs = {"wgmma": mm.cuda_matmul(a, b, cfg, out_dtype=torch.float32),
                "mma_sync": body, "cublas_f32": a.float() @ b.float()}
        record["precision_vs_f64_4096"] = {name: (x.double() - ref).abs().max().item()
                                           for name, x in outs.items()}
        print(f"  max |err| vs an f64 product at 4096^3 ({cfg.bm}x{cfg.bn} bk={cfg.bk}): "
              + json.dumps(record["precision_vs_f64_4096"]))
        del a, b, ref, body, outs

    with phase("2b staged kernel vs plain"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        cases = _staged_cases(candidate_configs, KernelConfig, mm.WGMMA_TILES)
        seen = set()
        for name, m, n, k, kw, out, route, off_a in cases:
            cfg = KernelConfig(**kw)
            depth = pl.staged_depth(cfg.pipeline_depth, k // cfg.bk)
            splits = (pl.staged_splits(m, n, k, cfg.bm, cfg.bn, depth)
                      if route and route != "wide" else 1)
            narrow = 32 in (cfg.bm, cfg.bn)
            before = counters()
            errs = [_check_staged(torch, mm, pl, gen, m, n, k, cfg, out, zero_one, splits,
                                  repeat=splits > 1 and not zero_one, offset_a=off_a)
                    for zero_one in (True, False)]
            moved = {key: v - before[key] for key, v in counters().items() if v != before[key]}
            store = _store_want(mm, cfg, m, n)
            if route is None:  # gk == 1: one single-K launch per input set
                want = ({key: 2 for key in moved if key.startswith("single_k")}
                        or {"single_k": 2}) | {key: 2 for key in store}
            elif route == "wide":
                want = {"staged_wide": 2} | {key: 2 for key in store}
            else:  # a split case runs its normal inputs twice
                runs = 3 if splits > 1 else 2
                want = ({f"staged_{route}": runs} | ({"staged_split": runs} if splits > 1 else {})
                        | ({"staged_narrow": runs} if narrow else {})
                        | {key: runs for key in store})
            if moved != want:
                raise AssertionError(f"{name}: launches {moved}, expected {want}")
            if route is not None and route != "wide":
                seen.add((route, "narrow" if narrow else "wide", splits > 1))
                for key in want:
                    max_err[key] = max(max_err[key], errs[1])
            print(f"  {name} {cfg.bm}x{cfg.bn} bk={cfg.bk} out={out}: {route or 'single-K'}"
                  f"{f', {splits} splits, repeat bit-identical' if splits > 1 else ''}, 0/1 "
                  f"exact, normal max|diff| {errs[1]:.3g}")
        need = {("ring", tile, split) for tile in ("narrow", "wide") for split in (True, False)}
        if not need <= seen or not any(r == "ring_lsu" for r, _, _ in seen):
            raise AssertionError(f"phase 2b missed a tile kind, a split or a producer: {seen}")
        record["phase2b_cases"] = len(cases)
        # precision of the f32 sums at the tuning shape, against an f64 product: the ring
        # (one split, as its shape gives), the same ring split 8 ways (launched directly),
        # the ring on a 32-edge tile, tl2_staged.cu's mma.sync body on it (launched
        # directly), the plain version (cuBLAS f32) and one K interval (bk = K) on the
        # ring's tile
        m, n, k = TUNE_SHAPE
        cfg = next(KernelConfig(**kw) for _, *mnk, kw, _, _, _ in cases
                   if tuple(mnk) == TUNE_SHAPE)
        cfg = dataclasses.replace(cfg, rhs_layout="kn")
        narrow_cfg = KernelConfig(bm=32, bn=64, bk=cfg.bk, pipeline_depth=4)
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        ref = a.double() @ b.double()
        one = KernelConfig(bm=cfg.bm, bn=cfg.bn, bk=k)
        split8 = torch.empty((m, n), dtype=torch.float32, device="cuda")
        pl.launch_staged(a, b, cfg, split8, cfg.pipeline_depth, m, n, k, 8)
        staged_mma = torch.empty((m, n), dtype=torch.float32, device="cuda")
        check_launch(mma["tl2_staged"](a.data_ptr(), b.data_ptr(), staged_mma.data_ptr(), m, n,
                                       k, 32, 64, 4, 0, 0, 1,
                                       torch._C._cuda_getCurrentRawStream(0)), "tl2_staged")
        outs = {"staged_ring": pl.cuda_matmul_pipelined(a, b, cfg, out_dtype=torch.float32),
                "staged_ring_split8": split8,
                "staged_ring_32x64": pl.cuda_matmul_pipelined(a, b, narrow_cfg,
                                                              out_dtype=torch.float32),
                "staged_mma_sync_32x64": staged_mma,
                "plain": pl.pipelined_reference(a, b, "kn", torch.float32),
                f"one_interval_{mm.launch_route(one, a, b, m, n, k)}": mm.cuda_matmul(
                    a, b, one, out_dtype=torch.float32)}
        record["precision_vs_f64"] = {name: (x.double() - ref).abs().max().item()
                                      for name, x in outs.items()}
        print(f"  max |err| vs an f64 product at {m}x{n}x{k} ({cfg.bm}x{cfg.bn} depth "
              f"{cfg.pipeline_depth}; 32x64 depth 4 on the ring and on mma.sync): "
              + json.dumps(record["precision_vs_f64"]))
        del a, b, ref, outs, split8, staged_mma

    eval_mod = _script(repo, "eval_one_shape_torch")
    host_time = _script(repo, "host_time_torch")  # alone_ms: device time, no host time

    def run_slice(m, n, k, acc, base) -> dict:
        """eval_one_shape_torch's main(): gate -> bench -> summary; the gate must pass
        with no guard-band hit.  Returns the speedup row."""
        rc = eval_mod.main(["--mnk", str(m), str(n), str(k), "--acc", acc,
                            "--warmup_seconds", "1", "--benchmark_seconds", "2",
                            "--correctness_seconds", "20", "--correctness_iters", "3",
                            "--base_dir", str(base)])
        if rc != 0:
            raise AssertionError(f"eval_one_shape_torch failed for {m}x{n}x{k} {acc}")
        gate = json.loads((base / "zero_one_correctness_check_result.json").read_text())
        row = json.loads((base / "speedup_row.json").read_text())
        if not gate["pass"] or gate["stats"]["guard_hits"] or gate["variants"]["guard_hits"]:
            raise AssertionError(f"gate did not pass cleanly: {gate.get('failure')}")
        print(f"  {m}x{n}x{k} {acc}: gate pass, guard hits 0, speedups " + json.dumps(row))
        return {"mnk": [m, n, k], "acc": acc, "speedups": row,
                "gate_iterations": gate["stats"]["iterations"]}

    zero_counters()
    record["slice"] = []
    with phase("3 slice"):
        for (m, n, k), acc in SLICE_SHAPES + [(sh, "float32") for sh in FEW_CTA_SHAPES]:
            base = repo / "runs" / "chip_smoke" / f"{m}x{n}x{k}_{acc}"
            record["slice"].append(run_slice(m, n, k, acc, base))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        for batch, m, n, k in UNALIGNED_SHAPES:
            cfg = resolve_config(m, n, k)
            if batch > 1:
                a = _inputs(torch, gen, (batch, m, k), True)
                b = _inputs(torch, gen, (batch, k, n), True)
                got = dispatch.batched_matmul(a, b, out_dtype=torch.float32)
            else:
                a, b = _inputs(torch, gen, (m, k), True), _inputs(torch, gen, (k, n), True)
                got = dispatch.matmul(a, b, out_dtype=torch.float32)
            want = mm.matmul_reference(a, b, cfg.bk, out_dtype=torch.float32)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"entry point at {batch}x{m}x{n}x{k} is not exact")
            print(f"  entry point {batch}x{m}x{n}x{k} {cfg.bm}x{cfg.bn} bk={cfg.bk} "
                  f"({mm.launch_route(cfg, a, b, m, n, k)}): exact on 0/1 inputs")
        # decode-size products through the heuristic: the swapped and width-32 tiles
        for batch, m, n, k, layout in DECODE_ENTRY_SHAPES:
            cfg = resolve_config(m, n, k)
            lead = (batch,) if batch > 1 else ()
            a, b = (_inputs(torch, gen, (*lead, m, k), True),
                    _inputs(torch, gen, (*lead, k, n), True))
            if batch > 1:
                got = dispatch.batched_matmul(a, b, out_dtype=torch.float32)
            else:
                got = dispatch.matmul(a, b, b_t=b.t().contiguous() if layout == "nk" else None,
                                      config=dataclasses.replace(cfg, rhs_layout=layout),
                                      out_dtype=torch.float32)
            torch.cuda.synchronize()
            if not torch.equal(got, (a.float() @ b.float())):
                raise AssertionError(f"entry point at {batch}x{m}x{n}x{k} is not exact")
            print(f"  entry point {batch}x{m}x{n}x{k} {layout} {cfg.bm}x{cfg.bn} bk={cfg.bk}: "
                  "exact on 0/1 inputs")
        # a bf16-family config whose rounding points fall mid-stage (bk 96), on a swapped
        # tile and a wide one, against the plain version's rounding points
        for bm, bn in ((32, 64), (64, 64)):
            cfg = KernelConfig(bm=bm, bn=bn, bk=96, acc_dtype="bfloat16")
            a = _inputs(torch, gen, (24, 1000), True)
            b = _inputs(torch, gen, (1000, 520), True)
            got = dispatch.matmul(a, b, config=cfg, out_dtype=torch.float32)
            if not torch.equal(got, mm.matmul_reference(a, b, 96, "bfloat16",
                                                        out_dtype=torch.float32)):
                raise AssertionError(f"entry point at bk 96 ({bm}x{bn}) is not exact")
            print(f"  entry point 24x520x1000 {bm}x{bn} bk=96 bf16 acc (mid-stage rounding): "
                  "exact on 0/1 inputs")
        # 'kn' blocks whose columns start off 16 bytes (bn % 8 != 0 over several column
        # blocks), on the ring and the wide walk: the loads producer reads B (a TMA box there
        # would trap the launch)
        for m in (600, 2000):
            for bm, bn in ((128, 100), (300, 300), (1000, 300)):
                cfg = KernelConfig(bm=bm, bn=bn, bk=256)
                a = _inputs(torch, gen, (m, 256), True)
                b = _inputs(torch, gen, (256, 600), True)
                route = mm.launch_route(cfg, a, b, m, 600, 256)
                got = dispatch.matmul(a, b, config=cfg, out_dtype=torch.float32)
                torch.cuda.synchronize()
                if not route.endswith("lsu") or not torch.equal(got, a.float() @ b.float()):
                    raise AssertionError(f"entry point at {m}x600x256 {bm}x{bn} 'kn' ({route}) "
                                         "is not exact or not on the loads producer")
                print(f"  entry point {m}x600x256 kn {bm}x{bn} ({route}): exact on 0/1 inputs")
        # the entry point with a wide block (the thin-K band's stripes, tl2_wgmma_wide.cu):
        # 'kn' and 'nk' (b_t read with no copy), bias + relu, M and N off the block
        for (m, n, k), layout in (((4096, 8192, 64), "kn"), ((1000, 3000, 200), "nk")):
            cfg = KernelConfig(bm=256, bn=1024, bk=-(-k // 32) * 32, rhs_layout=layout)
            a, b = _inputs(torch, gen, (m, k), True), _inputs(torch, gen, (k, n), True)
            bias = torch.randint(0, 2, (n,), generator=gen, device="cuda").float()
            got = dispatch.matmul(a, b, config=cfg, bias=bias, activation="relu",
                                  b_t=b.t().contiguous(), out_dtype=torch.float32)
            if not torch.equal(got, torch.relu(a.float() @ b.float() + bias)):
                raise AssertionError(f"entry point at {m}x{n}x{k} (wide) is not exact")
            print(f"  entry point {m}x{n}x{k} {layout} {cfg.bm}x{cfg.bn} bk={cfg.bk} "
                  f"({mm.launch_route(cfg, a, b, m, n, k)}), bias + relu: exact on 0/1 inputs")
        # the entry points with the other wide variants: a K carry (resident and streamed
        # A, the bf16 family's rounding), a block above 2048 rows, batched (one interval and
        # a carry), and the loads producer (K % 8, a base 2 bytes off 16) on each
        for batch, (m, n, k), kw, off in PHASE3_WIDE:
            cfg = KernelConfig(**kw)
            lead = (batch,) if batch > 1 else ()
            a = _offset(torch, _inputs(torch, gen, (*lead, m, k), True), off)
            b = _inputs(torch, gen, (*lead, k, n), True)
            if batch > 1:
                got = dispatch.batched_matmul(a, b, config=cfg, out_dtype=torch.float32)
            else:
                got = dispatch.matmul(a, b, config=cfg, out_dtype=torch.float32)
            want = mm.matmul_reference(a, b, cfg.bk, cfg.acc_dtype, out_dtype=torch.float32)
            if not torch.equal(got, want):
                raise AssertionError(f"entry point at {batch}x{m}x{n}x{k} {cfg} is not exact")
            route = mm.launch_route(cfg, a[0] if batch > 1 else a, b[0] if batch > 1 else b,
                                    m, n, k)
            print(f"  entry point {batch}x{m}x{n}x{k} {cfg.bm}x{cfg.bn} bk={cfg.bk} "
                  f"{cfg.acc_dtype} ({route}): exact on 0/1 inputs")
        # the entry point with staged configs: a 32-edge tile over few output tiles (a
        # split), a ring tile whose one output tile splits K 48 ways, A's base 2 bytes off
        # 16 (the loads producer), and a staged wide block of the swapped walk (no split)
        for (m, n, k), (bm, bn), off in (((64, 256, 8192), (32, 64), 0),
                                         ((64, 64, 12288), (64, 64), 0),
                                         ((64, 256, 8192), (64, 64), 1),
                                         ((16, 1024, 4096), (16, 512), 0)):
            cfg = KernelConfig(bm=bm, bn=bn, bk=1024, pipeline_depth=4)
            a = _offset(torch, _inputs(torch, gen, (m, k), True), off)
            b = _inputs(torch, gen, (k, n), True)
            got = dispatch.matmul(a, b, config=cfg, out_dtype=torch.float32)
            route = pl.staged_route(cfg, a, b, m, n, k)
            splits = 1 if cfg.wide else pl.staged_splits(m, n, k, bm, bn, 4)
            if not torch.equal(got, pl.pipelined_reference(a, b, "kn", torch.float32, splits)):
                raise AssertionError(f"staged entry point at {m}x{n}x{k} is not exact")
            print(f"  entry point {m}x{n}x{k} staged {bm}x{bn} depth 4 ({route}, {splits} "
                  "splits): exact on 0/1 inputs")
    launches = counters()

    with phase("4 launch counts"):
        print("  " + json.dumps(launches))
        missing = [key for key, v in launches.items() if v <= 0 and key != "mma_sync"]
        if missing:
            raise AssertionError(f"main path never launched: {missing}")
        if launches["mma_sync"]:
            raise AssertionError(f"the main path launched an mma.sync body: {launches}")

    tuned = {}
    with phase("tune"):
        db_path = repo / "runs" / "chip_smoke" / "tunedb_h100.json"
        db_path.unlink(missing_ok=True)
        os.environ[db_mod.ENV_VAR] = str(db_path)
        db_mod.reset_default_db()
        record["tune"] = []
        for tm, tn, tk in TUNE_SHAPES:
            zero_counters()
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rc = tune_cli.main(["--mnk", str(tm), str(tn), str(tk), "--acc", "float32",
                                    "--max_candidates", "8", "--stage1_rounds", "3",
                                    "--stage2_rounds", "5", "--finalists", "4"])
            tune_launches = counters()
            if rc != 0:
                raise AssertionError(f"the tuner exited {rc} at {tm}x{tn}x{tk}")
            res = json.loads(printed.getvalue())
            print(f"  {tm}x{tn}x{tk} (device ms by CUDA graphs, then end to end):")
            for d in res["medians_ms"]:
                c = d["config"]
                name = (f"vendor {c['vendor_variant']}" if c["use_vendor"] else
                        f"{c['bm']}x{c['bn']} bk={c['bk']} {c['grid_order']} "
                        f"{c['rhs_layout']} depth={c['pipeline_depth']}")
                print(f"    {name}: device stage1 {d['stage1_ms']:.5f} ms, stage2 "
                      + ("-" if d["stage2_ms"] is None else f"{d['stage2_ms']:.5f} ms")
                      + f"; end to end {d['e2e_ms']:.5f} ms")
            if res["clock"] != "cuda_graph" or res["refused"]:
                raise AssertionError(f"clock {res['clock']}, refused {res['refused']}")
            best = KernelConfig(**res["best"])
            if not (best.use_vendor and best.vendor_variant == "torch_matmul") \
                    and res["speedup"] <= 1.10:
                raise AssertionError(f"{best} stored within the 10% margin of torch_matmul")
            # torch_matmul and cublas_nn are one library call: their device times, in turns
            # over fresh inputs, must agree within the tuner's 10% margin
            data = bu.fresh_inputs(np.random.default_rng(7), tm, tn, tk)
            same = {v: bu.GraphTimer(lambda a, b, b_t, v=v: baselines.vendor_product(
                v, a, b, b_t, torch.bfloat16), data, bu.bound_ms(tm, tn, tk))
                for v in ("torch_matmul", "cublas_nn")}
            same_ms = {v: [] for v in same}
            for r in range(10):
                bu.load_inputs(data, bu.fresh_inputs(np.random.default_rng(r), tm, tn, tk))
                for v in (("torch_matmul", "cublas_nn") if r % 2 else
                          ("cublas_nn", "torch_matmul")):
                    same_ms[v].append(same[v].time_ms())
            ratio = float(np.median(same_ms["cublas_nn"]) / np.median(same_ms["torch_matmul"]))
            print(f"    cublas_nn / torch_matmul device time {ratio:.4f} over 10 rounds in "
                  "turns (one library call: must be within 10%)")
            if abs(ratio - 1.0) > 0.10:
                raise AssertionError("two timings of one library call differ by > 10%")
            del data, same
            print(f"    winner: {json.dumps(res['best'])}, {res['best_tflops']:.2f} TFLOP/s, "
                  f"{res['speedup']:.4f}x vs torch_matmul "
                  f"({res['torch_matmul_tflops']:.2f} TFLOP/s); launches "
                  + json.dumps(tune_launches))
            staged = [d for d in res["medians_ms"] if d["config"]["pipeline_depth"] >= 2]
            if res["n_launched"] != res["n_candidates"]:
                raise AssertionError(f"only {res['n_launched']} of {res['n_candidates']} "
                                     "candidates launched")
            if len(staged) < 2:
                raise AssertionError(f"{len(staged)} staged candidates timed (need 2)")
            if not all(d["config"]["bm"] in mm.WGMMA_TILES
                       and d["config"]["bn"] in mm.WGMMA_TILES for d in staged):
                raise AssertionError("a staged candidate is not a ring tile")
            if tune_launches["staged_ring"] <= 0 or tune_launches["mma_sync"] != 0:
                raise AssertionError("the staged candidates did not launch on the ring, or "
                                     "an mma.sync body ran")
            if ((tm, tn, tk) != TUNE_SHAPE) != (tune_launches["staged_split"] > 0):
                raise AssertionError(f"split launches {tune_launches['staged_split']} at "
                                     f"{tm}x{tn}x{tk}")
            entry = db_mod.TuneDB(path=db_path).load().get_entry(tm, tn, tk, "float32")
            if entry is None or KernelConfig(**entry["config"]) != KernelConfig(**res["best"]):
                raise AssertionError(f"the winner is not on disk: {entry}")
            if entry["timing_rev"] != 2 or set(entry["e2e_ms"]) != {"best", "torch_matmul"}:
                raise AssertionError(f"the entry lacks timing_rev 2 or its end-to-end "
                                     f"times: {entry}")
            print(f"    stored: timing_rev {entry['timing_rev']}, device ms "
                  f"{json.dumps(entry['device_ms'])}, end-to-end ms "
                  f"{json.dumps(entry['e2e_ms'])}, {entry['nvidia_smi']}")
            tuned[tm, tn, tk] = res
            record["tune"].append({**res, "launches": tune_launches})

    with phase("tuned dispatch"):
        db_path = repo / "runs" / "chip_smoke" / "tunedb_staged.json"
        db_path.unlink(missing_ok=True)
        db = db_mod.TuneDB(path=db_path)
        staged_cfgs = {}
        for shape, res in tuned.items():
            staged = [d for d in res["medians_ms"] if d["config"]["pipeline_depth"] >= 2]
            fastest = min(staged, key=lambda d: d["stage1_ms"])
            staged_cfgs[shape] = KernelConfig(**fastest["config"])
            reference_ms = next(d["stage1_ms"] for d in res["medians_ms"]
                                if d["config"]["use_vendor"]
                                and d["config"]["vendor_variant"] == "torch_matmul")
            for acc in ("float32", "bfloat16"):
                db.put(*shape, dataclasses.replace(staged_cfgs[shape], acc_dtype=acc),
                       2.0 * math.prod(shape) / fastest["stage1_ms"] * 1e-9, acc=acc,
                       extra={"speedup_vs_torch_matmul": reference_ms / fastest["stage1_ms"]})
            print(f"  stored {staged_cfgs[shape]} at {shape} (stage1 "
                  f"{fastest['stage1_ms']:.5f} ms)")
        db.save()
        os.environ[db_mod.ENV_VAR] = str(db_path)
        db_mod.reset_default_db()
        record["tuned_dispatch"] = []
        record["tuned_dispatch_launches"] = {}
        for (tm, tn, tk), staged_cfg in staged_cfgs.items():
            for acc in ("float32", "bfloat16"):
                got = resolve_config(tm, tn, tk, acc)
                if got != dataclasses.replace(staged_cfg, acc_dtype=acc):
                    raise AssertionError(f"dispatch resolved {got}, not the stored staged "
                                         "config")
            zero_counters()
            record["tuned_dispatch"] += [
                run_slice(tm, tn, tk, acc, repo / "runs" / "chip_smoke" /
                          f"staged_{tm}x{tn}x{tk}_{acc}") for acc in ("float32", "bfloat16")]
            path_launches = counters()
            print(f"  {tm}x{tn}x{tk} launches " + json.dumps(path_launches))
            split = (tm, tn, tk) != TUNE_SHAPE
            if (path_launches["staged_ring"] <= 0 or path_launches["mma_sync"]
                    or (path_launches["staged_split"] > 0) != split):
                raise AssertionError("the tuned dispatch path did not launch the staged ring"
                                     + (" with a split" if split else " without a split"))
            record["tuned_dispatch_launches"][f"{tm}x{tn}x{tk}"] = path_launches
        pin_empty_db()  # phase 5 and later resolve through the heuristic again
    # the launches of each staged body on its main paths: the staged entry points of
    # phase 3 and the tuned dispatch path
    for key in launches:
        launches[key] += sum(c[key] for c in record["tuned_dispatch_launches"].values())

    # Representative main-path call of each kernel body, timed against its plain version:
    # both routes of each multi-K body on the same tile and inputs, then the single-K ones.
    kernels = []
    kernel_keys = []  # the launch counter of each row
    reference = []  # the mma.sync bodies: on no path, launched directly beside the ring
    record["shapes"] = []
    with phase("5 timing"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        m = n = k = 4096
        cfg = resolve_config(m, n, k, "float32")
        for batch in (1, GATE_BATCH):
            batched = batch > 1
            a = _inputs(torch, gen, (batch, m, k) if batched else (m, k), False)
            b = _inputs(torch, gen, (batch, k, n) if batched else (k, n), False)
            out = torch.empty((batch, m, n) if batched else (m, n), dtype=torch.bfloat16,
                              device="cuda")
            if mm.launch_route(cfg, a, b, m, n, k) != "wgmma":
                raise AssertionError(f"{cfg} does not take the wgmma route at 4096^3")
            call = mm.launch_args(a, b, cfg, out, None, None, batch, m, n, k)
            if batched:
                run = lambda: bmm.cuda_batched_matmul(a, b, cfg, out=out)  # noqa: E731
                plain = lambda: bmm.batched_matmul_reference(a, b, cfg.bk)  # noqa: E731
                library = lambda: torch.bmm(a, b)  # noqa: E731
            else:
                run = lambda: mm.cuda_matmul(a, b, cfg, out=out)  # noqa: E731
                plain = lambda: mm.matmul_reference(a, b, cfg.bk)  # noqa: E731
                library = lambda: torch.matmul(a, b)  # noqa: E731
            # the mma.sync body on the same tile, launched directly (no path takes it)
            mma_sync = lambda: check_launch(mma["tl2_matmul_bf16out"](*call),  # noqa: E731
                                            "tl2_matmul")
            turns = [_time_ms(torch, fn) for fn in (run, mma_sync, mma_sync, run)]
            plain_ms, library_ms = _time_ms(torch, plain), _time_ms(torch, library)
            bound_ms, bound_by = _bound(batch, m, n, k)
            prefix = "batched_" if batched else ""
            print(f"  {prefix}multi_k {batch}x{m}x{n}x{k} {cfg.bm}x{cfg.bn} bk={cfg.bk} in "
                  f"turns (wgmma, mma.sync, mma.sync, wgmma) ms: " + json.dumps(turns))
            record[f"{prefix}multi_k_turns_ms"] = turns
            key = f"{prefix}multi_k_wgmma"
            common = {"route": "cuda", "replaces": ("tpul2/ops/batched.py:25" if batched
                                                    else "tpul2/ops/matmul.py:96"),
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
            kernels.append({"name": f"tl2_wgmma{' batched' if batched else ''} (multi-K)",
                            "source": _ring_source(cfg, "wgmma"),
                            "launches": launches[key], "max_abs_err": max_err[key],
                            "ms": (turns[0] + turns[3]) / 2, **common})
            kernel_keys.append(key)
            mma_sync()
            reference.append({"name": f"tl2_matmul mma.sync{' batched' if batched else ''} "
                                      f"(multi-K, {cfg.bm}x{cfg.bn} bk={cfg.bk})",
                              "source": "tpul2_torch/csrc/tl2_matmul.cu", "launches": 0,
                              "max_abs_err": (out.float() - plain().float()).abs().max().item(),
                              "ms": (turns[1] + turns[2]) / 2, **common})
        del a, b, out
        # the single-K bodies alone on both routes, in turns (wgmma, mma.sync, mma.sync,
        # wgmma): CUDA graphs of direct launches, since the entry point's host time exceeds
        # their device time; torch.matmul (torch.bmm) the same way
        record["single_k_alone"] = []
        fns = {"wgmma": lib.tl2_wgmma_bf16out, "mma_sync": mma["tl2_matmul_bf16out"]}
        for batch, m, n, k, acc in ((1, 8192, 128, 64, "float32"),
                                    (GATE_BATCH, 8192, 128, 64, "float32"),
                                    (1, 1000, 1000, 1000, "float32"),
                                    (1, 1000, 1000, 1000, "bfloat16")):
            batched = batch > 1
            lead = (batch,) if batched else ()
            cfg = resolve_config(m, n, k, acc)
            a = _inputs(torch, gen, (*lead, m, k), False)
            b = _inputs(torch, gen, (*lead, k, n), False)
            out = torch.empty((*lead, m, n), dtype=torch.bfloat16, device="cuda")
            if mm.launch_route(cfg, a, b, m, n, k) != "wgmma" or -(-k // cfg.bk) != 1:
                raise AssertionError(f"{cfg} is not a single-K wgmma launch at {m}x{n}x{k}")

            def direct(route, a=a, b=b, cfg=cfg, out=out, batch=batch, m=m, n=n, k=k):
                def make():  # the arguments name the capturing stream
                    call = mm.launch_args(a, b, cfg, out, None, None, batch, m, n, k)
                    return lambda: check_launch(fns[route](*call), route)
                return make

            library = torch.bmm if batched else torch.matmul
            if batched:
                plain = lambda: bmm.batched_matmul_reference(a, b, cfg.bk)  # noqa: E731
                wrapper = lambda: bmm.cuda_batched_matmul(a, b, cfg, out=out)  # noqa: E731
            else:
                plain = lambda: mm.matmul_reference(a, b, cfg.bk, acc)  # noqa: E731
                wrapper = lambda: mm.cuda_matmul(a, b, cfg, out=out)  # noqa: E731
            turns = [host_time.alone_ms(torch, direct(route))
                     for route in ("wgmma", "mma_sync", "mma_sync", "wgmma")]
            bound_ms, bound_by = _bound(batch, m, n, k)
            row = {"batch": batch, "mnk": [m, n, k], "acc": acc,
                   "config": f"{cfg.bm}x{cfg.bn} bk={cfg.bk}", "turns_ms": turns,
                   "wgmma_ms": (turns[0] + turns[3]) / 2,
                   "mma_sync_ms": (turns[1] + turns[2]) / 2,
                   "torch_alone_ms": host_time.alone_ms(torch, lambda: (lambda: library(a, b))),
                   "wrapper_back_to_back_ms": _time_ms(torch, wrapper),
                   "plain_ms": _time_ms(torch, plain), "bound_ms": bound_ms,
                   "bound_by": bound_by}
            record["single_k_alone"].append(row)
            print("  single-K alone " + json.dumps(row))
            if (m, n, k) != (8192, 128, 64):
                continue
            key = f"{'batched_' if batched else ''}single_k_wgmma"
            common = {"route": "cuda", "replaces": ("tpul2/ops/batched.py:40" if batched
                                                    else "tpul2/ops/matmul.py:136"),
                      "plain_ms": row["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": row["torch_alone_ms"]}
            kernels.append({"name": f"tl2_wgmma{' batched' if batched else ''} (single-K)",
                            "source": _ring_source(cfg, "wgmma"),
                            "launches": launches[key], "max_abs_err": max_err[key],
                            "ms": row["wgmma_ms"], **common})
            kernel_keys.append(key)
            direct("mma_sync")()()
            reference.append({"name": f"tl2_matmul mma.sync{' batched' if batched else ''} "
                                      f"(single-K, {cfg.bm}x{cfg.bn})",
                              "source": "tpul2_torch/csrc/tl2_matmul.cu", "launches": 0,
                              "max_abs_err": (out.float() - plain().float()).abs().max().item(),
                              "ms": row["mma_sync_ms"], **common})
        del a, b, out
        # the staged kernel alone at the tuning shape: the ring on the config the tuned path
        # dispatched against tl2_staged.cu's 32x64 at depth 4 (launched directly), in turns
        # (CUDA graphs, so no host time enters)
        tm, tn, tk = TUNE_SHAPE
        ring_cfg = dataclasses.replace(staged_cfgs[TUNE_SHAPE], acc_dtype="float32")
        mma_cfg = KernelConfig(bm=32, bn=64, bk=ring_cfg.bk, pipeline_depth=4)
        a, b = _inputs(torch, gen, (tm, tk), False), _inputs(torch, gen, (tk, tn), False)
        b_t = b.t().contiguous()
        out = torch.empty((tm, tn), dtype=torch.bfloat16, device="cuda")

        def staged_call(cfg, a=a, b=b, b_t=b_t, out=out):
            rhs = b_t if cfg.rhs_layout == "nk" else b
            return lambda: (lambda: pl.cuda_matmul_pipelined(a, rhs, cfg, out=out))

        def staged_mma(cfg, a=a, b=b, b_t=b_t, out=out):
            """tl2_staged.cu on cfg, launched directly (no path takes it)."""
            m, k = a.shape
            n = out.shape[1]
            rhs = b_t if cfg.rhs_layout == "nk" else b

            def make():
                args = (a.data_ptr(), rhs.data_ptr(), out.data_ptr(), m, n, k, cfg.bm, cfg.bn,
                        cfg.pipeline_depth, int(cfg.rhs_layout == "nk"),
                        int(cfg.grid_order == "nm"), int(out.dtype == torch.float32),
                        torch._C._cuda_getCurrentRawStream(0))
                return lambda: check_launch(mma["tl2_staged"](*args), "tl2_staged")
            return make

        turns = [host_time.alone_ms(torch, fn) for fn in (
            staged_call(ring_cfg), staged_mma(mma_cfg), staged_mma(mma_cfg),
            staged_call(ring_cfg))]
        plain_ms = _time_ms(torch, lambda: pl.pipelined_reference(a, b))
        library_ms = host_time.alone_ms(torch, lambda: (lambda: torch.matmul(a, b)))
        bound_ms, bound_by = _bound(1, tm, tn, tk)
        record["staged_alone_turns_ms"] = {"ring": str(ring_cfg), "mma_sync": str(mma_cfg),
                                           "turns_ms": turns, "torch_alone_ms": library_ms}
        print(f"  staged alone at {tm}x{tn}x{tk} in turns (ring {ring_cfg.bm}x{ring_cfg.bn} "
              f"{ring_cfg.rhs_layout} d{ring_cfg.pipeline_depth}, mma.sync 32x64 d4, mma.sync, "
              f"ring) ms: {json.dumps(turns)}; torch.matmul alone {library_ms:.5f}")
        common = {"route": "cuda", "replaces": "tpul2/ops/pipelined.py:39",
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": library_ms}
        kernels.append({"name": (f"tl2_wgmma_staged ring ({ring_cfg.bm}x{ring_cfg.bn} "
                                 f"{ring_cfg.rhs_layout} depth {ring_cfg.pipeline_depth}, "
                                 f"{tm}x{tn}x{tk}, one split)"),
                        "source": _ring_source(ring_cfg, "ring"),
                        "launches": launches["staged_ring"],
                        "max_abs_err": max_err["staged_ring"],
                        "ms": (turns[0] + turns[3]) / 2, **common})
        kernel_keys.append("staged_ring")
        staged_mma(mma_cfg)()()
        reference.append({"name": f"tl2_staged mma.sync (32x64 kn depth 4, {tm}x{tn}x{tk})",
                          "source": "tpul2_torch/csrc/tl2_staged.cu", "launches": 0,
                          "max_abs_err": (out.float() - pl.pipelined_reference(a, b).float()
                                          ).abs().max().item(),
                          "ms": (turns[1] + turns[2]) / 2, **common})
        # every depth (same inputs, alone): the 64x64 and 32x64 rings, tl2_staged.cu's 32x64
        sweep = {}
        for depth in PIPELINE_DEPTHS[1:]:
            c64 = KernelConfig(bm=64, bn=64, bk=ring_cfg.bk, pipeline_depth=depth)
            c32 = dataclasses.replace(mma_cfg, pipeline_depth=depth)
            sweep[depth] = {"64x64 ring": host_time.alone_ms(torch, staged_call(c64)),
                            "32x64 ring": host_time.alone_ms(torch, staged_call(c32)),
                            "32x64 mma.sync": host_time.alone_ms(torch, staged_mma(c32))}
        record["staged_depth_sweep_alone_ms"] = sweep
        print("  staged depth sweep alone (ms): " + json.dumps(sweep))
        # the skinny serving shape (same inputs): the heuristic's tile against the 32x64
        # tile (swapped, on the ring) and the 64x128 one, through the wrapper in turns, then
        # each alone
        heuristic = resolve_config(tm, tn, tk, "float32")
        if heuristic.bm != 64 or mm.launch_route(heuristic, a, b, tm, tn, tk) != "wgmma":
            raise AssertionError(f"the heuristic's {heuristic} at {tm}x{tn}x{tk} is not a "
                                 "64-row tile with TMA")
        tiles = [heuristic] + [KernelConfig(bm=bm, bn=bn, bk=heuristic.bk)
                               for bm, bn in ((32, 64), (64, 128))]
        skinny = {f"{c.bm}x{c.bn} bk={c.bk}": {"route": mm.launch_route(c, a, b, tm, tn, tk),
                                               "ms": []} for c in tiles}
        for c in tiles + tiles[::-1]:
            skinny[f"{c.bm}x{c.bn} bk={c.bk}"]["ms"].append(
                _time_ms(torch, lambda c=c: mm.cuda_matmul(a, b, c)))
        out = torch.empty((tm, tn), dtype=torch.bfloat16, device="cuda")
        for c in tiles:
            fn = fns[mm.launch_route(c, a, b, tm, tn, tk)]

            def make(c=c, fn=fn):
                call = mm.launch_args(a, b, c, out, None, None, 1, tm, tn, tk)
                return lambda: check_launch(fn(*call), "skinny")

            skinny[f"{c.bm}x{c.bn} bk={c.bk}"]["alone_ms"] = host_time.alone_ms(torch, make)
        record["skinny_tiles"] = skinny
        print(f"  {tm}x{tn}x{tk} tiles in turns (ms): " + json.dumps(skinny))
        # the few-CTA streaming shapes: the heuristic config (both families), the fastest of
        # the tuner's staged candidates there (alone), and torch.matmul, each alone (a CUDA
        # graph of direct launches) and through the entry point (back to back), in turns
        record["few_cta"] = []
        for m, n, k in FEW_CTA_SHAPES:
            a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
            b_t = b.t().contiguous()
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            candidates = {c: host_time.alone_ms(torch, staged_call(c, a, b, b_t, out))
                          for c in candidate_configs(m, n, k, "float32") if c.pipeline_depth >= 2}
            best = min(candidates, key=candidates.get)
            depth = pl.staged_depth(best.pipeline_depth, k // best.bk)
            heur = {acc: heuristic_config(m, n, k, acc) for acc in ("float32", "bfloat16")}

            def direct(cfg, a=a, b=b, out=out, m=m, n=n, k=k):
                def make():
                    call = mm.launch_args(a, b, cfg, out, None, None, 1, m, n, k)
                    fn = fns[mm.launch_route(cfg, a, b, m, n, k)]
                    return lambda: check_launch(fn(*call), "heuristic")
                return make

            alone_fns = {"heuristic_f32": direct(heur["float32"]),
                         "heuristic_bf16": direct(heur["bfloat16"]),
                         "staged": staged_call(best, a, b, b_t, out),
                         "torch_matmul": lambda a=a, b=b: (lambda: torch.matmul(a, b))}
            entry_fns = {"heuristic_f32": lambda a=a, b=b, b_t=b_t, out=out: dispatch.matmul(
                             a, b, acc="float32", b_t=b_t, out=out),
                         "heuristic_bf16": lambda a=a, b=b, b_t=b_t, out=out: dispatch.matmul(
                             a, b, acc="bfloat16", b_t=b_t, out=out),
                         "staged": lambda a=a, b=b, b_t=b_t, out=out, c=best: dispatch.matmul(
                             a, b, config=c, b_t=b_t, out=out),
                         "torch_matmul": lambda a=a, b=b: torch.matmul(a, b)}
            order = list(alone_fns) + list(alone_fns)[::-1]
            alone = {key: [] for key in alone_fns}
            entry = {key: [] for key in alone_fns}
            for key in order:
                alone[key].append(host_time.alone_ms(torch, alone_fns[key]))
            for key in order:
                entry[key].append(_time_ms(torch, entry_fns[key]))
            bound_ms, bound_by = _bound(1, m, n, k)
            row = {"mnk": [m, n, k],
                   "heuristic": f"{heur['float32'].bm}x{heur['float32'].bn} "
                                f"bk={heur['float32'].bk}",
                   "heuristic_ctas": (m // heur["float32"].bm) * (n // heur["float32"].bn),
                   "staged": str(best), "staged_splits": pl.staged_splits(
                       m, n, k, best.bm, best.bn, depth),
                   "staged_candidates_alone_ms": {
                       f"{c.grid_order} {c.rhs_layout} d{c.pipeline_depth}": ms
                       for c, ms in candidates.items()},
                   "alone_ms": alone, "entry_ms": entry, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            record["few_cta"].append(row)
            print("  few-CTA " + json.dumps(row))
        # the split launch alone at 64x64x12288 on the tuned dispatch's config, and the
        # reduction alone on a workspace of its size
        m, n, k = FEW_CTA_SHAPES[0]
        split_cfg = dataclasses.replace(staged_cfgs[FEW_CTA_SHAPES[0]], acc_dtype="float32")
        depth = pl.staged_depth(split_cfg.pipeline_depth, k // split_cfg.bk)
        splits = pl.staged_splits(m, n, k, split_cfg.bm, split_cfg.bn, depth)
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        b_t = b.t().contiguous()
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        rhs = b_t if split_cfg.rhs_layout == "nk" else b
        bound_ms, bound_by = _bound(1, m, n, k)
        kernels.append({
            "name": (f"tl2_wgmma_staged ring, split K ({split_cfg.bm}x{split_cfg.bn} "
                     f"{split_cfg.rhs_layout} depth {split_cfg.pipeline_depth}, {m}x{n}x{k}, "
                     f"{splits} splits + reduction)"),
            "route": "cuda", "source": _ring_source(split_cfg, "ring"),
            "replaces": "tpul2/ops/pipelined.py:39", "launches": launches["staged_split"],
            "max_abs_err": max_err["staged_split"],
            "ms": host_time.alone_ms(torch, staged_call(split_cfg, a, b, b_t, out)),
            "plain_ms": _time_ms(torch, lambda: pl.pipelined_reference(
                a, rhs, split_cfg.rhs_layout, torch.bfloat16, splits)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": host_time.alone_ms(torch, lambda: (lambda: torch.matmul(a, b)))})
        kernel_keys.append("staged_split")
        ws = torch.randn((splits, m, n), generator=gen, device="cuda")

        def reduce_plain():
            acc = ws[0]
            for s in range(1, splits):
                acc = acc + ws[s]
            return acc.to(torch.bfloat16)

        def make_reduce():
            stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
            return lambda: check_launch(lib.tl2_splitk_reduce(
                ws.data_ptr(), out.data_ptr(), m, n, splits, 0, stream), "tl2_splitk_reduce")

        make_reduce()()
        reduce_err = (out.float() - reduce_plain().float()).abs().max().item()
        kernels.append({
            "name": f"tl2_splitk_reduce ({splits} x {m}x{n} f32 -> bf16, split order)",
            "route": "cuda", "source": "tpul2_torch/csrc/tl2_wgmma.cu",
            "replaces": "tpul2/ops/pipelined.py:39", "launches": launches["staged_split"],
            "max_abs_err": reduce_err, "ms": host_time.alone_ms(torch, make_reduce),
            "plain_ms": _time_ms(torch, reduce_plain),
            "bound_ms": (splits * m * n * 4 + m * n * 2) / PEAK_BYTES * 1e3,
            "bound_by": "bytes",
            "library_ms": host_time.alone_ms(torch, lambda: (lambda: torch.sum(ws, 0)))})
        kernel_keys.append("staged_split")
        if reduce_err != 0.0:
            raise AssertionError(f"the reduction differs from the split-order sum by "
                                 f"{reduce_err}")
        for row in kernels:
            print("  " + json.dumps(row))
        for (m, n, k), acc in SLICE_SHAPES:
            cfg = resolve_config(m, n, k, acc)
            a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
            b_t = b.t().contiguous()
            cand = candidate_fn(acc)
            t = {"kernel_ms": _time_ms(torch, lambda: cand(a, b, b_t)),
                 "plain_ms": _time_ms(torch, lambda: mm.matmul_reference(a, b, cfg.bk, acc)),
                 "torch_matmul_ms": _time_ms(torch, lambda: torch.matmul(a, b))}
            t["kernel_tflops"] = 2 * m * n * k / t["kernel_ms"] * 1e-9
            t["torch_matmul_tflops"] = 2 * m * n * k / t["torch_matmul_ms"] * 1e-9
            # host time of one entry-point call: 20 calls enqueued with no wait between them
            # (the card's queue absorbs them), on the host clock
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                cand(a, b, b_t)
            t["host_ms_per_call"] = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
            print(f"  {m}x{n}x{k} {acc} cfg {cfg.bm}x{cfg.bn} bk={cfg.bk}: " + json.dumps(t))
            record["shapes"].append({"mnk": [m, n, k], "acc": acc, **t})
    record["kernels"] = kernels

    with phase("decode"):
        record["decode"], rows, keys, refs, decode_launches = _decode_phase(
            torch, lib, mma, counters, zero_counters, use_db, host_time)
        kernels += rows
        kernel_keys += keys
        reference += refs

    with phase("lt-autotune"):
        from tpul2_torch.ops import lt_autotune
        gen = torch.Generator(device="cuda")
        gen.manual_seed(6)
        record["lt_autotune"] = []
        for m, n, k in ((4096, 4096, 4096), TUNE_SHAPE):
            a, b = _inputs(torch, gen, (m, k), True), _inputs(torch, gen, (k, n), True)
            b_t = b.t().contiguous()
            want = torch.mm(a, b)
            for layout, rhs in (("nn", b), ("tn", b_t)):
                found = lt_autotune.search(m, n, k, layout)
                for algo in [-1] + list(range(found.n_algos)):
                    got = lt_autotune.lt_matmul(a, rhs, layout, algo=algo)
                    if not torch.equal(got, want):
                        raise AssertionError(f"cuBLASLt algo {algo} at {m}x{n}x{k} {layout} "
                                             "is not exact on 0/1 inputs")
                row = {"mnk": [m, n, k], "layout": layout, "n_algos": found.n_algos,
                       "n_skipped": found.n_skipped, "best": found.best,
                       "best_median_ms": found.medians_ms[found.best],
                       "medians_ms": found.medians_ms, "search_s": found.seconds,
                       "alone_ms": host_time.alone_ms(torch, lambda rhs=rhs, layout=layout: (
                           lambda: lt_autotune.lt_matmul(a, rhs, layout))),
                       "torch_matmul_alone_ms": host_time.alone_ms(
                           torch, lambda: (lambda: torch.matmul(a, b)))}
                record["lt_autotune"].append(row)
                print(f"  {m}x{n}x{k} {layout}: {found.n_algos} algos kept, {found.n_skipped} "
                      f"skipped, winner {found.best} ({row['best_median_ms']:.5f} ms in the "
                      f"search; alone {row['alone_ms']:.5f} ms, torch.matmul alone "
                      f"{row['torch_matmul_alone_ms']:.5f}); every algo exact on 0/1 inputs")

    with phase("sentinel"):
        m = n = k = 4096
        a, b = _inputs(torch, gen, (m, k), False), _inputs(torch, gen, (k, n), False)
        b_t = b.t().contiguous()
        bias = torch.randn((n,), generator=gen, device="cuda")
        gelu = mm.ACTIVATIONS["gelu"]

        def old_f32():  # the sentinel before this change: f32 copies, an f32 GEMM
            return torch.matmul(a.float(), b.float())

        paths = {
            "f32_out": {"old": old_f32,
                        "new": lambda: baselines.vendor_product("torch_matmul", a, b, b_t,
                                                                torch.float32)},
            "bias_gelu": {"old": lambda: gelu(old_f32() + bias),
                          "new": lambda: dispatch.matmul(
                              a, b, config=KernelConfig.vendor(), bias=bias,
                              activation="gelu", out_dtype=torch.float32)}}
        record["sentinel"] = {}
        for name, fns in paths.items():
            turns = [_time_ms(torch, fns[key], reps=10) for key in ("old", "new", "new", "old")]
            record["sentinel"][name] = {"turns_ms": turns, "old_ms": (turns[0] + turns[3]) / 2,
                                        "new_ms": (turns[1] + turns[2]) / 2}
            print(f"  {name} at 4096^3 in turns (old, new, new, old) ms: {json.dumps(turns)}")
        za, zb = _inputs(torch, gen, (m, k), True), _inputs(torch, gen, (k, n), True)
        zbias = torch.randint(0, 2, (n,), generator=gen, device="cuda").float()
        old = torch.relu(za.float() @ zb.float() + zbias)
        new = dispatch.matmul(za, zb, config=KernelConfig.vendor(), bias=zbias,
                              activation="relu", out_dtype=torch.float32)
        if not torch.equal(old, new) or not torch.equal(
                baselines.vendor_product("cublas_tn", za, zb, zb.t().contiguous(),
                                         torch.float32), za.float() @ zb.float()):
            raise AssertionError("the bf16-in, f32-out sentinel is not exact on 0/1 inputs")
        print("  new path exact on 0/1 inputs against the old (f32 out, bias + relu)")
        del a, b, b_t, za, zb, old, new

    with phase("server slice"):
        record["server_slice"] = []
        zero_counters()
        for (m, n, k) in ((64, 8192, 8192), (1000, 1000, 1000)):
            for acc in ("float32", "bfloat16"):
                base = repo / "runs" / "chip_smoke" / f"server_{m}x{n}x{k}_{acc}"
                rc = eval_mod.main(["--mnk", str(m), str(n), str(k), "--acc", acc,
                                    "--mode", "server", "--target_qps", "100",
                                    "--warmup_seconds", "0.5", "--benchmark_seconds", "1.5",
                                    "--correctness_seconds", "20", "--correctness_iters",
                                    "3", "--base_dir", str(base)])
                gate = json.loads((base / "zero_one_correctness_check_result.json").read_text())
                res = json.loads((base / "benchmark_result_torch_matmul.json").read_text())
                if rc != 0 or not gate["pass"] or gate["mode"] != "server":
                    raise AssertionError(f"server slice failed at {m}x{n}x{k} {acc}")
                if res["mode"] != "server" or res["target_qps"] != 100.0 or not all(
                        key in res[pf] for pf in ("torch_matmul", "tpul2_torch")
                        for key in ("p50_ms", "p99_ms")):
                    raise AssertionError(f"server result lacks p50/p99 or target_qps: {res}")
                row = json.loads((base / "speedup_row.json").read_text())
                record["server_slice"].append({
                    "mnk": [m, n, k], "acc": acc, "speedups": row,
                    "candidate_p50_p99_ms": [res["tpul2_torch"]["p50_ms"],
                                             res["tpul2_torch"]["p99_ms"]],
                    "torch_matmul_p50_p99_ms": [res["torch_matmul"]["p50_ms"],
                                                res["torch_matmul"]["p99_ms"]],
                    "iters": res["tpul2_torch"]["iters"]})
                print(f"  {m}x{n}x{k} {acc} server: " + json.dumps(record["server_slice"][-1]))
        server_launches = counters()
        print("  launches " + json.dumps(server_launches))
        record["server_slice_launches"] = server_launches
        if server_launches["multi_k_wgmma"] <= 0 or server_launches["single_k_wgmma"] <= 0:
            raise AssertionError("the server slice did not run the wgmma ring")

    with phase("committed-DB slice"):
        committed = repo / "tpul2_torch" / "data" / "tunedb_h100.json"
        if not committed.exists():
            raise AssertionError(f"{committed} is missing")
        os.environ.pop(db_mod.ENV_VAR)
        db_mod.reset_default_db()
        db = db_mod.default_db()
        if db.path != committed:
            raise AssertionError(f"the default DB is {db.path}, not the committed one")
        from tpul2_torch.harness.suite import DEFAULT_SHAPES
        summary = {}
        for acc in ("float32", "bfloat16"):
            for mode in ("offline", "server"):
                cfgs = [resolve_config(*sh, acc, mode=mode) for sh in DEFAULT_SHAPES]
                entries = [db.get_entry(*sh, acc) for sh in DEFAULT_SHAPES]
                stored = [None if e is None else KernelConfig(**(
                    e.get("server", e) if mode == "server" else e)["config"])
                    for e in entries]
                summary[f"{acc}/{mode}"] = {
                    "entries": sum(e is not None for e in entries),
                    "server_entries": sum(e is not None and "server" in e for e in entries),
                    "sentinel": sum(c.use_vendor for c in cfgs),
                    "refused_by_card": sum(c.use_vendor and x is not None and not x.use_vendor
                                           for c, x in zip(cfgs, stored))}
        print("  of the 20 DEFAULT_SHAPES (resolved to the sentinel; stored kernel configs the "
              "card refuses): " + json.dumps(summary))
        record["committed_db"] = summary
        if any(v["entries"] != len(DEFAULT_SHAPES) for v in summary.values()):
            raise AssertionError("the committed DB does not cover DEFAULT_SHAPES")
        suite_mod = _script(repo, "run_suite_torch")
        out_dir = repo / "runs" / "chip_smoke" / "suite"
        for f in out_dir.glob("*"):
            f.unlink()
        shapes = "64,8192,8192;64,64,12288;8192,128,64"
        zero_counters()
        for acc in ("float32", "bfloat16"):
            rc = suite_mod.main(["eval", "--acc", acc, "--shapes", shapes, "--out_dir",
                                 str(out_dir), "--warmup_seconds", "0.5",
                                 "--benchmark_seconds", "1", "--correctness_iters", "2"])
            if rc != 0:
                raise AssertionError(f"run_suite_torch failed ({acc})")
            text = (out_dir / f"tpul2_torch_h100_{acc}_speedup_offline.csv").read_text()
            print("  " + text.replace("\n", "\n  ").rstrip())
            record[f"committed_db_csv_{acc}"] = text
        record["committed_db_launches"] = counters()
        print("  launches " + json.dumps(record["committed_db_launches"]))

    with phase("campaign"):
        record["campaign"], campaign_launches = _campaign_phase(torch, repo, counters,
                                                                zero_counters, use_db)
    with phase("grid tune"):
        record["grid_tune"], grid_tune_launches = _grid_tune_phase(repo, counters,
                                                                   zero_counters)
    with phase("thin-K"):
        record["thin_k"], thin_rows, thin_keys, thin_k_launches = _thin_k_phase(
            torch, repo, lib, mods, counters, zero_counters, host_time)
        kernels += thin_rows
        kernel_keys += thin_keys
    with phase("wide"):
        record["wide"], wide_rows, wide_keys, wide_launches = _wide_phase(
            torch, repo, lib, mods, counters, zero_counters, host_time)
        kernels += wide_rows
        kernel_keys += wide_keys
    with phase("jax space"):
        record["jax_space"], space_rows, space_keys, space_launches = _jax_space_phase(
            torch, repo, lib, mods, counters, zero_counters, host_time)
        kernels += space_rows
        kernel_keys += space_keys
    with phase("model"):
        record["model"], model_launches = _model_phase(torch, counters, zero_counters, use_db)
    with phase("parallel"):
        record["parallel"], parallel_launches = _parallel_phase(torch, repo, counters,
                                                                zero_counters, use_db)
    # each kernel row's launches: its main paths', the campaign's, the grid tune's, the
    # thin-K retune's, the model path's, the parallel layer's and the seq-16 block's; no
    # path launched an mma.sync body
    paths = {"campaign": campaign_launches, "grid tune": grid_tune_launches,
             "thin-K": thin_k_launches, "wide": wide_launches, "jax space": space_launches,
             "model": model_launches, "parallel": parallel_launches,
             "decode block": decode_launches}
    for name, got in paths.items():
        if got["mma_sync"]:
            raise AssertionError(f"the {name} path launched an mma.sync body: {got}")
    for row, key in zip(kernels, kernel_keys):
        row["launches"] = launches[key] + sum(got[key] for got in paths.values())
        if row["launches"] <= 0:
            raise AssertionError(f"no path launched {row['name']}")

    if "jax" in sys.modules:
        raise AssertionError("jax was imported on the port's path")
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(record, indent=1))
    print(json.dumps({"reference_kernels": reference}))
    print(info["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
