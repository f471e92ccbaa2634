"""The staged GEMM (the kStage axis): wrapper of its two kernel bodies and its plain version.

Counterpart of ``tpul2/ops/pipelined.py``: ``cuda_matmul_pipelined`` plays
``pallas_matmul_pipelined``.  The K loop runs inside the CTA over a ring of
``pipeline_depth`` K stages in shared memory that asynchronous copies keep filled ahead of
the MMAs.  The sum is f32 over the whole K whatever ``acc_dtype`` says, then one cast, so in
the bf16 family a staged config answers differently from ``cuda_matmul``, which rounds the
carry after every bk interval.

Two bodies, picked per launch by ``staged_route`` from the shape before the launch
(``tl2_staged_route`` mirrors it; a launch outside its route is refused, never redirected):
  'ring'      bm and bn in WGMMA_TILES, operands TMA can read: ``tl2_wgmma_staged``
              (csrc/tl2_wgmma.cu), the TMA + wgmma ring's f32-carry instance.
              ``pipeline_depth`` is the ring's depth in 64-deep TMA stages (WGMMA_KSTAGE):
              depth d keeps up to d stages (64·d of K) in flight.  Where the output has
              few tiles, the launch splits K (``staged_splits``, below);
  'mma_sync'  a 32-edge tile, which has no m64 wgmma form: ``tl2_staged``
              (csrc/tl2_staged.cu), mma.sync fed by cp.async.  ``pipeline_depth`` counts
              32-deep slices (config.KSTEP): depth d keeps d - 1 slices in flight.
Neither ring holds a bk-deep block, as the JAX kernel's DMA slots do (one would not fit
shared memory at the tuning shape's bk = 1024).  bk reaches the staged path only through
the JAX rules below (divisibility, the clamp, the gk == 1 route, where bk is the single-K
kernel's interval); ``candidate_configs`` never offers two staged candidates that differ in
bk alone.

Split K.  The TPU kernel's grid runs in order on one core; on the H100 one CTA per output
tile leaves most of the 132 SMs idle at the skinny streaming shapes where the tuner offers
staged configs.  A ring launch with ``splits`` > 1 gives split s the K range
``split_bounds(k, splits)[s]`` (whole 64-deep stages; TMA zero-fills the last one's K
tail), writes each split's f32 partial into a workspace the wrapper allocates (splits x M x
N f32), then a second kernel on the same stream adds the partials of each element in split
order and casts once.  No atomics: two runs on the same inputs give the same bits.

The JAX package's rules hold: the RHS follows ``rhs_layout`` ((K, N) for 'kn', (N, K) for
'nk'); depth >= 2 or ValueError; every dim must divide its block or ValueError; the depth
is clamped to gk = K // bk, and gk == 1 goes to the single-K kernel.  For a CUDA tensor
the wrapper launches the kernel or raises; for a CPU tensor it runs
``pipelined_reference`` with the split count the launch would take.  Nothing falls back
from a kernel to another kernel or to the plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpul2_torch.config import NUM_SMS, WGMMA_KSTAGE, WGMMA_TILES, KernelConfig
from tpul2_torch.ops._build import check_launch, load_library
from tpul2_torch.ops.matmul import _vector_ok, check_operands, cuda_matmul, cuda_matmul_tn
from tpul2_torch.utils.padding import cdiv

#: Launches of the staged kernel (the port of ``pipelined._kernel``) by route: the TMA +
#: wgmma ring and the mma.sync body; and of the ring launches that split K (each also
#: launches the split-K reduction).  Counted where a kernel is launched and nowhere else:
#: not on the gk == 1 path.
LAUNCHES_STAGED_RING = 0
LAUNCHES_STAGED_MMA_SYNC = 0
LAUNCHES_STAGED_SPLIT = 0


def split_bounds(k: int, splits: int) -> list:
    """The K range [k0, k1) of each split: runs of cdiv(cdiv(k, 64), splits) whole 64-deep
    stages in order, the last ending at k.  Raises if a split would be empty."""
    steps = cdiv(k, WGMMA_KSTAGE)
    per = cdiv(steps, splits) if splits >= 1 else 0
    if splits < 1 or cdiv(steps, per) != splits:
        raise ValueError(f"{splits} splits of {steps} K stages leave a split empty")
    return [(s * per * WGMMA_KSTAGE, min(k, (s + 1) * per * WGMMA_KSTAGE))
            for s in range(splits)]


def staged_splits(m: int, n: int, k: int, bm: int, bn: int, depth: int) -> int:
    """The split count of a ring launch at this shape, tile and (clamped) depth.

    max(1, min(NUM_SMS // tiles, cdiv(k, 64) // depth)): enough splits to give each of the
    card's SMs about one CTA, but no more than leave each split ``depth`` stages, so that
    its ring fills.  Then rounded down to the count whose runs of cdiv(stages, splits)
    stages leave no split empty.  1 wherever the tiles alone fill the card (64 x 8192 x
    8192 on 64 x 64: 128 tiles)."""
    steps = cdiv(k, WGMMA_KSTAGE)
    want = max(1, min(NUM_SMS // (cdiv(m, bm) * cdiv(n, bn)), steps // depth))
    return cdiv(steps, cdiv(steps, want))


def pipelined_reference(a: torch.Tensor, rhs: torch.Tensor, rhs_layout: str = "kn",
                        out_dtype: torch.dtype = torch.bfloat16,
                        splits: int = 1) -> torch.Tensor:
    """Plain torch version: the f32 product over each split's K range
    (``split_bounds``), the partials added in split order in f32, then the cast.  One
    split is one f32 product over all of K."""
    b = rhs.transpose(-1, -2) if rhs_layout == "nk" else rhs
    acc = None
    for k0, k1 in split_bounds(a.shape[-1], splits):
        part = a[:, k0:k1].float() @ b[k0:k1, :].float()
        acc = part if acc is None else acc + part
    return acc.to(out_dtype)


def staged_depth(depth: int, gk: int) -> int:
    """The ring depth a launch uses: the config's, clamped to the gk K intervals (below 2,
    i.e. gk == 1, there is no ring: the single-K kernel runs)."""
    return min(depth, gk)


def staged_route(cfg: KernelConfig, a: torch.Tensor, rhs: torch.Tensor,
                 m: int, n: int, k: int) -> str:
    """The body a staged launch takes, from the shape before the launch
    (``tl2_staged_route`` mirrors it): 'ring' iff bm and bn are in WGMMA_TILES and TMA can
    read both operands (16-byte aligned bases; rows of a multiple of 16 bytes: K % 8 for A
    and B_t, N % 8 for B); else 'mma_sync'.  bk plays no part: the staged sum has no
    rounding point inside K."""
    rhs_row = k if cfg.rhs_layout == "nk" else n
    ring = (min(m, n, k) > 0 and cfg.bm in WGMMA_TILES and cfg.bn in WGMMA_TILES
            and a.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0
            and k % 8 == 0 and rhs_row % 8 == 0)
    return "ring" if ring else "mma_sync"


def launch_staged(a, rhs, cfg: KernelConfig, out: torch.Tensor, depth: int,
                  m: int, n: int, k: int, route: str, splits: int) -> None:
    """Launch the staged body of ``route`` on the current stream, writing ``out``: on the
    ring with ``splits`` (> 1: into a workspace, then the reduction), on mma.sync with one.

    Raises if the build fails or a launcher reports an error.  Does not synchronise."""
    lib = load_library()
    device = a.get_device()
    with torch.cuda.device(device):
        stream = torch._C._cuda_getCurrentRawStream(device)
        flags = (int(cfg.rhs_layout == "nk"), int(cfg.grid_order == "nm"),
                 int(out.dtype == torch.float32), stream)
        if route == "ring":
            ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
                  if splits > 1 else None)
            name = "tl2_wgmma_staged"
            err = lib.tl2_wgmma_staged(a.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                                       None if ws is None else ws.data_ptr(), m, n, k,
                                       cfg.bm, cfg.bn, depth, splits, *flags)
        else:
            name = "tl2_staged"
            err = lib.tl2_staged(a.data_ptr(), rhs.data_ptr(), out.data_ptr(), m, n, k,
                                 cfg.bm, cfg.bn, depth, *flags)
    if err:
        check_launch(err, f"{name} ({cfg} at depth={depth} splits={splits} "
                          f"m={m} n={n} k={k})")


def cuda_matmul_pipelined(a: torch.Tensor, b_or_bt: torch.Tensor,
                          config: Optional[KernelConfig] = None,
                          out_dtype: Optional[torch.dtype] = None,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A·B through the staged kernel.

    a: (M, K).  The RHS follows ``config.rhs_layout``: (K, N) for 'kn', (N, K) for 'nk'.
    ``config.pipeline_depth`` (>= 2) is the ring depth.  All three dims must divide the
    blocks.  ``out=`` receives C in place."""
    global LAUNCHES_STAGED_RING, LAUNCHES_STAGED_MMA_SYNC, LAUNCHES_STAGED_SPLIT
    cfg = config or KernelConfig(pipeline_depth=2)
    if cfg.pipeline_depth < 2:
        raise ValueError("cuda_matmul_pipelined requires pipeline_depth >= 2 "
                         f"(got {cfg.pipeline_depth})")
    out_dtype = out_dtype or (out.dtype if out is not None else a.dtype)
    _, m, n, k = check_operands(a, b_or_bt, cfg, out_dtype, None, None, out)
    if m % cfg.bm or n % cfg.bn or k % cfg.bk:
        raise ValueError(f"pipelined kernel needs dims divisible by blocks: ({m},{n},{k}) "
                         f"vs ({cfg.bm},{cfg.bn},{cfg.bk})")
    depth = staged_depth(cfg.pipeline_depth, k // cfg.bk)
    if depth < 2:
        # one K interval: the single-K kernel is the same sum without a ring
        plain = dataclasses.replace(cfg, pipeline_depth=0)
        wrapper = cuda_matmul_tn if cfg.rhs_layout == "nk" else cuda_matmul
        return wrapper(a, b_or_bt, plain, out_dtype=out_dtype, out=out)
    route = staged_route(cfg, a, b_or_bt, m, n, k)
    splits = staged_splits(m, n, k, cfg.bm, cfg.bn, depth) if route == "ring" else 1
    if a.device.type == "cpu":
        res = pipelined_reference(a, b_or_bt, cfg.rhs_layout, out_dtype, splits)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    for name, t, row in (("a", a, k), ("rhs", b_or_bt, k if cfg.rhs_layout == "nk" else n),
                         ("out", out, n)):
        if not _vector_ok(t, row):
            raise ValueError(f"the staged kernel needs 16-byte aligned rows; {name} is not")
    launch_staged(a, b_or_bt, cfg, out, depth, m, n, k, route, splits)
    if route == "ring":
        LAUNCHES_STAGED_RING += 1
    else:
        LAUNCHES_STAGED_MMA_SYNC += 1
    if splits > 1:
        LAUNCHES_STAGED_SPLIT += 1
    return out
