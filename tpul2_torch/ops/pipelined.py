"""The staged GEMM (the kStage axis): wrapper of its two kernel bodies and its plain version.

Counterpart of ``tpul2/ops/pipelined.py``: ``cuda_matmul_pipelined`` plays
``pallas_matmul_pipelined``.  The K loop runs inside the CTA over a ring of
``pipeline_depth`` K stages in shared memory that asynchronous copies keep filled ahead of
the MMAs.  The sum is f32 over the whole K whatever ``acc_dtype`` says, then one cast, so in
the bf16 family a staged config answers differently from ``cuda_matmul``, which rounds the
carry after every bk interval.

One body on every ring block: ``tl2_wgmma_staged`` (csrc/tl2_wgmma.cu), the ring kernel's
f32-carry instance, at the wide tiles, at width 32 and with the operands swapped (bm <= 32),
on any block of edges 1..128.  At a wide block (an edge above 128, the JAX kStage axis's
wide picks such as 16 x 11008 and 64 x 32000) the same entry runs the wide walk's f32-sum
instance (csrc/tl2_wgmma_wide.cu) with A and B streamed through ``pipeline_depth`` stages,
no split: the JAX kernel's one f32 sum over its DMA ring of both operands.
``pipeline_depth`` is the ring's depth in 64-deep stages (WGMMA_KSTAGE): depth d keeps up
to d stages (64·d of K) in flight.  ``staged_route`` names, from the shape before the launch
(``tl2_staged_route`` mirrors it), the producer that fills the ring: 'ring' (TMA) or
'ring_lsu' (the loads producer, where a base is not 16-byte aligned); at a wide block
'wgmma_wide' or 'wgmma_wide_lsu'.  Where a ring block's output has few tiles, the launch
splits K (``staged_splits``, below).  The ring does not hold a
bk-deep block, as the JAX kernel's DMA slots do (one would not fit shared memory at the
tuning shape's bk = 1024).  bk reaches the staged path only through the JAX rules below
(divisibility, the clamp, the gk == 1 route, where bk is the single-K kernel's interval);
``candidate_configs`` never offers two staged candidates that differ in bk alone.

Split K.  The TPU kernel's grid runs in order on one core; on the H100 one CTA per output
tile leaves most of the 132 SMs idle at the skinny streaming and decode-size shapes where
the tuner offers staged configs.  A launch with ``splits`` > 1 gives split s the K range
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

No gradient, as in the JAX package: ``pallas_matmul_pipelined`` has no ``custom_vjp``, and
``jax.grad`` through a staged config with gk > 1 raises (pallas_call's JVP rule fails on
the manual DMA ring).  Under autograd the forward runs and the backward raises
(``StagedNoVjp``); gk == 1 goes to the single-K wrapper, which is differentiable in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpul2_torch.config import NUM_SMS, WGMMA_KSTAGE, KernelConfig, wide_c_grid
from tpul2_torch.ops._build import check_launch, load_library
from tpul2_torch.ops.matmul import (_vector_ok, check_operands, count_store, cuda_matmul,
                                    cuda_matmul_tn, operand_producers, records_grad,
                                    refuse_out_under_grad)
from tpul2_torch.trace import COUNTS
from tpul2_torch.utils.padding import cdiv

class StagedNoVjp(torch.autograd.Function):
    """The staged kernel's output under autograd: ``forward(a, rhs)`` runs, and the backward
    raises, as ``jax.grad`` through ``pallas_matmul_pipelined`` does."""

    @staticmethod
    def forward(ctx, a, rhs, forward):
        return forward(a, rhs)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the staged kernel (pipeline_depth >= 2 with more than one K interval) has no "
            "gradient, as in the JAX package; differentiate through a config with "
            "pipeline_depth=0")


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
    """The producer of a staged launch's ring, from the shape before the launch
    (``tl2_staged_route`` mirrors it: 1 to 4): 'ring' where TMA can read both operands
    (``ops.matmul.operand_producers``), else 'ring_lsu'; at a wide block 'wgmma_wide' where
    TMA can also store C into a fresh output (N % 8 == 0, ``config.wide_c_grid``), else
    'wgmma_wide_lsu'.  Every block takes one of them; bk plays no part, since the staged
    sum has no rounding point inside K."""
    tma = all(operand_producers(cfg, a, rhs, n, k))
    if cfg.wide:
        return ("wgmma_wide" if tma and n % 8 == 0 and wide_c_grid(m, n, cfg.bm, cfg.bn)
                else "wgmma_wide_lsu")
    return "ring" if tma else "ring_lsu"


def launch_staged(a, rhs, cfg: KernelConfig, out: torch.Tensor, depth: int,
                  m: int, n: int, k: int, splits: int) -> None:
    """Launch the staged ring on the current stream, writing ``out``: with ``splits`` > 1
    into a workspace, then the reduction.

    Raises if the build fails or the launcher reports an error.  Does not synchronise."""
    device = a.get_device()
    with torch.cuda.device(device):
        ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
              if splits > 1 else None)
        err = load_library().tl2_wgmma_staged(
            a.data_ptr(), rhs.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
            m, n, k, cfg.bm, cfg.bn, depth, splits, int(cfg.rhs_layout == "nk"),
            int(cfg.grid_order == "nm"), int(out.dtype == torch.float32),
            torch._C._cuda_getCurrentRawStream(device))
    if err:
        check_launch(err, f"tl2_wgmma_staged ({cfg} at depth={depth} splits={splits} "
                          f"m={m} n={n} k={k})")


def cuda_matmul_pipelined(a: torch.Tensor, b_or_bt: torch.Tensor,
                          config: Optional[KernelConfig] = None,
                          out_dtype: Optional[torch.dtype] = None,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A·B through the staged kernel.

    a: (M, K).  The RHS follows ``config.rhs_layout``: (K, N) for 'kn', (N, K) for 'nk'.
    ``config.pipeline_depth`` (>= 2) is the ring depth.  All three dims must divide the
    blocks.  ``out=`` receives C in place."""
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
    if records_grad(a, b_or_bt):
        refuse_out_under_grad(out, "matmul_pipelined")
        return StagedNoVjp.apply(a, b_or_bt, lambda a_, rhs_: cuda_matmul_pipelined(
            a_, rhs_, cfg, out_dtype))
    # a wide block's staged sum has no split
    splits = 1 if cfg.wide else staged_splits(m, n, k, cfg.bm, cfg.bn, depth)
    if a.device.type == "cpu":
        res = pipelined_reference(a, b_or_bt, cfg.rhs_layout, out_dtype, splits)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    elif not _vector_ok(out, n):
        raise ValueError("the staged kernel needs a 16-byte aligned out")
    launch_staged(a, b_or_bt, cfg, out, depth, m, n, k, splits)
    # the staged kernel's launch counters (``trace.LAUNCHES``), counted here and nowhere
    # else (not on the gk == 1 path): by route, a wide block's staged sum, a split (which
    # also launches the reduction), a block with an edge of 32 or less
    count_store(cfg, m, n, out)  # a split's partials go out as C does: a fresh f32 workspace
    if cfg.wide:
        COUNTS["launch", "staged_wide"] += 1
        return out
    COUNTS["launch", "staged_" + staged_route(cfg, a, b_or_bt, m, n, k)] += 1
    if splits > 1:
        COUNTS["launch", "staged_split"] += 1
    if cfg.bm <= 32 or cfg.bn <= 32:
        COUNTS["launch", "staged_narrow"] += 1
    return out
