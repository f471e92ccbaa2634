"""The staged GEMM (the kStage axis): wrapper of ``csrc/tl2_staged.cu`` and its plain version.

Counterpart of ``tpul2/ops/pipelined.py``: ``cuda_matmul_pipelined`` plays
``pallas_matmul_pipelined``.  The K loop runs inside the CTA over a ring of
``pipeline_depth`` K slices in shared memory that cp.async keeps filled ahead of the
MMAs.  The sum is f32 over the whole K whatever ``acc_dtype`` says, then one cast, so in
the bf16 family a staged config answers differently from ``cuda_matmul``, which rounds
the carry after every bk interval.

The JAX package's rules hold: the RHS follows ``rhs_layout`` ((K, N) for 'kn', (N, K)
for 'nk'); depth >= 2 or ValueError; every dim must divide its block or ValueError;
the depth is clamped to gk = K // bk, and gk == 1 goes to the single-K kernel.  For a
CUDA tensor the wrapper launches the kernel or raises; for a CPU tensor it runs
``pipelined_reference``.  Nothing falls back from the kernel to the plain version.

A ring slot holds a 32-deep K slice (``config.KSTEP``), not a bk-deep block as the JAX
kernel's DMA slots do: ``pipeline_depth`` counts 32-deep slices, so depth d keeps d - 1
slices (32·(d - 1) of K) in flight, and a bk-deep slot would not fit shared memory at the
tuning shape's bk = 1024.  bk reaches the staged path only through the JAX rules above
(divisibility, the clamp, the gk == 1 route, where bk is the single-K kernel's interval);
``candidate_configs`` never offers two staged candidates that differ in bk alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpul2_torch.config import KernelConfig
from tpul2_torch.ops.matmul import (_vector_ok, check_operands, cuda_matmul, cuda_matmul_tn,
                                    matmul_reference)

#: Launches of the staged kernel (the port of ``pipelined._kernel``), counted where the
#: kernel is launched and nowhere else: not on the gk == 1 path.
LAUNCHES_STAGED = 0


def pipelined_reference(a: torch.Tensor, rhs: torch.Tensor, rhs_layout: str = "kn",
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain torch version: one f32 product over all of K, then the cast."""
    return matmul_reference(a, rhs, a.shape[-1], "float32", rhs_layout, out_dtype=out_dtype)


def staged_depth(depth: int, gk: int) -> int:
    """The ring depth a launch uses: the config's, clamped to the gk K intervals (below 2,
    i.e. gk == 1, there is no ring: the single-K kernel runs)."""
    return min(depth, gk)


def launch_staged(a, rhs, cfg: KernelConfig, out: torch.Tensor, depth: int,
                  m: int, n: int, k: int) -> None:
    """Launch tl2_staged.cu on the current stream, writing ``out``.

    Raises if the build fails or the launch reports an error.  Does not synchronise."""
    from tpul2_torch.ops._build import check_launch, load_library
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.tl2_staged(a.data_ptr(), rhs.data_ptr(), out.data_ptr(), m, n, k,
                             cfg.bm, cfg.bn, depth, int(cfg.rhs_layout == "nk"),
                             int(cfg.grid_order == "nm"), int(out.dtype == torch.float32),
                             stream)
    check_launch(err, f"tl2_staged ({cfg} at depth={depth} m={m} n={n} k={k})")


def cuda_matmul_pipelined(a: torch.Tensor, b_or_bt: torch.Tensor,
                          config: Optional[KernelConfig] = None,
                          out_dtype: Optional[torch.dtype] = None,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A·B through the staged kernel.

    a: (M, K).  The RHS follows ``config.rhs_layout``: (K, N) for 'kn', (N, K) for 'nk'.
    ``config.pipeline_depth`` (>= 2) is the ring depth.  All three dims must divide the
    blocks.  ``out=`` receives C in place."""
    global LAUNCHES_STAGED
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
    if a.device.type == "cpu":
        res = pipelined_reference(a, b_or_bt, cfg.rhs_layout, out_dtype)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    for name, t, row in (("a", a, k), ("rhs", b_or_bt, k if cfg.rhs_layout == "nk" else n),
                         ("out", out, n)):
        if not _vector_ok(t, row):
            raise ValueError(f"the staged kernel needs 16-byte aligned rows; {name} is not")
    launch_staged(a, b_or_bt, cfg, out, depth, m, n, k)
    LAUNCHES_STAGED += 1
    return out
