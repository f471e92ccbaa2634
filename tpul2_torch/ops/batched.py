"""Batched GEMM C[t] = A[t] @ B[t] on the same Hopper kernels.

Counterpart of ``tpul2/ops/batched.py`` (``_bmm_kernel`` and ``_bmm_kernel_single_k``):
the batch index is the kernels' ``blockIdx.z`` and each batch element reuses the 2-D
tiling and route (``ops.matmul.launch_route``: the wgmma body for the K carry and the
single interval alike where it takes the tile and the operands, else the mma.sync body),
with the same bk rounding points.  As in the JAX kernel there is no bias, no activation
and no 'nk' layout.  For a CUDA tensor
the wrapper launches a kernel or raises; for a CPU tensor it runs
``batched_matmul_reference``.  Under autograd the call goes through ``ops.matmul.GemmVjp``
(the JAX package's ``_bmm_bwd``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpul2_torch.config import KernelConfig
from tpul2_torch.ops.matmul import (GemmVjp, _with_layout, check_operands, launch_kernel,
                                    matmul_reference, records_grad, refuse_out_under_grad)
from tpul2_torch.utils.padding import cdiv

#: Launches of the batched kernels with more than one bk interval (``_bmm_kernel``) and
#: with one (``_bmm_kernel_single_k``), each on the wgmma body or on the mma.sync body,
#: counted where a kernel is launched.
LAUNCHES_MULTI_K_WGMMA = 0
LAUNCHES_MULTI_K_MMA_SYNC = 0
LAUNCHES_SINGLE_K_WGMMA = 0
LAUNCHES_SINGLE_K_MMA_SYNC = 0


def batched_matmul_reference(a: torch.Tensor, b: torch.Tensor, bk: int,
                             acc_dtype: str = "float32",
                             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain torch version: ``matmul_reference`` over a leading batch dimension."""
    return matmul_reference(a, b, bk, acc_dtype, "kn", out_dtype=out_dtype)


def cuda_batched_matmul(a: torch.Tensor, b: torch.Tensor,
                        config: Optional[KernelConfig] = None,
                        out_dtype: Optional[torch.dtype] = None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[t] = A[t] @ B[t]; a (B, M, K), b (B, K, N), both bf16."""
    global LAUNCHES_MULTI_K_WGMMA, LAUNCHES_MULTI_K_MMA_SYNC
    global LAUNCHES_SINGLE_K_WGMMA, LAUNCHES_SINGLE_K_MMA_SYNC
    cfg = _with_layout(config, "kn")
    if records_grad(a, b):
        refuse_out_under_grad(out, "batched_matmul")
        return GemmVjp.apply(a, b, None, lambda a_, b_, _: cuda_batched_matmul(
            a_, b_, cfg, out_dtype), "kn", None)
    out_dtype = out_dtype or (out.dtype if out is not None else a.dtype)
    batch, m, n, k = check_operands(a, b, cfg, out_dtype, None, None, out, batched=True)
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's z limit 65535")
    if a.device.type == "cpu":
        res = batched_matmul_reference(a, b, cfg.bk, cfg.acc_dtype, out_dtype)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((batch, m, n), dtype=out_dtype, device=a.device)
    route = launch_kernel(a, b, cfg, out, None, None, batch, m, n, k)
    if cdiv(k, cfg.bk) > 1:
        if route == "wgmma":
            LAUNCHES_MULTI_K_WGMMA += 1
        else:
            LAUNCHES_MULTI_K_MMA_SYNC += 1
    elif route == "wgmma":
        LAUNCHES_SINGLE_K_WGMMA += 1
    else:
        LAUNCHES_SINGLE_K_MMA_SYNC += 1
    return out
