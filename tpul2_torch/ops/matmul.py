"""The tuned GEMM: wrappers of the Hopper kernels and their plain torch version.

Counterpart of ``tpul2/ops/matmul.py``: ``cuda_matmul``, ``cuda_matmul_tn`` and
``cuda_matmul_fused`` play ``pallas_matmul``, ``pallas_matmul_tn`` and
``pallas_matmul_fused``.  For a CUDA tensor each launches one of two bodies, picked by
``multi_k_route`` from the shape before the launch: ``csrc/tl2_wgmma.cu`` (TMA ring +
wgmma) for the K carry on the tiles and alignments it takes, ``csrc/tl2_matmul.cu``
(mma.sync) for everything else; a launch that fails raises.  For a CPU tensor it runs
``matmul_reference``, the plain version of the same semantics.  Nothing falls back from
a kernel to another kernel or to the plain version.

The kernel predicates its own edges, so ``edge='pad'`` and ``edge='mask'`` are the same
launch: no padding copy, no output slice, and with ``out=`` the kernel writes straight
into caller memory.  Inputs are bf16, the bias f32, the output bf16 or f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from tpul2_torch.config import KernelConfig
from tpul2_torch.utils.padding import cdiv

#: Fused epilogues, applied in f32 after the bias and before the output cast.
#: gelu is the tanh approximation, as ``jax.nn.gelu`` is by default.
ACTIVATIONS = {
    None: lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}
#: The kernel's activation codes (tl2_matmul.cu enum Act).
_ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}
_OUT_DTYPES = (torch.bfloat16, torch.float32)

#: Launches of the 2-D kernels, by K-loop length and route: more than one bk interval
#: (the port of ``_kernel_multi_k``) on the wgmma body or on the mma.sync body, and
#: exactly one (``_kernel_single_k``, always mma.sync).  Counted where a kernel is
#: launched and nowhere else.
LAUNCHES_MULTI_K_WGMMA = 0
LAUNCHES_MULTI_K_MMA_SYNC = 0
LAUNCHES_SINGLE_K = 0

#: The wgmma body (csrc/tl2_wgmma.cu): its tile edges, the K depth of one TMA ring stage
#: (one 128-byte row of bf16, so bk must be a multiple) and its ring depth.
WGMMA_TILES = (64, 128)
WGMMA_KSTAGE = 64
WGMMA_STAGES = 4


def matmul_reference(a: torch.Tensor, rhs: torch.Tensor, bk: int,
                     acc_dtype: str = "float32", rhs_layout: str = "kn",
                     bias: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain torch version of the kernel, blockwise along K with its rounding points.

    a: (..., M, K); rhs: (..., K, N), or (N, K) when rhs_layout == 'nk'.  Each bk
    interval's product is taken in f32; with more than one interval the running sum is
    rounded to ``acc_dtype`` after every one, with a single interval it is not rounded.
    Then + bias (f32), the activation, the cast to ``out_dtype``."""
    b = rhs.transpose(-1, -2) if rhs_layout == "nk" else rhs
    k = a.shape[-1]
    gk = cdiv(k, bk)
    acc = None
    for kb in range(gk):
        ks, ke = kb * bk, min((kb + 1) * bk, k)
        part = a[..., ks:ke].float() @ b[..., ks:ke, :].float()
        if gk == 1:
            acc = part
            break
        s = part if acc is None else acc + part
        acc = s.to(torch.bfloat16).float() if acc_dtype == "bfloat16" else s
    if bias is not None:
        acc = acc + bias.float()
    return ACTIVATIONS[activation](acc).to(out_dtype)


def allowed_error(a: torch.Tensor, rhs: torch.Tensor, bk: int,
                  acc_dtype: str = "float32", rhs_layout: str = "kn",
                  out_dtype: torch.dtype = torch.float32,
                  bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None) -> torch.Tensor:
    """Per-element tolerance between two correct implementations on normal inputs.

    Each term has its reason:
      rtol 1e-5·|C| + atol 1e-5·√K   the f32 sums are taken in another order;
      2^-7 · max_j |running sum_j|   bf16 family only: an f32 reorder can flip one bf16
                                     rounding of the running sum, which moves it by at
                                     most one bf16 ulp of the largest sum it passed;
      x 1.2                          with an activation: no slope above 1.13 (gelu);
      2^-7 · |act(C + bias)|         bf16 output only: the final cast can round the two
                                     f32 values to neighbouring bf16 values.
    On 0/1 inputs every sum is an exact integer, so no tolerance applies there."""
    b = rhs.transpose(-1, -2) if rhs_layout == "nk" else rhs
    k = a.shape[-1]
    acc = None
    run_max = None
    for kb in range(cdiv(k, bk)):
        ks, ke = kb * bk, min((kb + 1) * bk, k)
        part = a[..., ks:ke].float() @ b[..., ks:ke, :].float()
        acc = part if acc is None else acc + part
        run_max = acc.abs() if run_max is None else torch.maximum(run_max, acc.abs())
    tol = 1e-5 * acc.abs() + 1e-5 * k ** 0.5
    if acc_dtype == "bfloat16":
        tol = tol + 2.0 ** -7 * run_max
    if activation is not None:
        tol = 1.2 * tol
    if out_dtype == torch.bfloat16:
        pre = acc if bias is None else acc + bias.float()
        tol = tol + 2.0 ** -7 * ACTIVATIONS[activation](pre).abs()
    return tol


def wgmma_smem_bytes(bm: int, bn: int) -> int:
    """Shared memory of one wgmma CTA (``tl2_wgmma_smem_bytes``): 1024 bytes to align the
    ring to the swizzle period, WGMMA_STAGES stages of (bm + bn) rows of 128 bytes, and a
    full and an empty mbarrier per stage."""
    return 1024 + WGMMA_STAGES * (bm + bn) * WGMMA_KSTAGE * 2 + 2 * WGMMA_STAGES * 8


def multi_k_route(cfg: KernelConfig, a: torch.Tensor, rhs: torch.Tensor,
                  m: int, n: int, k: int) -> str:
    """The body a launch takes, from the shape before the launch (``tl2_wgmma_route``
    mirrors it): 'wgmma' iff gk > 1, bm and bn are in WGMMA_TILES, bk is a multiple of
    WGMMA_KSTAGE (no ring stage straddles a rounding point), and TMA can read both
    operands (16-byte aligned bases; rows of a multiple of 16 bytes: K % 8 for A and
    B_t, N % 8 for B).  Else 'mma_sync', which also serves every gk == 1 launch."""
    rhs_row = k if cfg.rhs_layout == "nk" else n
    wgmma = (min(m, n, k) > 0 and cdiv(k, cfg.bk) > 1
             and cfg.bm in WGMMA_TILES and cfg.bn in WGMMA_TILES
             and cfg.bk % WGMMA_KSTAGE == 0
             and a.data_ptr() % 16 == 0 and rhs.data_ptr() % 16 == 0
             and k % 8 == 0 and rhs_row % 8 == 0)
    return "wgmma" if wgmma else "mma_sync"


def _vector_ok(t: torch.Tensor, row_len: int) -> bool:
    """16-byte loads are legal: an aligned base and rows of a multiple of 8 bf16."""
    return t.data_ptr() % 16 == 0 and row_len % 8 == 0


def check_operands(a, rhs, cfg: KernelConfig, out_dtype, bias, activation, out,
                   batched: bool = False) -> tuple:
    """Validate what the kernel takes; return (batch, m, n, k).  Raises on anything else."""
    err = cfg.validate()
    if err or cfg.use_vendor:
        raise ValueError(f"invalid kernel config {cfg}: {err or 'vendor sentinel'}")
    ndim = 3 if batched else 2
    if a.ndim != ndim or rhs.ndim != ndim:
        raise ValueError(f"expected {ndim}-D operands, got {tuple(a.shape)} and "
                         f"{tuple(rhs.shape)}")
    if a.dtype != torch.bfloat16 or rhs.dtype != torch.bfloat16:
        raise TypeError(f"operands must be bfloat16, got {a.dtype} and {rhs.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation}; "
                         f"choose from {sorted(k for k in _ACT_CODES if k)}")
    batch = a.shape[0] if batched else 1
    m, k = a.shape[-2:]
    if cfg.rhs_layout == "nk":
        n, k2 = rhs.shape[-2:]
    else:
        k2, n = rhs.shape[-2:]
    if k2 != k or (batched and rhs.shape[0] != batch):
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(rhs.shape)} "
                         f"(rhs_layout={cfg.rhs_layout})")
    if min(m, n, k) <= 0:
        raise ValueError(f"empty problem {(m, n, k)}")
    tensors = [a, rhs]
    if bias is not None:
        if bias.dtype != torch.float32 or bias.shape != (n,):
            raise TypeError(f"bias must be float32 of shape ({n},), got {bias.dtype} "
                            f"{tuple(bias.shape)}")
        tensors.append(bias)
    if out is not None:
        want = (batch, m, n) if batched else (m, n)
        if out.dtype != out_dtype or tuple(out.shape) != want:
            raise ValueError(f"out must be {out_dtype} {want}, got {out.dtype} "
                             f"{tuple(out.shape)}")
        tensors.append(out)
    if any(t.device != a.device for t in tensors):
        raise ValueError("all tensors must lie on one device")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {a.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors only")
    return batch, m, n, k


def launch_args(a, rhs, cfg: KernelConfig, out: torch.Tensor, bias, activation,
                batch: int, m: int, n: int, k: int) -> tuple:
    """The argument list of every C launcher (tl2_matmul_* and tl2_wgmma_*), on the
    current stream of ``a``'s card."""
    rhs_row = k if cfg.rhs_layout == "nk" else n
    return (a.data_ptr(), rhs.data_ptr(), bias.data_ptr() if bias is not None else None,
            out.data_ptr(), batch, m, n, k, m * k, k * n, m * n, cfg.bm, cfg.bn, cfg.bk,
            int(cfg.rhs_layout == "nk"), int(cfg.acc_dtype == "bfloat16"),
            _ACT_CODES[activation], int(cfg.grid_order == "nm"),
            int(_vector_ok(a, k)), int(_vector_ok(rhs, rhs_row)),
            torch.cuda.current_stream(a.device).cuda_stream)


def launch_kernel(a, rhs, cfg: KernelConfig, out: torch.Tensor, bias, activation,
                  batch: int, m: int, n: int, k: int) -> str:
    """Launch the body ``multi_k_route`` picks on the current stream, writing ``out``;
    return the route ('wgmma' or 'mma_sync').

    Raises if the build fails or the launch reports an error (``LaunchRefused`` for a
    launch refused before any work ran).  Does not synchronise."""
    from tpul2_torch.ops._build import check_launch, load_library
    lib = load_library()
    route = multi_k_route(cfg, a, rhs, m, n, k)
    name = "tl2_wgmma" if route == "wgmma" else "tl2_matmul"
    fn = getattr(lib, f"{name}_{'f32' if out.dtype == torch.float32 else 'bf16'}out")
    with torch.cuda.device(a.device):
        err = fn(*launch_args(a, rhs, cfg, out, bias, activation, batch, m, n, k))
    check_launch(err, f"{name} ({cfg} at batch={batch} m={m} n={n} k={k})")
    return route


def _matmul(a, rhs, cfg: KernelConfig, out_dtype, out, bias=None, activation=None):
    global LAUNCHES_MULTI_K_WGMMA, LAUNCHES_MULTI_K_MMA_SYNC, LAUNCHES_SINGLE_K
    out_dtype = out_dtype or (out.dtype if out is not None else a.dtype)
    batch, m, n, k = check_operands(a, rhs, cfg, out_dtype, bias, activation, out)
    if a.device.type == "cpu":
        res = matmul_reference(a, rhs, cfg.bk, cfg.acc_dtype, cfg.rhs_layout, bias,
                               activation, out_dtype)
        if out is None:
            return res
        return out.copy_(res)
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    route = launch_kernel(a, rhs, cfg, out, bias, activation, batch, m, n, k)
    if route == "wgmma":
        LAUNCHES_MULTI_K_WGMMA += 1
    elif cdiv(k, cfg.bk) > 1:
        LAUNCHES_MULTI_K_MMA_SYNC += 1
    else:
        LAUNCHES_SINGLE_K += 1
    return out


def cuda_matmul(a: torch.Tensor, b: torch.Tensor,
                config: Optional[KernelConfig] = None,
                out_dtype: Optional[torch.dtype] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A @ B, a (M, K), b (K, N), both bf16.  ``out=`` receives C in place."""
    cfg = dataclasses.replace(config or KernelConfig(), rhs_layout="kn")
    return _matmul(a, b, cfg, out_dtype, out)


def cuda_matmul_tn(a: torch.Tensor, b_t: torch.Tensor,
                   config: Optional[KernelConfig] = None,
                   out_dtype: Optional[torch.dtype] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A @ B with the RHS supplied transposed as b_t (N, K), read with no copy."""
    cfg = dataclasses.replace(config or KernelConfig(), rhs_layout="nk")
    return _matmul(a, b_t, cfg, out_dtype, out)


def cuda_matmul_fused(a: torch.Tensor, b: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None,
                      config: Optional[KernelConfig] = None,
                      out_dtype: Optional[torch.dtype] = None,
                      out: Optional[torch.Tensor] = None,
                      b_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(A @ B + bias) with the epilogue in the kernel.  bias: f32 (N,) or None.

    With ``config.rhs_layout == 'nk'`` the kernel reads ``b_t`` (made from b if absent)."""
    cfg = config or KernelConfig()
    rhs = b
    if cfg.rhs_layout == "nk":
        rhs = b_t if b_t is not None else b.t().contiguous()
    return _matmul(a, rhs, cfg, out_dtype, out, bias=bias, activation=activation)
