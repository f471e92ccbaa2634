"""The tuned GEMM: wrappers of the Hopper kernels and their plain torch version.

Counterpart of ``tpul2/ops/matmul.py``: ``cuda_matmul``, ``cuda_matmul_tn`` and
``cuda_matmul_fused`` play ``pallas_matmul``, ``pallas_matmul_tn`` and
``pallas_matmul_fused``.  For a CUDA tensor each launches ``csrc/tl2_wgmma.cu``'s ring
(wgmma warpgroups over a ring of 64-deep K stages) for the K carry and the single K
interval alike, on every ring block (edges of 1..128, on the least tile that holds each, so
the JAX space's sublane 16 and its covers of M < 16 and N < 128 too); ``launch_route``
names, from the shape before the launch, the producer that fills the ring: TMA ('wgmma')
or, where TMA cannot read an operand, the loads producer ('wgmma_lsu').  A wide block (an
edge above 128, the JAX space's wide stripes and blocks, any edges: swapped at bm <= 32,
narrow columns, covers of unaligned dimensions, bn up to 32768) takes
``csrc/tl2_wgmma_wide.cu`` at any bk: 'wgmma_wide' where TMA reads both operands and writes
C, else 'wgmma_wide_lsu' (the loads producer, predicated stores).
A config ``KernelConfig.validate`` refuses raises with its reason, and a launch that fails
raises.  For a CPU tensor it runs ``matmul_reference``, the plain version of the same
semantics, of every route and variant (a block's values depend only on bk, ``acc_dtype``
and the K tail).  Nothing falls back from a kernel to another kernel or to the plain
version.

The kernel predicates its own edges, so ``edge='pad'`` and ``edge='mask'`` are the same
launch: no padding copy, no output slice, and with ``out=`` the kernel writes straight
into caller memory.  Inputs are bf16, the bias f32, the output bf16 or f32.

The wrappers are differentiable where the JAX ones are: under autograd a call goes through
``GemmVjp``, whose forward is the same wrapper call and whose backward is the JAX
package's (library products in f32, not the kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

# the ring's constants and shared-memory model, read through this module too
from tpul2_torch.config import (WGMMA_KSTAGE, WGMMA_STAGES, WGMMA_TILES,  # noqa: F401
                                WIDE_BM_CHOICES, WIDE_SUB_N, WIDE_SWAP_M, KernelConfig,
                                carry_stages, kn_tma_cols, ring_c_grid, ring_edge,
                                wgmma_smem_bytes, wide_c_grid, wide_streamed, wide_streams,
                                wide_sub_m)
from tpul2_torch.ops._build import check_launch, load_library
from tpul2_torch.ops.baselines import f32_product
from tpul2_torch.trace import COUNTS
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
#: The kernel's activation codes (tl2_wgmma.cuh enum Act).
_ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}
_OUT_DTYPES = (torch.bfloat16, torch.float32)

#: ``tl2_wgmma_route``'s bit for a launch whose C TMA stores (``launch_store`` 'tma').
ROUTE_TMA_STORE = 8

#: The launch counter (``trace.COUNTS``) of each (batched, more than one K interval,
#: route): the 2-D and batched kernels with more than one bk interval (the port of
#: ``_kernel_multi_k``, ``_bmm_kernel``) or exactly one (``_kernel_single_k``,
#: ``_bmm_kernel_single_k``), on each route (``launch_route``).  Counted where a kernel is
#: launched and nowhere else.
COUNTER_OF = {(batched, gk, route): ("launch", f"{'batched_' if batched else ''}"
                                               f"{'multi' if gk else 'single'}_k_{route}")
              for batched in (False, True) for gk in (True, False)
              for route in ("wgmma", "wgmma_lsu", "wgmma_wide", "wgmma_wide_lsu")}


def records_grad(a: torch.Tensor, rhs: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> bool:
    """Whether autograd records a call on these operands: grad mode on and one of them
    requires grad.  Written out, since every entry-point call asks."""
    return torch.is_grad_enabled() and (a.requires_grad or rhs.requires_grad or (
        bias is not None and bias.requires_grad))


def refuse_out_under_grad(out: Optional[torch.Tensor], name: str) -> None:
    """Raise as torch's own ``out=`` does where autograd would record the call."""
    if out is not None:
        raise RuntimeError(f"{name}(): functions with out=... arguments don't support "
                           "automatic differentiation, but one of the arguments requires "
                           "grad.")


class GemmVjp(torch.autograd.Function):
    """act(A @ B + bias) whose backward is the JAX package's ``_matmul_bwd``,
    ``_matmul_tn_bwd``, ``_fused_bwd`` and ``_bmm_bwd`` (``tpul2/ops/matmul.py:286-411``,
    ``tpul2/ops/batched.py:45-64``) in one.

    ``forward(a, rhs, bias)`` computes the output: a wrapper of this package (the kernel on
    the card, the plain version on the CPU) or the dispatch sentinel's library GEMM.  rhs is
    (..., K, N), or (N, K) where ``rhs_layout`` is 'nk'; bias is f32 (N,) or None (2-D
    only).  The backward takes the cotangent to f32 and every product in f32
    (``baselines.f32_product``), cast once to its input's dtype.  With an activation it
    recomputes the f32 pre-activation a @ b + bias and differentiates
    ``ACTIVATIONS[activation]`` there (``_fused_ref_f32``).  The rhs cotangent comes in
    rhs's own layout, as ``_matmul_tn_bwd``'s does for b_t."""

    @staticmethod
    def forward(ctx, a, rhs, bias, forward, rhs_layout, activation):
        ctx.save_for_backward(a, rhs, bias)
        ctx.nk, ctx.activation = rhs_layout == "nk", activation
        return forward(a, rhs, bias)

    @staticmethod
    def backward(ctx, g):
        a, rhs, bias = ctx.saved_tensors
        b = rhs.transpose(-1, -2) if ctx.nk else rhs
        if ctx.activation is not None:
            h = f32_product(a, b)
            if bias is not None:
                h = h + bias.float()
            with torch.enable_grad():
                h.requires_grad_()
                g, = torch.autograd.grad(ACTIVATIONS[ctx.activation](h), h, g.float())
        da = db = dbias = None
        if ctx.needs_input_grad[0]:
            da = f32_product(g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = (f32_product(g.transpose(-1, -2), a) if ctx.nk
                  else f32_product(a.transpose(-1, -2), g)).to(rhs.dtype)
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = g.float().sum(0).to(bias.dtype)
        return da, db, dbias, None, None, None


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
      2^-7 · max_j |running sum_j|   bf16 family with more than one K interval only: an
                                     f32 reorder can flip one bf16 rounding of the running
                                     sum, which moves it by one bf16 ulp of the sum it
                                     passed (a single interval is never rounded, so it is
                                     held to the f32 terms).  Later intervals re-round
                                     that gap and can widen it past this term where a sum
                                     crosses a power of two; chip_smoke.py then requires
                                     the bits of a reference in the kernel's f32 order;
      x 1.2                          with an activation: no slope above 1.13 (gelu);
      2^-7 · |act(C + bias)|         bf16 output only: the final cast can round the two
                                     f32 values to neighbouring bf16 values.
    On 0/1 inputs every sum is an exact integer, so no tolerance applies there."""
    b = rhs.transpose(-1, -2) if rhs_layout == "nk" else rhs
    k = a.shape[-1]
    gk = cdiv(k, bk)
    acc = None
    run_max = None
    for kb in range(gk):
        ks, ke = kb * bk, min((kb + 1) * bk, k)
        part = a[..., ks:ke].float() @ b[..., ks:ke, :].float()
        acc = part if acc is None else acc + part
        run_max = acc.abs() if run_max is None else torch.maximum(run_max, acc.abs())
    tol = 1e-5 * acc.abs() + 1e-5 * k ** 0.5
    if acc_dtype == "bfloat16" and gk > 1:
        tol = tol + 2.0 ** -7 * run_max
    if activation is not None:
        tol = 1.2 * tol
    if out_dtype == torch.bfloat16:
        pre = acc if bias is None else acc + bias.float()
        tol = tol + 2.0 ** -7 * ACTIVATIONS[activation](pre).abs()
    return tol


def operand_producers(cfg: KernelConfig, a: torch.Tensor, rhs: torch.Tensor,
                      n: int, k: int) -> tuple:
    """(TMA reads A, TMA reads the RHS): a 16-byte aligned base and rows of a multiple of
    16 bytes (K % 8 for A and B_t, N % 8 for B), and for 'kn' B a box start on 16 bytes at
    every block column (``config.kn_tma_cols``: bn % 8 == 0 or one block covers N); where
    not, the loads producer reads the operand.  ``launch_args`` passes the same two flags
    as vec_a and vec_b."""
    if cfg.rhs_layout == "nk":
        tma_b = rhs.data_ptr() % 16 == 0 and k % 8 == 0
    else:
        tma_b = rhs.data_ptr() % 16 == 0 and n % 8 == 0 and kn_tma_cols(n, cfg.bn)
    return a.data_ptr() % 16 == 0 and k % 8 == 0, tma_b


def c_by_tma(n: int, out: Optional[torch.Tensor] = None) -> bool:
    """TMA can store C: N % 8 == 0 and ``out=`` (where given) 16-byte aligned; a fresh
    output is.  The block's edges decide the rest (``launch_store``)."""
    return n % 8 == 0 and (out is None or out.data_ptr() % 16 == 0)


def launch_store(cfg: KernelConfig, m: int, n: int, out: Optional[torch.Tensor] = None) -> str:
    """The store that writes a launch's C (``tl2_wgmma_route``'s ROUTE_TMA_STORE bit mirrors
    it): 'tma', the consumers stage C in shared memory and TMA stores it, where TMA can
    write C (``c_by_tma``) and every block edge is one the stores may write whole
    (``config.ring_c_grid`` for a ring block: the tile's edge or past the problem's;
    ``config.wide_c_grid`` for a wide one); else 'predicated', stores from registers that
    stop at the block's edges."""
    grid = wide_c_grid if cfg.wide else ring_c_grid
    return "tma" if c_by_tma(n, out) and grid(m, n, cfg.bm, cfg.bn) else "predicated"


def launch_route(cfg: KernelConfig, a: torch.Tensor, rhs: torch.Tensor,
                 m: int, n: int, k: int, out: Optional[torch.Tensor] = None) -> str:
    """The producer of a launch's ring, from the shape before the launch
    (``tl2_wgmma_route`` mirrors it: codes 1 to 4, with ROUTE_TMA_STORE added for the store
    ``launch_store`` names): 'wgmma' where TMA can read both operands
    (``operand_producers``), else 'wgmma_lsu' (the loads producer reads the operand TMA
    cannot).  Every valid ring tile takes one of them, at any bk: a carry's rounding point
    falls on a stage's start or, where bk % 64 == 32, its middle.  A wide block
    (tl2_wgmma_wide.cu) takes 'wgmma_wide' where TMA can also store C (``c_by_tma`` and
    ``config.wide_c_grid``: never in the swapped walk), else 'wgmma_wide_lsu', at any bk
    and batch."""
    tma = all(operand_producers(cfg, a, rhs, n, k))
    if cfg.wide:
        return ("wgmma_wide" if tma and c_by_tma(n, out) and wide_c_grid(m, n, cfg.bm, cfg.bn)
                else "wgmma_wide_lsu")
    return "wgmma" if tma else "wgmma_lsu"


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
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)):
        raise TypeError(f"bias must be float32 of shape ({n},), got {bias.dtype} "
                        f"{tuple(bias.shape)}")
    if out is not None:
        want = (batch, m, n) if batched else (m, n)
        if out.dtype != out_dtype or tuple(out.shape) != want:
            raise ValueError(f"out must be {out_dtype} {want}, got {out.dtype} "
                             f"{tuple(out.shape)}")
    # written out rather than looped over a list: this runs on every call of the entry
    # point, whose host time the small shapes pay in full
    device = a.device
    if (rhs.device != device or (bias is not None and bias.device != device)
            or (out is not None and out.device != device)):
        raise ValueError("all tensors must lie on one device")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if not (a.is_contiguous() and rhs.is_contiguous()
            and (bias is None or bias.is_contiguous())
            and (out is None or out.is_contiguous())):
        raise ValueError("the kernel takes contiguous tensors only")
    return batch, m, n, k


def launch_args(a, rhs, cfg: KernelConfig, out: torch.Tensor, bias, activation,
                batch: int, m: int, n: int, k: int) -> tuple:
    """The argument list of the C launchers (tl2_wgmma_*, and tl2_matmul_*, which share it),
    on the current stream of ``a``'s card: vec_a / vec_b say TMA may read the operand
    (tl2_matmul.cu reads them as 16-byte loads being legal, the same condition).

    The stream is taken as its raw handle (``torch._C._cuda_getCurrentRawStream``, what
    torch's own compiled kernels launch on): ``torch.cuda.current_stream`` builds a Stream
    object per call, 4-7 us of host time on the H100's host (PERF.md)."""
    a_ptr, rhs_ptr = a.data_ptr(), rhs.data_ptr()
    nk = cfg.rhs_layout == "nk"
    vec_b = rhs_ptr % 16 == 0 and (k % 8 == 0 if nk else n % 8 == 0 and kn_tma_cols(n, cfg.bn))
    return (a_ptr, rhs_ptr, bias.data_ptr() if bias is not None else None,
            out.data_ptr(), batch, m, n, k, m * k, k * n, m * n, cfg.bm, cfg.bn, cfg.bk,
            int(nk), int(cfg.acc_dtype == "bfloat16"),
            _ACT_CODES[activation], int(cfg.grid_order == "nm"),
            int(a_ptr % 16 == 0 and k % 8 == 0), int(vec_b),
            torch._C._cuda_getCurrentRawStream(a.get_device()))


def launch_variants(cfg: KernelConfig, k: int, tma_a: bool = False) -> list:
    """The variant counters (keys of ``trace.LAUNCHES``) a launch of ``cfg`` at depth K adds
    one to, 2-D and batched alike: the tile ('width32': bn <= 32; 'swapped': bm <= 32 over
    bn 33..128; 'ring_narrow': a ring block narrower than its tile, an edge other than 32,
    64 or 128, such as the sublane 16 or a cover of M < 16 or N < 128), a bf16-family carry
    that rounds in the middle of a stage ('midstage': bk % 64 == 32), and for a wide block
    its A's mode ('wide_streamed', ``config.wide_streams``; ``tma_a``: TMA reads A), its
    height above WIDE_BM_CHOICES' largest ('wide_tall'), the swapped walk ('wide_swapped':
    bm <= 32), narrow columns ('wide_narrow_n': bn < 128), an edge inside a sub-tile
    ('wide_clipped': the covers of an unaligned M or N) and more than 16384 columns
    ('wide_long')."""
    keys = []
    if cfg.bk % WGMMA_KSTAGE and cfg.acc_dtype == "bfloat16" and cdiv(k, cfg.bk) > 1:
        keys.append("midstage")
    if not cfg.wide:
        tm, tn = ring_edge(cfg.bm), ring_edge(cfg.bn)
        if tn == 32:
            keys.append("width32")
        elif tm == 32:
            keys.append("swapped")
        if (tm, tn) != (cfg.bm, cfg.bn):
            keys.append("ring_narrow")
        return keys
    if wide_streams(cfg.bm, k, tma_a):
        keys.append("wide_streamed")
    if cfg.bm > WIDE_BM_CHOICES[-1]:
        keys.append("wide_tall")
    if cfg.bm <= WIDE_SWAP_M:
        keys.append("wide_swapped")
    if cfg.bn < WIDE_SUB_N:
        keys.append("wide_narrow_n")
    if ((cfg.bm > WIDE_SWAP_M and cfg.bm % wide_sub_m(cfg.bm))
            or (cfg.bn > WIDE_SUB_N and cfg.bn % WIDE_SUB_N)):
        keys.append("wide_clipped")
    if cfg.bn > 16384:
        keys.append("wide_long")
    return keys
#: The launch counter of each store of C (``launch_store``), 2-D, batched and staged, ring
#: and wide: TMA from shared memory, or predicated stores from registers.
STORE_COUNTER = {"tma": "c_tma_store", "predicated": "c_predicated"}


def count_store(cfg: KernelConfig, m: int, n: int, out: torch.Tensor) -> None:
    """Add one to the counter of the store a launch just made (``launch_store``); the
    staged wrapper counts its launches here too."""
    COUNTS["launch", STORE_COUNTER[launch_store(cfg, m, n, out)]] += 1

#: The C launcher of each output dtype.
_LAUNCHERS = {torch.float32: "tl2_wgmma_f32out", torch.bfloat16: "tl2_wgmma_bf16out"}


def launch_kernel(a, rhs, cfg: KernelConfig, out: torch.Tensor, bias, activation,
                  batch: int, m: int, n: int, k: int) -> str:
    """Launch the ring on the current stream, writing ``out``; return the route
    (``launch_route``: 'wgmma', 'wgmma_lsu' or, for a wide block, 'wgmma_wide' or
    'wgmma_wide_lsu').  Counts the launch's variants (``launch_variants``) and its store
    (``launch_store``).

    Raises if the build fails or the launch reports an error (``LaunchRefused`` for a
    launch refused before any work ran).  Does not synchronise."""
    name = _LAUNCHERS[out.dtype]
    args = launch_args(a, rhs, cfg, out, bias, activation, batch, m, n, k)
    with torch.cuda.device(a.get_device()):  # an int index: the cheap way in
        err = getattr(load_library(), name)(*args)
    if err:  # the message formats the config, so only on failure
        check_launch(err, f"{name} ({cfg} at batch={batch} m={m} n={n} k={k})")
    for key in launch_variants(cfg, k, bool(args[18])):
        COUNTS["launch", key] += 1
    count_store(cfg, m, n, out)
    # launch_route's answer, read off the launch's own vec_a and vec_b
    tma = args[18] and args[19]
    if cfg.wide:
        return ("wgmma_wide" if tma and c_by_tma(n, out) and wide_c_grid(m, n, cfg.bm, cfg.bn)
                else "wgmma_wide_lsu")
    return "wgmma" if tma else "wgmma_lsu"


def _matmul(a, rhs, cfg: KernelConfig, out_dtype, out, bias=None, activation=None):
    if records_grad(a, rhs, bias):
        refuse_out_under_grad(out, "matmul")
        return GemmVjp.apply(a, rhs, bias, lambda a_, rhs_, bias_: _matmul(
            a_, rhs_, cfg, out_dtype, None, bias_, activation), cfg.rhs_layout, activation)
    out_dtype = out_dtype or (out.dtype if out is not None else a.dtype)
    batch, m, n, k = check_operands(a, rhs, cfg, out_dtype, bias, activation, out)
    if a.is_cpu:
        res = matmul_reference(a, rhs, cfg.bk, cfg.acc_dtype, cfg.rhs_layout, bias,
                               activation, out_dtype)
        if out is None:
            return res
        return out.copy_(res)
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    route = launch_kernel(a, rhs, cfg, out, bias, activation, batch, m, n, k)
    COUNTS[COUNTER_OF[False, k > cfg.bk, route]] += 1
    return out


def _with_layout(config: Optional[KernelConfig], rhs_layout: str) -> KernelConfig:
    """``config`` (default: ``KernelConfig()``) reading the RHS in ``rhs_layout``; the same
    object where it already does, since ``dataclasses.replace`` costs microseconds a call."""
    cfg = config or KernelConfig()
    if cfg.rhs_layout == rhs_layout:
        return cfg
    return dataclasses.replace(cfg, rhs_layout=rhs_layout)


def cuda_matmul(a: torch.Tensor, b: torch.Tensor,
                config: Optional[KernelConfig] = None,
                out_dtype: Optional[torch.dtype] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A @ B, a (M, K), b (K, N), both bf16.  ``out=`` receives C in place."""
    return _matmul(a, b, _with_layout(config, "kn"), out_dtype, out)


def cuda_matmul_tn(a: torch.Tensor, b_t: torch.Tensor,
                   config: Optional[KernelConfig] = None,
                   out_dtype: Optional[torch.dtype] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A @ B with the RHS supplied transposed as b_t (N, K), read with no copy."""
    return _matmul(a, b_t, _with_layout(config, "nk"), out_dtype, out)


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
