"""Vendor baselines — the library GEMMs the candidate is measured against.

Counterpart of ``tpul2/ops/baselines.py`` (there: XLA formulations).  These stay library
calls on purpose: they are the vendor side of every speedup and the dispatch sentinel
that means a call can never fail, the role XLA has for the JAX package.  None of them is
a port of a kernel.

All share the harness ABI ``f(a, b, b_t) -> C`` with a (M, K), b (K, N) and its
transposed layout b_t (N, K) always supplied; each returns ``a.dtype``, as ``xla_dot_nn``
does.  On the card every one accumulates in f32: ``pin_precision`` keeps
``allow_bf16_reduced_precision_reduction`` and ``allow_tf32`` off, so the f32 family's
rule (no bf16 reduction, ``tpul2/config.py:83-98``) holds for every variant, and the
cuBLASLt search admits only f32 split-K reductions.  On the CPU they run as plain torch.

``cublaslt_autotuned_{nn,tn}`` are the reference's cuBLASLt auto-tuning baseline (its
C12): each shape's fastest of cuBLASLt's heuristic algos, searched at the shape's first
call (``ops/lt_autotune.py``).  They are measuring baselines only; the dispatch sentinel
(``VENDOR_VARIANTS``) is the plain library calls.
"""

from __future__ import annotations

import contextlib

import torch

from tpul2_torch.ops import lt_autotune


def pin_precision() -> None:
    """Full-precision reductions for every library GEMM (stated, not assumed)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def _blas(library: str, a: torch.Tensor):
    """Route CUDA GEMMs of the block through ``library``; restore the previous choice."""
    if not a.is_cuda:
        yield
        return
    prev = torch.backends.cuda.preferred_blas_library()
    torch.backends.cuda.preferred_blas_library(library)
    try:
        yield
    finally:
        torch.backends.cuda.preferred_blas_library(prev)


def torch_matmul(a, b, b_t):
    pin_precision()
    return torch.matmul(a, b)


def cublas_nn(a, b, b_t):
    pin_precision()
    with _blas("cublas", a):
        return torch.mm(a, b)


def cublas_tn(a, b, b_t):
    pin_precision()
    with _blas("cublas", a):
        return torch.mm(a, b_t.t())


def cublaslt_nn(a, b, b_t):
    pin_precision()
    with _blas("cublaslt", a):
        return torch.mm(a, b)


def cublaslt_tn(a, b, b_t):
    pin_precision()
    with _blas("cublaslt", a):
        return torch.mm(a, b_t.t())


def cublaslt_autotuned_nn(a, b, b_t):
    return lt_autotune.lt_matmul(a, b, "nn", a.dtype)


def cublaslt_autotuned_tn(a, b, b_t):
    return lt_autotune.lt_matmul(a, b_t, "tn", a.dtype)


#: Ordered baseline registry (the reference's PERF_FUNCS list).
BASELINES = {
    "torch_matmul": torch_matmul,
    "cublas_nn": cublas_nn,
    "cublas_tn": cublas_tn,
    "cublaslt_nn": cublaslt_nn,
    "cublaslt_tn": cublaslt_tn,
    "cublaslt_autotuned_nn": cublaslt_autotuned_nn,
    "cublaslt_autotuned_tn": cublaslt_autotuned_tn,
}

#: Variants the dispatch sentinel (``KernelConfig.use_vendor``) may name: the plain
#: library calls, each the library name and the layout it reads.  All reduce in f32, so
#: both accumulator families admit all of them.
_SENTINELS = {"torch_matmul": (None, "nn"), "cublas_nn": ("cublas", "nn"),
              "cublas_tn": ("cublas", "tn"), "cublaslt_nn": ("cublaslt", "nn"),
              "cublaslt_tn": ("cublaslt", "tn")}
VENDOR_VARIANTS = tuple(_SENTINELS)


def vendor_product(variant: str, a, b, b_t, out_dtype: torch.dtype):
    """The dispatch sentinel's C = A @ B in ``out_dtype``: the f32 sum, cast once.

    The role of the JAX package's ``XLA_VARIANT_FNS``, which return the f32 product for
    the caller to cast.  With an output in the operands' dtype the library call itself
    does that (f32 sum, one rounding).  For any other output on the card it is one
    library GEMM of the bf16 operands with an f32 result (``torch.mm(..., out_dtype=
    torch.float32)``, ``aten::mm.dtype``; the variant's library and layout as above),
    then one cast where the output is not f32.  On the CPU, whose build has no kernel for
    ``mm.dtype``, the same call runs on f32 copies of the operands: bf16 products are
    exact in f32, so either way the result is the f32 sum."""
    if out_dtype == a.dtype:
        return BASELINES[variant](a, b, b_t)
    library, layout = _SENTINELS[variant]
    rhs = b_t.t() if layout == "tn" else b
    if not a.is_cuda:
        return torch.mm(a.float(), rhs.float()).to(out_dtype)
    pin_precision()
    with contextlib.nullcontext() if library is None else _blas(library, a):
        res = torch.mm(a, rhs, out_dtype=torch.float32)
    return res if out_dtype == torch.float32 else res.to(out_dtype)


def vendor_bmm(a, b, out_dtype: torch.dtype):
    """The batched sentinel: ``torch.bmm`` with the f32 sum, cast once (``aten::bmm.dtype``
    on the card, f32 copies on the CPU, as ``vendor_product``)."""
    pin_precision()
    if out_dtype == a.dtype:
        return torch.bmm(a, b)
    if not a.is_cuda:
        return torch.bmm(a.float(), b.float()).to(out_dtype)
    res = torch.bmm(a, b, out_dtype=torch.float32)
    return res if out_dtype == torch.float32 else res.to(out_dtype)
