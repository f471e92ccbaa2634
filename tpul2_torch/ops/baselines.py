"""Vendor baselines — the library GEMMs the candidate is measured against.

Counterpart of ``tpul2/ops/baselines.py`` (there: XLA formulations).  These stay library
calls on purpose: they are the vendor side of every speedup and the dispatch sentinel
that means a call can never fail, the role XLA has for the JAX package.  None of them is
a port of a kernel.

All share the harness ABI ``f(a, b, b_t) -> C`` with a (M, K), b (K, N) and its
transposed layout b_t (N, K) always supplied; each returns ``a.dtype``, as ``xla_dot_nn``
does.  On the card every one accumulates in f32: ``pin_precision`` keeps
``allow_bf16_reduced_precision_reduction`` and ``allow_tf32`` off, so the f32 family's
rule (no bf16 reduction, ``tpul2/config.py:83-98``) holds for every variant.  On the CPU
they run as plain torch.
"""

from __future__ import annotations

import contextlib

import torch


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


#: Ordered baseline registry (the reference's PERF_FUNCS list).
BASELINES = {
    "torch_matmul": torch_matmul,
    "cublas_nn": cublas_nn,
    "cublas_tn": cublas_tn,
    "cublaslt_nn": cublaslt_nn,
    "cublaslt_tn": cublaslt_tn,
}

#: Variants the dispatch sentinel (``KernelConfig.use_vendor``) may name.  All reduce in
#: f32, so both accumulator families admit all of them.
VENDOR_VARIANTS = tuple(BASELINES)


def vendor_product(variant: str, a, b, b_t, out_dtype: torch.dtype):
    """The dispatch sentinel's C = A @ B in ``out_dtype``: the f32 sum, cast once.

    The role of the JAX package's ``XLA_VARIANT_FNS``, which return the f32 product for
    the caller to cast.  With an output in the operands' dtype the library call itself
    does that (f32 sum, one rounding).  For any other output the same call runs on f32
    copies of the operands, TF32 off: bf16 products are exact in f32, so the result is the
    f32 sum rather than one rounded to bf16 on the way."""
    fn = BASELINES[variant]
    if out_dtype == a.dtype:
        return fn(a, b, b_t)
    return fn(a.float(), b.float(), b_t.float() if b_t is not None else None).to(out_dtype)
