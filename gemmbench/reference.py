"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch, importing nothing of the program: the product of the bf16 operands the
benchmark handed the program, in float64 (each product of two bf16 values is exact there,
and a sum of up to 16384 of them is exact to far below a bf16 step), row block by row block
so that it fits beside the kept outputs.

The number compared is the widest gap between a program output and the exact product, in
units of the bf16 step (ulp) at the exact value: a product accumulated in float32 and
rounded once to bf16 lies within half a step.  So that an exact value near zero does not
make the step vanish, the step is taken at no less than 2**-8 of the row's root mean
square.  A product whose running sum was rounded to bf16 on the way (the bf16-accumulator
family, the precision below the configuration's float32) lies many steps off where the sum
cancels, so it fails.

Beside it, each output's relative error: the Frobenius norm of its difference from the
exact product over the exact product's (``compare``).  Rounding once to bf16 puts it near
1.6e-3; an output off by a uniform factor reads that factor's distance from 1.
"""

from __future__ import annotations

import math

import torch

#: Elements of one float64 block of the exact product.
BLOCK = 1 << 25
#: The least step is taken at this share of the row's root mean square.
FLOOR = 2.0 ** -8
#: The names of ``compare``'s readings, in its order, as a workload's limits name them.
READINGS = ("max_ulp_gap", "max_rel_err")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values (8 significant bits) at |x| > 0, in x's dtype."""
    _, exp = torch.frexp(x)  # x = mantissa · 2**exp, 0.5 <= |mantissa| < 1
    return torch.ldexp(torch.ones_like(x), exp - 8)


def exact_rows(a: torch.Tensor, b: torch.Tensor):
    """Yield (first row, float64 block of A @ B), a block of at most ``BLOCK`` elements."""
    b64 = b.double()
    rows = max(1, BLOCK // b.shape[1])
    for r0 in range(0, a.shape[0], rows):
        yield r0, a[r0:r0 + rows].double() @ b64


def compare(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(the widest gap, in bf16 steps, between c and the exact A @ B; the relative
    Frobenius error of c), each inf for a NaN, an infinity or a shape that is not A @ B's."""
    if tuple(c.shape) != (a.shape[0], b.shape[1]):
        return math.inf, math.inf
    worst = diff2 = exact2 = 0.0
    for r0, exact in exact_rows(a, b):
        floor = FLOOR * exact.pow(2).mean(dim=1, keepdim=True).sqrt()
        step = bf16_ulp(torch.maximum(exact.abs(), floor))
        diff = c[r0:r0 + exact.shape[0]].double() - exact
        gap = (diff.abs() / step).max().item()
        if not math.isfinite(gap):
            return math.inf, math.inf
        worst = max(worst, gap)
        diff2 += diff.pow(2).sum().item()
        exact2 += exact.pow(2).sum().item()
    return worst, math.sqrt(diff2 / exact2) if exact2 else math.inf

