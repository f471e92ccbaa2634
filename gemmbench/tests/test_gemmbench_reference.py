"""The reference against a naive product, and the comparison's readings."""

import math

import numpy as np
import torch

from gemmbench import reference

g = torch.Generator().manual_seed(0)


def _operands(m, n, k):
    return (torch.randn(m, k, generator=g).bfloat16(), torch.randn(k, n, generator=g).bfloat16())


def test_exact_product_against_a_naive_loop(monkeypatch):
    monkeypatch.setattr(reference, "BLOCK", 7 * 5)  # several row blocks
    a, b = _operands(9, 5, 13)
    an, bn = a.double().numpy(), b.double().numpy()
    naive = np.array([[sum(an[i, p] * bn[p, j] for p in range(13)) for j in range(5)]
                      for i in range(9)])
    got = torch.cat([blk for _, blk in reference.exact_rows(a, b)]).numpy()
    assert got.shape == (9, 5) and np.allclose(got, naive, rtol=0, atol=1e-12)


def test_bf16_ulp():
    x = torch.tensor([1.0, 1.5, 2.0, 3.0, 0.75, -256.0], dtype=torch.float64)
    assert reference.bf16_ulp(x).tolist() == [2 ** -7, 2 ** -7, 2 ** -6, 2 ** -6, 2 ** -8, 2.0]


def test_f32_sum_rounded_once_is_within_half_a_step():
    a, b = _operands(64, 48, 2048)
    c = (a.float() @ b.float()).bfloat16()
    assert reference.compare(c, a, b)[0] <= 0.5 + 1e-3


def test_sum_rounded_to_bf16_on_the_way_reads_many_steps():
    a, b = _operands(64, 48, 2048)
    acc = torch.zeros(64, 48)
    for k0 in range(0, 2048, 256):  # the bf16 family's carry: round after each interval
        acc = (acc + a[:, k0:k0 + 256].float() @ b[k0:k0 + 256].float()).bfloat16().float()
    assert reference.compare(acc.bfloat16(), a, b)[0] > 3.0


def test_a_nan_or_a_wrong_shape_reads_infinite():
    a, b = _operands(8, 8, 64)
    c = (a.float() @ b.float()).bfloat16()
    c[3, 3] = float("nan")
    assert reference.compare(c, a, b) == (math.inf, math.inf)
    assert reference.compare(c[:4], a, b) == (math.inf, math.inf)


def test_relative_error_of_one_rounding_and_of_a_uniform_factor():
    a, b = _operands(64, 48, 2048)
    exact = a.float() @ b.float()
    rounded = reference.compare(exact.bfloat16(), a, b)[1]
    assert 1.4e-3 < rounded < 1.9e-3  # the root mean square of a bf16 step's rounding
    assert math.isclose(reference.compare(exact * 1.01, a, b)[1], 0.01, rel_tol=1e-3)

