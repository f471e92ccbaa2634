"""Gradients of the port's GEMM entry points against ``jax.vjp`` of the JAX package's.

The same numpy-seeded inputs and cotangent go through ``tpul2.dispatch.matmul`` /
``batched_matmul`` (Pallas interpret mode, explicit configs, as the JAX tests run them) and
through ``tpul2_torch.dispatch``'s, then ``torch.autograd.grad``.  Both backwards are
library products in f32 cast once to each input's dtype, so the tolerances are those of two
f32 sums taken in another order, then rounded:
  bf16 grads   |ours - theirs| <= 2^-7·|theirs| + 1e-5·√L: one bf16 ulp (a rounding of the
               f32 sums that falls the other way; an ulp is at most 2^-7 of the value), plus
               the f32 reorder of L unit-scale terms where a sum cancels to near zero;
  f32 grads    the bias: rtol = atol = 1e-5 (a sum of M f32 values in another order), plus,
               with an activation, what the recomputed f32 pre-activation h = a @ b + bias
               moves it by: each h is a sum of K terms in another order, off by up to
               1e-5·(|h| + √K) (``ops.matmul.allowed_error``'s f32 terms), which moves
               g·act'(h) by up to |g|·max|act''|·that, summed over the M rows.
K = 384 with bk = 128 gives three K intervals (gk > 1), so the K carry runs forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2.config as jcfg
from tpul2 import dispatch as jdispatch
from tpul2_torch import dispatch
from tpul2_torch.config import KernelConfig
from tpul2_torch.ops import matmul as mm

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

M, N, K, BK = 64, 96, 384, 128
BATCH = 3


def _bf16(rng, shape) -> np.ndarray:
    """Normal values rounded to bf16 once, so both packages read the same numbers."""
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16() \
        .float().numpy()


def _configs(acc: str, layout: str = "kn") -> tuple:
    """(JAX config, port config) with the same bk: JAX takes bn = N (a full-dim block),
    the port's tiles are 32/64/128, so its bn = 64 leaves an N edge."""
    return (jcfg.KernelConfig(bm=64, bn=N, bk=BK, acc_dtype=acc, rhs_layout=layout),
            KernelConfig(bm=64, bn=64, bk=BK, acc_dtype=acc, rhs_layout=layout))


def _assert_grad(ours: torch.Tensor, theirs, length: int) -> None:
    theirs = torch.from_numpy(np.array(theirs, np.float32))
    assert tuple(ours.shape) == tuple(theirs.shape)
    ours = ours.float()
    tol = 2.0 ** -7 * theirs.abs() + 1e-5 * length ** 0.5
    err = (ours - theirs).abs()
    assert bool((err <= tol).all()), f"max |diff| {err.max().item()}, worst excess " \
                                     f"{(err - tol).max().item()}"


#: max |act''(x)|: the tanh gelu's is 0.798 (at 0); relu's and the identity's are 0.
_CURVATURE = {None: 0.0, "relu": 0.0, "gelu": 0.8}


def _assert_bias_grad(ours: torch.Tensor, theirs, ct, a, b, bias, act) -> None:
    assert ours.dtype == torch.float32
    theirs = np.asarray(theirs, np.float64)
    h = a.astype(np.float64) @ b.astype(np.float64) + bias
    moved = (np.abs(ct) * _CURVATURE[act] * 1e-5 * (np.abs(h) + K ** 0.5)).sum(0)
    tol = 1e-5 + 1e-5 * np.abs(theirs) + moved
    err = np.abs(ours.double().numpy() - theirs)
    assert bool((err <= tol).all()), f"max |diff| {err.max()}, worst excess {(err - tol).max()}"


def _jax_vjp(fn, primals, ct):
    out, vjp = jax.vjp(fn, *primals)
    return out, vjp(ct)


#: (layout, epilogue, out dtype, acc family): every JAX VJP is reached (pallas_matmul's,
#: pallas_matmul_tn's and pallas_matmul_fused's), with both out dtypes and both families.
CASES = [(layout, epi, out, acc)
         for layout in ("kn", "nk")
         for epi in (None, "bias", "gelu", "relu")
         for out in ("bfloat16", "float32")
         for acc in (("float32", "bfloat16") if epi in (None, "gelu") else ("float32",))]


@pytest.mark.parametrize("layout,epi,out,acc", CASES)
def test_matmul_grads_match_jax(layout, epi, out, acc):
    rng = np.random.default_rng(11)
    a_np, b_np = _bf16(rng, (M, K)), _bf16(rng, (K, N))
    bias_np = rng.standard_normal(N).astype(np.float32) if epi else None
    act = epi if epi in ("gelu", "relu") else None
    ct_np = _bf16(rng, (M, N))  # the cotangent: bf16 values, exact in either out dtype
    jax_cfg, cfg = _configs(acc, layout)
    out_j, out_t = getattr(jnp, out), getattr(torch, out)

    def f_jax(a, b, *bias):
        return jdispatch.matmul(a, b, config=jax_cfg, bias=bias[0] if bias else None,
                                activation=act, out_dtype=out_j, interpret=True)

    primals = [jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16)]
    if epi:
        primals.append(jnp.asarray(bias_np))
    _, grads_j = _jax_vjp(f_jax, primals, jnp.asarray(ct_np, out_j))

    a = torch.from_numpy(a_np).bfloat16().requires_grad_()
    b = torch.from_numpy(b_np).bfloat16().requires_grad_()
    bias = torch.from_numpy(bias_np).requires_grad_() if epi else None
    res = dispatch.matmul(a, b, config=cfg, bias=bias, activation=act, out_dtype=out_t)
    assert res.dtype == out_t and res.grad_fn is not None
    inputs = (a, b) + ((bias,) if epi else ())
    grads_t = torch.autograd.grad(res, inputs, torch.from_numpy(ct_np).to(out_t))
    assert grads_t[0].dtype == torch.bfloat16 and grads_t[1].dtype == torch.bfloat16
    _assert_grad(grads_t[0], grads_j[0], N)
    _assert_grad(grads_t[1], grads_j[1], M)
    if epi:
        _assert_bias_grad(grads_t[2], grads_j[2], ct_np, a_np, b_np, bias_np, act)


def test_tn_grad_goes_to_b_t():
    """With b_t given and an 'nk' config, both packages read b_t and return its cotangent
    in b_t's (N, K) layout (``_matmul_tn_bwd``)."""
    rng = np.random.default_rng(12)
    a_np, bt_np, ct_np = _bf16(rng, (M, K)), _bf16(rng, (N, K)), _bf16(rng, (M, N))
    jax_cfg, cfg = _configs("float32", "nk")
    b_dummy = jnp.zeros((K, N), jnp.bfloat16)
    _, grads_j = _jax_vjp(lambda a, bt: jdispatch.matmul(
        a, b_dummy, config=jax_cfg, b_t=bt, interpret=True),
        [jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(bt_np, jnp.bfloat16)],
        jnp.asarray(ct_np, jnp.bfloat16))
    a = torch.from_numpy(a_np).bfloat16().requires_grad_()
    b_t = torch.from_numpy(bt_np).bfloat16().requires_grad_()
    res = dispatch.matmul(a, torch.zeros((K, N), dtype=torch.bfloat16), config=cfg, b_t=b_t)
    da, dbt = torch.autograd.grad(res, (a, b_t), torch.from_numpy(ct_np).bfloat16())
    _assert_grad(da, grads_j[0], N)
    _assert_grad(dbt, grads_j[1], M)


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_batched_grads_match_jax(acc, out):
    rng = np.random.default_rng(13)
    k = 2 * BK  # two K intervals
    a_np, b_np = _bf16(rng, (BATCH, M, k)), _bf16(rng, (BATCH, k, N))
    ct_np = _bf16(rng, (BATCH, M, N))
    jax_cfg, cfg = _configs(acc)
    out_j, out_t = getattr(jnp, out), getattr(torch, out)
    _, grads_j = _jax_vjp(lambda a, b: jdispatch.batched_matmul(
        a, b, config=jax_cfg, out_dtype=out_j, interpret=True),
        [jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16)],
        jnp.asarray(ct_np, out_j))
    a = torch.from_numpy(a_np).bfloat16().requires_grad_()
    b = torch.from_numpy(b_np).bfloat16().requires_grad_()
    res = dispatch.batched_matmul(a, b, config=cfg, out_dtype=out_t)
    da, db = torch.autograd.grad(res, (a, b), torch.from_numpy(ct_np).to(out_t))
    _assert_grad(da, grads_j[0], N)
    _assert_grad(db, grads_j[1], M)


@pytest.mark.parametrize("epi,out", [(None, "bfloat16"), (None, "float32"),
                                     ("gelu", "float32"), ("gelu", "bfloat16")])
def test_sentinel_grads_match_jax(epi, out):
    """The sentinel (XLA's own derivative in JAX; ``GemmVjp`` here, since the card's
    bf16-in, f32-out ``aten::mm.dtype`` has no derivative)."""
    rng = np.random.default_rng(14)
    a_np, b_np, ct_np = _bf16(rng, (M, K)), _bf16(rng, (K, N)), _bf16(rng, (M, N))
    bias_np = rng.standard_normal(N).astype(np.float32) if epi else None
    out_j, out_t = getattr(jnp, out), getattr(torch, out)

    def f_jax(a, b, *bias):
        return jdispatch.matmul(a, b, config=jcfg.KernelConfig.xla(),
                                bias=bias[0] if bias else None, activation=epi,
                                out_dtype=out_j)

    primals = [jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16)]
    if epi:
        primals.append(jnp.asarray(bias_np))
    _, grads_j = _jax_vjp(f_jax, primals, jnp.asarray(ct_np, out_j))
    a = torch.from_numpy(a_np).bfloat16().requires_grad_()
    b = torch.from_numpy(b_np).bfloat16().requires_grad_()
    bias = torch.from_numpy(bias_np).requires_grad_() if epi else None
    res = dispatch.matmul(a, b, config=KernelConfig.vendor(), bias=bias, activation=epi,
                          out_dtype=out_t)
    grads_t = torch.autograd.grad(res, (a, b) + ((bias,) if epi else ()),
                                  torch.from_numpy(ct_np).to(out_t))
    _assert_grad(grads_t[0], grads_j[0], N)
    _assert_grad(grads_t[1], grads_j[1], M)
    if epi:
        _assert_bias_grad(grads_t[2], grads_j[2], ct_np, a_np, b_np, bias_np, epi)


def test_batched_sentinel_grads_match_jax():
    rng = np.random.default_rng(15)
    a_np, b_np = _bf16(rng, (BATCH, M, K)), _bf16(rng, (BATCH, K, N))
    ct_np = rng.standard_normal((BATCH, M, N)).astype(np.float32)  # an f32 cotangent
    _, grads_j = _jax_vjp(lambda a, b: jdispatch.batched_matmul(
        a, b, config=jcfg.KernelConfig.xla(), out_dtype=jnp.float32),
        [jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16)],
        jnp.asarray(ct_np))
    a = torch.from_numpy(a_np).bfloat16().requires_grad_()
    b = torch.from_numpy(b_np).bfloat16().requires_grad_()
    res = dispatch.batched_matmul(a, b, config=KernelConfig.vendor(), out_dtype=torch.float32)
    da, db = torch.autograd.grad(res, (a, b), torch.from_numpy(ct_np))
    _assert_grad(da, grads_j[0], N)
    _assert_grad(db, grads_j[1], M)


def test_staged_config_has_no_gradient_as_in_jax():
    """A staged config with more than one K interval: ``jax.grad`` raises (pallas_call's
    JVP rule fails on the manual DMA ring), so the port's backward raises; the forward
    runs in both."""
    rng = np.random.default_rng(16)
    n = 128  # the staged kernel needs every dim to divide its block
    a_np, b_np = _bf16(rng, (M, K)), _bf16(rng, (K, n))
    jax_cfg = jcfg.KernelConfig(bm=64, bn=n, bk=BK, pipeline_depth=2)
    with pytest.raises(AssertionError):
        jax.grad(lambda a: jdispatch.matmul(a, jnp.asarray(b_np, jnp.bfloat16),
                                            config=jax_cfg, interpret=True)
                 .astype(jnp.float32).sum())(jnp.asarray(a_np, jnp.bfloat16))
    a = torch.from_numpy(a_np).bfloat16().requires_grad_()
    res = dispatch.matmul(a, torch.from_numpy(b_np).bfloat16(),
                          config=KernelConfig(bm=64, bn=n, bk=BK, pipeline_depth=2))
    assert res.shape == (M, n)
    with pytest.raises(NotImplementedError, match="staged"):
        res.float().sum().backward()


def test_staged_config_with_one_interval_is_differentiable_as_in_jax():
    """gk == 1: both packages hand the call to the single-K kernel, whose VJP applies."""
    rng = np.random.default_rng(17)
    k, n = BK, 128
    a_np, b_np, ct_np = _bf16(rng, (M, k)), _bf16(rng, (k, n)), _bf16(rng, (M, n))
    jax_cfg = jcfg.KernelConfig(bm=64, bn=n, bk=BK, pipeline_depth=2)
    _, grads_j = _jax_vjp(lambda a, b: jdispatch.matmul(a, b, config=jax_cfg, interpret=True),
                          [jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16)],
                          jnp.asarray(ct_np, jnp.bfloat16))
    a = torch.from_numpy(a_np).bfloat16().requires_grad_()
    b = torch.from_numpy(b_np).bfloat16().requires_grad_()
    res = dispatch.matmul(a, b, config=KernelConfig(bm=64, bn=n, bk=BK, pipeline_depth=2))
    da, db = torch.autograd.grad(res, (a, b), torch.from_numpy(ct_np).bfloat16())
    _assert_grad(da, grads_j[0], n)
    _assert_grad(db, grads_j[1], M)


@pytest.mark.parametrize("entry", ["matmul", "batched_matmul", "sentinel", "staged"])
def test_out_with_grad_raises(entry):
    """``out=`` and a tensor that requires grad: refused, as torch's own ``out=`` does; the
    same call under ``torch.no_grad()`` writes ``out``."""
    a = torch.ones((1, M, BK), dtype=torch.bfloat16, requires_grad=True)
    b = torch.ones((1, BK, 128), dtype=torch.bfloat16)
    if entry == "batched_matmul":
        def call(out):
            return dispatch.batched_matmul(a, b, config=KernelConfig(bm=64, bn=128, bk=BK),
                                           out=out)
    else:
        cfg = {"matmul": KernelConfig(bm=64, bn=128, bk=BK), "sentinel": KernelConfig.vendor(),
               "staged": KernelConfig(bm=64, bn=128, bk=32, pipeline_depth=2)}[entry]

        def call(out):
            return dispatch.matmul(a[0], b[0], config=cfg, out=out[0])
    out = torch.empty((1, M, 128), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="out="):
        call(out)
    with torch.no_grad():
        call(out)
    assert torch.equal(out.float(), torch.full(out.shape, float(BK)))


def test_no_grad_path_records_nothing():
    """Without a tensor that requires grad the wrapper is the plain call: no graph node."""
    a, b = torch.ones((M, BK), dtype=torch.bfloat16), torch.ones((BK, 64), dtype=torch.bfloat16)
    res = mm.cuda_matmul(a, b, KernelConfig(bm=64, bn=64, bk=BK))
    assert res.grad_fn is None and not res.requires_grad
