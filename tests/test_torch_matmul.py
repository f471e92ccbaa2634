"""tpul2_torch.ops.matmul against the JAX kernels (Pallas interpret mode) at small sizes.

Inputs are made once with numpy from a seed, rounded to bf16, and handed to both packages.
Tolerances, each with its reason:
  0/1 inputs        exact equality: every sum is an integer below 2^24, so both sides
                    round identically, in either family;
  normal, f32 acc   rtol 1e-5, atol 1e-5·√K: the f32 sums run in another order;
  normal, bf16 acc  + one bf16 ulp of the largest running sum: an f32 reorder can flip one
                    rounding of the carry (ops.matmul.allowed_error states both).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2.config as jcfg
from tpul2.ops.matmul import pallas_matmul, pallas_matmul_fused, pallas_matmul_tn
from tpul2_torch.config import KernelConfig
from tpul2_torch.ops import matmul as mm

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

M, N, K = 100, 200, 300   # unaligned in every dim


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """Round to bf16 once, so both packages read identical values."""
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _inputs(seed, shape_a, shape_b, zero_one):
    rng = np.random.default_rng(seed)
    if zero_one:
        return (rng.integers(0, 2, shape_a).astype(np.float32),
                rng.integers(0, 2, shape_b).astype(np.float32))
    return _bf16_exact(rng.standard_normal(shape_a)), _bf16_exact(rng.standard_normal(shape_b))


def _t(x):
    return torch.from_numpy(x).bfloat16()


def _j(x):
    return jnp.asarray(x, jnp.bfloat16)


def _assert_close(ours, theirs, a, rhs, cfg, zero_one, bias=None, act=None):
    ours = ours.float()
    theirs = torch.from_numpy(np.array(theirs, np.float32))
    if zero_one:
        assert torch.equal(ours, theirs)
        return
    tol = mm.allowed_error(a, rhs, cfg.bk, cfg.acc_dtype, cfg.rhs_layout, torch.float32,
                           bias, act)
    assert bool(((ours - theirs).abs() <= tol).all()), (ours - theirs).abs().max()


def _cfg_dict(acc, layout, edge, gk):
    # gk == 1: one bk covering K (JAX pads or masks 300 -> 384); gk > 1: 3 intervals
    return dict(bm=64, bn=128, bk=384 if gk == "gk1" else 128, acc_dtype=acc,
                rhs_layout=layout, edge=edge)


@pytest.mark.parametrize("zero_one", [True, False], ids=["01", "normal"])
@pytest.mark.parametrize("gk", ["gk1", "gkN"])
@pytest.mark.parametrize("edge", ["pad", "mask"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_parity_grid(acc, layout, edge, gk, zero_one):
    d = _cfg_dict(acc, layout, edge, gk)
    jax_cfg = jcfg.KernelConfig(**d)
    cfg = KernelConfig.from_jax(dataclasses.asdict(jax_cfg))
    a_np, b_np = _inputs(1, (M, K), (K, N), zero_one)
    a = _t(a_np)
    if layout == "nk":
        bt_np = np.ascontiguousarray(b_np.T)
        rhs = _t(bt_np)
        ours = mm.cuda_matmul_tn(a, rhs, cfg, out_dtype=torch.float32)
        theirs = pallas_matmul_tn(_j(a_np), _j(bt_np), jax_cfg, out_dtype=jnp.float32)
    else:
        rhs = _t(b_np)
        ours = mm.cuda_matmul(a, rhs, cfg, out_dtype=torch.float32)
        theirs = pallas_matmul(_j(a_np), _j(b_np), jax_cfg, out_dtype=jnp.float32)
    assert ours.shape == (M, N) and ours.dtype == torch.float32
    _assert_close(ours, theirs, a, rhs, cfg, zero_one)


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "tanh"])
@pytest.mark.parametrize("gk", ["gk1", "gkN"])
def test_parity_bias_activation(act, gk):
    d = _cfg_dict("float32", "kn", "mask", gk)
    jax_cfg = jcfg.KernelConfig(**d)
    cfg = KernelConfig.from_jax(dataclasses.asdict(jax_cfg))
    a_np, b_np = _inputs(2, (M, K), (K, N), False)
    bias_np = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    a, b, bias = _t(a_np), _t(b_np), torch.from_numpy(bias_np)
    ours = mm.cuda_matmul_fused(a, b, bias=bias, activation=act, config=cfg,
                                out_dtype=torch.float32)
    theirs = pallas_matmul_fused(_j(a_np), _j(b_np), bias=jnp.asarray(bias_np),
                                 activation=act, config=jax_cfg, out_dtype=jnp.float32)
    _assert_close(ours, theirs, a, b, cfg, False, bias, act)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    tanh_form = 0.5 * x * (1 + torch.tanh((2 / np.pi) ** 0.5 * (x + 0.044715 * x ** 3)))
    torch.testing.assert_close(mm.ACTIVATIONS["gelu"](x), tanh_form, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_bf16_output_parity_on_01(acc):
    d = _cfg_dict(acc, "kn", "pad", "gkN")
    jax_cfg = jcfg.KernelConfig(**d)
    cfg = KernelConfig.from_jax(dataclasses.asdict(jax_cfg))
    a_np, b_np = _inputs(4, (M, K), (K, N), True)
    ours = mm.cuda_matmul(_t(a_np), _t(b_np), cfg)
    assert ours.dtype == torch.bfloat16
    theirs = pallas_matmul(_j(a_np), _j(b_np), jax_cfg)
    assert torch.equal(ours.float(), torch.from_numpy(np.array(theirs, np.float32)))


def test_bf16_rounding_points_are_per_interval():
    """The bf16 carry rounds after every bk interval but not when there is one."""
    k = 384
    a = torch.full((1, k), 1.0).bfloat16()
    b = torch.full((k, 1), 1.0 + 2 ** -7).bfloat16()   # each interval of 128 sums to 129
    one = mm.matmul_reference(a, b, bk=384, acc_dtype="bfloat16", out_dtype=torch.float32)
    many = mm.matmul_reference(a, b, bk=128, acc_dtype="bfloat16", out_dtype=torch.float32)
    assert one.item() == 387.0    # gk == 1: the f32 sum, not rounded
    assert many.item() == 388.0   # 129, 258, 387 -> bf16 388 (ties to even)


def test_out_writes_caller_memory():
    a_np, b_np = _inputs(5, (M, K), (K, N), True)
    out = torch.full((M, N), -1.0)
    res = mm.cuda_matmul(_t(a_np), _t(b_np), KernelConfig(bm=64, bn=64, bk=128), out=out)
    assert res is out
    assert torch.equal(out, torch.from_numpy(a_np @ b_np))


@pytest.mark.parametrize("bad", ["f32_inputs", "out_dtype", "noncontig", "shape",
                                 "config", "bias_dtype", "out_shape", "activation",
                                 "device"])
def test_wrapper_raises(bad):
    a, b = torch.zeros((64, 96)).bfloat16(), torch.zeros((96, 32)).bfloat16()
    cfg, kw = KernelConfig(bm=32, bn=32, bk=96), {}
    if bad == "f32_inputs":
        a = a.float()
    elif bad == "out_dtype":
        kw["out_dtype"] = torch.float16
    elif bad == "noncontig":
        b = torch.zeros((32, 96)).bfloat16().t()
    elif bad == "shape":
        b = torch.zeros((95, 32)).bfloat16()
    elif bad == "config":
        cfg = KernelConfig(bm=48)
    elif bad == "bias_dtype":
        kw["bias"] = torch.zeros(32).bfloat16()
    elif bad == "out_shape":
        kw["out"] = torch.zeros((64, 31)).bfloat16()
    elif bad == "activation":
        kw["activation"] = "softplus"
    elif bad == "device":
        a = a.to("meta")
        b = b.to("meta")
    with pytest.raises((ValueError, TypeError)):
        mm.cuda_matmul_fused(a, b, config=cfg, **kw)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises, and nothing falls back to the plain version."""
    from tpul2_torch.ops import _build
    monkeypatch.setattr(_build, "LIB_PATH", tmp_path / "libtl2_kernels.so")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    _build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load_library()
    finally:
        _build.load_library.cache_clear()
