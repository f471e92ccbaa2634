"""tpul2_torch.models against tpul2.models at a small width (Pallas interpret mode).

d_model 128, d_ff 256, seq 32, 4 heads: the block's products are (32 x 384 x 128),
(32 x 128 x 128), (32 x 256 x 128), (32 x 128 x 256) and the batched (4 x 32 x 32 x 32)
twice; every GEMM runs on an explicit config with bk = 128 in both packages (so the f32
sums have the same intervals), or on the sentinel.  Params are drawn once with numpy (biases
random and non-zero, scales away from 1, so both are exercised), made into the JAX
package's params, and carried across with ``block_params_from_numpy`` /
``ffn_params_from_numpy``; x and y come from the same numpy draw.

Tolerances, each with its reason: the two packages take the same f32 sums in another
order, which can flip a bf16 rounding of an intermediate (qkv, probs, ctx, h) by one ulp
and carry it on:
  forward        rtol = atol = 0.02 on the bf16 output (JAX's own block test holds its
                 kernels to the XLA sentinel at 0.05);
  loss           rtol 1e-3 (a mean over seq x d_model of such outputs);
  grads          per tensor, relative L2 error <= 0.02;
  updated params bf16 weights: one bf16 ulp (rtol 2^-7) + the step's own difference;
                 f32 biases and scales: rtol 1e-5 + lr x the grad tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import tpul2.config as jcfg
from tpul2.models import mlp as jmlp
from tpul2.models import transformer as jtf
from tpul2_torch.config import KernelConfig
from tpul2_torch.models import (FFNParams, block_forward, block_params_from_numpy,
                                block_train_step, block_value_and_grad, ffn_forward,
                                ffn_params_from_numpy, train_step)
from tpul2_torch.models import entry as entry_mod
from tpul2_torch.models.transformer import BlockParams

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

D, F, S, HEADS = 128, 256, 32, 4
LR = 5e-2
CONFIGS = {"kernel": (jcfg.KernelConfig(bm=32, bn=128, bk=128),
                      KernelConfig(bm=32, bn=128, bk=128)),
           "sentinel": (jcfg.KernelConfig.xla(), KernelConfig.vendor())}
FWD_TOL = 0.02
GRAD_TOL = 0.02


def _block_params(seed: int) -> tuple:
    """(JAX BlockParams, the same as numpy arrays)."""
    rng = np.random.default_rng(seed)

    def w(fan_in, shape):
        return jnp.asarray(rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5, jnp.bfloat16)

    def vec(n, center):
        return jnp.asarray(center + 0.1 * rng.standard_normal(n), jnp.float32)

    params = jtf.BlockParams(
        wqkv=w(D, (D, 3 * D)), bqkv=vec(3 * D, 0.0), wo=w(D, (D, D)), bo=vec(D, 0.0),
        w1=w(D, (D, F)), b1=vec(F, 0.0), w2=w(F, (F, D)), b2=vec(D, 0.0),
        ln1_scale=vec(D, 1.0), ln2_scale=vec(D, 1.0))
    return params, {k: np.asarray(v) for k, v in params._asdict().items()}


def _ffn_params(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    params = jmlp.FFNParams(
        w1=jnp.asarray(rng.standard_normal((D, F)) * (2.0 / D) ** 0.5, jnp.bfloat16),
        w2=jnp.asarray(rng.standard_normal((F, D)) * (2.0 / F) ** 0.5, jnp.bfloat16))
    return params, {k: np.asarray(v) for k, v in params._asdict().items()}


def _xy(seed: int, rows: int = S) -> tuple:
    """(x, y) as bf16-exact f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x, y = (torch.from_numpy(rng.standard_normal((rows, D)).astype(np.float32)).bfloat16()
            .float().numpy() for _ in range(2))
    return x, y


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _rel_l2(ours: torch.Tensor, theirs) -> float:
    theirs = _t(theirs)
    return ((ours.float() - theirs).norm() / theirs.norm()).item()


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_block_forward_matches_jax(kind):
    jparams, arrays = _block_params(0)
    x, _ = _xy(1)
    jax_cfg, cfg = CONFIGS[kind]
    theirs = jtf.block_forward(jparams, jnp.asarray(x, jnp.bfloat16), HEADS, config=jax_cfg)
    ours = block_forward(block_params_from_numpy(arrays, device="cpu"),
                         torch.from_numpy(x).bfloat16(), HEADS, config=cfg)
    assert ours.shape == (S, D) and ours.dtype == torch.bfloat16
    torch.testing.assert_close(ours.float(), _t(theirs), rtol=FWD_TOL, atol=FWD_TOL)


def test_block_train_step_matches_jax():
    jparams, arrays = _block_params(2)
    x, y = _xy(3)
    jax_cfg, cfg = CONFIGS["kernel"]
    xj, yj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    loss_j, grads_j = jax.value_and_grad(jtf.block_loss)(jparams, xj, yj, HEADS, config=jax_cfg)
    new_j, step_loss_j = jtf.block_train_step(jparams, xj, yj, HEADS, lr=LR, config=jax_cfg)

    params = block_params_from_numpy(arrays, device="cpu")
    xt, yt = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
    loss, grads = block_value_and_grad(params, xt, yt, HEADS, config=cfg)
    new, step_loss = block_train_step(params, xt, yt, HEADS, lr=LR, config=cfg)

    assert float(step_loss) == pytest.approx(float(step_loss_j), rel=1e-3)
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-3)
    for name in BlockParams._fields:
        g, gj = getattr(grads, name), getattr(grads_j, name)
        assert g.dtype == getattr(params, name).dtype and torch.isfinite(g.float()).all()
        assert _rel_l2(g, gj) <= GRAD_TOL, name
        p, pj, old = getattr(new, name), _t(getattr(new_j, name)), getattr(params, name)
        assert p.dtype == old.dtype and p.shape == old.shape
        if old.dtype == torch.bfloat16:
            # one ulp, plus the two steps' difference lr·|Δg| before the rounding
            tol = 2.0 ** -7 * pj.abs() + LR * (g.float() - _t(gj)).abs()
        else:
            tol = 1e-5 * pj.abs() + LR * GRAD_TOL * _t(gj).norm() + 1e-6
        assert bool(((p.float() - pj).abs() <= tol).all()), name
        assert not torch.equal(p.float(), old.float()) or name.startswith("w"), name


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_ffn_forward_matches_jax(kind):
    jparams, arrays = _ffn_params(4)
    x, _ = _xy(5)
    jax_cfg, cfg = CONFIGS[kind]
    theirs = jmlp.ffn_forward(jparams, jnp.asarray(x, jnp.bfloat16), config=jax_cfg)
    ours = ffn_forward(ffn_params_from_numpy(arrays, device="cpu"),
                       torch.from_numpy(x).bfloat16(), config=cfg)
    assert ours.shape == (S, D) and ours.dtype == torch.bfloat16
    torch.testing.assert_close(ours.float(), _t(theirs), rtol=FWD_TOL, atol=FWD_TOL)


def test_ffn_train_step_matches_jax():
    jparams, arrays = _ffn_params(6)
    x, y = _xy(7)
    jax_cfg, cfg = CONFIGS["kernel"]
    xj, yj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    new_j, loss_j = jmlp.train_step(jparams, xj, yj, lr=LR, config=jax_cfg)
    grads_j = jax.grad(jmlp.loss_fn)(jparams, xj, yj, config=jax_cfg)
    params = ffn_params_from_numpy(arrays, device="cpu")
    new, loss = train_step(params, torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(y).bfloat16(), lr=LR, config=cfg)
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-3)
    for name in FFNParams._fields:
        p, pj, old = getattr(new, name), _t(getattr(new_j, name)), getattr(params, name)
        assert p.dtype == torch.bfloat16 and p.shape == old.shape
        step_diff = LR * GRAD_TOL * _t(getattr(grads_j, name)).abs().max()
        assert bool(((p.float() - pj).abs() <= 2.0 ** -7 * pj.abs() + step_diff).all()), name


def test_causal_masking():
    """The output at the first positions does not depend on later ones (the counterpart of
    tests/test_transformer.py's), and the masked scores give finite grads."""
    _, arrays = _block_params(0)
    params = block_params_from_numpy(arrays, device="cpu")
    x, _ = _xy(8, rows=16)
    x1 = torch.from_numpy(x).bfloat16()
    x2 = x1.clone()
    x2[8:] = torch.from_numpy(np.random.default_rng(9).standard_normal((8, D))
                              .astype(np.float32)).bfloat16()
    cfg = CONFIGS["kernel"][1]
    out1, out2 = (block_forward(params, xx, HEADS, config=cfg) for xx in (x1, x2))
    assert torch.equal(out1[:8], out2[:8])
    assert not torch.equal(out1[8:], out2[8:])
    xg = x1.clone().requires_grad_()
    (gx,) = torch.autograd.grad(block_forward(params, xg, HEADS, config=cfg)[:8].float().sum(),
                                xg)
    assert torch.isfinite(gx.float()).all()
    assert torch.count_nonzero(gx[8:]) == 0  # later positions do not reach earlier outputs


def test_entry_matches_the_jax_entry_shapes():
    """``entry(device='cpu')`` builds what ``__graft_entry__.entry()`` describes (shapes and
    dtypes, read with ``jax.eval_shape``: nothing runs at full width)."""
    fn, (params, x) = entry_mod.entry(device="cpu")
    jparams, jx = jax.eval_shape(lambda: graft.entry()[1])
    assert tuple(x.shape) == jx.shape and str(x.dtype).endswith(str(jx.dtype))
    for name in BlockParams._fields:
        ours, theirs = getattr(params, name), getattr(jparams, name)
        assert tuple(ours.shape) == theirs.shape, name
        assert str(ours.dtype).endswith(str(theirs.dtype)), name
        assert ours.device.type == "cpu"
    assert (entry_mod.D_MODEL, entry_mod.D_FF, entry_mod.SEQ, entry_mod.N_HEADS) == \
        (1024, 4096, 512, 8)
    # the entry's step at a small width (8 heads, the configs each package resolves) against
    # what __graft_entry__'s fn computes there
    jparams, arrays = _block_params(10)
    small_x, _ = _xy(11)
    ours = fn(block_params_from_numpy(arrays, device="cpu"), torch.from_numpy(small_x).bfloat16())
    theirs = jtf.block_forward(jparams, jnp.asarray(small_x, jnp.bfloat16), n_heads=8)
    assert ours.shape == (S, D) and ours.dtype == torch.bfloat16
    torch.testing.assert_close(ours.float(), _t(theirs), rtol=FWD_TOL, atol=FWD_TOL)


def test_entry_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry_mod.entry()
    with pytest.raises(ValueError):
        entry_mod.entry(device="tpu")


def test_params_from_numpy_keep_values_and_dtypes():
    jparams, arrays = _block_params(12)
    params = block_params_from_numpy(arrays, device="cpu")
    for name in BlockParams._fields:
        ours, theirs = getattr(params, name), getattr(jparams, name)
        assert str(ours.dtype).endswith(str(theirs.dtype)), name
        assert torch.equal(ours.float(), _t(theirs)), name
    with pytest.raises(ValueError, match="fields"):
        block_params_from_numpy({k: v for k, v in arrays.items() if k != "bo"}, device="cpu")
    ffn = ffn_params_from_numpy(_ffn_params(13)[1], device="cpu")
    assert ffn.w1.dtype == torch.bfloat16 and ffn.w1.shape == (D, F)
