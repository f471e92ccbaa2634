"""tpul2_torch.ops.batched against ``tpul2.ops.batched`` (Pallas interpret mode).

Tolerances as in test_torch_matmul.py: 0/1 inputs exact; normal inputs within
``ops.matmul.allowed_error`` (f32 reorder, plus one bf16 ulp of the running sum in the
bf16 family).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2.config as jcfg
from tpul2.ops.batched import pallas_batched_matmul
from tpul2_torch import dispatch
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.config import KernelConfig
from tpul2_torch.ops import batched as bmm
from tpul2_torch.ops.matmul import allowed_error

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

BATCH = 3


@pytest.fixture(autouse=True)
def empty_tunedb(tmp_path, monkeypatch):
    """These tests hold the heuristic: TPUL2_TORCH_TUNEDB names a file that is not there,
    so no DB, the committed one included, steers their resolution."""
    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "empty_tunedb.json"))
    db_mod.reset_default_db()
    yield
    db_mod.reset_default_db()


def _inputs(seed, shape_a, shape_b, zero_one):
    rng = np.random.default_rng(seed)
    if zero_one:
        return (rng.integers(0, 2, shape_a).astype(np.float32),
                rng.integers(0, 2, shape_b).astype(np.float32))
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .bfloat16().float().numpy() for s in (shape_a, shape_b))


@pytest.mark.parametrize("zero_one", [True, False], ids=["01", "normal"])
@pytest.mark.parametrize("shape", [(64, 128, 256), (100, 200, 300)], ids=["al", "un"])
@pytest.mark.parametrize("gk", ["gk1", "gkN"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_batched_parity(acc, gk, shape, zero_one):
    m, n, k = shape
    bk = 128 if gk == "gkN" else (256 if k <= 256 else 384)
    jax_cfg = jcfg.KernelConfig(bm=32, bn=128, bk=bk, acc_dtype=acc)
    cfg = KernelConfig.from_jax(dataclasses.asdict(jax_cfg))
    a_np, b_np = _inputs(7, (BATCH, m, k), (BATCH, k, n), zero_one)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    ours = bmm.cuda_batched_matmul(a, b, cfg, out_dtype=torch.float32)
    theirs = torch.from_numpy(np.array(pallas_batched_matmul(
        jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16), config=jax_cfg,
        out_dtype=jnp.float32), np.float32))
    assert ours.shape == (BATCH, m, n)
    if zero_one:
        assert torch.equal(ours, theirs)
    else:
        tol = allowed_error(a, b, cfg.bk, acc)
        assert bool(((ours - theirs).abs() <= tol).all())


def test_batched_matches_2d_per_element():
    from tpul2_torch.ops.matmul import cuda_matmul
    a_np, b_np = _inputs(8, (BATCH, 40, 200), (BATCH, 200, 72), False)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    cfg = KernelConfig(bm=32, bn=64, bk=64, acc_dtype="bfloat16")
    out = bmm.cuda_batched_matmul(a, b, cfg)
    for t in range(BATCH):
        assert torch.equal(out[t], cuda_matmul(a[t], b[t], cfg))


def test_dispatch_batched_matmul_exact_on_01():
    a_np, b_np = _inputs(9, (2, 96, 160), (2, 160, 80), True)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    out = dispatch.batched_matmul(a, b, out_dtype=torch.float32)
    assert torch.equal(out, torch.from_numpy(np.matmul(a_np, b_np)))
    vendor = dispatch.batched_matmul(a, b, config=KernelConfig.vendor())
    assert torch.equal(vendor.float(), torch.from_numpy(np.matmul(a_np, b_np)).bfloat16().float())


@pytest.mark.parametrize("bad", ["2d", "batch", "k", "nk_shape"])
def test_batched_raises(bad):
    a, b = torch.zeros((2, 32, 64)).bfloat16(), torch.zeros((2, 64, 32)).bfloat16()
    if bad == "2d":
        a = a[0]
    elif bad == "batch":
        b = torch.zeros((3, 64, 32)).bfloat16()
    elif bad == "k":
        b = torch.zeros((2, 63, 32)).bfloat16()
    elif bad == "nk_shape":
        b = torch.zeros((2, 32, 63)).bfloat16()
    with pytest.raises(ValueError):
        bmm.cuda_batched_matmul(a, b, KernelConfig(bm=32, bn=32, bk=64))
