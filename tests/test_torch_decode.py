"""Decode-size (M or N <= 32) and unaligned products: the port against the JAX package.

Every such launch takes ``csrc/tl2_wgmma.cu``'s ring (a width-32 or swapped tile, and the
loads producer where TMA cannot read an operand); on the CPU the wrappers run their plain
versions.  Here, through the heuristic on both sides (an empty TuneDB; the JAX heuristic's
config in Pallas interpret mode, as the JAX package's own tests run it), at the shapes of
the small-batch serving regime cut to CPU size, in both families: 0/1 inputs exact (every
sum is an integer below 2^24), normal inputs within ``ops.matmul.allowed_error`` at the
JAX side's bk (the port's heuristic keeps JAX's K intervals).  Then the tuner's staged
candidates at a decode shape, and the 32-edge rings' shared memory at every depth.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2.config as jcfg
from tpul2.ops.batched import pallas_batched_matmul
from tpul2.ops.matmul import pallas_matmul
from tpul2_torch import dispatch
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.config import (PIPELINE_DEPTHS, RING_BYTES, SMEM_LIMIT, WGMMA_KSTAGE,
                                KernelConfig, candidate_configs, carry_stages,
                                wgmma_smem_bytes)
from tpul2_torch.ops import matmul as mm
from tpul2_torch.ops import pipelined as pl
from tpul2_torch.utils.padding import cdiv

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers


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


def _hold(ours, theirs, a, rhs, bk, acc, layout, zero_one):
    assert ours.shape == theirs.shape
    if zero_one:
        assert torch.equal(ours, theirs)
    else:
        tol = mm.allowed_error(a, rhs, bk, acc, layout, torch.float32)
        assert bool(((ours - theirs).abs() <= tol).all()), (ours - theirs).abs().max()


#: (m, n, k, rhs layout, the tile edge the port's heuristic must give, its producer):
#: single-request and small-batch decode, K % 8 != 0 (the loads producer reads A and
#: B_t), and N odd in 'kn' (the loads producer reads B).
SHAPES = [
    (1, 256, 512, "nk", "swapped", "wgmma"),
    (16, 384, 1024, "kn", "swapped", "wgmma"),
    (8, 136, 1001, "nk", "swapped", "wgmma_lsu"),
    (24, 1001, 256, "kn", "swapped", "wgmma_lsu"),
    (200, 17, 320, "kn", "width32", "wgmma_lsu"),
]


@pytest.mark.parametrize("zero_one", [True, False], ids=["01", "normal"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k,layout,tile,route", SHAPES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}-{s[3]}" for s in SHAPES])
def test_decode_shapes_match_jax(m, n, k, layout, tile, route, acc, zero_one):
    a_np, b_np = _inputs(41, (m, k), (k, n), zero_one)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    b_t = b.t().contiguous()
    rhs = b_t if layout == "nk" else b
    cfg = dispatch.resolve_config(m, n, k, acc)
    cfg = dataclasses.replace(cfg, rhs_layout=layout)
    assert (cfg.bn == 32 if tile == "width32" else (cfg.bm == 32 and cfg.bn > 32))
    assert mm.launch_route(cfg, a, rhs, m, n, k) == route
    jax_cfg = jcfg.heuristic_config(m, n, k, acc)
    assert cdiv(k, cfg.bk) == cdiv(k, jax_cfg.bk)
    ours = dispatch.matmul(a, b, acc=acc, b_t=b_t, config=cfg, out_dtype=torch.float32)
    theirs = torch.from_numpy(np.array(pallas_matmul(
        jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16), jax_cfg,
        out_dtype=jnp.float32), np.float32))
    _hold(ours, theirs, a, rhs, jax_cfg.bk, acc, layout, zero_one)


@pytest.mark.parametrize("zero_one", [True, False], ids=["01", "normal"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_batched_decode_matches_jax(acc, zero_one):
    """4 heads x (16 queries x 64) @ (64 x 200): the swapped tile over a batch."""
    a_np, b_np = _inputs(42, (4, 16, 64), (4, 64, 200), zero_one)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    cfg = dispatch.resolve_config(16, 200, 64, acc)
    assert cfg.bm == 32 and cfg.bn > 32
    assert mm.launch_route(cfg, a[0], b[0], 16, 200, 64) == "wgmma"
    jax_cfg = jcfg.heuristic_config(16, 200, 64, acc)
    ours = dispatch.batched_matmul(a, b, acc=acc, out_dtype=torch.float32)
    theirs = torch.from_numpy(np.array(pallas_batched_matmul(
        jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16), config=jax_cfg,
        out_dtype=jnp.float32), np.float32))
    _hold(ours, theirs, a, b, jax_cfg.bk, acc, "kn", zero_one)


def test_tuning_candidates_at_decode_take_the_ring():
    """candidate_configs(32, 14336, 4096) (the Llama-3-8B FFN up-projection at 32-batch
    decode) offers staged 32-edge candidates; each takes the ring on aligned operands, fits
    its shared memory, and splits K where its tiles leave SMs idle."""
    m, n, k = 32, 14336, 4096
    staged = [c for c in candidate_configs(m, n, k) if c.pipeline_depth >= 2]
    assert staged and all(c.bm == 32 for c in staged)
    a, rhs = torch.zeros(64, dtype=torch.bfloat16), torch.zeros(64, dtype=torch.bfloat16)
    for c in staged:
        assert c.validate() is None and c.smem_bytes() <= SMEM_LIMIT
        assert pl.staged_route(c, a, rhs, m, n, k) == "ring"
        depth = pl.staged_depth(c.pipeline_depth, k // c.bk)
        splits = pl.staged_splits(m, n, k, c.bm, c.bn, depth)
        assert splits == max(1, min(132 // (n // c.bn), cdiv(k, WGMMA_KSTAGE) // depth))
    # 16 x 4096 x 4096 on the 32 x 64 tile: 64 CTAs, so the staged launch splits K in two
    assert pl.staged_splits(16, 4096, 4096, 32, 64, 4) == 2


@pytest.mark.parametrize("bm,bn", [(32, 32), (32, 64), (32, 128), (64, 32), (128, 32)])
def test_narrow_ring_fits_at_every_depth(bm, bn):
    """A 32-edge tile's ring fits 227 KB at every staged depth and at its carry depth,
    whose stages keep RING_BYTES of the bn side in flight unless shared memory caps them."""
    for depth in PIPELINE_DEPTHS[1:]:
        cfg = KernelConfig(bm=bm, bn=bn, pipeline_depth=depth)
        assert cfg.smem_bytes() == wgmma_smem_bytes(bm, bn, depth) <= SMEM_LIMIT
        assert cfg.validate() is None
    stages = carry_stages(bm, bn)
    assert KernelConfig(bm=bm, bn=bn).smem_bytes() == wgmma_smem_bytes(bm, bn, stages)
    assert wgmma_smem_bytes(bm, bn, stages) <= SMEM_LIMIT
    assert (stages * bn * 128 >= RING_BYTES
            or wgmma_smem_bytes(bm, bn, stages + 1) > SMEM_LIMIT)


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("bk", [64, 96, 128])
def test_ring_order_reference_keeps_the_rounding_points(bk, layout):
    """chip_smoke.py's ring-order reference (which an element of a bf16 carry beyond
    allowed_error must match bit for bit) rounds the running sum where matmul_reference
    does, K tail included: on 0/1 inputs every partial sum is an exact integer, so only
    the rounding points decide the bits, and sums past 256 make them round."""
    import chip_smoke

    rng = np.random.default_rng(43)
    a = torch.from_numpy((rng.random((9, 1000)) < 0.8).astype(np.float32)).bfloat16()
    b = torch.from_numpy((rng.random((1000, 40)) < 0.8).astype(np.float32)).bfloat16()
    rhs = b.t().contiguous() if layout == "nk" else b
    want = mm.matmul_reference(a, rhs, bk, "bfloat16", layout, out_dtype=torch.float32)
    assert not torch.equal(want, a.float() @ b.float())  # the carry did round
    for chain16 in (False, True):
        got = chip_smoke._ring_order_reference(torch, mm, a, rhs, bk, layout,
                                               out_dtype=torch.float32, chain16=chain16)
        assert torch.equal(got, want)
