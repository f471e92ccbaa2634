"""tpul2_torch.config: the Hopper config space against the JAX package's."""

import dataclasses

import pytest
import torch

import tpul2.config as jcfg
from tpul2_torch.config import (KSTEP, NUM_SMS, SMEM_LIMIT, TILE_CHOICES, WGMMA_TILES,
                                KernelConfig, carry_stages, heuristic_config)
from tpul2_torch.ops.baselines import VENDOR_VARIANTS
from tpul2_torch.utils.padding import cdiv

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

BRING_UP_SHAPES = [(4096, 4096, 4096), (64, 8192, 8192), (8192, 128, 64),
                   (1000, 1000, 1000)]


@pytest.mark.parametrize("kw", [
    dict(bm=64, bn=128, bk=128),
    dict(bm=32, bn=128, bk=256, acc_dtype="bfloat16", grid_order="nm"),
    dict(bm=128, bn=128, bk=512, rhs_layout="nk", edge="mask"),
    dict(bm=64, bn=128, bk=128, parallel_mn=False, vmem_limit_bytes=32 << 20),
])
def test_from_jax_carries_the_shared_fields(kw):
    jax_cfg = jcfg.KernelConfig(**kw)
    cfg = KernelConfig.from_jax(dataclasses.asdict(jax_cfg))
    for field in ("bm", "bn", "bk", "acc_dtype", "grid_order", "rhs_layout", "edge",
                  "pipeline_depth"):
        assert getattr(cfg, field) == getattr(jax_cfg, field)
    assert not cfg.use_vendor
    assert cfg.validate() is None
    assert not hasattr(cfg, "vmem_limit_bytes") and not hasattr(cfg, "parallel_mn")


@pytest.mark.parametrize("variant", jcfg.XLA_VARIANTS)
def test_from_jax_maps_the_xla_sentinel(variant):
    cfg = KernelConfig.from_jax(dataclasses.asdict(jcfg.KernelConfig.xla(variant)))
    assert cfg.use_vendor and cfg.validate() is None
    assert cfg.vendor_variant in VENDOR_VARIANTS
    if variant.endswith("_tn"):
        assert cfg.vendor_variant.endswith("_tn")  # the layout carries over


def test_from_jax_keeps_a_staged_pipeline_invalid():
    """A staged config carries over with its depth; one the JAX package rejects (a depth
    outside its set, or 'mask' edges with a depth) stays rejected here."""
    d = dataclasses.asdict(jcfg.KernelConfig(bm=64, bn=128, bk=128, pipeline_depth=2))
    cfg = KernelConfig.from_jax(d)
    assert cfg.pipeline_depth == 2 and cfg.validate() is None
    for bad in (dict(d, pipeline_depth=5), dict(d, edge="mask")):
        assert jcfg.KernelConfig(**bad).validate() is not None
        assert "pipeline_depth" in KernelConfig.from_jax(bad).validate()


@pytest.mark.parametrize("kw,needle", [
    (dict(bm=0), "bm=0"),
    (dict(bn=-96), "bn=-96"),
    (dict(bk=100), "bk=100"),
    (dict(bk=0), "bk=0"),
    (dict(acc_dtype="float16"), "acc_dtype"),
    (dict(grid_order="km"), "grid_order"),
    (dict(rhs_layout="mk"), "rhs_layout"),
    (dict(edge="wrap"), "edge"),
    (dict(pipeline_depth=5), "pipeline_depth"),
])
def test_validate_rejects(kw, needle):
    err = KernelConfig(**kw).validate()
    assert err is not None and needle in err


def test_wide_block_at_gk_above_one_is_refused_at_its_launch():
    """A wide block (an edge above 128) validates without a shape, and at a K beyond its bk
    (more than one interval) it launches with the K carry on the wide route, equal to the
    plain version at its bk; so does bm = 16 beside it (the JAX space's sublane 16, the
    swapped walk).  What its launch still refuses, on every path, is a block beyond the
    wide route's largest edges (bn above 32768)."""
    from tpul2_torch import dispatch
    from tpul2_torch.ops import matmul as mm
    cfg = KernelConfig(bm=128, bn=256, bk=64, acc_dtype="bfloat16")
    assert cfg.validate() is None
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(128, 128, generator=gen).bfloat16()
    b = torch.randn(128, 256, generator=gen).bfloat16()
    assert mm.launch_route(cfg, a, b, 128, 256, 128) == "wgmma_wide"
    assert torch.equal(mm.cuda_matmul(a, b, cfg),
                       mm.matmul_reference(a, b, 64, "bfloat16"))
    short = KernelConfig(bm=16, bn=256, bk=64, acc_dtype="bfloat16")
    assert short.validate() is None
    for call in (lambda: mm.cuda_matmul(a[:16], b, short),
                 lambda: dispatch.matmul(a[:16], b, config=short)):
        assert torch.equal(call(), mm.matmul_reference(a[:16], b, 64, "bfloat16"))
    long = KernelConfig(bm=16, bn=32769, bk=64)
    for call in (lambda: mm.cuda_matmul(a[:16], b, long),
                 lambda: dispatch.matmul(a[:16], b, config=long)):
        with pytest.raises(ValueError, match="bn=32769"):
            call()


def test_validate_vendor_variants():
    for v in VENDOR_VARIANTS:
        assert KernelConfig.vendor(v).validate() is None
    assert "vendor_variant" in KernelConfig.vendor("cublas_xx").validate()


@pytest.mark.parametrize("bm", TILE_CHOICES)
@pytest.mark.parametrize("bn", TILE_CHOICES)
def test_smem_model(bm, bn):
    cfg = KernelConfig(bm=bm, bn=bn)
    # the carry ring: carry_stages stages of A (bm rows) and B (bn rows) of 64 bf16 each,
    # the 1024-byte alignment slack and two mbarriers a stage
    stages = carry_stages(bm, bn)
    assert cfg.smem_bytes() == 1024 + stages * (bm + bn) * 2 * KSTEP * 2 + 16 * stages
    assert cfg.smem_bytes() <= SMEM_LIMIT and cfg.validate() is None


@pytest.mark.parametrize("m,n,k", BRING_UP_SHAPES + [(1, 1, 1), (96, 160, 200),
                                                     (12288, 64, 64), (64, 64, 12288)])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_heuristic_is_a_valid_kernel_config(m, n, k, acc):
    cfg = heuristic_config(m, n, k, acc)
    assert not cfg.use_vendor
    assert cfg.validate() is None
    assert cfg.acc_dtype == acc
    # the grid fills the card, or the tiles are already the wgmma body's least
    assert (cdiv(m, cfg.bm) * cdiv(n, cfg.bn) >= NUM_SMS
            or max(cfg.bm, cfg.bn) <= WGMMA_TILES[0])
    # an edge goes below the wgmma tiles only where its own dimension does
    for edge, dim in ((cfg.bm, m), (cfg.bn, n)):
        assert edge in WGMMA_TILES or dim <= TILE_CHOICES[0]


def test_heuristic_puts_the_skinny_shape_on_a_64_row_tile():
    """64x8192x8192 (the skinny serving shape): the 64x64 wgmma tile, 128 CTAs, where the
    grid rule alone went down to the 32x64 mma.sync tile."""
    for acc in ("float32", "bfloat16"):
        cfg = heuristic_config(64, 8192, 8192, acc)
        assert (cfg.bm, cfg.bn, cfg.bk) == (64, 64, 1024)
        assert cdiv(64, cfg.bm) * cdiv(8192, cfg.bn) == 128


@pytest.mark.parametrize("k", [1, 31, 64, 100, 127, 128, 200, 300, 1000, 1024, 4096,
                               8192, 12288])
def test_heuristic_keeps_the_jax_rounding_points(k):
    """Same number of K intervals as the JAX heuristic, so the bf16 family rounds at the
    same points for an untuned shape."""
    ours = heuristic_config(256, 256, k)
    theirs = jcfg.heuristic_config(256, 256, k)
    assert cdiv(k, ours.bk) == cdiv(k, theirs.bk)
    if cdiv(k, ours.bk) > 1:
        assert ours.bk == theirs.bk
