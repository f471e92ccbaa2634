"""tpul2_torch.ops.pipelined (the staged kernel's wrapper) against tpul2.ops.pipelined.

The JAX side runs in Pallas interpret mode, as tests/test_pipelined.py runs it.  Inputs
are made once with numpy from a seed, rounded to bf16, and handed to both packages.
Configs are shared through ``KernelConfig.from_jax``.  On the CPU the wrapper runs the
plain version with the split count its launch would take, so a ring tile over few output
tiles compares a split-K sum with the JAX kernel's one sum.  Tolerances, each with its
reason:
  0/1 inputs   exact equality: every sum (and every split's partial) is an integer below
               2^24;
  normal       1e-5·|C| + 1e-5·√K: both sides sum in f32 over all of K, in another order
               (split partials added in split order are one more order);
               + 2^-7·|C| with bf16 output: the final cast can round the two f32 values
               to neighbouring bf16 values (ops.matmul.allowed_error with bk = K).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2.config as jcfg
from tpul2.dispatch import matmul as jax_matmul
from tpul2.ops.pipelined import pallas_matmul_pipelined
from tpul2_torch import dispatch
from tpul2_torch.config import (NUM_SMS, SMEM_LIMIT, TILE_CHOICES, WGMMA_KSTAGE, KernelConfig,
                                wgmma_smem_bytes)
from tpul2_torch.ops import launch_counts
from tpul2_torch.ops import matmul as mm
from tpul2_torch.ops import pipelined as pl

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

M, N, K = 128, 256, 512
BLOCKS = dict(bm=64, bn=128, bk=128)


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _inputs(seed, m, n, k, zero_one):
    rng = np.random.default_rng(seed)
    if zero_one:
        return (rng.integers(0, 2, (m, k)).astype(np.float32),
                rng.integers(0, 2, (k, n)).astype(np.float32))
    return (_bf16_exact(rng.standard_normal((m, k))),
            _bf16_exact(rng.standard_normal((k, n))))


def _rhs(b_np, layout):
    return np.ascontiguousarray(b_np.T) if layout == "nk" else b_np


def _configs(depth, layout, acc, **kw):
    jax_cfg = jcfg.KernelConfig(**{**BLOCKS, **kw}, pipeline_depth=depth, rhs_layout=layout,
                                acc_dtype=acc)
    return jax_cfg, KernelConfig.from_jax(dataclasses.asdict(jax_cfg))


@functools.lru_cache(maxsize=None)
def _jax_fn(jax_cfg, out_name):
    """The JAX staged matmul for one config, traced once (interpret mode) and reused for
    every input of the same shape: tracing dominates its time on the CPU."""
    return jax.jit(functools.partial(pallas_matmul_pipelined, config=jax_cfg,
                                     out_dtype=getattr(jnp, out_name)))


def _jax(a_np, rhs_np, jax_cfg, out_name):
    out = _jax_fn(jax_cfg, out_name)(jnp.asarray(a_np, jnp.bfloat16),
                                     jnp.asarray(rhs_np, jnp.bfloat16))
    return torch.from_numpy(np.array(out, np.float32))


def _ours(a_np, rhs_np, cfg, out_name):
    return pl.cuda_matmul_pipelined(torch.from_numpy(a_np).bfloat16(),
                                    torch.from_numpy(rhs_np).bfloat16(), cfg,
                                    out_dtype=getattr(torch, out_name))


def _staged_tol(a_np, rhs_np, layout, out_name):
    return mm.allowed_error(torch.from_numpy(a_np), torch.from_numpy(rhs_np), a_np.shape[1],
                            "float32", layout, getattr(torch, out_name))


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("depth", [2, 3, 4])
def test_staged_matches_jax(depth, layout, acc):
    # each family sees both output types across the depths and layouts
    out_name = "float32" if (depth + (layout == "nk")) % 2 == 0 else "bfloat16"
    jax_cfg, cfg = _configs(depth, layout, acc)
    for seed, zero_one in ((depth, True), (10 + depth, False)):
        a_np, b_np = _inputs(seed, M, N, K, zero_one)
        rhs_np = _rhs(b_np, layout)
        ours = _ours(a_np, rhs_np, cfg, out_name)
        assert ours.dtype == getattr(torch, out_name) and ours.shape == (M, N)
        # the JAX staged kernel never reads acc_dtype (it sums in f32 over all of K), so
        # both families share one trace; test_bf16_family_sums_in_f32_unlike_the_carry_kernel
        # runs it with a bf16-family config
        theirs = _jax(a_np, rhs_np, dataclasses.replace(jax_cfg, acc_dtype="float32"),
                      out_name)
        if zero_one:
            assert torch.equal(ours.float(), theirs)
        else:
            tol = _staged_tol(a_np, rhs_np, layout, out_name)
            assert bool(((ours.float() - theirs).abs() <= tol).all())


def test_plain_version_is_one_f32_product():
    a_np, b_np = _inputs(3, M, N, K, False)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    want = (a.float() @ b.float()).to(torch.bfloat16)
    assert torch.equal(pl.pipelined_reference(a, b), want)
    # the 'nk' layout reads the same operand through a transposed view; the CPU's f32
    # GEMM may then sum in another order
    nk = pl.pipelined_reference(a, b.t().contiguous(), "nk")
    assert bool(((nk.float() - want.float()).abs()
                 <= _staged_tol(a_np, b_np, "kn", "bfloat16")).all())


def test_bf16_family_sums_in_f32_unlike_the_carry_kernel():
    """A staged bf16-family config sums in f32 over all of K (as the JAX staged kernel
    does); the single-stage kernel rounds its carry to bf16 after every bk interval."""
    jax_cfg, cfg = _configs(2, "kn", "bfloat16")
    a_np, b_np = _inputs(4, M, N, K, False)
    staged = _ours(a_np, b_np, cfg, "float32")
    theirs = _jax(a_np, b_np, jax_cfg, "float32")
    tol = _staged_tol(a_np, b_np, "kn", "float32")
    assert bool(((staged - theirs).abs() <= tol).all())
    carry = mm.cuda_matmul(torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16(),
                           dataclasses.replace(cfg, pipeline_depth=0), out_dtype=torch.float32)
    assert bool(((carry - staged).abs() > tol).any())
    # and the carry kernel is the JAX package's standard kernel at the same bk
    jax_carry = jax_matmul(jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16),
                           acc="bfloat16", out_dtype=jnp.float32,
                           config=dataclasses.replace(jax_cfg, pipeline_depth=0))
    carry_tol = mm.allowed_error(torch.from_numpy(a_np), torch.from_numpy(b_np), cfg.bk,
                                 "bfloat16", "kn", torch.float32)
    assert bool(((carry - torch.from_numpy(np.array(jax_carry))).abs() <= carry_tol).all())


@pytest.mark.parametrize("depth,gk,want", [(2, 8, 2), (4, 8, 4), (8, 3, 3), (6, 2, 2),
                                           (4, 1, 1), (2, 1, 1)])
def test_staged_depth_clamps_to_gk(depth, gk, want):
    assert pl.staged_depth(depth, gk) == want


def test_depth_exceeds_gk_matches_jax():
    m, n, k = 128, 128, 384  # gk = 3 < depth 8 (64 x 128: 128 x 128 at depth 8 is too large)
    jax_cfg, cfg = _configs(8, "kn", "float32", bm=64, bn=128)
    a_np, b_np = _inputs(5, m, n, k, True)
    assert torch.equal(_ours(a_np, b_np, cfg, "float32"), _jax(a_np, b_np, jax_cfg, "float32"))


@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_single_k_goes_to_the_single_k_kernel(layout, monkeypatch):
    m, n, k = 128, 128, 512
    jax_cfg, cfg = _configs(4, layout, "bfloat16", bm=128, bn=128, bk=512)
    calls = []
    name = "cuda_matmul_tn" if layout == "nk" else "cuda_matmul"
    real = getattr(pl, name)

    def spy(a, rhs, config, **kw):
        calls.append(config)
        return real(a, rhs, config, **kw)

    monkeypatch.setattr(pl, name, spy)
    a_np, b_np = _inputs(6, m, n, k, False)
    rhs_np = _rhs(b_np, layout)
    ours = _ours(a_np, rhs_np, cfg, "float32")
    assert len(calls) == 1 and calls[0].pipeline_depth == 0 and calls[0].bk == k
    # one interval: no rounding of the carry, so the bf16 family sums in f32 like JAX's
    theirs = _jax(a_np, rhs_np, jax_cfg, "float32")
    assert bool(((ours - theirs).abs() <= _staged_tol(a_np, rhs_np, layout, "float32")).all())


def test_rejects_nondivisible_on_both_sides():
    jax_cfg, cfg = _configs(2, "kn", "float32")
    a_np, b_np = _inputs(7, 100, 128, 512, True)
    with pytest.raises(ValueError, match="divisible"):
        _jax(a_np, b_np, jax_cfg, "float32")
    with pytest.raises(ValueError, match="divisible"):
        _ours(a_np, b_np, cfg, "float32")


def test_rejects_depth_below_two():
    a_np, b_np = _inputs(8, 64, 128, 256, True)
    with pytest.raises(ValueError, match="pipeline_depth >= 2"):
        _ours(a_np, b_np, KernelConfig(**BLOCKS), "float32")


def test_out_receives_the_result():
    _, cfg = _configs(3, "nk", "float32")
    a_np, b_np = _inputs(9, M, N, K, True)
    a, bt = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(_rhs(b_np, "nk")).bfloat16()
    out = torch.empty((M, N), dtype=torch.float32)
    assert pl.cuda_matmul_pipelined(a, bt, cfg, out=out) is out
    assert torch.equal(out, torch.from_numpy(a_np @ b_np))


def _spy_staged(monkeypatch):
    calls = []
    real = dispatch.cuda_matmul_pipelined

    def spy(*args, **kw):
        calls.append(args[2])
        return real(*args, **kw)

    monkeypatch.setattr(dispatch, "cuda_matmul_pipelined", spy)
    return calls


def test_dispatch_routes_pipeline_depth(monkeypatch):
    """Parity with tests/test_pipelined.py::test_dispatch_routes_pipeline_depth."""
    calls = _spy_staged(monkeypatch)
    jax_cfg, cfg = _configs(2, "kn", "float32", bm=128, bn=128)
    a_np, b_np = _inputs(0, 256, 256, 512, True)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    ours = dispatch.matmul(a, b, config=cfg, out_dtype=torch.float32)
    theirs = jax_matmul(jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16),
                        config=jax_cfg, out_dtype=jnp.float32)
    assert torch.equal(ours, torch.from_numpy(np.array(theirs)))
    assert len(calls) == 1
    # non-divisible dims: dispatch takes the standard kernel instead of raising
    a2_np, b2_np = _inputs(1, 100, 256, 512, True)
    a2, b2 = torch.from_numpy(a2_np).bfloat16(), torch.from_numpy(b2_np).bfloat16()
    ours2 = dispatch.matmul(a2, b2, config=cfg, out_dtype=torch.float32)
    theirs2 = jax_matmul(jnp.asarray(a2_np, jnp.bfloat16), jnp.asarray(b2_np, jnp.bfloat16),
                         config=jax_cfg, out_dtype=jnp.float32)
    assert torch.equal(ours2, torch.from_numpy(np.array(theirs2)))
    assert len(calls) == 1


@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_dispatch_with_bias_ignores_depth(layout, monkeypatch):
    """The fused epilogue has no staged form: depth is ignored, on both sides."""
    calls = _spy_staged(monkeypatch)
    jax_cfg, cfg = _configs(4, layout, "bfloat16", bm=128, bn=128)
    a_np, b_np = _inputs(2, 256, 256, 512, True)
    bias_np = np.linspace(-3, 3, 256).astype(np.float32)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    ours = dispatch.matmul(a, b, acc="bfloat16", config=cfg, bias=torch.from_numpy(bias_np),
                           activation="relu", out_dtype=torch.float32)
    theirs = jax_matmul(jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16),
                        acc="bfloat16", config=jax_cfg, bias=jnp.asarray(bias_np),
                        activation="relu", out_dtype=jnp.float32)
    assert torch.equal(ours, torch.from_numpy(np.array(theirs)))
    assert calls == []


def test_batched_dispatch_ignores_depth():
    _, cfg = _configs(2, "kn", "float32", bm=64, bn=64)
    rng = np.random.default_rng(3)
    a_np = rng.integers(0, 2, (2, 64, 512)).astype(np.float32)
    b_np = rng.integers(0, 2, (2, 512, 128)).astype(np.float32)
    out = dispatch.batched_matmul(torch.from_numpy(a_np).bfloat16(),
                                  torch.from_numpy(b_np).bfloat16(), config=cfg,
                                  out_dtype=torch.float32)
    assert torch.equal(out, torch.from_numpy(np.matmul(a_np, b_np)))


@pytest.mark.parametrize("bm", TILE_CHOICES)
@pytest.mark.parametrize("bn", TILE_CHOICES)
def test_smem_grows_with_depth(bm, bn):
    """Every tile's staged launch takes the ring: 1024 + depth·(bm + bn)·128 + 16·depth
    bytes, growing with the depth; depth 0 is the carry ring (``carry_stages`` stages);
    validate refuses what exceeds 227 KB."""
    base = KernelConfig(bm=bm, bn=bn)
    sizes = [dataclasses.replace(base, pipeline_depth=d).smem_bytes() for d in (2, 3, 4, 6, 8)]
    assert base.smem_bytes() == wgmma_smem_bytes(bm, bn) and sizes == sorted(sizes)
    for d, size in zip((2, 3, 4, 6, 8), sizes):
        assert size == 1024 + d * (bm + bn) * 128 + 16 * d == wgmma_smem_bytes(bm, bn, d)
        err = dataclasses.replace(base, pipeline_depth=d).validate()
        assert (err is None) == (size <= SMEM_LIMIT)
    # only 128 x 128 at depth 8 (263,296 bytes) does not fit
    assert (sizes[-1] > SMEM_LIMIT) == ((bm, bn) == (128, 128))


def test_validate_refuses_a_ring_beyond_227kb():
    err = KernelConfig(bm=128, bn=128, pipeline_depth=8).validate()
    assert err is not None and "shared memory 263296" in err
    assert KernelConfig(bm=128, bn=128, pipeline_depth=6).validate() is None
    assert KernelConfig(bm=64, bn=128, pipeline_depth=8).validate() is None
    # the carry launches keep the 4-stage ring: depth 0 is tl2_matmul.cu's model
    assert KernelConfig(bm=128, bn=128).validate() is None


# ---- the staged route and split K ----

def _bf16(shape, offset=0):
    """A bf16 tensor of ``shape`` whose base lies ``offset`` elements into its buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("bm", TILE_CHOICES)
@pytest.mark.parametrize("bn", TILE_CHOICES)
def test_staged_route_rule(bm, bn, layout):
    """Every tile takes the ring: filled by TMA where it can read both operands, by the
    loads producer where a base is off 16 bytes or a row TMA cannot step (K % 8 != 0);
    bk and the depth play no part."""
    m, n, k = 128, 256, 1024
    rhs_shape = (n, k) if layout == "nk" else (k, n)
    for bk, depth in ((128, 2), (256, 4), (512, 8)):
        cfg = KernelConfig(bm=bm, bn=bn, bk=bk, rhs_layout=layout, pipeline_depth=depth)
        assert pl.staged_route(cfg, _bf16((m, k)), _bf16(rhs_shape), m, n, k) == "ring"
        assert pl.staged_route(cfg, _bf16((m, k), 1), _bf16(rhs_shape), m, n, k) == "ring_lsu"
        assert pl.staged_route(cfg, _bf16((m, k)), _bf16(rhs_shape, 4), m, n, k) == "ring_lsu"
        assert pl.staged_route(cfg, _bf16((m, 1020)), _bf16(rhs_shape), m, n,
                               1020) == "ring_lsu"


@pytest.mark.parametrize("m,n,k,want", [(64, 64, 12288, 48), (64, 64, 4096, 16),
                                        (128, 64, 4096, 16), (64, 256, 8192, 32),
                                        (64, 4096, 4096, 2), (64, 8192, 8192, 1)])
def test_split_rule_at_the_few_cta_shapes(m, n, k, want):
    """max(1, min(NUM_SMS // tiles, cdiv(K, 64) // depth)) on the heuristic's 64 x 64 tile
    at depth 4: the few-CTA streaming shapes split, the skinny one's 128 tiles do not."""
    assert pl.staged_splits(m, n, k, 64, 64, 4) == want
    tiles = (m // 64) * (n // 64)
    assert want == max(1, min(NUM_SMS // tiles, -(-k // WGMMA_KSTAGE) // 4))


@pytest.mark.parametrize("k,splits", [(12288, 48), (4096, 16), (8192, 1), (2080, 11),
                                      (480, 4), (64, 1), (640, 5), (640, 3)])
def test_split_bounds_fall_on_stages(k, splits):
    bounds = pl.split_bounds(k, splits)
    assert len(bounds) == splits
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    for (k0, k1), (nxt, _) in zip(bounds, bounds[1:] + [(k, None)]):
        assert k0 % WGMMA_KSTAGE == 0 and k0 < k1 == nxt  # whole stages, none empty
    # equal runs of stages but the last, which ends at K (its tail zero-filled on the card)
    runs = {k1 - k0 for k0, k1 in bounds[:-1]}
    assert len(runs) <= 1 and all(r % WGMMA_KSTAGE == 0 for r in runs)


@pytest.mark.parametrize("k,splits", [(640, 6), (640, 7), (64, 2), (4096, 0)])
def test_split_bounds_refuse_an_empty_split(k, splits):
    with pytest.raises(ValueError, match="empty"):
        pl.split_bounds(k, splits)


def test_split_count_never_leaves_a_split_empty():
    for k in (64, 96, 640, 2080, 4160, 12288):
        for tiles_m in (1, 2, 3):
            for depth in (2, 3, 4, 6, 8):
                splits = pl.staged_splits(64 * tiles_m, 64, k, 64, 64, depth)
                assert len(pl.split_bounds(k, splits)) == splits >= 1


#: (m, n, k, port config, JAX config, the split rule's count): ring tiles over one or two
#: output tiles; the K-tail case (K % 64 = 32) uses bk = 160 on the port's side, which the
#: JAX package refuses (bk % 128), so its side runs its own legal config, bk = K.
SPLIT_CASES = {
    "64x64x512": (64, 64, 512, dict(bm=64, bn=64, bk=128, pipeline_depth=2),
                  dict(bm=64, bn=64, bk=128, pipeline_depth=2), 4),
    "64x128x1024": (64, 128, 1024, dict(bm=64, bn=128, bk=256, pipeline_depth=4),
                    dict(bm=64, bn=128, bk=256, pipeline_depth=4), 4),
    "128x64x480-ktail": (128, 64, 480, dict(bm=64, bn=64, bk=160, pipeline_depth=2),
                         dict(bm=128, bn=64, bk=480, pipeline_depth=2), 4),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_split_plain_version_matches_jax(case, layout, acc):
    """The plain split-K version with one split and with the rule's count, and the CPU
    wrapper (which takes the rule's count), against pallas_matmul_pipelined in interpret
    mode: exact on 0/1 inputs, within allowed_error(..., bk=K, 'float32') on normal ones."""
    m, n, k, ours_kw, jax_kw, splits = SPLIT_CASES[case]
    out_name = "float32" if layout == "kn" else "bfloat16"
    cfg = KernelConfig(**ours_kw, acc_dtype=acc, rhs_layout=layout)
    jax_cfg = jcfg.KernelConfig(**jax_kw, rhs_layout=layout)  # JAX's staged sum ignores acc
    depth = pl.staged_depth(cfg.pipeline_depth, k // cfg.bk)
    assert pl.staged_splits(m, n, k, cfg.bm, cfg.bn, depth) == splits > 1
    for seed, zero_one in ((20, True), (21, False)):
        a_np, b_np = _inputs(seed, m, n, k, zero_one)
        rhs_np = _rhs(b_np, layout)
        theirs = _jax(a_np, rhs_np, jax_cfg, out_name)
        a, rhs = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(rhs_np).bfloat16()
        tol = _staged_tol(a_np, rhs_np, layout, out_name)
        for ours in (pl.pipelined_reference(a, rhs, layout, getattr(torch, out_name), 1),
                     pl.pipelined_reference(a, rhs, layout, getattr(torch, out_name), splits),
                     _ours(a_np, rhs_np, cfg, out_name)):
            assert ours.shape == (m, n) and ours.dtype == getattr(torch, out_name)
            if zero_one:
                assert torch.equal(ours.float(), theirs)
            else:
                assert bool(((ours.float() - theirs).abs() <= tol).all())


def test_plain_split_sum_adds_partials_in_split_order():
    a_np, b_np = _inputs(22, 64, 64, 2080, False)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    want = None
    for k0, k1 in pl.split_bounds(2080, 11):
        part = a[:, k0:k1].float() @ b[k0:k1].float()
        want = part if want is None else want + part
    assert torch.equal(pl.pipelined_reference(a, b, "kn", torch.float32, 11), want)


@pytest.mark.parametrize("tile,splits", [((64, 64), 4), ((128, 64), 4), ((32, 64), 4)])
def test_cpu_path_takes_the_launch_split_count(tile, splits, monkeypatch):
    """The CPU wrapper runs the plain version with the split count its launch would take,
    the rule's on every tile (a 32-edge one included); no kernel counter moves."""
    seen = []
    real = pl.pipelined_reference
    monkeypatch.setattr(pl, "pipelined_reference",
                        lambda *args: seen.append(args[-1]) or real(*args))
    cfg = KernelConfig(bm=tile[0], bn=tile[1], bk=128, pipeline_depth=2)
    a_np, b_np = _inputs(23, 128, 64, 512, True)
    before = launch_counts()
    got = _ours(a_np, b_np, cfg, "float32")
    assert seen == [splits]
    assert torch.equal(got, torch.from_numpy(a_np @ b_np))
    assert launch_counts() == before


@pytest.mark.parametrize("depth", [1, 5, 7, 9, -2])
def test_validate_rejects_unknown_depths_like_jax(depth):
    d = dataclasses.asdict(jcfg.KernelConfig(**BLOCKS, pipeline_depth=depth))
    assert jcfg.KernelConfig(**d).validate() is not None
    err = KernelConfig.from_jax(d).validate()
    assert err is not None and "pipeline_depth" in err


@pytest.mark.parametrize("depth", [2, 3, 4, 6, 8])
def test_validate_rejects_mask_with_depth_like_jax(depth):
    jax_cfg = jcfg.KernelConfig(**BLOCKS, pipeline_depth=depth, edge="mask")
    assert jax_cfg.validate() is not None
    err = KernelConfig.from_jax(dataclasses.asdict(jax_cfg)).validate()
    assert err is not None and "edge='pad'" in err
