"""Tests of the CUDA kernel itself; they need the card and skip elsewhere.

This file imports no jax, so it runs on a machine that has only torch:

    TPUL2_TEST_ON_TPU=1 python -m pytest tests/test_torch_gpu.py -m gpu -q

(the variable keeps tests/conftest.py from importing jax).  ``chip_smoke.py`` covers the
same ground at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from tpul2_torch.config import KernelConfig
from tpul2_torch.harness import correctness as corr
from tpul2_torch.ops import batched as bmm
from tpul2_torch.ops import matmul as mm
from tpul2_torch.ops import pipelined as pl
from tpul2_torch.ops._build import LaunchRefused, check_launch, load_library

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

pytestmark = pytest.mark.gpu

M, N, K = 100, 200, 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _01(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2, shape).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("bk", [128, 320])
def test_kernel_matches_plain(cuda, acc, layout, bk):
    cfg = KernelConfig(bm=64, bn=128, bk=bk, acc_dtype=acc, rhs_layout=layout)
    a = _01((M, K), 1).to(cuda)
    rhs = _01((N, K) if layout == "nk" else (K, N), 2).to(cuda)
    fn = mm.cuda_matmul_tn if layout == "nk" else mm.cuda_matmul
    assert mm.multi_k_route(cfg, a, rhs, M, N, K) == "mma_sync"  # K % 8 != 0 or gk == 1
    before = mm.LAUNCHES_MULTI_K_MMA_SYNC + mm.LAUNCHES_SINGLE_K
    got = fn(a, rhs, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mm.LAUNCHES_MULTI_K_MMA_SYNC + mm.LAUNCHES_SINGLE_K == before + 1
    want = mm.matmul_reference(a, rhs, cfg.bk, acc, layout, out_dtype=torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_long_interval_stays_in_f32_tolerance(cuda, layout):
    """One K interval of 8192 (bk = K): the f32 sum must stay inside allowed_error on
    normal inputs, as the tuner's space offers such intervals."""
    m, n, k = 64, 512, 8192
    cfg = KernelConfig(bm=32, bn=64, bk=k, rhs_layout=layout)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    rhs = torch.randn((n, k) if layout == "nk" else (k, n), generator=gen,
                      device=cuda).bfloat16()
    fn = mm.cuda_matmul_tn if layout == "nk" else mm.cuda_matmul
    got = fn(a, rhs, cfg, out_dtype=torch.float32)
    want = mm.matmul_reference(a, rhs, k, "float32", layout, out_dtype=torch.float32)
    tol = mm.allowed_error(a, rhs, k, "float32", layout, torch.float32)
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("bk", [128, 320])
def test_batched_kernel_matches_plain(cuda, bk):
    cfg = KernelConfig(bm=64, bn=64, bk=bk, acc_dtype="bfloat16")
    a, b = _01((3, M, K), 3).to(cuda), _01((3, K, N), 4).to(cuda)
    got = bmm.cuda_batched_matmul(a, b, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = bmm.batched_matmul_reference(a, b, cfg.bk, "bfloat16", torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_gate_on_card(cuda, acc):
    res = corr.run_correctness_check(M, N, K, acc=acc, iterations=2, device="cuda")
    assert res["pass"], res.get("failure")
    assert res["stats"]["guard_hits"] == 0 and res["variants"]["guard_hits"] == 0


def test_refused_launch_raises(cuda):
    """A tile the kernel has no instance for: the C launcher returns an error code and the
    wrapper raises instead of computing anything else."""
    a, b = _01((64, 64), 5).to(cuda), _01((64, 64), 6).to(cuda)
    out = torch.empty((64, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        mm.launch_kernel(a, b, KernelConfig(bm=48), out, None, None, 1, 64, 64, 64)


WG_M, WG_N, WG_K = 200, 264, 328   # edges in M and N, a K tail of 8 (K % 64 != 0)


@pytest.mark.parametrize("tile", [(64, 64), (64, 128), (128, 64), (128, 128)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_wgmma_route_matches_plain(cuda, acc, layout, tile):
    """The wgmma body against the plain version: 0/1 inputs exact, normal inputs within
    allowed_error."""
    cfg = KernelConfig(bm=tile[0], bn=tile[1], bk=128, acc_dtype=acc, rhs_layout=layout)
    fn = mm.cuda_matmul_tn if layout == "nk" else mm.cuda_matmul
    gen = torch.Generator(device=cuda)
    gen.manual_seed(17)
    for zero_one in (True, False):
        shape_b = (WG_N, WG_K) if layout == "nk" else (WG_K, WG_N)
        if zero_one:
            a, rhs = _01((WG_M, WG_K), 18).to(cuda), _01(shape_b, 19).to(cuda)
        else:
            a = torch.randn((WG_M, WG_K), generator=gen, device=cuda).bfloat16()
            rhs = torch.randn(shape_b, generator=gen, device=cuda).bfloat16()
        assert mm.multi_k_route(cfg, a, rhs, WG_M, WG_N, WG_K) == "wgmma"
        before = mm.LAUNCHES_MULTI_K_WGMMA
        got = fn(a, rhs, cfg, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert mm.LAUNCHES_MULTI_K_WGMMA == before + 1
        want = mm.matmul_reference(a, rhs, cfg.bk, acc, layout, out_dtype=torch.float32)
        if zero_one:
            assert torch.equal(got, want)
        else:
            tol = mm.allowed_error(a, rhs, cfg.bk, acc, layout, torch.float32)
            assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("tile", [(64, 128), (128, 64)], ids=lambda t: f"{t[0]}x{t[1]}")
def test_wgmma_batched_m_edge(cuda, tile):
    """M % BM != 0 inside a batch: the rank-3 tensor maps fill rows past M with zeros,
    not with the next batch element's rows, and stores stay inside each element."""
    cfg = KernelConfig(bm=tile[0], bn=tile[1], bk=128, acc_dtype="bfloat16")
    a, b = _01((3, 100, WG_K), 20).to(cuda), _01((3, WG_K, 136), 21).to(cuda)
    before = bmm.LAUNCHES_MULTI_K_WGMMA
    got = bmm.cuda_batched_matmul(a, b, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert bmm.LAUNCHES_MULTI_K_WGMMA == before + 1
    assert torch.equal(got, bmm.batched_matmul_reference(a, b, cfg.bk, "bfloat16",
                                                         torch.float32))


@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_wgmma_long_interval_stays_in_f32_tolerance(cuda, layout):
    """Two K intervals of 4096: the wgmma body's f32 sum stays inside allowed_error."""
    m, n, k = 128, 512, 8192
    cfg = KernelConfig(bm=64, bn=128, bk=4096, rhs_layout=layout)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(12)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    rhs = torch.randn((n, k) if layout == "nk" else (k, n), generator=gen,
                      device=cuda).bfloat16()
    assert mm.multi_k_route(cfg, a, rhs, m, n, k) == "wgmma"
    fn = mm.cuda_matmul_tn if layout == "nk" else mm.cuda_matmul
    got = fn(a, rhs, cfg, out_dtype=torch.float32)
    want = mm.matmul_reference(a, rhs, cfg.bk, "float32", layout, out_dtype=torch.float32)
    tol = mm.allowed_error(a, rhs, cfg.bk, "float32", layout, torch.float32)
    assert bool(((got - want).abs() <= tol).all())


def test_wgmma_refused_launch_raises(cuda):
    """A launch outside the wgmma route (K % 8 != 0) is refused by the C launcher before
    any work, and check_launch raises LaunchRefused; the route sends it to mma.sync."""
    lib = load_library()
    m, n, k = 64, 64, 1001
    cfg = KernelConfig(bm=64, bn=64, bk=128)
    a, b = _01((m, k), 22).to(cuda), _01((k, n), 23).to(cuda)
    out = torch.empty((m, n), dtype=torch.float32, device=cuda)
    assert mm.multi_k_route(cfg, a, b, m, n, k) == "mma_sync"
    assert lib.tl2_wgmma_route(m, n, k, 64, 64, 128, 0, a.data_ptr(), b.data_ptr()) == 0
    err = lib.tl2_wgmma_f32out(*mm.launch_args(a, b, cfg, out, None, None, 1, m, n, k))
    with pytest.raises(LaunchRefused, match="launch failed"):
        check_launch(err, "tl2_wgmma")


def test_wgmma_smem_model_matches_the_kernel(cuda):
    lib = load_library()
    for bm in mm.WGMMA_TILES:
        for bn in mm.WGMMA_TILES:
            assert lib.tl2_wgmma_smem_bytes(bm, bn) == mm.wgmma_smem_bytes(bm, bn)


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("depth", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("tile", [(32, 64), (64, 128), (128, 128)])
def test_staged_kernel_matches_plain(cuda, layout, depth, tile):
    m, n, k = 256, 512, 2048
    cfg = KernelConfig(bm=tile[0], bn=tile[1], bk=256, acc_dtype="bfloat16",
                       rhs_layout=layout, pipeline_depth=depth,
                       grid_order="nm" if depth % 2 else "mn")
    a = _01((m, k), 9).to(cuda)
    rhs = _01((n, k) if layout == "nk" else (k, n), 10).to(cuda)
    before = pl.LAUNCHES_STAGED
    got = pl.cuda_matmul_pipelined(a, rhs, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert pl.LAUNCHES_STAGED == before + 1
    assert torch.equal(got, pl.pipelined_reference(a, rhs, layout, torch.float32))


def test_staged_smem_model_matches_the_kernel(cuda):
    lib = load_library()
    for bm in (32, 64, 128):
        for bn in (32, 64, 128):
            for depth in (2, 3, 4, 6, 8):
                cfg = KernelConfig(bm=bm, bn=bn, pipeline_depth=depth)
                assert lib.tl2_staged_smem_bytes(bm, bn, depth) == cfg.smem_bytes()


def test_staged_single_k_takes_the_single_k_kernel(cuda):
    cfg = KernelConfig(bm=64, bn=64, bk=512, pipeline_depth=4)
    a, b = _01((128, 512), 11).to(cuda), _01((512, 128), 12).to(cuda)
    staged, single = pl.LAUNCHES_STAGED, mm.LAUNCHES_SINGLE_K
    got = pl.cuda_matmul_pipelined(a, b, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert pl.LAUNCHES_STAGED == staged and mm.LAUNCHES_SINGLE_K == single + 1
    assert torch.equal(got, pl.pipelined_reference(a, b, "kn", torch.float32))


def test_staged_refused_launch_raises(cuda):
    """A tile the staged kernel has no instance for: the launcher refuses before any work
    and the wrapper raises; a misaligned operand raises before the launch."""
    a, b = _01((96, 256), 13).to(cuda), _01((256, 96), 14).to(cuda)
    out = torch.empty((96, 96), dtype=torch.float32, device=cuda)
    with pytest.raises(LaunchRefused, match="launch failed"):
        pl.launch_staged(a, b, KernelConfig(bm=48, bn=48, pipeline_depth=2), out, 2,
                         96, 96, 256)
    buf = _01((64 * 256 + 8,), 15).to(cuda)
    a_off = buf[8:].view(64, 256)  # 16-byte rows, but a base 16 bytes past the allocation
    a_odd = buf[1:1 + 64 * 256].view(64, 256)  # base 2 bytes off: no 16-byte copies
    cfg = KernelConfig(bm=64, bn=64, bk=64, pipeline_depth=2)
    got = pl.cuda_matmul_pipelined(a_off, _01((256, 64), 16).to(cuda), cfg)
    torch.cuda.synchronize()
    assert got.shape == (64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        pl.cuda_matmul_pipelined(a_odd, _01((256, 64), 16).to(cuda), cfg)


def test_tuner_on_card(cuda, tmp_path):
    from tpul2_torch.autotune import TuneDB, tune_shape
    db = TuneDB(path=tmp_path / "db.json")
    res = tune_shape(64, 1024, 4096, db=db, max_candidates=4, stage1_rounds=2,
                     stage2_rounds=2, finalists=2, save=True)
    assert res.n_launched == res.n_candidates
    assert any(d["config"]["pipeline_depth"] >= 2 for d in res.medians_ms)
    assert db.get(64, 1024, 4096) == res.best and res.device != "cpu"


def test_cpu_and_cuda_tensors_do_not_mix(cuda):
    a = _01((64, 64), 7).to(cuda)
    with pytest.raises(ValueError, match="one device"):
        mm.cuda_matmul(a, _01((64, 64), 8), KernelConfig(bm=32, bn=32, bk=64))
