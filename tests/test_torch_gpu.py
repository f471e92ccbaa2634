"""Tests of the CUDA kernel itself; they need the card and skip elsewhere.

This file imports no jax, so it runs on a machine that has only torch:

    TPUL2_TEST_ON_TPU=1 python -m pytest tests/test_torch_gpu.py -m gpu -q

(the variable keeps tests/conftest.py from importing jax).  ``chip_smoke.py`` covers the
same ground at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from tpul2_torch.autotune import db as db_mod
from tpul2_torch.config import KernelConfig
from tpul2_torch.harness import correctness as corr
from tpul2_torch.ops import batched as bmm
from tpul2_torch.ops import matmul as mm
from tpul2_torch.ops import pipelined as pl
from tpul2_torch.ops._build import LaunchRefused, check_launch, load_library

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

pytestmark = pytest.mark.gpu

M, N, K = 100, 200, 300


@pytest.fixture(autouse=True)
def empty_tunedb(tmp_path, monkeypatch):
    """These tests hold the heuristic: TPUL2_TORCH_TUNEDB names a file that is not there,
    so no DB, the committed one included, steers their resolution."""
    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "empty_tunedb.json"))
    db_mod.reset_default_db()
    yield
    db_mod.reset_default_db()


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
    assert mm.launch_route(cfg, a, rhs, M, N, K) == "wgmma_lsu"  # K % 8 != 0
    before = mm.LAUNCHES_MULTI_K_WGMMA_LSU + mm.LAUNCHES_SINGLE_K_WGMMA_LSU
    got = fn(a, rhs, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mm.LAUNCHES_MULTI_K_WGMMA_LSU + mm.LAUNCHES_SINGLE_K_WGMMA_LSU == before + 1
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
    """A block the kernel has no instance for (an edge of 0; every edge of 1..128 is a ring
    block since the JAX space's narrow edges run): the C launcher returns an error code and
    the wrapper raises instead of computing anything else."""
    a, b = _01((64, 64), 5).to(cuda), _01((64, 64), 6).to(cuda)
    out = torch.empty((64, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        mm.launch_kernel(a, b, KernelConfig(bm=0), out, None, None, 1, 64, 64, 64)


WG_M, WG_N, WG_K = 200, 264, 328   # edges in M and N, a K tail of 8 (K % 64 != 0)


@pytest.mark.parametrize("bk", [128, 352], ids=["carry", "one_interval"])
@pytest.mark.parametrize("tile", [(64, 64), (64, 128), (128, 64), (128, 128)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_wgmma_route_matches_plain(cuda, acc, layout, tile, bk):
    """The wgmma body against the plain version, with a K carry and with one interval
    (bk 352 >= K, not a multiple of 64): 0/1 inputs exact, normal inputs within
    allowed_error."""
    cfg = KernelConfig(bm=tile[0], bn=tile[1], bk=bk, acc_dtype=acc, rhs_layout=layout)
    counter = "LAUNCHES_MULTI_K_WGMMA" if bk < WG_K else "LAUNCHES_SINGLE_K_WGMMA"
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
        assert mm.launch_route(cfg, a, rhs, WG_M, WG_N, WG_K) == "wgmma"
        before = getattr(mm, counter)
        got = fn(a, rhs, cfg, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert getattr(mm, counter) == before + 1
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
    assert mm.launch_route(cfg, a, rhs, m, n, k) == "wgmma"
    fn = mm.cuda_matmul_tn if layout == "nk" else mm.cuda_matmul
    got = fn(a, rhs, cfg, out_dtype=torch.float32)
    want = mm.matmul_reference(a, rhs, cfg.bk, "float32", layout, out_dtype=torch.float32)
    tol = mm.allowed_error(a, rhs, cfg.bk, "float32", layout, torch.float32)
    assert bool(((got - want).abs() <= tol).all())


def test_wgmma_refused_launch_raises(cuda):
    """A launch outside the ring's route (bk 48, not a multiple of 32, which validate also
    refuses) is refused by the C launcher before any work, and check_launch raises
    LaunchRefused; K % 8 != 0 is on the route, with the loads producer (and C stored by
    TMA: the route code's ROUTE_TMA_STORE bit)."""
    lib = load_library()
    m, n, k = 64, 64, 1001
    cfg = KernelConfig(bm=64, bn=64, bk=48)
    assert cfg.validate() is not None
    a, b = _01((m, k), 22).to(cuda), _01((k, n), 23).to(cuda)
    out = torch.empty((m, n), dtype=torch.float32, device=cuda)
    assert lib.tl2_wgmma_route(m, n, k, 64, 64, 128, 0, a.data_ptr(), b.data_ptr(),
                               None) == 2 | mm.ROUTE_TMA_STORE
    assert lib.tl2_wgmma_route(m, n, k, 64, 64, 48, 0, a.data_ptr(), b.data_ptr(), None) == 0
    err = lib.tl2_wgmma_f32out(*mm.launch_args(a, b, cfg, out, None, None, 1, m, n, k))
    with pytest.raises(LaunchRefused, match="launch failed"):
        check_launch(err, "tl2_wgmma")


def test_bf16_family_single_interval_is_the_f32_sum(cuda):
    """A bf16-family launch with one K interval and f32 output runs the f32-carry
    instance: its result is the f32 sum, within the f32 tolerance, and not that sum's
    bf16 rounding (which the 0/1 gate cannot tell apart)."""
    m, n, k = 1000, 1000, 1000
    cfg = KernelConfig(bm=64, bn=64, bk=1024, acc_dtype="bfloat16")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(13)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    b = torch.randn((k, n), generator=gen, device=cuda).bfloat16()
    assert mm.launch_route(cfg, a, b, m, n, k) == "wgmma"
    before = mm.LAUNCHES_SINGLE_K_WGMMA
    got = mm.cuda_matmul(a, b, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mm.LAUNCHES_SINGLE_K_WGMMA == before + 1
    tol = mm.allowed_error(a, b, k, "float32", "kn", torch.float32)
    f32_sum = a.float() @ b.float()
    assert bool(((got - f32_sum).abs() <= tol).all())
    assert bool(((f32_sum.bfloat16().float() - f32_sum).abs() > tol).any())
    assert not torch.equal(got, got.bfloat16().float())


def test_wgmma_smem_model_matches_the_kernel(cuda):
    lib = load_library()
    for bm in (32, 64, 128):
        for bn in (32, 64, 128):
            assert lib.tl2_wgmma_carry_stages(bm, bn) == mm.carry_stages(bm, bn)
            assert (lib.tl2_wgmma_smem_bytes(bm, bn, mm.carry_stages(bm, bn))
                    == mm.wgmma_smem_bytes(bm, bn))
            for stages in (2, 3, 6, 8):
                assert (lib.tl2_wgmma_smem_bytes(bm, bn, stages)
                        == mm.wgmma_smem_bytes(bm, bn, stages))


def _staged_counts() -> tuple:
    return pl.LAUNCHES_STAGED_RING, pl.LAUNCHES_STAGED_RING_LSU, pl.LAUNCHES_STAGED_SPLIT


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("depth", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("tile", [(32, 64), (64, 128), (128, 128)])
def test_staged_kernel_matches_plain(cuda, layout, depth, tile):
    """The staged ring on every tile (a swapped 32-edge one included) against its plain
    version with the same split count; 128 x 128 at depth 8 needs more than 227 KB,
    which validate refuses."""
    m, n, k = 256, 512, 2048
    cfg = KernelConfig(bm=tile[0], bn=tile[1], bk=256, acc_dtype="bfloat16",
                       rhs_layout=layout, pipeline_depth=depth,
                       grid_order="nm" if depth % 2 else "mn")
    a = _01((m, k), 9).to(cuda)
    rhs = _01((n, k) if layout == "nk" else (k, n), 10).to(cuda)
    if cfg.validate() is not None:
        assert (tile, depth) == ((128, 128), 8)
        with pytest.raises(ValueError, match="shared memory"):
            pl.cuda_matmul_pipelined(a, rhs, cfg, out_dtype=torch.float32)
        return
    assert pl.staged_route(cfg, a, rhs, m, n, k) == "ring"
    splits = pl.staged_splits(m, n, k, cfg.bm, cfg.bn, depth)
    ring, ring_lsu, split = _staged_counts()
    got = pl.cuda_matmul_pipelined(a, rhs, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _staged_counts() == (ring + 1, ring_lsu, split + (splits > 1))
    assert torch.equal(got, pl.pipelined_reference(a, rhs, layout, torch.float32, splits))


def test_staged_smem_model_matches_the_kernel(cuda):
    """Every tile's staged ring: tl2_wgmma.cu's count at each depth."""
    lib = load_library()
    for bm in (32, 64, 128):
        for bn in (32, 64, 128):
            for depth in (2, 3, 4, 6, 8):
                cfg = KernelConfig(bm=bm, bn=bn, pipeline_depth=depth)
                assert lib.tl2_wgmma_smem_bytes(bm, bn, depth) == cfg.smem_bytes()


def test_staged_route_matches_the_c_rule(cuda):
    """ops.pipelined.staged_route, with ops.matmul.launch_store's ROUTE_TMA_STORE bit for an
    aligned output, against tl2_staged_route over tiles, layouts, shapes and operand
    alignments (views 2, 8 and 16 bytes into one allocation)."""
    lib = load_library()
    buf = torch.zeros(64, dtype=torch.bfloat16, device=cuda)
    out = torch.zeros(8, dtype=torch.float32, device=cuda)
    for off_a in (0, 1, 8):
        for off_b in (0, 4):
            a, b = buf[off_a:], buf[off_b:]
            for m, n, k in ((64, 64, 12288), (64, 8192, 8192), (96, 160, 1004),
                            (128, 100, 2048)):
                for bm in (32, 64, 128):
                    for bn in (32, 64, 128):
                        for layout in ("kn", "nk"):
                            cfg = KernelConfig(bm=bm, bn=bn, rhs_layout=layout,
                                               pipeline_depth=2)
                            py = {"ring": 1, "ring_lsu": 2}[pl.staged_route(cfg, a, b, m, n, k)]
                            if mm.launch_store(cfg, m, n, out) == "tma":
                                py |= mm.ROUTE_TMA_STORE
                            assert py == lib.tl2_staged_route(
                                m, n, k, bm, bn, int(layout == "nk"), a.data_ptr(),
                                b.data_ptr(), out.data_ptr()), (m, n, k, cfg, off_a, off_b)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_split_launch_is_bit_identical(cuda, out_dtype):
    """A split-K launch on normal inputs, twice: the partials are added in split order by
    one thread per element, so the bits repeat; and it stays within the staged
    tolerance of its plain version."""
    m, n, k = 64, 64, 12288
    cfg = KernelConfig(bm=64, bn=64, bk=1024, pipeline_depth=4)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(17)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    b = torch.randn((k, n), generator=gen, device=cuda).bfloat16()
    splits = pl.staged_splits(m, n, k, 64, 64, 4)
    assert splits == 48
    split = pl.LAUNCHES_STAGED_SPLIT
    first = pl.cuda_matmul_pipelined(a, b, cfg, out_dtype=out_dtype)
    second = pl.cuda_matmul_pipelined(a, b, cfg, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert pl.LAUNCHES_STAGED_SPLIT == split + 2
    assert torch.equal(first, second)
    want = pl.pipelined_reference(a, b, "kn", out_dtype, splits)
    tol = mm.allowed_error(a, b, k, "float32", "kn", out_dtype)
    assert bool(((first.float() - want.float()).abs() <= tol).all())


def test_split_reduce_adds_in_split_order(cuda):
    """The reduction alone: the sum of the partials in split order, cast once."""
    lib = load_library()
    m, n, splits = 64, 128, 5
    gen = torch.Generator(device=cuda)
    gen.manual_seed(18)
    ws = torch.randn((splits, m, n), generator=gen, device=cuda)
    want = ws[0].clone()
    for s in range(1, splits):
        want = want + ws[s]
    for out_dtype in (torch.float32, torch.bfloat16):
        out = torch.empty((m, n), dtype=out_dtype, device=cuda)
        check_launch(lib.tl2_splitk_reduce(ws.data_ptr(), out.data_ptr(), m, n, splits,
                                           int(out_dtype == torch.float32),
                                           torch.cuda.current_stream().cuda_stream),
                     "tl2_splitk_reduce")
        torch.cuda.synchronize()
        assert torch.equal(out, want.to(out_dtype))


def test_staged_single_k_takes_the_single_k_kernel(cuda):
    """gk == 1 on a staged config: the single-K body, on the wgmma route (64x64 tile,
    aligned operands), not the staged ring."""
    cfg = KernelConfig(bm=64, bn=64, bk=512, pipeline_depth=4)
    a, b = _01((128, 512), 11).to(cuda), _01((512, 128), 12).to(cuda)
    staged, single = _staged_counts(), mm.LAUNCHES_SINGLE_K_WGMMA
    got = pl.cuda_matmul_pipelined(a, b, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _staged_counts() == staged and mm.LAUNCHES_SINGLE_K_WGMMA == single + 1
    assert torch.equal(got, pl.pipelined_reference(a, b, "kn", torch.float32))


def test_staged_refused_launch_raises(cuda):
    """A block the staged kernel has no instance for (an edge of 0; every edge of 1..128 is
    a ring block), a depth below 2, and a split count that leaves a split empty: the
    launcher refuses before any work and the wrapper raises.  A base 2 bytes off 16 takes
    the loads producer ('ring_lsu', the same sum); an out off 16 bytes raises before the
    launch."""
    a, b = _01((192, 256), 13).to(cuda), _01((256, 192), 14).to(cuda)
    out = torch.empty((192, 192), dtype=torch.float32, device=cuda)
    for tile, depth, splits in (((0, 48), 2, 1), ((64, 64), 1, 1), ((64, 64), 2, 3)):
        cfg = KernelConfig(bm=tile[0], bn=tile[1], pipeline_depth=2)
        with pytest.raises(LaunchRefused, match="launch failed"):
            pl.launch_staged(a, b, cfg, out, depth, 192, 192, 256, splits)
    buf = _01((64 * 256 + 8,), 15).to(cuda)
    a_off = buf[8:].view(64, 256)  # 16-byte rows, but a base 16 bytes past the allocation
    a_odd = buf[1:1 + 64 * 256].view(64, 256)  # base 2 bytes off: the loads producer
    rhs = _01((256, 64), 16).to(cuda)
    cfg = KernelConfig(bm=64, bn=64, bk=64, pipeline_depth=2)
    got = pl.cuda_matmul_pipelined(a_off, rhs, cfg, out_dtype=torch.float32)
    assert pl.staged_route(cfg, a_odd, rhs, 64, 64, 256) == "ring_lsu"
    lsu = pl.LAUNCHES_STAGED_RING_LSU
    odd = pl.cuda_matmul_pipelined(a_odd, rhs, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert pl.LAUNCHES_STAGED_RING_LSU == lsu + 1
    for x, got_x in ((a_off, got), (a_odd, odd)):
        assert torch.equal(got_x, pl.pipelined_reference(x, rhs, "kn", torch.float32,
                                                         pl.staged_splits(64, 64, 256, 64,
                                                                          64, 2)))
    bad_out = torch.empty(64 * 64 + 1, dtype=torch.float32, device=cuda)[1:].view(64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        pl.cuda_matmul_pipelined(a_off, rhs, cfg, out=bad_out)


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("tile", [(32, 32), (32, 64), (32, 128), (64, 32), (128, 32)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_narrow_tiles_match_plain(cuda, layout, tile):
    """The width-32 and swapped tiles at decode-size M and N edges, a bf16-family carry
    with a rounding point in the middle of a stage (bk 96): 0/1 inputs exact, normal inputs
    within allowed_error."""
    m, n, k = 17, 2 * tile[1] + 9, 328
    cfg = KernelConfig(bm=tile[0], bn=tile[1], bk=96, acc_dtype="bfloat16", rhs_layout=layout)
    fn = mm.cuda_matmul_tn if layout == "nk" else mm.cuda_matmul
    gen = torch.Generator(device=cuda)
    gen.manual_seed(24)
    counter = "LAUNCHES_WIDTH32" if tile[1] == 32 else "LAUNCHES_SWAPPED"
    for zero_one in (True, False):
        shape_b = (n, k) if layout == "nk" else (k, n)
        if zero_one:
            a, rhs = _01((m, k), 25).to(cuda), _01(shape_b, 26).to(cuda)
        else:
            a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
            rhs = torch.randn(shape_b, generator=gen, device=cuda).bfloat16()
        before, mid = getattr(mm, counter), mm.LAUNCHES_MIDSTAGE
        got = fn(a, rhs, cfg, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert getattr(mm, counter) == before + 1 and mm.LAUNCHES_MIDSTAGE == mid + 1
        want = mm.matmul_reference(a, rhs, cfg.bk, "bfloat16", layout, out_dtype=torch.float32)
        if zero_one:
            assert torch.equal(got, want)
        else:
            tol = mm.allowed_error(a, rhs, cfg.bk, "bfloat16", layout, torch.float32)
            assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("tile", [(128, 128), (32, 64), (64, 32)], ids=lambda t: f"{t[0]}x{t[1]}")
def test_loads_producer_gives_the_tma_bits(cuda, tile):
    """Aligned operands launched directly with the loads producer on A, on B and on both
    (vec_a / vec_b = 0): the same stages and wgmmas as the TMA producer, so the same bits."""
    lib = load_library()
    m, n, k = 96, 200, 520
    cfg = KernelConfig(bm=tile[0], bn=tile[1], bk=128, acc_dtype="bfloat16")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(27)
    a = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    b = torch.randn((k, n), generator=gen, device=cuda).bfloat16()
    outs = []
    for vec_a, vec_b in ((1, 1), (0, 1), (1, 0), (0, 0)):
        out = torch.empty((m, n), dtype=torch.float32, device=cuda)
        args = list(mm.launch_args(a, b, cfg, out, None, None, 1, m, n, k))
        args[18], args[19] = vec_a, vec_b
        check_launch(lib.tl2_wgmma_f32out(*args), "tl2_wgmma_f32out")
        outs.append(out)
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


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


@pytest.mark.parametrize("layout", ["nn", "tn"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_cublaslt_search_is_exact_on_01(cuda, layout, out_dtype):
    """Every algo the cuBLASLt search keeps, and its winner, against torch.mm on 0/1
    inputs (sums of up to 1024 ones: exact in f32, and at most 256 where bf16 rounds)."""
    from tpul2_torch.ops import lt_autotune
    m, n, k = 192, 320, 1024 if out_dtype == torch.float32 else 256
    a, b = _01((m, k), 31).to(cuda), _01((k, n), 32).to(cuda)
    rhs = b.t().contiguous() if layout == "tn" else b
    found = lt_autotune.search(m, n, k, layout, out_dtype)
    assert found.n_algos >= 1 and 0 <= found.best < found.n_algos
    assert len(found.medians_ms) == found.n_algos and min(found.medians_ms) > 0
    want = torch.mm(a.float(), b.float()).to(out_dtype)
    for algo in [-1] + list(range(found.n_algos)):
        got = lt_autotune.lt_matmul(a, rhs, layout, out_dtype, algo=algo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), algo


def test_graph_timer_agrees_with_a_graph_of_direct_calls(cuda):
    """The GraphTimer's per-call time at a host-bound shape against the device time of a
    CUDA graph of 20 calls (scripts/host_time_torch.py's alone_ms): within 25%, and not
    below the bound it is clamped at."""
    import importlib.util
    from pathlib import Path

    import numpy as np

    from tpul2_torch.harness import bench_utils as bu
    spec = importlib.util.spec_from_file_location(
        "host_time_torch", Path(__file__).resolve().parent.parent / "scripts" /
        "host_time_torch.py")
    host_time = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(host_time)
    m, n, k = 64, 64, 4096
    data = bu.fresh_inputs(np.random.default_rng(0), m, n, k)
    timer = bu.GraphTimer(lambda a, b, b_t: torch.matmul(a, b), data, bu.bound_ms(m, n, k))
    graph_ms = float(np.median([timer.time_ms() for _ in range(9)]))
    alone = host_time.alone_ms(torch, lambda: (lambda: torch.matmul(data[0], data[1])))
    assert abs(graph_ms / alone - 1.0) < 0.25, (graph_ms, alone)
    assert graph_ms >= bu.bound_ms(m, n, k)


def _normal(shape, seed, device):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device)


@pytest.mark.parametrize("path", ["kernel_kn", "kernel_nk", "fused_gelu", "sentinel",
                                  "sentinel_gelu", "batched", "batched_sentinel"])
def test_grads_on_card_match_the_cpu(cuda, path):
    """The backward on the card (bf16-in, f32-out library GEMMs for a bf16 cotangent, f32
    GEMMs with TF32 off for an f32 one) against the same call on the CPU (f32 copies):
    within one bf16 ulp plus the f32 reorder of the sums (test_torch_autograd.py's terms)."""
    from tpul2_torch import dispatch
    batched = path.startswith("batched")
    lead = (3,) if batched else ()
    cfg = (KernelConfig.vendor() if "sentinel" in path else
           KernelConfig(bm=64, bn=64, bk=128, rhs_layout="nk" if path == "kernel_nk" else "kn"))
    act = "gelu" if path.endswith("gelu") else None
    out_dtype = torch.float32 if path in ("fused_gelu", "batched") else torch.bfloat16
    a = _normal((*lead, M, 384), 21, "cpu").bfloat16()
    b = _normal((*lead, 384, 192), 22, "cpu").bfloat16()
    bias = _normal((192,), 23, "cpu") if act else None
    ct = _normal((*lead, M, 192), 24, "cpu").to(out_dtype)
    grads = {}
    for device in ("cpu", "cuda"):
        ins = [t.to(device).requires_grad_() for t in (a, b) + ((bias,) if act else ())]
        if batched:
            res = dispatch.batched_matmul(*ins, config=cfg, out_dtype=out_dtype)
        else:
            res = dispatch.matmul(ins[0], ins[1], config=cfg, bias=ins[2] if act else None,
                                  activation=act, out_dtype=out_dtype)
        grads[device] = [g.float().cpu() for g in torch.autograd.grad(res, ins, ct.to(device))]
    for got, want, length in zip(grads["cuda"], grads["cpu"], (192, M, M)):
        tol = 2.0 ** -7 * want.abs() + 1e-5 * length ** 0.5
        assert bool(((got - want).abs() <= tol).all())


def test_block_on_card_matches_the_cpu(cuda, empty_tunedb):
    """A small block (d_model 128, 4 heads) forward and grads through the heuristic on the
    card against the same block on the CPU (the plain versions)."""
    from tpul2_torch.models import BlockParams, block_forward, block_value_and_grad, init_block
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_block(gen, 128, 256, device="cpu")
    x = torch.randn((64, 128), generator=gen).bfloat16()
    y = torch.randn((64, 128), generator=gen).bfloat16()
    res = {}
    for device in ("cpu", "cuda"):
        p = BlockParams(*(t.to(device) for t in params))
        out = block_forward(p, x.to(device), 4)
        loss, grads = block_value_and_grad(p, x.to(device), y.to(device), 4)
        res[device] = (out.float().cpu(), float(loss), [g.float().cpu() for g in grads])
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=0.02, atol=0.02)
    assert res["cuda"][1] == pytest.approx(res["cpu"][1], rel=1e-3)
    for got, want in zip(res["cuda"][2], res["cpu"][2]):
        assert ((got - want).norm() / want.norm()).item() <= 0.02


def test_stream_defense_flags_a_side_stream_cheat_and_passes_the_candidate(cuda):
    """The side-stream cheat (the product on another stream, returned with no wait) is
    flagged; the honest candidate passes with a side stream as the current stream, since
    every launcher follows the caller's stream."""
    from tpul2_torch.dispatch import candidate_fn
    from tpul2_torch.harness import defense
    from tpul2_torch.harness.bench_utils import fresh_inputs

    data = fresh_inputs(np.random.default_rng(0), 4096, 4096, 4096)
    side = torch.cuda.Stream()

    def cheat(a, b, b_t):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            return torch.matmul(a, b)

    res = defense.defend_against_stream_injection(cheat, data)
    assert not res["pass"] and res["runs_flagged"] >= 2, res
    assert res["authoritative_ms"] > res["event_ms"]
    current = torch.cuda.Stream()
    current.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(current):
        honest = defense.run_all_defenses(candidate_fn("float32"), data)
    torch.cuda.synchronize()
    assert honest["pass"], honest


@pytest.mark.parametrize("bm,bn,layout,out_dtype,act", [
    (128, 256, "kn", torch.bfloat16, None), (256, 384, "nk", torch.float32, "relu"),
    (64, 256, "kn", torch.float32, "relu"), (1024, 128, "nk", torch.bfloat16, None)])
def test_wide_route_matches_its_plain_version(cuda, bm, bn, layout, out_dtype, act):
    """A wide block (tl2_wgmma_wide.cu) on 0/1 inputs at edges its block does not divide:
    launched once on the wide route, bit-equal to the plain version."""
    m, n, k = 1000, 1000, 200
    cfg = KernelConfig(bm=bm, bn=bn, bk=224, rhs_layout=layout)
    a = _01((m, k), 3).to(cuda)
    rhs = _01((n, k) if layout == "nk" else (k, n), 4).to(cuda)
    bias = _01((n,), 5).float().to(cuda) if act else None
    assert mm.launch_route(cfg, a, rhs, m, n, k) == "wgmma_wide"
    before = mm.LAUNCHES_SINGLE_K_WGMMA_WIDE
    got = mm._matmul(a, rhs, cfg, out_dtype, None, bias, act)
    torch.cuda.synchronize()
    assert mm.LAUNCHES_SINGLE_K_WGMMA_WIDE == before + 1
    want = mm.matmul_reference(a, rhs, cfg.bk, "float32", layout, bias, act, out_dtype)
    assert torch.equal(got, want)


#: (batch, m, n, k, config, A off 16 bytes, out= off 16 bytes, route, counter key): each
#: variant of the wide route.
WIDE_VARIANTS = [
    (1, 1024, 2048, 512, dict(bm=1024, bn=2048, bk=256, acc_dtype="bfloat16"), False, False,
     "wgmma_wide", "multi_k_wgmma_wide"),                       # the carry, resident A
    (1, 1024, 1024, 2048, dict(bm=512, bn=1024, bk=512), False, False,
     "wgmma_wide", "multi_k_wgmma_wide"),                       # the carry, streamed A
    (1, 1024, 1024, 1024, dict(bm=1024, bn=1024, bk=1024), False, False,
     "wgmma_wide", "single_k_wgmma_wide"),                      # one interval, streamed A
    (1, 300, 520, 1000, dict(bm=256, bn=256, bk=96, acc_dtype="bfloat16"), False, False,
     "wgmma_wide", "multi_k_wgmma_wide"),                       # rounding points mid-stage
    (1, 16384, 256, 128, dict(bm=16384, bn=256, bk=128), False, False,
     "wgmma_wide", "single_k_wgmma_wide"),                      # above 2048 rows
    (3, 1000, 1024, 512, dict(bm=1024, bn=512, bk=512), False, False,
     "wgmma_wide", "batched_single_k_wgmma_wide"),
    (3, 1000, 1024, 512, dict(bm=256, bn=512, bk=256, acc_dtype="bfloat16"), False, False,
     "wgmma_wide", "batched_multi_k_wgmma_wide"),
    (1, 1000, 1000, 60, dict(bm=256, bn=512, bk=64), False, False,
     "wgmma_wide_lsu", "single_k_wgmma_wide_lsu"),              # K % 8, N % 8
    (1, 700, 1024, 1500, dict(bm=256, bn=256, bk=256, acc_dtype="bfloat16"), True, True,
     "wgmma_wide_lsu", "multi_k_wgmma_wide_lsu"),               # bases off 16, streamed
    (3, 300, 1000, 300, dict(bm=128, bn=512, bk=128), False, False,
     "wgmma_wide_lsu", "batched_multi_k_wgmma_wide_lsu"),
]


@pytest.mark.parametrize("case", WIDE_VARIANTS)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_wide_variants_match_their_plain_version(cuda, case, out_dtype):
    """Each wide variant on 0/1 inputs: its route, one launch on its counter, and the plain
    version's bits at the config's bk."""
    from tpul2_torch.ops import launch_counts
    batch, m, n, k, kw, a_off, out_off, route, key = case
    cfg = KernelConfig(**kw)
    lead = (batch,) if batch > 1 else ()

    def placed(t, off):
        if not off:
            return t
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    a = placed(_01((*lead, m, k), 6).to(cuda), a_off)
    b = _01((*lead, k, n), 7).to(cuda)
    out = placed(torch.zeros((*lead, m, n), dtype=out_dtype, device=cuda), out_off)
    assert mm.launch_route(cfg, a[0] if batch > 1 else a, b[0] if batch > 1 else b, m, n, k,
                           out[0] if batch > 1 else out) == route
    before = launch_counts()[key]
    if batch > 1:
        bmm.cuda_batched_matmul(a, b, cfg, out=out)
    else:
        mm.cuda_matmul(a, b, cfg, out=out)
    torch.cuda.synchronize()
    assert launch_counts()[key] == before + 1
    want = mm.matmul_reference(a, b, cfg.bk, cfg.acc_dtype, out_dtype=out_dtype)
    assert torch.equal(out, want)


#: The JAX space's narrow and unaligned edges (block, counter): a ring block narrower than
#: its tile, the swapped wide walk, narrow columns beside a wide bm, a clipped cover.
NARROW_BLOCKS = [((16, 128), "ring_narrow"), ((16, 512), "wide_swapped"),
                 ((48, 64), "ring_narrow"), ((256, 64), "wide_narrow_n"),
                 ((200, 256), "wide_clipped")]


@pytest.mark.parametrize("block,key", NARROW_BLOCKS)
def test_next_block_nan_rows_are_never_stored(cuda, block, key):
    """A's rows of the second block are NaN, and the tile's rows beyond the first block
    read them from shared memory: the first block's rows of C are exact and the second's
    NaN, in one launch on the variant's counter (the CPU twin is in
    tests/test_torch_jax_space.py)."""
    from tpul2_torch.ops import launch_counts
    bm, bn = block
    m, n, k = 2 * bm, 600, 256
    a = _01((m, k), 8).to(cuda)
    a[bm:] = float("nan")
    b = _01((k, n), 9).to(cuda)
    before = launch_counts()[key]
    got = mm.cuda_matmul(a, b, KernelConfig(bm=bm, bn=bn, bk=128), out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert launch_counts()[key] == before + 1
    assert torch.equal(got[:bm], a[:bm].float() @ b.float())
    assert bool(torch.isnan(got[bm:]).all())


#: (block, counter): 'kn' blocks whose every column but the first starts off 16 bytes
#: (bn % 8 != 0 over several column blocks), on the ring and on the wide walk.
KN_OFF_16 = [((128, 100), "single_k_wgmma_lsu"), ((64, 60), "single_k_wgmma_lsu"),
             ((300, 300), "single_k_wgmma_wide_lsu"), ((1000, 300), "single_k_wgmma_wide_lsu")]


@pytest.mark.parametrize("block,key", KN_OFF_16)
@pytest.mark.parametrize("m", [600, 2000])
def test_kn_block_columns_off_16_bytes_take_the_loads_producer(cuda, block, key, m):
    """A 'kn' B block whose columns start off 16 bytes (bn 300 or 100 at N = 600) is read by
    the loads producer, not by TMA (whose box would start off 16 bytes and trap the launch):
    one launch on the loads producer's counter, equal to the plain version, and the card
    still answers afterwards."""
    from tpul2_torch.ops import launch_counts
    bm, bn = block
    n, k = 600, 256
    cfg = KernelConfig(bm=bm, bn=bn, bk=256)
    a, b = _01((m, k), 10).to(cuda), _01((k, n), 11).to(cuda)
    assert mm.operand_producers(cfg, a, b, n, k) == (True, False)
    before = launch_counts()[key]
    got = mm.cuda_matmul(a, b, cfg, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert launch_counts()[key] == before + 1
    assert torch.equal(got, mm.matmul_reference(a, b, cfg.bk, out_dtype=torch.float32))
