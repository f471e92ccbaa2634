"""The route rule, and the ring's semantics on the CPU path.

Every launch runs ``csrc/tl2_wgmma.cu``'s ring; ``ops.matmul.launch_route`` names, from
the shape before the launch, the producer that fills it: TMA ('wgmma') or, where TMA
cannot read an operand, the loads producer ('wgmma_lsu'); ``ops.matmul.operand_producers``
says which operand each takes.  On the card, ``chip_smoke.py`` phase 1 holds the C mirror
(``tl2_wgmma_route``) to it.  Here: each condition flips the producer on its own, every
tile takes the ring at a single interval, the CPU path launches nothing, at each wide tile,
with gk > 1 and K % 64 != 0, the port's CPU path agrees with ``tpul2.ops.matmul`` in
interpret mode, and so does the bf16 family's single interval (the f32 sum, never rounded,
then the epilogue) against ``pallas_matmul_fused``.  Tolerances as in test_torch_matmul.py:
0/1 inputs bit-exact (every sum is an integer below 2^24); normal inputs within
``ops.matmul.allowed_error`` (f32 reorder, plus one bf16 ulp of the running sum in the
bf16 family where there is more than one interval).

On the CPU the port's result does not depend on the tile, so each tile case has a shape
of its own, with M and N edges off that tile; the JAX kernel runs each shape at a tile it
takes (bn a multiple of its 128 lanes), since its result depends on bk, not on the tile.
"""

import dataclasses
import functools
import json
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2.config as jcfg
from tpul2.ops.matmul import pallas_matmul, pallas_matmul_fused, pallas_matmul_tn
from tpul2_torch.config import (PIPELINE_DEPTHS, KernelConfig, kn_tma_cols, ring_c_grid,
                                ring_edge, wide_c_grid)
from tpul2_torch.ops import batched as bmm
from tpul2_torch.ops import matmul as mm
from tpul2_torch.ops._build import ptxas_report

CSRC = Path(__file__).resolve().parent.parent / "tpul2_torch" / "csrc"

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

M, N, K, BK = 136, 200, 328, 128   # M and N off every tile, K % 64 == 8, gk == 3


def _operands(m, n, k, layout, off_a=0, off_b=0):
    """Zero bf16 operands whose bases lie off_a / off_b elements into their allocations."""
    a = torch.zeros(m * k + off_a, dtype=torch.bfloat16)[off_a:].view(m, k)
    shape = (n, k) if layout == "nk" else (k, n)
    rhs = torch.zeros(n * k + off_b, dtype=torch.bfloat16)[off_b:].view(shape)
    return a, rhs


#: (case, changes to the base launch, route, the operands the loads producer reads).  The
#: base takes TMA for both; each other row changes one condition.  Every valid config takes
#: the ring: a 32 edge (width 32, or swapped at bm 32), bk 96 (a rounding point in the
#: middle of a stage) and M or N of 1..31 included.
ROUTE_CASES = [
    ("base", {}, "wgmma", ""),
    ("nk", {"layout": "nk"}, "wgmma", ""),
    ("tile_64x64", {"bm": 64, "bn": 64}, "wgmma", ""),
    ("tile_128x64", {"bn": 64}, "wgmma", ""),
    ("k_tail", {"k": 328}, "wgmma", ""),
    ("gk1", {"bk": 512}, "wgmma", ""),
    ("bm32", {"bm": 32}, "wgmma", ""),
    ("bn32", {"bn": 32}, "wgmma", ""),
    ("bk_not_64", {"bk": 96}, "wgmma", ""),
    ("k_not_8", {"k": 1001}, "wgmma_lsu", "a"),
    ("kn_n_not_8", {"n": 1001}, "wgmma_lsu", "b"),
    ("nk_n_not_8", {"n": 1001, "layout": "nk"}, "wgmma", ""),
    ("nk_k_not_8", {"k": 1004, "layout": "nk"}, "wgmma_lsu", "ab"),
    ("a_base_2_bytes_off", {"off_a": 1}, "wgmma_lsu", "a"),
    ("b_base_8_bytes_off", {"off_b": 4}, "wgmma_lsu", "b"),
    ("b_base_16_bytes_off", {"off_b": 8}, "wgmma", ""),
    ("m1", {"m": 1, "bm": 32}, "wgmma", ""),
    ("m17", {"m": 17, "bm": 32, "layout": "nk"}, "wgmma", ""),
    ("m31", {"m": 31, "bm": 32, "bn": 32}, "wgmma", ""),
    ("n1_kn", {"n": 1, "bn": 32}, "wgmma_lsu", "b"),
    ("n17_nk", {"n": 17, "bn": 32, "layout": "nk"}, "wgmma", ""),
    ("n31_kn", {"n": 31, "bm": 32, "bn": 32}, "wgmma_lsu", "b"),
    ("bk96_bm32", {"bk": 96, "bm": 32, "bn": 64}, "wgmma", ""),
    ("bk96_a_off", {"bk": 96, "off_a": 1}, "wgmma_lsu", "a"),
    ("lsu_a_only_nk", {"off_a": 2, "layout": "nk", "bn": 32}, "wgmma_lsu", "a"),
    ("lsu_b_only_nk", {"off_b": 1, "layout": "nk", "bm": 32}, "wgmma_lsu", "b"),
    # a 'kn' column block that starts off 16 bytes: TMA's box would too (bn % 8 != 0 over
    # several blocks); one block of N, or B_t, is read by TMA
    ("kn_bn100_cols_off_16", {"bn": 100, "n": 600}, "wgmma_lsu", "b"),
    ("kn_bn100_one_block", {"bn": 100, "n": 96}, "wgmma", ""),
    ("nk_bn100", {"bn": 100, "n": 600, "layout": "nk"}, "wgmma", ""),
    ("kn_bn1_cols_off_16", {"bn": 1, "n": 64}, "wgmma_lsu", "b"),
]


@pytest.mark.parametrize("case,change,route,lsu", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_route_rule(case, change, route, lsu):
    d = dict(m=256, n=256, k=512, bm=128, bn=128, bk=128, layout="kn", off_a=0, off_b=0)
    d.update(change)
    cfg = KernelConfig(bm=d["bm"], bn=d["bn"], bk=d["bk"], rhs_layout=d["layout"])
    assert cfg.validate() is None
    a, rhs = _operands(d["m"], d["n"], d["k"], d["layout"], d["off_a"], d["off_b"])
    assert mm.launch_route(cfg, a, rhs, d["m"], d["n"], d["k"]) == route
    tma_a, tma_b = mm.operand_producers(cfg, a, rhs, d["n"], d["k"])
    assert ("a" if not tma_a else "") + ("b" if not tma_b else "") == lsu


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("k,bk", [(512, 512), (328, 512), (64, 64), (1024, 8192)])
def test_single_interval_takes_the_ring_on_every_tile(k, bk, layout):
    """gk == 1 takes the ring on every tile, 32 edges included: filled by TMA where both
    operands allow it, by the loads producer where an operand's base is off 16 bytes or
    its rows are not (K % 8 != 0)."""
    a, rhs = _operands(128, 128, k, layout)
    a_off, _ = _operands(128, 128, k, layout, off_a=1)
    odd_a, odd_rhs = _operands(128, 128, k - 1, layout)
    for bm in (32, 64, 128):
        for bn in (32, 64, 128):
            cfg = KernelConfig(bm=bm, bn=bn, bk=bk, rhs_layout=layout)
            assert mm.launch_route(cfg, a, rhs, 128, 128, k) == "wgmma"
            assert mm.launch_route(cfg, a_off, rhs, 128, 128, k) == "wgmma_lsu"
            assert mm.launch_route(cfg, odd_a, odd_rhs, 128, 128, k - 1) == "wgmma_lsu"


def test_wgmma_smem_model_fits_every_tile():
    """The carry ring of every tile fits the H100's 227 KB a block: 4 stages on the wide
    tiles, a 32-edge tile's ring sized to hold 64 KB of its bn side in flight."""
    for bm in (32, 64, 128):
        for bn in (32, 64, 128):
            assert mm.wgmma_smem_bytes(bm, bn) <= 232448
            assert mm.wgmma_smem_bytes(bm, bn) == mm.wgmma_smem_bytes(
                bm, bn, mm.carry_stages(bm, bn))
    assert mm.wgmma_smem_bytes(128, 128) == 1024 + 4 * 256 * 128 + 64
    assert [mm.carry_stages(bm, bn) for bm, bn in ((32, 64), (32, 128), (32, 32), (64, 32),
                                                    (128, 32))] == [8, 4, 16, 16, 11]


_RING_MIRROR = r"""
#include <cstdio>
#include "tl2_wgmma_model.cuh"
int main() {
  const int edges[] = {1, 16, 31, 32, 33, 48, 64, 100, 128};
  const int dims[] = {1, 40, 64, 96, 600};
  std::printf("[");
  bool first = true;
  for (int bm : edges)
    for (int bn : edges)
      for (int stages = 0; stages <= tl2wg::MAX_STAGES; ++stages)
        for (int m : dims)
          for (int n : dims) {
            const int tm = tl2wg::ring_edge(bm), tn = tl2wg::ring_edge(bn);
            std::printf("%s[%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d]", first ? "" : ",", bm,
                        bn, stages, m, n, tl2wg::carry_stages(bm, bn),
                        tl2wg::smem_bytes(bm, bn, stages), (int)tl2wg::ring_c_grid(m, n, bm, bn),
                        (int)tl2wg::kn_tma_cols(n, bn), tl2wg::ring_c_rows(tm, tn),
                        tl2wg::ring_c_cols(tm, tn), tl2wg::ring_c_box_cols(tm, tn, 2),
                        tl2wg::ring_c_box_cols(tm, tn, 4), (int)tl2wg::ring_swapped(tm, tn));
            first = false;
          }
  std::printf("]\n");
  return 0;
}
"""


def test_ring_model_equals_its_c_mirror(tmp_path):
    """``carry_stages``, ``KernelConfig.smem_bytes`` (the carry ring and every staged depth),
    ``config.ring_c_grid`` and ``config.kn_tma_cols`` against ``tl2_wgmma_model.cuh``, which
    the launcher and the route use, built here with g++, at every ring tile, narrower blocks
    and shapes on either side of each edge; and the C staging of each tile (its rows, columns
    and boxes of 128 or 64 bytes) lies within the ring's first two stages in both output
    dtypes, as the kernel's static_assert says."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the C mirror"
    src, exe = tmp_path / "ring.cpp", tmp_path / "ring"
    src.write_text(_RING_MIRROR)
    subprocess.run([gxx, "-std=c++17", "-O0", f"-I{CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)
    rows = json.loads(subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                                     timeout=60).stdout)
    assert len(rows) == 9 * 9 * 9 * 5 * 5
    for (bm, bn, stages, m, n, depth, smem, c_grid, kn_cols, c_rows, c_cols, box_bf16,
         box_f32, swapped) in rows:
        assert depth == mm.carry_stages(bm, bn)
        assert smem == mm.wgmma_smem_bytes(bm, bn, stages)
        if stages == 0:  # the carry ring's model, as validate reads it
            assert KernelConfig(bm=bm, bn=bn).smem_bytes() == mm.wgmma_smem_bytes(bm, bn)
        elif stages in PIPELINE_DEPTHS:
            assert smem == KernelConfig(bm=bm, bn=bn, pipeline_depth=stages).smem_bytes()
        assert bool(c_grid) == ring_c_grid(m, n, bm, bn)
        assert bool(kn_cols) == kn_tma_cols(n, bn)
        tm, tn = ring_edge(bm), ring_edge(bn)
        consumers = (tn if swapped else max(tm, 64)) // 64
        for box, elem in ((box_bf16, 2), (box_f32, 4)):
            assert box * elem in (64, 128) and c_cols % box == 0
            assert consumers * c_rows * c_cols * elem <= 2 * (tm + tn) * 128
        assert (c_rows, c_cols) == ((32, 64) if swapped else (min(tm, 64), tn))


@pytest.mark.parametrize("bn,layout,tma_b", [(300, "kn", False), (256, "kn", True),
                                              (600, "kn", True), (300, "nk", True)])
@pytest.mark.parametrize("m", [600, 2000])
def test_wide_kn_block_columns_off_16_bytes_take_the_loads_producer(m, bn, layout, tma_b):
    """A wide 'kn' block of bn 300 at N = 600 starts its second column block 600 bytes into
    B's rows, off 16: the loads producer reads B (TMA's box would trap the launch on the
    card); bn 256, one block of N, or B_t are read by TMA."""
    n, k = 600, 256
    for bm in (300, 1000):
        cfg = KernelConfig(bm=bm, bn=bn, bk=256, rhs_layout=layout)
        assert cfg.validate() is None and cfg.wide
        a, rhs = _operands(m, n, k, layout)
        assert mm.operand_producers(cfg, a, rhs, n, k) == (True, tma_b)
        assert mm.launch_route(cfg, a, rhs, m, n, k) == (
            "wgmma_wide" if tma_b and wide_c_grid(m, n, bm, bn) else "wgmma_wide_lsu")


#: (case, changes to the base launch, store): the TMA store where TMA can write C and every
#: block edge is the tile's or past the problem's; predicated stores elsewhere.
STORE_CASES = [
    ("tile", {}, "tma"),
    ("tile_64x32", {"bm": 64, "bn": 32}, "tma"),
    ("swapped_32x128", {"bm": 32, "bn": 128}, "tma"),
    ("bf16_width32", {"bm": 32, "bn": 32}, "tma"),
    ("m_edge_off_tile", {"m": 200}, "tma"),
    ("bm48_clipped", {"bm": 48}, "predicated"),
    ("bn100_clipped", {"bn": 100}, "predicated"),
    ("bm16_clipped", {"bm": 16, "bn": 64}, "predicated"),
    ("bm48_one_block", {"bm": 48, "m": 40}, "tma"),
    ("bn100_one_block", {"bn": 100, "n": 96}, "tma"),
    ("n_not_8", {"n": 1001}, "predicated"),
    ("out_off_16", {"off_c": 2}, "predicated"),
    ("out_16_bytes_in", {"off_c": 4}, "tma"),
    ("wide_grid", {"bm": 256, "bn": 1024, "n": 2048}, "tma"),
    ("wide_clipped", {"bm": 200, "bn": 256}, "predicated"),
    ("wide_swapped", {"bm": 16, "bn": 512}, "predicated"),
]


@pytest.mark.parametrize("case,change,store", STORE_CASES, ids=[c[0] for c in STORE_CASES])
def test_store_rule(case, change, store):
    """``launch_store`` (``tl2_wgmma_route``'s ROUTE_TMA_STORE bit on the card): C goes out
    by TMA from shared memory at a block equal to the tile, or one whose edges lie past the
    problem's, where N % 8 == 0 and ``out=`` is 16-byte aligned; by predicated stores at
    clipped blocks, N % 8 != 0 and an ``out=`` off 16 bytes."""
    d = dict(m=256, n=256, bm=128, bn=128, off_c=None)
    d.update(change)
    cfg = KernelConfig(bm=d["bm"], bn=d["bn"], bk=128)
    assert cfg.validate() is None
    out = None
    if d["off_c"] is not None:
        out = torch.zeros(d["m"] * d["n"] + d["off_c"])[d["off_c"]:].view(d["m"], d["n"])
    assert mm.launch_store(cfg, d["m"], d["n"], out) == store


def _counts():
    return tuple(getattr(mod, f"LAUNCHES_{body}_K_{route}") for mod in (mm, bmm)
                 for body in ("MULTI", "SINGLE") for route in ("WGMMA", "WGMMA_LSU"))


@pytest.mark.parametrize("entry", ["nn", "tn", "fused", "batched"])
@pytest.mark.parametrize("route", ["wgmma", "wgmma_lsu"])
def test_cpu_path_launches_nothing(entry, route):
    """Configs of both routes run the plain version on CPU tensors: no counter moves.  The
    loads producer's case has A's base 2 bytes off 16 and a 32-row tile."""
    rng = np.random.default_rng(3)
    bm = 128 if route == "wgmma" else 32
    cfg = KernelConfig(bm=bm, bn=64, bk=BK, rhs_layout="nk" if entry == "tn" else "kn")
    a = torch.from_numpy(rng.integers(0, 2, (2, M, K)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.integers(0, 2, (2, K, N)).astype(np.float32)).bfloat16()
    if route == "wgmma_lsu":
        a = torch.zeros(a.numel() + 1, dtype=torch.bfloat16)[1:].view(a.shape).copy_(a)
    rhs = b[0].t().contiguous() if entry == "tn" else b[0]
    assert mm.launch_route(cfg, a[0], rhs, M, N, K) == route
    want = (a @ b).float()
    before = _counts() + (mm.LAUNCHES_WIDTH32, mm.LAUNCHES_SWAPPED, mm.LAUNCHES_MIDSTAGE)
    if entry == "nn":
        got, want = mm.cuda_matmul(a[0], rhs, cfg, out_dtype=torch.float32), want[0]
    elif entry == "tn":
        got, want = mm.cuda_matmul_tn(a[0], rhs, cfg, out_dtype=torch.float32), want[0]
    elif entry == "fused":
        got = mm.cuda_matmul_fused(a[0], rhs, bias=torch.ones(N), activation="relu",
                                   config=cfg, out_dtype=torch.float32)
        want = want[0] + 1
    else:
        got = bmm.cuda_batched_matmul(a, b, cfg, out_dtype=torch.float32)
    assert _counts() + (mm.LAUNCHES_WIDTH32, mm.LAUNCHES_SWAPPED,
                        mm.LAUNCHES_MIDSTAGE) == before
    assert torch.equal(got, want)


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _tile_shape(tile):
    """(M, N) of a tile's case: past a whole number of tiles in both, so each has an edge."""
    return tile[0] + 72, 2 * tile[1] + 8


def _inputs(m, n, zero_one):
    rng = np.random.default_rng(21)
    if zero_one:
        return (rng.integers(0, 2, (m, K)).astype(np.float32),
                rng.integers(0, 2, (K, n)).astype(np.float32))
    return _bf16_exact(rng.standard_normal((m, K))), _bf16_exact(rng.standard_normal((K, n)))


@functools.cache
def _jax_result(m, n, acc, layout, zero_one) -> torch.Tensor:
    a_np, b_np = _inputs(m, n, zero_one)
    jax_cfg = jcfg.KernelConfig(bm=128, bn=128, bk=BK, acc_dtype=acc, rhs_layout=layout)
    a = jnp.asarray(a_np, jnp.bfloat16)
    if layout == "nk":
        res = pallas_matmul_tn(a, jnp.asarray(np.ascontiguousarray(b_np.T), jnp.bfloat16),
                               jax_cfg, out_dtype=jnp.float32)
    else:
        res = pallas_matmul(a, jnp.asarray(b_np, jnp.bfloat16), jax_cfg, out_dtype=jnp.float32)
    return torch.from_numpy(np.array(res, np.float32))


@pytest.mark.parametrize("zero_one", [True, False], ids=["01", "normal"])
@pytest.mark.parametrize("tile", [(64, 64), (64, 128), (128, 64), (128, 128)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_wgmma_tiles_match_jax(acc, layout, tile, zero_one):
    jax_cfg = jcfg.KernelConfig(bm=128, bn=128, bk=BK, acc_dtype=acc, rhs_layout=layout)
    cfg = dataclasses.replace(KernelConfig.from_jax(dataclasses.asdict(jax_cfg)),
                              bm=tile[0], bn=tile[1])
    m, n = _tile_shape(tile)
    a_np, b_np = _inputs(m, n, zero_one)
    a = torch.from_numpy(a_np).bfloat16()
    rhs = torch.from_numpy(np.ascontiguousarray(b_np.T) if layout == "nk" else b_np).bfloat16()
    assert m % tile[0] and n % tile[1] and K % 64 and K > BK
    assert mm.launch_route(cfg, a, rhs, m, n, K) == "wgmma"
    fn = mm.cuda_matmul_tn if layout == "nk" else mm.cuda_matmul
    ours = fn(a, rhs, cfg, out_dtype=torch.float32)
    theirs = _jax_result(m, n, acc, layout, zero_one)
    assert ours.shape == (m, n)
    if zero_one:
        assert torch.equal(ours, theirs)
    else:
        tol = mm.allowed_error(a, rhs, BK, acc, layout, torch.float32)
        assert bool(((ours - theirs).abs() <= tol).all()), (ours - theirs).abs().max()


#: A single interval with edges like 1000^3: M and N off every wgmma tile, K % 64 != 0.
GK1_M, GK1_N, GK1_K = 200, 264, 328


@functools.cache
def _jax_fused_gk1(zero_one: bool) -> tuple:
    """(a, b, bias) as numpy and the JAX fused kernel's f32 result at one interval in the
    bf16 family (bk 384 >= K), run in interpret mode on the CPU: bias + gelu on normal
    inputs, bias + relu on 0/1 inputs (integer-exact)."""
    rng = np.random.default_rng(31)
    if zero_one:
        a_np = rng.integers(0, 2, (GK1_M, GK1_K)).astype(np.float32)
        b_np = rng.integers(0, 2, (GK1_K, GK1_N)).astype(np.float32)
        bias_np = rng.integers(0, 2, (GK1_N,)).astype(np.float32)
    else:
        a_np = _bf16_exact(rng.standard_normal((GK1_M, GK1_K)))
        b_np = _bf16_exact(rng.standard_normal((GK1_K, GK1_N)))
        bias_np = rng.standard_normal((GK1_N,)).astype(np.float32)
    jax_cfg = jcfg.KernelConfig(bm=128, bn=128, bk=384, acc_dtype="bfloat16")
    res = pallas_matmul_fused(jnp.asarray(a_np, jnp.bfloat16), jnp.asarray(b_np, jnp.bfloat16),
                              bias=jnp.asarray(bias_np),
                              activation="relu" if zero_one else "gelu", config=jax_cfg,
                              out_dtype=jnp.float32)
    return a_np, b_np, bias_np, torch.from_numpy(np.array(res, np.float32))


@pytest.mark.parametrize("zero_one", [True, False], ids=["01", "normal"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_bf16_family_single_interval_matches_jax(layout, zero_one):
    """The bf16 family at gk == 1 with f32 output and a fused epilogue: one f32 sum over
    all of K, never rounded to bf16 before the bias (``_kernel_single_k``), on a 64x64
    launch that takes the wgmma route.  Normal inputs (gelu) within the f32 tolerance,
    which a bf16 rounding of the sum breaks; 0/1 inputs (relu) bit-exact."""
    a_np, b_np, bias_np, theirs = _jax_fused_gk1(zero_one)
    act = "relu" if zero_one else "gelu"
    cfg = KernelConfig(bm=64, bn=64, bk=384, acc_dtype="bfloat16", rhs_layout=layout)
    a = torch.from_numpy(a_np).bfloat16()
    b = torch.from_numpy(b_np).bfloat16()
    b_t = b.t().contiguous()
    rhs = b_t if layout == "nk" else b
    bias = torch.from_numpy(bias_np)
    assert mm.launch_route(cfg, a, rhs, GK1_M, GK1_N, GK1_K) == "wgmma"
    ours = mm.cuda_matmul_fused(a, b, bias=bias, activation=act, config=cfg,
                                out_dtype=torch.float32, b_t=b_t)
    assert ours.shape == (GK1_M, GK1_N)
    if zero_one:
        assert torch.equal(ours, theirs)
        assert torch.equal(ours, torch.relu(torch.from_numpy(a_np @ b_np + bias_np)))
        return
    tol = mm.allowed_error(a, rhs, cfg.bk, "bfloat16", layout, torch.float32, bias, act)
    assert torch.equal(tol, mm.allowed_error(a, rhs, cfg.bk, "float32", layout,
                                             torch.float32, bias, act))
    assert bool(((ours - theirs).abs() <= tol).all()), (ours - theirs).abs().max()
    # the sum rounded to bf16 before the epilogue lies outside that tolerance
    rounded = mm.ACTIVATIONS[act]((a.float() @ b.float()).bfloat16().float() + bias)
    assert bool(((rounded - theirs).abs() > tol).any())


def test_ptxas_report_reads_each_kernels_registers_and_spills():
    """``ops._build.ptxas_report`` (phase 1's spill check) on nvcc's -Xptxas -v lines: each
    entry function's registers from its "Used" line, its spills from its properties."""
    ring = "_ZN5tl2wg16tl2_wgmma_kernelILi128ELi128ELb0ELb1ELb0EEEv14CUtensorMap_stS1_S1_NS_8WgParamsE"
    other = "_Z20tl2_splitk_reduce_kernelIfEvPKfPT_xi"
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{ring}' for 'sm_90a'",
        f"ptxas info    : Function properties for {ring}",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 1552 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{other}' for 'sm_90a'",
        f"ptxas info    : Function properties for {other}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 22 registers, 380 bytes cmem[0]"])
    assert ptxas_report(log) == {
        ring: {"registers": 168, "stack": 8, "spill_stores": 8, "spill_loads": 4},
        other: {"registers": 22, "stack": 0, "spill_stores": 0, "spill_loads": 0}}
