"""The multi-K route rule, and the wgmma route's semantics on the CPU path.

``ops.matmul.multi_k_route`` sends a launch to ``csrc/tl2_wgmma.cu`` or to
``csrc/tl2_matmul.cu``'s mma.sync body, from the shape before the launch; on the card,
``chip_smoke.py`` phase 1 holds the C mirror (``tl2_wgmma_route``) to it.  Here: each
condition flips the route on its own, gk == 1 never takes wgmma, the CPU path launches
nothing, and at each wgmma tile, with gk > 1 and K % 64 != 0, the port's CPU path agrees
with ``tpul2.ops.matmul`` in interpret mode.  Tolerances as in test_torch_matmul.py:
0/1 inputs bit-exact (every sum is an integer below 2^24); normal inputs within
``ops.matmul.allowed_error`` (f32 reorder, plus one bf16 ulp of the running sum in the
bf16 family).

On the CPU the port's result does not depend on the tile, so each tile case has a shape
of its own, with M and N edges off that tile; the JAX kernel runs each shape at a tile it
takes (bn a multiple of its 128 lanes), since its result depends on bk, not on the tile.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2.config as jcfg
from tpul2.ops.matmul import pallas_matmul, pallas_matmul_tn
from tpul2_torch.config import KernelConfig
from tpul2_torch.ops import batched as bmm
from tpul2_torch.ops import matmul as mm

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

M, N, K, BK = 136, 200, 328, 128   # M and N off every tile, K % 64 == 8, gk == 3


def _operands(m, n, k, layout, off_a=0, off_b=0):
    """Zero bf16 operands whose bases lie off_a / off_b elements into their allocations."""
    a = torch.zeros(m * k + off_a, dtype=torch.bfloat16)[off_a:].view(m, k)
    shape = (n, k) if layout == "nk" else (k, n)
    rhs = torch.zeros(n * k + off_b, dtype=torch.bfloat16)[off_b:].view(shape)
    return a, rhs


#: (case, changes to the base launch, route).  The base takes wgmma; each other row
#: changes one condition.
ROUTE_CASES = [
    ("base", {}, "wgmma"),
    ("nk", {"layout": "nk"}, "wgmma"),
    ("tile_64x64", {"bm": 64, "bn": 64}, "wgmma"),
    ("tile_128x64", {"bn": 64}, "wgmma"),
    ("k_tail", {"k": 328}, "wgmma"),
    ("gk1", {"bk": 512}, "mma_sync"),
    ("bm32", {"bm": 32}, "mma_sync"),
    ("bn32", {"bn": 32}, "mma_sync"),
    ("bk_not_64", {"bk": 96}, "mma_sync"),
    ("k_not_8", {"k": 1001}, "mma_sync"),
    ("kn_n_not_8", {"n": 1001}, "mma_sync"),
    ("nk_n_not_8", {"n": 1001, "layout": "nk"}, "wgmma"),
    ("nk_k_not_8", {"k": 1004, "layout": "nk"}, "mma_sync"),
    ("a_base_2_bytes_off", {"off_a": 1}, "mma_sync"),
    ("b_base_8_bytes_off", {"off_b": 4}, "mma_sync"),
    ("b_base_16_bytes_off", {"off_b": 8}, "wgmma"),
]


@pytest.mark.parametrize("case,change,route", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_route_rule(case, change, route):
    d = dict(m=256, n=256, k=512, bm=128, bn=128, bk=128, layout="kn", off_a=0, off_b=0)
    d.update(change)
    cfg = KernelConfig(bm=d["bm"], bn=d["bn"], bk=d["bk"], rhs_layout=d["layout"])
    a, rhs = _operands(d["m"], d["n"], d["k"], d["layout"], d["off_a"], d["off_b"])
    assert mm.multi_k_route(cfg, a, rhs, d["m"], d["n"], d["k"]) == route


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("k,bk", [(512, 512), (328, 512), (64, 64), (1024, 8192)])
def test_single_interval_never_takes_wgmma(k, bk, layout):
    a, rhs = _operands(128, 128, k, layout)
    for bm in (32, 64, 128):
        for bn in (32, 64, 128):
            cfg = KernelConfig(bm=bm, bn=bn, bk=bk, rhs_layout=layout)
            assert mm.multi_k_route(cfg, a, rhs, 128, 128, k) == "mma_sync"


def test_wgmma_smem_model_fits_every_tile():
    for bm in mm.WGMMA_TILES:
        for bn in mm.WGMMA_TILES:
            assert mm.wgmma_smem_bytes(bm, bn) <= 232448   # the H100's 227 KB per block
    assert mm.wgmma_smem_bytes(128, 128) == 1024 + 4 * 256 * 128 + 64


def _counts():
    return (mm.LAUNCHES_MULTI_K_WGMMA, mm.LAUNCHES_MULTI_K_MMA_SYNC, mm.LAUNCHES_SINGLE_K,
            bmm.LAUNCHES_MULTI_K_WGMMA, bmm.LAUNCHES_MULTI_K_MMA_SYNC,
            bmm.LAUNCHES_SINGLE_K)


@pytest.mark.parametrize("entry", ["nn", "tn", "fused", "batched"])
@pytest.mark.parametrize("route", ["wgmma", "mma_sync"])
def test_cpu_path_launches_nothing(entry, route):
    """Configs of both routes run the plain version on CPU tensors: no counter moves."""
    rng = np.random.default_rng(3)
    bm = 128 if route == "wgmma" else 32
    cfg = KernelConfig(bm=bm, bn=64, bk=BK, rhs_layout="nk" if entry == "tn" else "kn")
    a = torch.from_numpy(rng.integers(0, 2, (2, M, K)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.integers(0, 2, (2, K, N)).astype(np.float32)).bfloat16()
    rhs = b[0].t().contiguous() if entry == "tn" else b[0]
    assert mm.multi_k_route(cfg, a[0], rhs, M, N, K) == route
    want = (a @ b).float()
    before = _counts()
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
    assert _counts() == before
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
    assert mm.multi_k_route(cfg, a, rhs, m, n, K) == "wgmma"
    fn = mm.cuda_matmul_tn if layout == "nk" else mm.cuda_matmul
    ours = fn(a, rhs, cfg, out_dtype=torch.float32)
    theirs = _jax_result(m, n, acc, layout, zero_one)
    assert ours.shape == (m, n)
    if zero_one:
        assert torch.equal(ours, theirs)
    else:
        tol = mm.allowed_error(a, rhs, BK, acc, layout, torch.float32)
        assert bool(((ours - theirs).abs() <= tol).all()), (ours - theirs).abs().max()
