"""The wide blocks wherever the JAX space has them: the K carry (gk > 1) with a resident or a
streamed A, blocks above 2048 rows, batched wide blocks and the loads producer, against the
JAX package on the CPU.

Each wide variant runs ``csrc/tl2_wgmma_wide.cu`` on the card; on the CPU the wrappers run
its plain version, ``ops.matmul.matmul_reference`` at the config's bk (a block's values
depend only on bk, ``acc_dtype`` and the K tail).  Here: the port at ``from_jax`` of a JAX
config against ``pallas_matmul*`` / ``pallas_batched_matmul`` in interpret mode, as the JAX
package's own tests run them (0/1 inputs exact, normal inputs within
``ops.matmul.allowed_error``); batched dispatch through a DB holding a wide config, which
must give JAX's bits; the JAX DB's kernel entries; the tuner's candidates; the
shared-memory model against its C mirror (``csrc/tl2_wgmma_model.cuh``, built here with
g++); and the routes.  No JAX timing loop.
"""

import dataclasses
import json
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2.config as jcfg
from tpul2.ops.batched import pallas_batched_matmul
from tpul2.ops.matmul import pallas_matmul_fused, pallas_matmul_tn
from tpul2_torch import dispatch
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.config import (WIDE_BM_CHOICES, WIDE_STAGES, KernelConfig, candidate_configs,
                                wide_c_grid, wide_smem_bytes, wide_stages, wide_streamed)
from tpul2_torch.ops import batched
from tpul2_torch.ops import matmul as mm

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "tpul2_torch" / "csrc"


@pytest.fixture(autouse=True)
def empty_tunedb(tmp_path, monkeypatch):
    """TPUL2_TORCH_TUNEDB names a file that is not there, so the committed DB steers
    nothing; a test that needs entries writes its own DB there."""
    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "tunedb.json"))
    db_mod.reset_default_db()
    yield
    db_mod.reset_default_db()


def _draw(seed: int, shapes, zero_one: bool) -> list:
    rng = np.random.default_rng(seed)
    if zero_one:
        return [rng.integers(0, 2, s).astype(np.float32) for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16(x: np.ndarray) -> tuple:
    """The same bf16 values on both sides."""
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


# ---- 2-D parity at wide blocks with a K carry ----

#: (acc, layout, jax block (bm, bn, bk), (m, n, k), activation): a 256 x 256 block over
#: three K intervals, and a 64 x 512 block at K = 320 (the last interval a masked tail).
CARRY_CASES = [
    ("float32", "kn", (256, 256, 128), (256, 384, 384), None),
    ("bfloat16", "nk", (256, 256, 128), (256, 384, 384), None),
    ("bfloat16", "kn", (64, 512, 128), (128, 512, 320), "gelu"),
    ("float32", "nk", (64, 512, 128), (128, 512, 320), "gelu"),
]


@pytest.mark.parametrize("acc,layout,block,shape,act", CARRY_CASES)
@pytest.mark.parametrize("zero_one", [True, False])
def test_wide_carry_matches_pallas(acc, layout, block, shape, act, zero_one):
    (bm, bn, bk), (m, n, k) = block, shape
    jax_cfg = jcfg.KernelConfig(bm=bm, bn=bn, bk=bk, acc_dtype=acc, rhs_layout=layout)
    cfg = KernelConfig.from_jax(dataclasses.asdict(jax_cfg))
    assert cfg.wide and cfg.validate() is None and -(-k // cfg.bk) > 1
    a_np, b_np, bias_np = _draw(11, [(m, k), (k, n), (n,)], zero_one)
    (a, a_j), (b, b_j) = _bf16(a_np), _bf16(b_np)
    bias = torch.from_numpy(bias_np) if act else None
    rhs = b.t().contiguous() if layout == "nk" else b
    assert mm.launch_route(cfg, a, rhs, m, n, k) == "wgmma_wide"
    if act is None and layout == "nk":  # the TN entry, b_t read as it is
        theirs = pallas_matmul_tn(a_j, jnp.swapaxes(b_j, 0, 1), jax_cfg, out_dtype=jnp.float32)
        ours = mm.cuda_matmul_tn(a, rhs, cfg, out_dtype=torch.float32)
    else:
        theirs = pallas_matmul_fused(a_j, b_j, None if bias is None else jnp.asarray(bias_np),
                                     act, jax_cfg, out_dtype=jnp.float32)
        ours = mm.cuda_matmul_fused(a, b, bias=bias, activation=act, config=cfg,
                                    out_dtype=torch.float32)
    diff = (ours - _np(theirs)).abs()
    if zero_one:
        assert float(diff.max()) == 0.0
    else:
        tol = mm.allowed_error(a, rhs, cfg.bk, acc, layout, torch.float32, bias, act)
        assert bool((diff <= tol).all()), float((diff - tol).max())


# ---- batched parity, and batched dispatch at a resolved wide config ----

@pytest.mark.parametrize("acc,bk", [("float32", 256), ("bfloat16", 128)])
def test_batched_wide_matches_pallas_and_dispatch_runs_it(acc, bk):
    """gk 1 (bk = K) and gk 2 in the bf16 family.  Small integers (0..3) keep every f32
    sum exact, so both sides' f32 parts agree to the bit and the bf16 carry's roundings
    are the same: the port's bits equal JAX's, through ``cuda_batched_matmul`` and through
    ``dispatch.batched_matmul`` at the DB's wide config.  In the bf16 family they differ
    from the f32 sum, which the library's bmm (the sentinel the batched entry point used to
    take at a wide config) returns."""
    batch, m, n, k = 2, 128, 512, 256
    jax_cfg = jcfg.KernelConfig(bm=64, bn=512, bk=bk, acc_dtype=acc)
    cfg = KernelConfig.from_jax(dataclasses.asdict(jax_cfg))
    rng = np.random.default_rng(4)
    a_np = rng.integers(0, 4, (batch, m, k)).astype(np.float32)
    b_np = rng.integers(0, 4, (batch, k, n)).astype(np.float32)
    (a, a_j), (b, b_j) = _bf16(a_np), _bf16(b_np)
    theirs = _np(pallas_batched_matmul(a_j, b_j, jax_cfg, out_dtype=jnp.float32))
    assert mm.launch_route(cfg, a[0], b[0], m, n, k) == "wgmma_wide"
    assert torch.equal(batched.cuda_batched_matmul(a, b, cfg, out_dtype=torch.float32), theirs)
    db = db_mod.default_db()
    db.put(m, n, k, cfg, 1.0, acc=acc, extra={"speedup_vs_torch_matmul": 1.5})
    db.save()
    db_mod.reset_default_db()
    assert dispatch.resolve_config(m, n, k, acc) == cfg
    got = dispatch.batched_matmul(a, b, acc=acc, out_dtype=torch.float32)
    assert torch.equal(got, theirs)
    exact = torch.from_numpy(np.matmul(a_np, b_np))
    assert torch.equal(got, exact) == (acc == "float32")


# ---- the JAX DB's kernel entries ----

def _jax_entries() -> list:
    entries = json.loads((REPO / "tpul2" / "data" / "tunedb_v5e.json").read_text())["entries"]
    out = []
    for key, entry in entries.items():
        if entry["config"].get("use_xla"):
            continue
        m, n, k = map(int, key.split("/")[0].split("_"))
        out.append(((m, n, k), key.split("/")[1], KernelConfig.from_jax(entry["config"])))
    return out


def test_jax_db_wide_entries_launch_at_their_own_shape():
    """All 214 kernel entries validate and take a route at their own shape (a 16-byte
    aligned stand-in operand: the route reads only the base), the two bm = 16 ones (JAX's
    sublane 16 beside a wide bn) on the
    swapped walk; through a DB holding them, dispatch resolves each to itself and runs it
    (here its plain version, at its own bk)."""
    stand_in = torch.zeros(8, dtype=torch.bfloat16)
    routes = {}
    entries = _jax_entries()
    assert len(entries) == 214
    for (m, n, k), _, cfg in entries:
        assert cfg.validate() is None, (m, n, k, cfg)
        route = mm.launch_route(cfg, stand_in, stand_in, m, n, k)
        routes[route] = routes.get(route, 0) + 1
    assert sum(routes.values()) == 214
    assert routes["wgmma_wide"] > 0
    narrow = [(s, acc, c) for s, acc, c in entries if c.bm == 16]
    assert [(s, c.bm) for s, _, c in narrow] == [((16, 11008, 4096), 16), ((8, 4096, 4096), 16)]
    db = db_mod.default_db()
    for (m, n, k), acc, cfg in narrow:
        db.put(m, n, k, cfg, 1.0, acc=acc, extra={"scope": "from_jax"})
    db.save()
    db_mod.reset_default_db()
    for (m, n, k), acc, cfg in narrow:
        assert cfg.wide and mm.launch_route(cfg, stand_in, stand_in, m, n, k) == "wgmma_wide_lsu"
        assert mm.launch_variants(cfg, k) == ["wide_streamed", "wide_swapped"]
        assert dispatch.resolve_config(m, n, k, acc) == cfg
        a_np, b_np = _draw(17, [(m, k), (k, n)], True)
        a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
        got = dispatch.matmul(a, b, acc=acc, out_dtype=torch.float32)
        assert torch.equal(got, mm.matmul_reference(a, b, cfg.bk, acc, out_dtype=torch.float32))


def test_jax_db_covers_every_new_variant():
    """Among the launchable entries: K carries in both families, streamed A (single-K and
    carried), blocks above 2048 rows, and 'nk' beside 'kn'."""
    kinds = set()
    for (m, n, k), acc, cfg in _jax_entries():
        if not cfg.wide or cfg.validate():
            continue
        carry = k > cfg.bk
        kinds.add(("carry" if carry else "single", acc if carry else "-",
                   wide_streamed(cfg.bm, k)))
        kinds.add(("tall", cfg.bm > WIDE_BM_CHOICES[-1]))
        kinds.add(("layout", cfg.rhs_layout))
    assert {("carry", "float32", True), ("carry", "bfloat16", False),
            ("single", "-", True), ("single", "-", False), ("tall", True),
            ("layout", "nk"), ("layout", "kn")} <= kinds


# ---- the tuner's candidates ----

@pytest.mark.parametrize("m,n,k,acc", [(1024, 2048, 512, "bfloat16"),
                                       (12288, 12288, 12288, "float32")])
def test_candidates_hold_the_jax_entrys_config(m, n, k, acc):
    want = next(cfg for shape, a, cfg in _jax_entries() if shape == (m, n, k) and a == acc)
    assert want.wide and k > want.bk
    cands = candidate_configs(m, n, k, acc, max_candidates=10000)
    assert want in cands
    stand_in = torch.zeros(8, dtype=torch.bfloat16)
    wide = [c for c in cands if not c.use_vendor and c.wide]
    assert any(k > c.bk for c in wide)
    for c in wide:
        assert c.validate() is None
        # TMA stores C where every block edge lies on the sub-tile grid or past the
        # problem's; the swapped walk (bm <= 32) and a clipped edge store by predication
        want_route = "wgmma_wide" if wide_c_grid(m, n, c.bm, c.bn) else "wgmma_wide_lsu"
        assert mm.launch_route(c, stand_in, stand_in, m, n, k) == want_route


def test_candidates_take_jaxs_full_dim_cover_above_2048_rows():
    cands = candidate_configs(4096, 512, 128, max_candidates=10000)
    assert {c.bm for c in cands if c.wide} >= {4096, 2048, 256}
    # 4096 rows is the most one block covers (JAX: twice its largest bm)
    assert max(c.bm for c in candidate_configs(8192, 512, 128, max_candidates=10000)
               if c.wide) == 2048


# ---- the shared-memory model against its C mirror ----

_MIRROR = r"""
#include <cstdio>
#include "tl2_wgmma_model.cuh"
int main() {
  const int bms[] = {BMS};
  const int ks[] = {KS};
  std::printf("[");
  bool first = true;
  for (int bm : bms)
    for (int k : ks)
      for (int stages = 0; stages <= tl2wg::WIDE_STAGES; ++stages) {
        std::printf("%s[%d,%d,%d,%d,%d,%d,%d]", first ? "" : ",", bm, k, stages,
                    (int)tl2wg::wide_streamed(bm, k), tl2wg::wide_stages(bm, k),
                    tl2wg::wide_smem_bytes(bm, k, stages, false),
                    tl2wg::wide_smem_bytes(bm, k, stages, true));
        first = false;
      }
  std::printf("]\n");
  return 0;
}
"""


def test_wide_smem_model_equals_its_c_mirror(tmp_path):
    """``config.wide_streamed`` / ``wide_stages`` / ``wide_smem_bytes`` (both modes, every
    depth) against ``tl2_wgmma_model.cuh``, which the kernel's launcher and route use, at
    every wide sub-tile height and K on either side of each mode's limit."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the C mirror"
    bms = (64, 128) + WIDE_BM_CHOICES + (16384,)
    ks = (64, 512, 576, 1280, 1344, 4096, 16384)
    src = tmp_path / "mirror.cpp"
    src.write_text(_MIRROR.replace("BMS", ", ".join(map(str, bms)))
                   .replace("KS", ", ".join(map(str, ks))))
    exe = tmp_path / "mirror"
    subprocess.run([gxx, "-std=c++17", "-O0", f"-I{CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)
    rows = json.loads(subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                                     timeout=60).stdout)
    assert len(rows) == len(bms) * len(ks) * (WIDE_STAGES + 1)
    for bm, k, stages, streamed, depth, resident_bytes, streamed_bytes in rows:
        assert (bool(streamed), depth) == (wide_streamed(bm, k), wide_stages(bm, k))
        assert resident_bytes == wide_smem_bytes(bm, k, stages, False)
        assert streamed_bytes == wide_smem_bytes(bm, k, stages, True)
    # the limits the design states: resident up to K = 512 at 128-row strips, 1280 at 64
    assert [wide_streamed(64, k) for k in ks] == [False] * 4 + [True] * 3
    assert [wide_streamed(256, k) for k in ks] == [False] * 2 + [True] * 5


# ---- the routes ----

def test_loads_producer_route_takes_what_tma_cannot():
    """K = 60, N = 1020, an A base off 16 bytes and out= off 16 bytes each take
    'wgmma_wide_lsu', 2-D and batched, and give the plain version's values."""
    cfg = KernelConfig(bm=256, bn=512, bk=64)

    def off(t: torch.Tensor) -> torch.Tensor:
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for (m, n, k), a_off, out_off in (((300, 1024, 60), False, False),
                                      ((300, 1020, 64), False, False),
                                      ((300, 1024, 64), True, False),
                                      ((300, 1024, 64), False, True)):
        a_np, b_np = _draw(5, [(m, k), (k, n)], True)
        a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
        a = off(a) if a_off else a
        out = off(torch.zeros(m, n)) if out_off else None
        assert mm.launch_route(cfg, a, b, m, n, k, out) == "wgmma_wide_lsu"
        got = mm.cuda_matmul(a, b, cfg, out_dtype=torch.float32, out=out)
        assert torch.equal(got, torch.from_numpy(a_np @ b_np))
        if not (a_off or out_off):
            two = batched.cuda_batched_matmul(torch.stack([a, a]), torch.stack([b, b]), cfg,
                                              out_dtype=torch.float32)
            assert torch.equal(two[1], got)
    # the same shapes aligned take TMA
    a = torch.zeros(300, 64, dtype=torch.bfloat16)
    assert mm.launch_route(cfg, a, torch.zeros(64, 1024, dtype=torch.bfloat16), 300, 1024,
                           64, torch.zeros(300, 1024)) == "wgmma_wide"
