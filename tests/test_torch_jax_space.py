"""Every block edge of the JAX space in the port, against the JAX package on the CPU.

The JAX tuner's space (``tpul2.config.candidate_configs``) and its heuristic emit blocks the
port's first wide route did not take: the sublane edge 16 and the covers of M < 16 (bm 1, 2,
4, 8), N < 128 beside a wide bm (bn 1, 64), unaligned full-dim covers (1000, 200 x 300), bn
covers above 16384, and staged wide blocks (its kStage axis at 16 x 11008 x 4096).  The port
runs each as a ring block narrower than its tile, the swapped wide walk (bm <= 32), a wide
block of narrow or clipped columns, or the wide walk's staged sum (``csrc/tl2_wgmma*.cu``);
on the CPU its wrappers run the plain versions at the config's bk.  Here:

  - every JAX kernel candidate at the sample shapes validates in the port and is in its
    uncapped candidate set (``KernelConfig.from_jax``), in both families;
  - the JAX heuristic's config validates at decode sizes;
  - ``data/jax_decode_db.json`` (the DB copy chip_smoke.py's phase ``jax space`` dispatches
    the main path through) holds the JAX heuristic's configs at the decode shapes of
    Llama-3-8B's projections and of the flagship block at seq 16, and dispatch resolves each
    to itself;
  - parity with ``pallas_matmul*`` / ``pallas_batched_matmul`` / ``pallas_matmul_pipelined``
    in interpret mode, one shape per class, both families, 0/1 inputs exact and normal
    inputs within ``ops.matmul.allowed_error``;
  - the rows of the next block holding NaN leave a block's own rows exact;
  - the shared-memory model and the block rules against their C mirror
    (``csrc/tl2_wgmma_model.cuh``, built with g++).

No JAX timing loop.  ``PYTHONPATH=. python tests/test_torch_jax_space.py`` rewrites the data file.
"""

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpul2.config as jcfg
from tpul2.ops.batched import pallas_batched_matmul
from tpul2.ops.matmul import pallas_matmul_fused, pallas_matmul_tn
from tpul2.ops.pipelined import pallas_matmul_pipelined
from tpul2_torch import config as cfg_mod
from tpul2_torch import dispatch
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.config import KernelConfig, candidate_configs
from tpul2_torch.ops import batched
from tpul2_torch.ops import matmul as mm
from tpul2_torch.ops import pipelined as pl

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "tpul2_torch" / "csrc"
DECODE_DB = Path(__file__).resolve().parent / "data" / "jax_decode_db.json"

#: The shapes whose JAX space chip_smoke.py's phase ``jax space`` launches whole: decode
#: sizes of Llama-3-8B and Llama-2-7B, M = 48 (a cover of an M off the sublane), N = 1,
#: N = 64 at two heights, 1000^3, a thin-K bn cover above 16384 and a 32000-wide vocab.
SAMPLE_SHAPES = [(1, 4096, 4096), (8, 4096, 4096), (16, 11008, 4096), (32, 4096, 14336),
                 (48, 4096, 4096), (8192, 1, 4096), (1024, 64, 64), (12288, 64, 64),
                 (1000, 1000, 1000), (4096, 24576, 64), (64, 32000, 4096)]
ACCS = ("float32", "bfloat16")

#: Decode sizes, and the (N, K) of Llama-3-8B's q/o and FFN projections, Llama-2-7B's FFN,
#: the flagship block's square, an N below the lane and a vocab's width.
DECODE_M = (1, 2, 4, 8, 16, 24, 32, 48)
DECODE_NK = ((4096, 4096), (14336, 4096), (4096, 14336), (11008, 4096), (1024, 1024),
             (64, 4096), (32000, 4096))

#: The main path's shapes (batch, m, n, k): Llama-3-8B's projections at 1, 8, 16 and 32
#: requests, Llama-2-7B's FFN at 16, and the flagship block's GEMMs at seq 16 (d_model
#: 1024, d_ff 4096, 8 heads: qkv, the batched scores and mixing, the output projection,
#: FFN-1 and FFN-2).
DECODE_SHAPES = ([(1, m, n, k) for m in (1, 8, 16, 32)
                  for n, k in ((4096, 4096), (14336, 4096), (4096, 14336))]
                 + [(1, 16, 11008, 4096)])
BLOCK_SEQ16_SHAPES = [(1, 16, 3072, 1024), (8, 16, 16, 128), (8, 16, 128, 16),
                      (1, 16, 1024, 1024), (1, 16, 4096, 1024), (1, 16, 1024, 4096)]


def _port(c) -> KernelConfig:
    return KernelConfig.from_jax(dataclasses.asdict(c))


def decode_db_rows() -> list:
    """The JAX heuristic's config (``tpul2.config.heuristic_config``, as a port config) at
    every main-path shape, in both families."""
    rows = []
    for acc in ACCS:
        for batch, m, n, k in DECODE_SHAPES + BLOCK_SEQ16_SHAPES:
            cfg = _port(jcfg.heuristic_config(m, n, k, acc))
            rows.append({"batch": batch, "m": m, "n": n, "k": k, "acc": acc,
                         "config": dataclasses.asdict(cfg)})
    return rows


def _decode_db_json() -> str:
    return json.dumps({"source": "tpul2.config.heuristic_config at the decode shapes of "
                                 "Llama-3-8B (1/8/16/32 x 4096 x 4096, x 14336 x 4096, "
                                 "x 4096 x 14336), 16 x 11008 x 4096 and the flagship "
                                 "block's GEMMs at seq 16, through KernelConfig.from_jax; "
                                 "written by tests/test_torch_jax_space.py",
                       "rows": decode_db_rows()}, indent=1) + "\n"


# ---- the JAX space validates, and the port's candidate set holds it ----

@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("shape", SAMPLE_SHAPES, ids=["x".join(map(str, s)) for s in SAMPLE_SHAPES])
def test_jax_space_validates_and_the_port_holds_it(shape, acc):
    """Every kernel candidate of the JAX tuner (its kStage picks included) validates after
    from_jax and is in the port's uncapped candidate set; none is refused."""
    theirs = [c for c in jcfg.candidate_configs(*shape, acc_dtype=acc, max_candidates=10**6)
              if not c.use_xla]
    ours = set(candidate_configs(*shape, acc, max_candidates=10**6))
    refused = [(c, _port(c).validate()) for c in theirs if _port(c).validate()]
    missing = [c for c in theirs if _port(c) not in ours]
    assert theirs and not refused and not missing, (refused[:3], missing[:3])
    staged = {_port(c) for c in theirs if c.pipeline_depth}
    assert staged <= {c for c in ours if c.pipeline_depth}
    if shape == (16, 11008, 4096):  # JAX's kStage picks: the 16 x 11008 cover, bk 1024
        assert {(c.bm, c.bn, c.bk, c.pipeline_depth) for c in staged} == {(16, 11008, 1024, 2)}


@pytest.mark.parametrize("m", DECODE_M)
def test_jax_heuristic_validates_at_decode_sizes(m):
    stand_in = torch.zeros(8, dtype=torch.bfloat16)
    for n, k in DECODE_NK:
        for acc in ACCS:
            cfg = _port(jcfg.heuristic_config(m, n, k, acc))
            assert cfg.validate() is None, (m, n, k, acc, cfg)
            assert mm.launch_route(cfg, stand_in, stand_in, m, n, k) in (
                "wgmma", "wgmma_wide", "wgmma_wide_lsu")


# ---- the main path's DB copy ----

def test_decode_db_is_the_jax_heuristics_and_resolves_to_itself(tmp_path, monkeypatch):
    """The committed data is the JAX heuristic's configs at the main-path shapes, the
    block's shapes are those block_forward resolves at seq 16, and through a DB holding
    the rows every shape resolves to its own config, which validates."""
    assert DECODE_DB.read_text() == _decode_db_json()
    from tpul2_torch.models import block_forward, init_block
    seen = []
    real = dispatch.resolve_config

    def record(m, n, k, acc="float32", *args, **kwargs):
        seen.append((m, n, k))
        return real(m, n, k, acc, *args, **kwargs)

    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "empty.json"))
    db_mod.reset_default_db()
    monkeypatch.setattr(dispatch, "resolve_config", record)
    gen = torch.Generator().manual_seed(3)
    params = init_block(gen, 1024, 4096, device="cpu")
    block_forward(params, torch.randn(16, 1024, generator=gen).bfloat16(), 8)
    monkeypatch.setattr(dispatch, "resolve_config", real)
    assert seen == [s[1:] for s in BLOCK_SEQ16_SHAPES]

    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "decode_db.json"))
    db_mod.reset_default_db()
    db = db_mod.default_db()
    rows = json.loads(DECODE_DB.read_text())["rows"]
    for row in rows:
        db.put(row["m"], row["n"], row["k"], KernelConfig(**row["config"]), 0.0,
               acc=row["acc"], extra={"scope": "jax_heuristic"})
    db.save()
    db_mod.reset_default_db()
    for row in rows:
        cfg = KernelConfig(**row["config"])
        assert cfg.validate() is None
        assert dispatch.resolve_config(row["m"], row["n"], row["k"], row["acc"]) == cfg
    db_mod.reset_default_db()
    # the decode shapes take the new edges: bm 1, 8 and 16 beside wide bn (the swapped
    # walk) and the narrow ring blocks of the block's scores and mixing
    edges = {(r["config"]["bm"], r["config"]["bn"]) for r in rows}
    assert {(1, 512), (8, 512), (16, 512), (16, 16), (16, 128)} <= edges


# ---- parity with the JAX kernels, one shape per class ----

def _draw(seed: int, shapes, zero_one: bool) -> list:
    rng = np.random.default_rng(seed)
    if zero_one:
        return [rng.integers(0, 2, s).astype(np.float32) for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16(x: np.ndarray) -> tuple:
    t = torch.from_numpy(x).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _hold(ours, theirs, a, rhs, bk, acc, layout, zero_one, bias=None, act=None):
    diff = (ours.float() - theirs).abs()
    if zero_one:
        assert float(diff.max()) == 0.0
    else:
        tol = mm.allowed_error(a, rhs, bk, acc, layout, torch.float32, bias, act)
        assert bool((diff <= tol).all()), float((diff - tol).max())


#: (class, JAX block (bm, bn, bk), shape (m, n, k), layout, activation, the port's variant
#: counters): each a block of the JAX space at its own shape.
CLASSES = {
    "bm16-ring": ((16, 128, 128), (48, 200, 256), "kn", "gelu",
                  ["swapped", "ring_narrow"]),
    "bm8-ring-cover": ((8, 128, 128), (8, 200, 384), "nk", None,
                       ["swapped", "ring_narrow"]),
    "bm16-wide": ((16, 512, 128), (32, 600, 256), "nk", "relu",
                  ["wide_streamed", "wide_swapped"]),
    "bm8-wide-cover": ((8, 512, 256), (8, 1024, 512), "kn", None,
                       ["wide_streamed", "wide_swapped"]),
    "bm1-cover": ((1, 256, 128), (1, 300, 384), "kn", None,
                  ["wide_streamed", "wide_swapped"]),
    "bn1-beside-wide-bm": ((256, 1, 128), (300, 1, 256), "kn", None,
                           ["wide_narrow_n"]),
    "bn64-beside-wide-bm": ((256, 64, 64), (512, 64, 64), "nk", "relu",
                            ["wide_narrow_n"]),
    "unaligned-covers-200x300": ((200, 300, 128), (200, 300, 256), "kn", "silu",
                                 ["wide_clipped"]),
    "bn-above-16384-thin-k": ((16, 16512, 64), (16, 16512, 64), "kn", None,
                              ["wide_streamed", "wide_swapped",
                               "wide_long"]),
}


@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("name", list(CLASSES))
def test_parity_with_pallas_per_class(name, acc):
    (bm, bn, bk), (m, n, k), layout, act, variants = CLASSES[name]
    jax_cfg = jcfg.KernelConfig(bm=bm, bn=bn, bk=bk, acc_dtype=acc, rhs_layout=layout)
    in_space = jcfg.assign_vmem_limit(jax_cfg, m, n, k)  # a block of the JAX space
    assert in_space is not None and in_space.validate(shape=(m, n, k)) is None
    cfg = _port(jax_cfg)
    assert cfg.validate() is None and mm.launch_variants(cfg, k) == variants
    for seed, zero_one in ((31, True), (32, False)):
        a_np, b_np, bias_np = _draw(seed, [(m, k), (k, n), (n,)], zero_one)
        (a, a_j), (b, b_j) = _bf16(a_np), _bf16(b_np)
        bias = torch.from_numpy(bias_np) if act else None
        rhs = b.t().contiguous() if layout == "nk" else b
        if act is None and layout == "nk":
            theirs = pallas_matmul_tn(a_j, jnp.swapaxes(b_j, 0, 1), jax_cfg,
                                      out_dtype=jnp.float32)
            ours = mm.cuda_matmul_tn(a, rhs, cfg, out_dtype=torch.float32)
        else:
            theirs = pallas_matmul_fused(a_j, b_j, None if bias is None else jnp.asarray(bias_np),
                                         act, jax_cfg, out_dtype=jnp.float32)
            ours = mm.cuda_matmul_fused(a, b, bias=bias, activation=act, config=cfg,
                                        out_dtype=torch.float32)
        _hold(ours, _np(theirs), a, rhs, cfg.bk, acc, layout, zero_one, bias, act)


@pytest.mark.parametrize("acc", ACCS)
def test_parity_staged_wide_16x512_depth_2(acc):
    """A staged wide block of the swapped walk (bm 16, bn 512, depth 2) against
    pallas_matmul_pipelined: one f32 sum over all of K in both families, no split."""
    m, n, k = 16, 1024, 1024
    jax_cfg = jcfg.KernelConfig(bm=16, bn=512, bk=256, acc_dtype=acc, pipeline_depth=2)
    cfg = _port(jax_cfg)
    assert cfg.wide and cfg.validate() is None
    stand_in = torch.zeros(8, dtype=torch.bfloat16)
    assert pl.staged_route(cfg, stand_in, stand_in, m, n, k) == "wgmma_wide_lsu"
    for seed, zero_one in ((33, True), (34, False)):
        a_np, b_np = _draw(seed, [(m, k), (k, n)], zero_one)
        (a, a_j), (b, b_j) = _bf16(a_np), _bf16(b_np)
        theirs = _np(pallas_matmul_pipelined(a_j, b_j, jax_cfg, out_dtype=jnp.float32))
        ours = pl.cuda_matmul_pipelined(a, b, cfg, out_dtype=torch.float32)
        _hold(ours, theirs, a, b, k, "float32", "kn", zero_one)


@pytest.mark.parametrize("acc", ACCS)
def test_parity_batched_bm16(acc):
    """A batched narrow ring block (bm 16, bn 128: the decode scores' shape class) against
    pallas_batched_matmul, gk 2."""
    bt, m, n, k = 3, 16, 300, 256
    jax_cfg = jcfg.KernelConfig(bm=16, bn=128, bk=128, acc_dtype=acc)
    cfg = _port(jax_cfg)
    for seed, zero_one in ((35, True), (36, False)):
        a_np, b_np = _draw(seed, [(bt, m, k), (bt, k, n)], zero_one)
        (a, a_j), (b, b_j) = _bf16(a_np), _bf16(b_np)
        theirs = _np(pallas_batched_matmul(a_j, b_j, jax_cfg, out_dtype=jnp.float32))
        ours = batched.cuda_batched_matmul(a, b, cfg, out_dtype=torch.float32)
        _hold(ours, theirs, a, b, cfg.bk, acc, "kn", zero_one)


# ---- the next block's rows hold NaN ----

@pytest.mark.parametrize("block", [(16, 128), (16, 512), (48, 64), (200, 256)])
def test_next_block_nan_rows_leave_a_block_exact(block):
    """A's rows of the second block are NaN: the first block's rows of C are exact (a row
    of the product depends only on its row of A, which is why the tile's rows beyond the
    block may read the next block's rows), the second block's are NaN (a row is never
    stored by the wrong block's CTA with a value of its own).  The kernel's version of
    this test is tests/test_torch_gpu.py's."""
    bm, bn = block
    m, n, k = 2 * bm, 600, 256
    a_np, b_np = _draw(37, [(m, k), (k, n)], True)
    a, b = torch.from_numpy(a_np).bfloat16(), torch.from_numpy(b_np).bfloat16()
    a[bm:] = float("nan")
    got = mm.cuda_matmul(a, b, KernelConfig(bm=bm, bn=bn, bk=128), out_dtype=torch.float32)
    assert torch.equal(got[:bm], torch.from_numpy(a_np[:bm] @ b_np))
    assert bool(torch.isnan(got[bm:]).all())


# ---- the model and the rules against their C mirror ----

_MIRROR = r"""
#include <cstdio>
#include "tl2_wgmma_model.cuh"
using namespace tl2wg;
int main() {
  const int edges[] = {EDGES};
  const int ks[] = {KS};
  std::printf("{\"ring\": [");
  bool first = true;
  for (int bm = 1; bm <= 128; ++bm)
    for (int bn = 1; bn <= 128; bn += 9) {
      std::printf("%s[%d,%d,%d,%d,%d,%d]", first ? "" : ",", bm, bn, ring_edge(bm),
                  carry_stages(bm, bn), smem_bytes(bm, bn, carry_stages(bm, bn)),
                  smem_bytes(bm, bn, 8));
      first = false;
    }
  std::printf("], \"wide\": [");
  first = true;
  for (int bm : edges)
    for (int k : ks)
      for (int stages = 0; stages <= MAX_STAGES; ++stages) {
        std::printf("%s[%d,%d,%d,%d,%d,%d,%d,%d,%d]", first ? "" : ",", bm, k, stages,
                    wide_sub_m(bm), (int)wide_streamed(bm, k), wide_stages(bm, k),
                    wide_smem_bytes(bm, k, stages, false), wide_smem_bytes(bm, k, stages, true),
                    (int)wide_staged_ok(bm, stages));
        first = false;
      }
  std::printf("], \"grid\": [");
  first = true;
  for (int m : edges)
    for (int bm : edges)
      for (int bn : edges) {
        std::printf("%s[%d,%d,%d,%d,%d]", first ? "" : ",", m, bm, bn,
                    (int)wide_block_ok(bm, bn), (int)wide_c_grid(m, m + 7, bm, bn));
        first = false;
      }
  std::printf("]}\n");
  return 0;
}
"""


def test_model_and_rules_equal_their_c_mirror(tmp_path):
    """``config.ring_edge`` / ``carry_stages`` / ``wgmma_smem_bytes`` at every ring block,
    ``wide_sub_m`` / ``wide_streamed`` / ``wide_stages`` / ``wide_smem_bytes`` (both modes,
    every depth, the swapped walk's height included), the staged wide block's fit,
    ``validate``'s wide block rule and ``wide_c_grid`` against tl2_wgmma_model.cuh, which
    the kernels' launchers and routes use."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the C mirror"
    edges = (1, 8, 16, 32, 33, 48, 64, 65, 100, 128, 129, 200, 256, 1000, 11008, 16384,
             16512, 32768, 32769)
    ks = (64, 512, 576, 1280, 1344, 4096, 16384)
    src = tmp_path / "mirror.cpp"
    src.write_text(_MIRROR.replace("EDGES", ", ".join(map(str, edges)))
                   .replace("KS", ", ".join(map(str, ks))))
    exe = tmp_path / "mirror"
    subprocess.run([gxx, "-std=c++17", "-O1", f"-I{CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)
    got = json.loads(subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                                    timeout=60).stdout)
    for bm, bn, edge, stages, carry_bytes, staged_bytes in got["ring"]:
        assert edge == cfg_mod.ring_edge(bm) and stages == cfg_mod.carry_stages(bm, bn)
        assert carry_bytes == KernelConfig(bm=bm, bn=bn).smem_bytes()
        assert staged_bytes == cfg_mod.wgmma_smem_bytes(bm, bn, 8)
    for bm, k, stages, sub_m, streamed, depth, resident, stream, staged_ok in got["wide"]:
        assert (sub_m, bool(streamed), depth) == (
            cfg_mod.wide_sub_m(bm), cfg_mod.wide_streamed(bm, k), cfg_mod.wide_stages(bm, k))
        assert resident == cfg_mod.wide_smem_bytes(bm, k, stages, False)
        assert stream == cfg_mod.wide_smem_bytes(bm, k, stages, True)
        if stages in cfg_mod.PIPELINE_DEPTHS[1:] and bm <= cfg_mod.WIDE_BM_MAX:
            staged = KernelConfig(bm=bm, bn=16384 if bm <= 128 else 128, pipeline_depth=stages)
            assert bool(staged_ok) == (staged.validate() is None)
    for m, bm, bn, ok, c_grid in got["grid"]:
        if cfg_mod.is_wide(bm, bn):
            assert bool(ok) == (KernelConfig(bm=bm, bn=bn, bk=64).validate() is None)
        assert bool(c_grid) == cfg_mod.wide_c_grid(m, m + 7, bm, bn)
    # the swapped walk streams A always, in 20 KB stages, with no C staging
    assert cfg_mod.wide_smem_bytes(16, 4096, 4, True) == 1024 + 4 * 160 * 128 + 10 * 8


if __name__ == "__main__":
    DECODE_DB.parent.mkdir(parents=True, exist_ok=True)
    DECODE_DB.write_text(_decode_db_json())
    print(f"wrote {DECODE_DB} ({len(decode_db_rows())} rows)", file=sys.stderr)
