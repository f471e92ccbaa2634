"""The wide walk's schedule: a launch's work items spread over persistent CTAs.

On the card a wide launch (``csrc/tl2_wgmma_wide.cuh``) deals its work items, one per
128-column sub-tile of each strip of each block of each batch element, out to
G = min(items, SMs) CTAs in contiguous runs; each item is one sub-tile summed over all of K
inside one CTA, so the output's bits do not depend on G (chip_smoke.py compares the bits of
two counts launch by launch).  Here, with no card:

  - ``config.wide_walk`` / ``wide_item`` / ``wide_first`` / ``wide_strips`` /
    ``wide_ctas`` against their C mirror in ``csrc/tl2_wgmma_model.cuh``, built with g++;
  - over the JAX space's wide blocks at its sample shapes and the timed rows' shapes (both
    rasters, batched, swapped, clipped and narrow), the CTAs' runs cover every item once,
    differ by at most one item, their strip segments walk every non-empty item once, and
    the non-empty items' stored sub-tiles tile C exactly;
  - a CPU emulation of the walk assembles C segment by segment from the plain version's product of
    each item's sub-tile (its rows and columns beyond the block's edge read, as the kernel
    reads them, and not stored): it equals the plain version bit for bit at every CTA count,
    also when the next block's rows hold NaN, and equals the JAX kernel (interpret mode) on
    small integers.

No JAX timing loop.
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
from tpul2.ops.matmul import pallas_matmul_fused
from tpul2_torch.config import (NUM_SMS, WIDE_SUB_N, WIDE_THIN_K, KernelConfig,
                                candidate_configs, wide_ctas, wide_first, wide_item,
                                wide_streamed, wide_streams, wide_strips, wide_sub_m,
                                wide_walk)
from tpul2_torch.ops import matmul as mm
from tpul2_torch.utils.padding import cdiv

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

CSRC = Path(__file__).resolve().parent.parent / "tpul2_torch" / "csrc"

#: (m, n, bm, bn, batch, raster_nm): the timed rows' launches (one block of 1024 x 2048,
#: 1024^3, the 1000^3 cover, 16384 x 256, batched 4 x 1024 x 2048, the staged 16 x 11008,
#: the swapped 1 x 512 and 16 x 256, bn 24576, the loads producer's 256 x 1024, 12288^3 at
#: 512 x 2048, the thin-K stripes) and edges: narrow columns, blocks of unaligned edges,
#: bn of 1, a 48-row swapped-height cover, the column raster, batched edge blocks.
WALKS = [(1024, 2048, 1024, 2048, 1, 0), (1024, 1024, 1024, 1024, 1, 0),
         (1000, 1000, 1000, 1000, 1, 0), (16384, 256, 16384, 256, 1, 0),
         (1024, 2048, 1024, 2048, 4, 0), (16, 11008, 16, 11008, 1, 0),
         (1, 4096, 1, 512, 1, 0), (16, 11008, 16, 256, 1, 1), (4096, 24576, 128, 24576, 1, 0),
         (4096, 4096, 256, 1024, 1, 1), (12288, 12288, 512, 2048, 1, 0),
         (16384, 16384, 128, 2048, 1, 0), (8192, 8192, 128, 1024, 1, 0),
         (1024, 64, 256, 64, 1, 0), (300, 520, 256, 256, 3, 1), (200, 264, 64, 256, 2, 0),
         (2048, 1001, 256, 300, 1, 1), (8192, 1, 2048, 1, 1, 0), (48, 32000, 48, 32000, 1, 0),
         (1000, 1000, 200, 300, 1, 0), (8, 4096, 16, 4096, 1, 0), (100, 600, 33, 129, 2, 1)]


def _ids(cases) -> list:
    return ["x".join(map(str, c)) for c in cases]


def _counts(walk) -> list:
    """The rule's CTA count, one CTA per block (the walk before the schedule), one, and a
    few that split blocks and strips off their edges."""
    blocks = walk.items // (walk.strips * walk.cols)  # over the batch
    rule = min(walk.items, NUM_SMS)  # wide_ctas
    return sorted({c for c in (rule, blocks, 1, 3, 7, 100, walk.items) if c <= walk.items})


# ---- the mirror against the C model ----

_MIRROR = r"""
#include <cstdio>
#include "tl2_wgmma_model.cuh"
using namespace tl2wg;
const int cases[][6] = {CASES};
const long long item_q[][2] = {ITEMS};     // (case, item)
const long long first_q[][3] = {FIRSTS};   // (case, ctas, cta)
// CTA c's strip segments at `ctas` CTAs, as for_each_strip walks them: [ctas, c, item, end]
bool segments(const WideWalk& w, int ctas, bool first) {
  for (int c = 0; c < ctas; ++c) {
    const long long last = wide_first(w.items, ctas, c + 1);
    WideItem t;
    int end;
    for (long long i = wide_first(w.items, ctas, c); i < last;) {
      const long long at = i;
      i = wide_segment(w, i, last, t, end);
      if (t.col < end) {
        std::printf("%s[%d, %d, %lld, %d]", first ? "" : ",", ctas, c, at, end);
        first = false;
      }
    }
  }
  return first;
}
int main() {
  std::printf("{\"walks\": [");
  for (unsigned c = 0; c < sizeof(cases) / sizeof(cases[0]); ++c) {
    const int* x = cases[c];
    const WideWalk w = wide_walk(x[0], x[1], x[2], x[3], x[4], x[5]);
    std::printf("%s[%d, %d, %d, %d, %d, %lld, %d]", c ? "," : "", w.sm, w.blocks_m,
                w.blocks_n, w.strips, w.cols, w.items, wide_ctas(w.items, SMS));
  }
  std::printf("], \"segments\": [");
  for (unsigned c = 0; c < sizeof(cases) / sizeof(cases[0]); ++c) {
    const int* x = cases[c];
    const WideWalk w = wide_walk(x[0], x[1], x[2], x[3], x[4], x[5]);
    std::printf("%s[", c ? "," : "");
    const bool first = segments(w, wide_ctas(w.items, SMS), true);
    if (w.items >= 7) segments(w, 7, first);
    std::printf("]");
  }
  std::printf("], \"streams\": [");
  const int bms[] = {1, 16, 48, 64, 100, 128, 1000, 16384};
  const int ks[] = {32, 60, 64, 128, 129, 192, 256, 512, 576, 1280, 1344};
  bool first_mode = true;
  for (int bm : bms)
    for (int k : ks)
      for (int tma_a = 0; tma_a < 2; ++tma_a) {
        std::printf("%s[%d, %d, %d, %d]", first_mode ? "" : ",", bm, k, tma_a,
                    (int)wide_streams(bm, k, tma_a != 0));
        first_mode = false;
      }
  std::printf("], \"items\": [");
  for (unsigned q = 0; q < sizeof(item_q) / sizeof(item_q[0]); ++q) {
    const int* x = cases[item_q[q][0]];
    const WideItem t = wide_item(wide_walk(x[0], x[1], x[2], x[3], x[4], x[5]), item_q[q][1]);
    std::printf("%s[%d, %d, %d, %d, %d, %d, %d, %d, %d, %d, %d]", q ? "," : "", t.z, t.block,
                t.m_blk, t.n_blk, t.strip, t.col, t.m_lim, t.n_lim, t.strips, t.cols,
                (int)t.empty);
  }
  std::printf("], \"firsts\": [");
  for (unsigned q = 0; q < sizeof(first_q) / sizeof(first_q[0]); ++q) {
    const int* x = cases[first_q[q][0]];
    const WideWalk w = wide_walk(x[0], x[1], x[2], x[3], x[4], x[5]);
    std::printf("%s%lld", q ? "," : "", wide_first(w.items, (int)first_q[q][1],
                                                   (int)first_q[q][2]));
  }
  std::printf("]}\n");
  return 0;
}
"""


def _queries() -> tuple:
    """(case, item) and (case, ctas, cta) queries: per walk its first, last and ~200 items
    spread between, and the runs' first items at 1, 7, the rule's and one CTA an item
    (a sample of CTAs where there are many)."""
    items, firsts = [], []
    for c, (m, n, bm, bn, batch, raster) in enumerate(WALKS):
        walk = wide_walk(m, n, bm, bn, batch, raster)
        for i in np.unique(np.linspace(0, walk.items - 1, 200).astype(np.int64)):
            items.append((c, int(i)))
        for ctas in (1, 7, min(walk.items, NUM_SMS), walk.items):
            if ctas > walk.items:
                continue
            for cta in np.unique(np.linspace(0, ctas, 60).astype(np.int64)):
                firsts.append((c, ctas, int(cta)))
    return items, firsts


@pytest.fixture(scope="module")
def mirror(tmp_path_factory) -> dict:
    """The C mirror's answers to ``_queries`` and its strip segments, built once with g++."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build the C mirror"
    items, firsts = _queries()

    def arr(rows) -> str:
        return ", ".join("{" + ", ".join(map(str, r)) + "}" for r in rows)

    tmp = tmp_path_factory.mktemp("walk")
    src = tmp / "walk.cpp"
    src.write_text(_MIRROR.replace("CASES", arr(WALKS)).replace("ITEMS", arr(items))
                   .replace("FIRSTS", arr(firsts)).replace("SMS", str(NUM_SMS)))
    exe = tmp / "walk"
    subprocess.run([gxx, "-std=c++17", "-O1", f"-I{CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)
    got = json.loads(subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                                    timeout=60).stdout)
    return {"got": got, "items": items, "firsts": firsts}


def test_walk_equals_its_c_mirror(mirror):
    """``wide_walk``, ``wide_item``, ``wide_first`` and ``wide_ctas`` (at the H100's 132 SMs)
    against ``tl2_wgmma_model.cuh``'s, which the kernel and its launcher use, at every case
    of WALKS: the walk's sizes, sampled items (the first and the last among them) and the
    runs' first items at 1, 7, the rule's count and one CTA an item; and ``wide_streams``,
    the launch's A mode, at heights and depths either side of its limits."""
    got, items, firsts = mirror["got"], mirror["items"], mirror["firsts"]
    walks = [wide_walk(m, n, bm, bn, batch, raster) for m, n, bm, bn, batch, raster in WALKS]
    assert got["walks"] == [[w.sub_m, w.blocks_m, w.blocks_n, w.strips, w.cols, w.items,
                             wide_ctas(m, n, bm, bn, batch)]
                            for w, (m, n, bm, bn, batch, _) in zip(walks, WALKS)]
    for bm, k, tma_a, streams in got["streams"]:
        assert bool(streams) == wide_streams(bm, k, bool(tma_a)), (bm, k, tma_a)
    assert len(got["items"]) == len(items) and len(got["firsts"]) == len(firsts)
    for (c, i), c_item in zip(items, got["items"]):
        z, block, strip, col, m_blk, n_blk, m_lim, n_lim, empty = wide_item(walks[c], i)
        assert c_item == [z, block, m_blk, n_blk, strip, col, m_lim, n_lim,
                          cdiv(m_lim - m_blk, walks[c].sub_m), cdiv(n_lim - n_blk, WIDE_SUB_N),
                          int(empty)], (WALKS[c], i)
    for (c, ctas, cta), first in zip(firsts, got["firsts"]):
        assert first == wide_first(walks[c].items, ctas, cta), (WALKS[c], ctas, cta)
    assert any(row[-1] for row in got["items"])  # edge blocks' empty items among them


@pytest.mark.parametrize("case", range(len(WALKS)), ids=_ids(WALKS))
def test_strip_segments_equal_their_c_mirror(mirror, case):
    """``wide_strips`` against the kernel's walk (``for_each_strip`` over
    ``tl2wg::wide_segment``) at the rule's count and at 7 CTAs: every CTA's segments, their
    first items and end columns."""
    m, n, bm, bn, batch, raster = WALKS[case]
    walk = wide_walk(m, n, bm, bn, batch, raster)
    counts = [wide_ctas(m, n, bm, bn, batch)] + ([7] if walk.items >= 7 else [])
    want = [[ctas, c, i, end] for ctas in counts for c in range(ctas)
            for i, end in wide_strips(walk, ctas, c)]
    assert mirror["got"]["segments"][case] == want
    assert want


# ---- the runs cover every item once ----

def _decode_all(walk) -> dict:
    """Every item of the walk decoded at once (numpy: the same arithmetic as
    ``wide_item``, checked against it on a sample)."""
    i = np.arange(walk.items, dtype=np.int64)
    per_block = walk.strips * walk.cols
    bi, rest = np.divmod(i, per_block)
    z, block = np.divmod(bi, walk.blocks_m * walk.blocks_n)
    strip, col = np.divmod(rest, walk.cols)
    if walk.raster_nm:
        bn_i, bm_i = np.divmod(block, walk.blocks_m)
    else:
        bm_i, bn_i = np.divmod(block, walk.blocks_n)
    m_blk, n_blk = bm_i * walk.bm, bn_i * walk.bn
    m_lim = np.minimum(walk.m, m_blk + walk.bm)
    n_lim = np.minimum(walk.n, n_blk + walk.bn)
    empty = ((strip >= -(-(m_lim - m_blk) // walk.sub_m))
             | (col >= -(-(n_lim - n_blk) // WIDE_SUB_N)))
    for j in np.unique(np.linspace(0, walk.items - 1, 9).astype(np.int64)):
        assert wide_item(walk, int(j)) == (z[j], block[j], strip[j], col[j], m_blk[j],
                                           n_blk[j], m_lim[j], n_lim[j], bool(empty[j]))
    r0 = m_blk + strip * walk.sub_m
    c0 = n_blk + col * WIDE_SUB_N
    return {"z": z, "r0": r0, "c0": c0, "r1": np.minimum(r0 + walk.sub_m, m_lim),
            "c1": np.minimum(c0 + WIDE_SUB_N, n_lim), "m_blk": m_blk, "n_blk": n_blk,
            "m_lim": m_lim, "n_lim": n_lim, "empty": empty}


def _check_cover(walk, batch: int, segments: bool = True) -> None:
    """The runs at each of ``_counts`` partition [0, items) into runs that differ by at most
    one item, and (``segments``) the CTAs' strip segments walk every non-empty item once,
    in order, each within one strip; the non-empty items' stored sub-tiles lie in their own
    block, start at distinct places and add up to the whole output, so they tile C exactly;
    and where C is small, a count of stores per element is 1 everywhere."""
    d = _decode_all(walk)
    live = ~d["empty"]
    for ctas in _counts(walk):
        firsts = np.array([wide_first(walk.items, ctas, c) for c in range(ctas + 1)])
        sizes = np.diff(firsts)
        assert firsts[0] == 0 and firsts[-1] == walk.items
        assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1, (walk, ctas)
        if not segments:
            continue
        walked = []
        for c in range(ctas):
            for i, end in wide_strips(walk, ctas, c):
                col = i % walk.cols
                assert firsts[c] <= i and i + end - col <= firsts[c + 1] and end > col
                assert end <= walk.cols
                walked.extend(range(i, i + end - col))
        assert walked == np.flatnonzero(live).tolist(), (walk, ctas)
    for key in d:
        d[key] = d[key][live]
    assert (d["r0"] >= d["m_blk"]).all() and (d["r1"] <= d["m_lim"]).all()
    assert (d["c0"] >= d["n_blk"]).all() and (d["c1"] <= d["n_lim"]).all()
    assert (d["r1"] > d["r0"]).all() and (d["c1"] > d["c0"]).all()
    origins = d["z"] * (walk.m * walk.n) + d["r0"] * walk.n + d["c0"]
    assert len(np.unique(origins)) == len(origins)
    area = ((d["r1"] - d["r0"]) * (d["c1"] - d["c0"])).sum()
    assert area == batch * walk.m * walk.n
    if batch * walk.m * walk.n <= 1 << 22:
        stores = np.zeros((batch, walk.m, walk.n), np.int32)
        for z, r0, r1, c0, c1 in zip(d["z"], d["r0"], d["r1"], d["c0"], d["c1"]):
            stores[z, r0:r1, c0:c1] += 1
        assert (stores == 1).all()


@pytest.mark.parametrize("case", WALKS, ids=_ids(WALKS))
def test_runs_cover_every_item_once(case):
    m, n, bm, bn, batch, raster = case
    _check_cover(wide_walk(m, n, bm, bn, batch, raster), batch)


#: The JAX space's sample shapes (tests/test_torch_jax_space.py's, which chip_smoke.py's
#: phase jax space launches whole).
SPACE_SHAPES = [(1, 4096, 4096), (8, 4096, 4096), (16, 11008, 4096), (32, 4096, 14336),
                (48, 4096, 4096), (8192, 1, 4096), (1024, 64, 64), (12288, 64, 64),
                (1000, 1000, 1000), (4096, 24576, 64), (64, 32000, 4096)]


@pytest.mark.parametrize("shape", SPACE_SHAPES, ids=_ids(SPACE_SHAPES))
def test_runs_cover_the_jax_spaces_wide_blocks(shape):
    """Every distinct wide block of the port's uncapped candidate space at the shape (the
    JAX space's, both families' edges), in both rasters."""
    m, n, k = shape
    blocks = {(c.bm, c.bn) for acc in ("float32", "bfloat16")
              for c in candidate_configs(m, n, k, acc, max_candidates=10**6)
              if not c.use_vendor and c.wide}
    assert blocks
    for bm, bn in sorted(blocks):
        for raster in (0, 1):
            _check_cover(wide_walk(m, n, bm, bn, 1, raster), 1, segments=False)


@pytest.mark.parametrize("bm", [64, 128, 256, 16384])
def test_thin_k_streams_a_only_where_tma_reads_it(bm):
    """The launch's A mode (``wide_streams``, counted by ``ops.matmul.launch_variants``):
    at K <= WIDE_THIN_K A streams where TMA reads it and stays resident where the loads
    producer gathers it; above, the strip's fit alone decides (``wide_streamed``)."""
    cfg = KernelConfig(bm=bm, bn=1024, bk=64)
    for k in (8, 60, 64, 128, 129, 192, 256, 512, 576, 4096):
        for tma_a in (False, True):
            streams = wide_streams(bm, k, tma_a)
            assert streams == (wide_streamed(bm, k) or (tma_a and k <= WIDE_THIN_K))
            assert ("wide_streamed" in mm.launch_variants(cfg, k, tma_a)) == streams
        assert not wide_streamed(bm, k) or k > 512  # resident by fit up to 512 at least
    assert wide_streams(bm, 64, True) and not wide_streams(bm, 64, False)
    assert not wide_streams(bm, 256, True)


def test_rule_fills_the_card_where_the_items_allow():
    """The rule's counts at the timed rows (132 SMs): one-block launches now reach 64 to
    132 CTAs; the swapped and staged blocks have one strip, so their columns bound them."""
    assert [wide_ctas(m, n, bm, bn, batch) for m, n, bm, bn, batch in (
        (1024, 2048, 1024, 2048, 1), (1024, 1024, 1024, 1024, 1), (1000, 1000, 1000, 1000, 1),
        (16384, 256, 16384, 256, 1), (1024, 2048, 1024, 2048, 4), (16, 11008, 16, 11008, 1),
        (1, 4096, 1, 512, 1), (16, 11008, 16, 256, 1), (4096, 24576, 128, 24576, 1),
        (4096, 4096, 256, 1024, 1), (12288, 12288, 512, 2048, 1))] == [
        128, 64, 64, 132, 132, 86, 32, 86, 132, 132, 132]
    assert [wide_walk(*w).items for w in ((16384, 256, 16384, 256), (1024, 2048, 1024, 2048, 4),
                                          (4096, 24576, 128, 24576), (4096, 4096, 256, 1024),
                                          (12288, 12288, 512, 2048))] == [
        256, 512, 6144, 1024, 9216]


def test_resident_runs_load_each_strip_once():
    """At 16384 x 16384 x 64 on 128 x 2048 blocks (a resident A; 16384 items, 124 or 125 a
    CTA, 16 columns a strip) each CTA walks its run in 8 or 9 strip segments, each of
    another strip, so its A is loaded once per strip of the run."""
    walk = wide_walk(16384, 16384, 128, 2048)
    ctas = wide_ctas(16384, 16384, 128, 2048)
    assert not wide_streamed(128, 64)
    for c in range(ctas):
        strips = [i // walk.cols for i, _ in wide_strips(walk, ctas, c)]
        assert len(set(strips)) == len(strips) and len(strips) in (8, 9)


# ---- the walk emulated on the CPU ----

def _emulate(a, rhs, cfg: KernelConfig, batch: int, ctas: int) -> torch.Tensor:
    """C assembled as the kernel does, CTA by CTA: each CTA's run one strip segment at a
    time (``wide_strips``), each item the plain version's product of its whole sub-tile
    (``sub_m`` rows of A from the strip's first, 128 columns of the RHS from the column's
    first, beyond the block's edge too: the next block's rows and columns, zeros past the
    problem), stored within the block's and the problem's edges.  C starts as NaN, so an
    element no item stores shows."""
    m, k = a.shape[-2:]
    n = rhs.shape[-2] if cfg.rhs_layout == "nk" else rhs.shape[-1]
    walk = wide_walk(m, n, cfg.bm, cfg.bn, batch, cfg.grid_order == "nm")
    a3 = a.reshape(batch, m, k)
    r3 = rhs.reshape(batch, *rhs.shape[-2:])
    a_pad = torch.cat([a3, a3.new_zeros(batch, walk.sub_m, k)], dim=1)
    if cfg.rhs_layout == "nk":
        r_pad = torch.cat([r3, r3.new_zeros(batch, WIDE_SUB_N, k)], dim=1)
    else:
        r_pad = torch.cat([r3, r3.new_zeros(batch, k, WIDE_SUB_N)], dim=2)
    c = torch.full((batch, m, n), float("nan"))
    for cta in range(ctas):
        for i, end in wide_strips(walk, ctas, cta):
            z, _, strip, col0, m_blk, n_blk, m_lim, n_lim, _ = wide_item(walk, i)
            r0 = m_blk + strip * walk.sub_m
            sub_a = a_pad[z, r0:r0 + walk.sub_m]
            r1 = min(r0 + walk.sub_m, m_lim)
            for col in range(col0, end):
                c0 = n_blk + col * WIDE_SUB_N
                sub_r = (r_pad[z, c0:c0 + WIDE_SUB_N] if cfg.rhs_layout == "nk"
                         else r_pad[z, :, c0:c0 + WIDE_SUB_N])
                tile = mm.matmul_reference(sub_a, sub_r, cfg.bk, cfg.acc_dtype,
                                           cfg.rhs_layout, out_dtype=torch.float32)
                c1 = min(c0 + WIDE_SUB_N, n_lim)
                c[z, r0:r1, c0:c1] = tile[:r1 - r0, :c1 - c0]
    return c.reshape(*a.shape[:-2], m, n)


def _ints(seed: int, shape, lo: int = -8, hi: int = 9) -> torch.Tensor:
    """Small integers as bf16: every f32 sum below is exact, so the plain version's bits do
    not depend on how the CPU's GEMM orders its adds, and the bf16 carry's roundings (sums
    past 256) are the same on every side."""
    return torch.from_numpy(np.random.default_rng(seed).integers(lo, hi, shape)
                            .astype(np.float32)).bfloat16()


#: (batch, m, n, k, cfg kwargs): the bf16 carry over three intervals and a mid-stage bk,
#: the f32 sum, 'nk', the column raster, a clipped cover, narrow columns, the swapped walk
#: (bm 16 and 1), a block of unaligned edges inside the sub-tiles, batched edge blocks.
EMULATED = [(1, 300, 520, 384, dict(bm=256, bn=256, bk=128, acc_dtype="bfloat16")),
            (1, 300, 520, 320, dict(bm=256, bn=256, bk=96, acc_dtype="bfloat16")),
            (1, 200, 300, 256, dict(bm=200, bn=300, bk=256, rhs_layout="nk")),
            (1, 260, 640, 192, dict(bm=128, bn=256, bk=64, grid_order="nm",
                                    acc_dtype="bfloat16")),
            (1, 520, 64, 128, dict(bm=256, bn=64, bk=128)),
            (1, 40, 700, 256, dict(bm=16, bn=256, bk=128, acc_dtype="bfloat16")),
            (1, 3, 600, 128, dict(bm=1, bn=512, bk=128)),
            (1, 150, 400, 160, dict(bm=100, bn=200, bk=64, rhs_layout="nk")),
            (3, 130, 300, 192, dict(bm=64, bn=256, bk=64, acc_dtype="bfloat16"))]


@pytest.mark.parametrize("case", EMULATED, ids=[f"{c[0]}x{c[1]}x{c[2]}x{c[3]}-{c[4]['bm']}x"
                                                f"{c[4]['bn']}" for c in EMULATED])
def test_emulated_walk_equals_the_plain_version_at_every_count(case):
    """Every count of ``_counts`` (the rule's, one CTA a block, 1, 3, 7, 100 and one an
    item) assembles the plain version's bits, through the bf16 carry's rounding points."""
    batch, m, n, k, kw = case
    cfg = KernelConfig(**kw)
    assert cfg.wide and cfg.validate() is None
    lead = (batch,) if batch > 1 else ()
    a = _ints(1, (*lead, m, k))
    rhs = _ints(2, (*lead, n, k) if cfg.rhs_layout == "nk" else (*lead, k, n))
    want = mm.matmul_reference(a, rhs, cfg.bk, cfg.acc_dtype, cfg.rhs_layout,
                               out_dtype=torch.float32)
    walk = wide_walk(m, n, cfg.bm, cfg.bn, batch, cfg.grid_order == "nm")
    for ctas in _counts(walk):
        assert torch.equal(_emulate(a, rhs, cfg, batch, ctas), want), ctas
    if cfg.acc_dtype == "bfloat16" and cdiv(k, cfg.bk) > 1:  # the carry did round
        exact = mm.matmul_reference(a, rhs, k, "float32", cfg.rhs_layout,
                                    out_dtype=torch.float32)
        assert not torch.equal(want, exact)


@pytest.mark.parametrize("block", [(16, 512), (48, 256), (200, 256), (1000, 300), (300, 64)])
def test_emulated_walk_leaves_a_block_exact_beside_next_block_nan_rows(block):
    """A's rows of the second block are NaN: the first block's rows of C are exact at every
    count (its last strip's sub-tile reads the NaN rows and does not store them), and the
    second block's are NaN."""
    bm, bn = block
    m, n, k = 2 * bm, 600, 256
    cfg = KernelConfig(bm=bm, bn=bn, bk=128)
    a = (_ints(3, (m, k), 0, 2))
    b = _ints(4, (k, n), 0, 2)
    want = mm.matmul_reference(a[:bm], b, cfg.bk, out_dtype=torch.float32)
    a[bm:] = float("nan")
    walk = wide_walk(m, n, bm, bn)
    assert wide_sub_m(bm) > bm or bm % wide_sub_m(bm)  # the sub-tile reaches the NaN rows
    for ctas in _counts(walk):
        got = _emulate(a, b, cfg, 1, ctas)
        assert torch.equal(got[:bm], want), ctas
        assert bool(torch.isnan(got[bm:]).all())


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_emulated_walk_equals_the_jax_kernel(acc):
    """The walk at the rule's count and at one CTA a block against ``pallas_matmul_fused``
    (interpret mode) at a JAX wide block over three K intervals, on small integers: the
    same bits."""
    m, n, k = 300, 520, 384
    jax_cfg = jcfg.KernelConfig(bm=256, bn=256, bk=128, acc_dtype=acc)
    cfg = KernelConfig.from_jax(dataclasses.asdict(jax_cfg))
    a, b = _ints(5, (m, k)), _ints(6, (k, n))
    theirs = torch.from_numpy(np.array(pallas_matmul_fused(
        jnp.asarray(a.float().numpy(), jnp.bfloat16), jnp.asarray(b.float().numpy(),
                                                                  jnp.bfloat16),
        None, None, jax_cfg, out_dtype=jnp.float32), np.float32))
    walk = wide_walk(m, n, cfg.bm, cfg.bn)
    for ctas in (wide_ctas(m, n, cfg.bm, cfg.bn), walk.blocks_m * walk.blocks_n):
        assert torch.equal(_emulate(a, b, cfg, 1, ctas), theirs)
