"""Kernel configuration space of the Hopper GEMM kernels.

Counterpart of ``tpul2/config.py``.  One dataclass names a point of the searched space;
field names are the JAX package's, so a configuration carries across
(``KernelConfig.from_jax``).  What the fields mean on Hopper:

  bm, bn          the CTA's output block, any edges the JAX space emits (its sublane 16,
                  its covers of M < 16 and N < 128, any full-dim cover).  A ring block (both
                  edges 1..128) runs tl2_wgmma.cu's TMA + wgmma ring
                  (``ops.matmul.launch_route``), for the K carry and the single interval
                  (gk == 1) alike, on the tile of ``ring_edge`` of each edge (32, 64 or 128,
                  the least that holds it): 64 or 128 in both edges, one consumer warpgroup
                  per 64 rows of m64 x bn wgmmas; a 32 bn the same at width 32; a 32 bm over
                  bn 64 / 128 with the operands swapped (the tile's N rows are wgmma's M).
                  The CTAs step by the block's edges, and the tile's rows and columns
                  beyond them are computed and never stored.  The route names the producer
                  that fills the ring: TMA where it can read both operands, the loads
                  producer where it cannot.  ``smem_bytes`` models the ring a config's
                  launches take: ``carry_stages`` stages for depth 0 (``wgmma_smem_bytes``),
                  ``pipeline_depth`` stages for a staged config.
                  Or a wide block (``is_wide``: an edge above 128), the JAX space's
                  "longest contiguous C stripes" (``tpul2/config.py:422-447``): bm up to
                  WIDE_BM_MAX, bn up to WIDE_BN_MAX.  It runs tl2_wgmma_wide.cu at any bk,
                  2-D and batched, in ``wide_sub_m``-row x 128-column sub-tiles (swapped
                  at bm <= 32: the sub-tile's columns are wgmma's M), the last of each
                  clipped at the block's edge, the bf16 family's K carry rounded at every bk
                  as on the ring; every sub-tile of every block is a work item, dealt out to
                  ``wide_ctas`` persistent CTAs in runs (``wide_walk``, ``wide_item``,
                  ``wide_strips``).  A stays resident
                  per strip where all of K fits beside two ring stages, else streams
                  through the ring beside B (``wide_streamed``, from K at the launch; always
                  in the swapped walk).  The route ('wgmma_wide', or 'wgmma_wide_lsu' where
                  the loads producer reads an operand or predicated stores write C) is
                  ``ops.matmul.launch_route``'s
  bk              the K interval after which the running sum is rounded to ``acc_dtype``
                  (the JAX meaning, ``tpul2/ops/matmul.py:116``); a multiple of KSTEP, half
                  a ring stage, so that a rounding point falls on a stage's start or its
                  middle
  acc_dtype       'float32' (F32F16F16F32 family) or 'bfloat16' (F16F16F16F16 family)
  grid_order      CTA raster order: 'mn' walks N fastest, 'nm' walks M fastest
  rhs_layout      'kn' reads B (K, N); 'nk' reads B_t (N, K)
  edge            'pad' or 'mask': the same launch on Hopper, since the kernel predicates
                  its own loads and stores; kept so configurations carry across
  pipeline_depth  0: the carry and single-K bodies; 2..8: the staged kernel (the port of
                  ``tpul2/ops/pipelined.py``) with a ring of this many 64-deep K stages in
                  shared memory, on every ring block, with a split K where the output has
                  few tiles (``ops.pipelined``); at a wide block, the wide walk's f32 sum with
                  A and B streamed through that many stages, no split
  use_vendor      sentinel: call the library GEMM ``vendor_variant`` (ops/baselines.py)

The TPU's VMEM model is replaced by the CTA's shared-memory footprint (the reference's
``kShmSize`` role).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

from tpul2_torch.ops.baselines import VENDOR_VARIANTS
from tpul2_torch.utils.padding import cdiv, round_up

#: Output tile edges the ring kernel is instantiated for (csrc/tl2_wgmma*.cu); a ring block of
#: any edges in 1..128 runs the least that holds it (``ring_edge``).
TILE_CHOICES = (32, 64, 128)
#: The wide tile edges: one consumer warpgroup of m64 wgmmas per 64 rows of C.  A 32 edge
#: runs the same ring at width 32 (bn) or with the operands swapped (bm).
WGMMA_TILES = (64, 128)
#: K depth of one stage of the wgmma body's TMA ring: one 128-byte row of bf16, so a K
#: carry's bk must be a multiple.
WGMMA_KSTAGE = 64
#: Ring depth of the K-carry and single-K launches on the wide tiles (CARRY_STAGES); a
#: 32-edge tile's ring is sized by bytes (``carry_stages``), a staged launch takes its
#: config's pipeline_depth.
WGMMA_STAGES = 4
#: The bytes of the bn side a 32-edge tile's carry ring keeps in flight, and its most
#: stages (RING_BYTES, MAX_RING).
RING_BYTES = 65536
MAX_RING = 16
#: Half a ring stage: every bk is a multiple, so a rounding point falls on a stage's start
#: or its middle, where the bf16 family's consumer can round.
KSTEP = 32
#: Shared memory one block may use on the H100 (227 KB); above 48 KB only as dynamic
#: shared memory after cudaFuncSetAttribute, which the launcher does.
SMEM_LIMIT = 232448
#: Streaming multiprocessors of an H100 SXM; the heuristic sizes the grid against it.
NUM_SMS = 132

#: Stage counts of the staged kernel (the JAX package's set); 0 is the single-stage kernel.
PIPELINE_DEPTHS = (0, 2, 3, 4, 6, 8)
#: bk choices of the candidate space before the full-K cover (the JAX package's, all
#: multiples of KSTEP).
_BK_CHOICES = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)

#: The wide blocks (tl2_wgmma_wide.cu; tl2_wgmma_model.cuh mirrors these constants): the
#: JAX space's edges (``dim_choices``, ``tpul2/config.py:422-447``, and the edges of its tuned
#: DB), any edge up to these: bm 16384 (the JAX DB's tallest block), bn 32768 (JAX's
#: full-dim cover of N, up to twice its largest bn).
WIDE_BM_MAX = 16384
WIDE_BN_MAX = 32768
#: The power-of-two edges above 128 that ``candidate_configs`` emits (JAX's bases), and the
#: largest M it covers with one block (JAX's full-dim cover: M up to twice its largest bm).
WIDE_BM_CHOICES = (256, 512, 1024, 2048)
WIDE_BN_CHOICES = (256, 512, 1024, 2048, 4096, 8192, 16384)
WIDE_FULL_M_MAX = 2 * WIDE_BM_CHOICES[-1]
#: JAX's sublane edge for bf16 (``min_sublane``): its least bm, beside its covers of M < 16.
JAX_SUBLANE = 16
#: Columns of the wide route's sub-tile (its wgmmas are m64n128, or m64n32 swapped); its rows
#: are WIDE_SWAP_M (the swapped walk) at bm <= 32, 64 at bm <= 64 and 128 otherwise
#: (``wide_sub_m``).
WIDE_SUB_N = 128
WIDE_SWAP_M = 32
#: The wide route's ring: WIDE_STAGES deep where shared memory allows, WIDE_MIN_STAGES at
#: least.
WIDE_STAGES = 4
WIDE_MIN_STAGES = 2
#: The wide route's C staging per consumer warpgroup: 64 rows x 128 columns of f32, two
#: sub-tiles' worth of bf16 (WIDE_C_BYTES).
WIDE_C_BYTES = 64 * WIDE_SUB_N * 4

#: Candidate-space revision, stamped into TuneDB entries.  1 = the first Hopper space:
#: TILE_CHOICES tiles, the JAX package's bk rule, the kStage axis, the vendor variants.
#: 2 = the wide blocks at gk == 1 (WIDE_BM_CHOICES x WIDE_BN_CHOICES, bk the whole K).
#: 3 = the wide blocks at every bk of the set and JAX's full-dim covers (bm = M up to
#: WIDE_FULL_M_MAX, bn = N).  4 = every edge of the JAX space: its sublane 16, its covers of
#: M < 16 and of unaligned M and N, bn < 128 beside a wide bm, bn covers up to WIDE_BN_MAX,
#: and the kStage axis with JAX's own picks (staged wide blocks among them).
SPACE_REV = 4

#: TPU-only fields of ``tpul2.config.KernelConfig`` that have no Hopper meaning.
_TPU_ONLY_FIELDS = ("vmem_limit_bytes", "parallel_mn")


def ring_edge(edge: int) -> int:
    """The ring tile's edge that runs a block edge of 1..128 (``tl2wg::ring_edge``): the least
    of TILE_CHOICES that holds it."""
    return next(t for t in TILE_CHOICES if t >= edge)


def carry_stages(bm: int, bn: int) -> int:
    """The ring depth of a carry or single-K launch of a ring block (``tl2_wgmma_carry_stages``),
    by its tile (``ring_edge``): WGMMA_STAGES on the wide tiles; on a 32-edge tile, whose
    stage is small, enough stages to keep RING_BYTES of the bn side in flight
    (cdiv(65536, bn * 128)), at least WGMMA_STAGES and at most MAX_RING, within SMEM_LIMIT:
    32 x 64 8, 32 x 128 4, 32 x 32 and 64 x 32 16, 128 x 32 the 11 that fit."""
    bm, bn = ring_edge(bm), ring_edge(bn)
    if bm in WGMMA_TILES and bn in WGMMA_TILES:
        return WGMMA_STAGES
    want = max(WGMMA_STAGES, cdiv(RING_BYTES, bn * WGMMA_KSTAGE * 2))
    fit = (SMEM_LIMIT - 1024) // ((bm + bn) * WGMMA_KSTAGE * 2 + 16)
    return min(want, MAX_RING, fit)


def wgmma_smem_bytes(bm: int, bn: int, stages: Optional[int] = None) -> int:
    """Shared memory of one ring CTA of a ring block (``tl2_wgmma_smem_bytes``): 1024 bytes to
    align the ring to the swizzle period, ``stages`` (default: ``carry_stages``) stages of
    the tile's (bm + bn) rows of 128 bytes, and a full and an empty mbarrier per stage."""
    if stages is None:
        stages = carry_stages(bm, bn)
    return 1024 + stages * (ring_edge(bm) + ring_edge(bn)) * WGMMA_KSTAGE * 2 + 2 * stages * 8


def is_wide(bm: int, bn: int) -> bool:
    """A block with an edge above the ring tiles': the wide route's."""
    return bm > TILE_CHOICES[-1] or bn > TILE_CHOICES[-1]


def wide_sub_m(bm: int) -> int:
    """Rows of the wide route's sub-tile (and of its A strip): WIDE_SWAP_M at bm <= 32 (the
    swapped walk), 64 at bm <= 64, else 128 (``tl2wg::wide_sub_m``)."""
    return WIDE_SWAP_M if bm <= WIDE_SWAP_M else 64 if bm <= 64 else 128


def wide_smem_bytes(bm: int, k: int, stages: int, streamed: bool) -> int:
    """Shared memory of one wide CTA at depth K (``tl2_wgmma_wide_smem_bytes``): 1024 bytes
    to align to the swizzle period, ``stages`` ring stages (a B box of WIDE_SUB_N rows of
    128 bytes, and where A streams the strip's A box of ``wide_sub_m`` rows beside it), the
    resident A strip (``wide_sub_m`` rows x K rounded up to 64, in 128-byte rows; none where
    A streams), WIDE_C_BYTES of C staging per consumer warpgroup of the plain walk (none in
    the swapped walk, whose stores are predicated), a full and an empty mbarrier per stage
    and for the strip."""
    sub_m = wide_sub_m(bm)
    stage = (WIDE_SUB_N + (sub_m if streamed else 0)) * WGMMA_KSTAGE * 2
    strip = 0 if streamed else cdiv(k, WGMMA_KSTAGE) * sub_m * WGMMA_KSTAGE * 2
    staging = 0 if sub_m == WIDE_SWAP_M else sub_m // 64 * WIDE_C_BYTES
    return 1024 + stages * stage + strip + staging + (2 * stages + 2) * 8


def _wide_fit(bm: int, k: int, streamed: bool) -> int:
    """The ring depth that fits beside the rest in SMEM_LIMIT, at most WIDE_STAGES."""
    stage = (WIDE_SUB_N + (wide_sub_m(bm) if streamed else 0)) * WGMMA_KSTAGE * 2 + 16
    free = SMEM_LIMIT - wide_smem_bytes(bm, k, 0, streamed)
    return max(0, min(WIDE_STAGES, free // stage))


def wide_streamed(bm: int, k: int) -> bool:
    """Whether a bm-row wide block's A streams through the ring at depth K
    (``tl2_wgmma_wide_streamed``): where the resident strip of all of K leaves fewer than
    WIDE_MIN_STAGES stages, K above 512 at 128-row strips and above 1280 at 64-row ones;
    always in the swapped walk (bm <= 32), whose A box is 4 KB a stage."""
    return bm <= WIDE_SWAP_M or _wide_fit(bm, k, False) < WIDE_MIN_STAGES


#: The depth up to which a wide launch streams A where TMA reads it (``wide_streams``).
WIDE_THIN_K = 128


def wide_streams(bm: int, k: int, tma_a: bool) -> bool:
    """Whether a wide launch streams A (``tl2wg::wide_streams``, the launcher's choice):
    where its strip does not fit (``wide_streamed``), and at K <= WIDE_THIN_K where TMA
    reads A (``tma_a``).  There a strip is one or two 64-deep boxes: keeping it saves
    little L2 traffic, while each strip of a CTA's run costs a load and a barrier round
    trip before its first wgmma; streamed, the box rides in the ring beside B.  The loads
    producer's gather of A costs more per item than the strip's reloads, so there A stays
    resident.  ``KernelConfig.smem_bytes`` counts the mode ``wide_streamed`` gives: both
    modes fit at thin K."""
    return wide_streamed(bm, k) or (tma_a and k <= WIDE_THIN_K)


def wide_stages(bm: int, k: int) -> int:
    """The wide route's ring depth at depth K in the mode K takes (``tl2_wgmma_wide_stages``):
    WIDE_STAGES, or as many as fit; below WIDE_MIN_STAGES the block does not fit."""
    return _wide_fit(bm, k, wide_streamed(bm, k))


def wide_c_grid(m: int, n: int, bm: int, bn: int) -> bool:
    """Whether TMA stores can write a wide block's C (``tl2wg::wide_c_grid``): they clip only
    at the problem's edges, so every block edge must lie on the sub-tile grid or past the
    problem's edge (one block along that dimension); the swapped walk's stores are
    predicated."""
    return (bm > WIDE_SWAP_M and (bm % wide_sub_m(bm) == 0 or bm >= m)
            and (bn % WIDE_SUB_N == 0 or bn >= n))


@dataclasses.dataclass(frozen=True)
class WideWalk:
    """The work items of a wide launch (``tl2wg::wide_walk``): one per sub-tile of each
    block of each batch element, ordered (batch element, block, strip, column), the column
    fastest, the blocks in the launch's raster.  Every block has ``strips`` strips of
    ``sub_m`` rows and ``cols`` columns of WIDE_SUB_N: its edge, or the problem's where that
    is nearer, rounded up to them."""

    m: int
    n: int
    bm: int
    bn: int
    raster_nm: bool
    sub_m: int
    blocks_m: int
    blocks_n: int
    strips: int
    cols: int
    items: int


def wide_walk(m: int, n: int, bm: int, bn: int, batch: int = 1,
              raster_nm: bool = False) -> WideWalk:
    """The work items of a wide launch of bm x bn blocks over batch x M x N."""
    sub_m = wide_sub_m(bm)
    strips, cols = cdiv(min(bm, m), sub_m), cdiv(min(bn, n), WIDE_SUB_N)
    blocks_m, blocks_n = cdiv(m, bm), cdiv(n, bn)
    return WideWalk(m, n, bm, bn, bool(raster_nm), sub_m, blocks_m, blocks_n, strips, cols,
                    batch * blocks_m * blocks_n * strips * cols)


def wide_item(walk: WideWalk, i: int) -> tuple:
    """Item i of a walk (``tl2wg::wide_item``): (batch element, block, strip, column, the
    block's first row, its first column, the stored edges m_lim and n_lim (the block's or
    the problem's, the nearer), empty).  An item past the problem's edge in an edge block is
    empty: no CTA computes it."""
    per_block = walk.strips * walk.cols
    z, block = divmod(i // per_block, walk.blocks_m * walk.blocks_n)
    strip, col = divmod(i % per_block, walk.cols)
    if walk.raster_nm:
        bn_i, bm_i = divmod(block, walk.blocks_m)
    else:
        bm_i, bn_i = divmod(block, walk.blocks_n)
    m_blk, n_blk = bm_i * walk.bm, bn_i * walk.bn
    m_lim, n_lim = min(walk.m, m_blk + walk.bm), min(walk.n, n_blk + walk.bn)
    empty = (strip >= cdiv(m_lim - m_blk, walk.sub_m)
             or col >= cdiv(n_lim - n_blk, WIDE_SUB_N))
    return z, block, strip, col, m_blk, n_blk, m_lim, n_lim, empty


def wide_first(items: int, ctas: int, c: int) -> int:
    """The first item of CTA c of ``ctas`` (``tl2wg::wide_first``): floor(c * items / ctas).
    CTA c walks [wide_first(c), wide_first(c + 1)); the runs differ by at most one item."""
    return c * items // ctas


def wide_strips(walk: WideWalk, ctas: int, c: int) -> list:
    """CTA c's run [wide_first(c), wide_first(c + 1)) as the kernel walks it, one strip at a
    time (``for_each_strip`` with ``tl2wg::wide_segment``): (first item, end column) of each
    segment of the run with a non-empty item.  A segment holds its strip's items from the
    first one's column up to the strip's last column or the run's end, whichever comes
    first; the items to compute are its columns up to ``end`` (the non-empty ones).  A
    resident A strip is loaded once per segment."""
    i, last = wide_first(walk.items, ctas, c), wide_first(walk.items, ctas, c + 1)
    out = []
    while i < last:
        _, _, _, col, _, n_blk, _, n_lim, empty = wide_item(walk, i)
        stop = min(walk.cols, col + last - i)
        if not empty:
            out.append((i, min(stop, cdiv(n_lim - n_blk, WIDE_SUB_N))))
        i += stop - col
    return out


def wide_ctas(m: int, n: int, bm: int, bn: int, batch: int = 1, sms: int = NUM_SMS) -> int:
    """The CTAs of a wide launch (``tl2_wgmma_wide_ctas``): one per SM, the kernel's
    one CTA an SM, or one per work item where there are fewer."""
    return min(wide_walk(m, n, bm, bn, batch).items, sms)


def _vendor_for_xla(variant: str) -> str:
    """The library GEMM playing the role of one XLA sentinel formulation.

    The layout carries over (``*_tn`` consumes b_t); precision and scheduler-flag variants
    have no torch counterpart and map onto the plain f32-accumulating call of their layout.
    """
    if variant == "matmul":
        return "torch_matmul"
    return "cublas_tn" if variant.endswith("_tn") else "cublas_nn"


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point in the Hopper kernel's search space."""

    bm: int = 128
    bn: int = 128
    bk: int = 256
    acc_dtype: str = "float32"
    grid_order: str = "mn"
    rhs_layout: str = "kn"
    edge: str = "pad"
    pipeline_depth: int = 0
    use_vendor: bool = False
    vendor_variant: str = "torch_matmul"

    @staticmethod
    def vendor(variant: str = "torch_matmul") -> "KernelConfig":
        return KernelConfig(use_vendor=True, vendor_variant=variant)

    @staticmethod
    def from_jax(d: dict) -> "KernelConfig":
        """Build from ``dataclasses.asdict(tpul2.config.KernelConfig)``.

        Drops the TPU-only fields and maps ``use_xla``/``xla_variant`` onto the vendor
        sentinel.  Blocks are carried as they are; ``validate`` judges them.  A bk that is
        not a multiple of KSTEP is JAX's full-K cover (its validate admits a bk off its
        lane only as bk == K, ``tpul2/config.py:264``): it becomes round_up(bk, KSTEP), the
        same single interval (the extra columns read as zeros)."""
        d = {k: v for k, v in d.items() if k not in _TPU_ONLY_FIELDS}
        use_xla = d.pop("use_xla", False)
        xla_variant = d.pop("xla_variant", "matmul")
        if use_xla:
            d["use_vendor"] = True
            d["vendor_variant"] = _vendor_for_xla(xla_variant)
        elif d.get("bk", KSTEP) % KSTEP and d.get("bk", 0) > 0:
            d["bk"] = round_up(d["bk"], KSTEP)
        return KernelConfig(**d)

    # ---- serialization (the tuning DB stores these) ----
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "KernelConfig":
        return KernelConfig(**json.loads(s))

    @property
    def wide(self) -> bool:
        """A wide block (``is_wide``), run by tl2_wgmma_wide.cu."""
        return is_wide(self.bm, self.bn)

    def smem_bytes(self) -> int:
        """Shared memory of one CTA of the ring this config's launches take
        (``wgmma_smem_bytes``): ``carry_stages`` 64-deep stages for depth 0,
        ``pipeline_depth`` of them for a staged config.  A wide block's at K = bk
        (``wide_smem_bytes`` in the mode K = bk takes); at any K the launch takes the mode
        that fits.  A staged wide block streams A beside B through ``pipeline_depth``
        stages, at any K."""
        if self.wide and self.pipeline_depth:
            return wide_smem_bytes(self.bm, 0, self.pipeline_depth, True)
        if self.wide:
            return wide_smem_bytes(self.bm, self.bk, wide_stages(self.bm, self.bk),
                                   wide_streamed(self.bm, self.bk))
        return wgmma_smem_bytes(self.bm, self.bn, self.pipeline_depth or None)

    def validate(self) -> Optional[str]:
        """Return an error string if the kernel cannot run this config, else None.

        Worked out once per instance (the config is frozen): the entry point validates
        the same resolved config on every call."""
        err = self.__dict__.get("_validated", False)
        if err is False:
            err = self._check()
            object.__setattr__(self, "_validated", err)
        return err

    def _check(self) -> Optional[str]:
        if self.use_vendor:
            if self.vendor_variant not in VENDOR_VARIANTS:
                return f"unknown vendor_variant {self.vendor_variant}"
            return None
        if self.edge not in ("pad", "mask"):
            return f"bad edge {self.edge}"
        if self.pipeline_depth not in PIPELINE_DEPTHS:
            return f"bad pipeline_depth {self.pipeline_depth} (one of {PIPELINE_DEPTHS})"
        if self.pipeline_depth >= 2 and self.edge == "mask":
            return ("pipeline_depth requires edge='pad' (the staged kernel needs "
                    "block-divisible dims)")
        if self.bm < 1:
            return f"bm={self.bm} is not a positive block edge"
        if self.bn < 1:
            return f"bn={self.bn} is not a positive block edge"
        if self.wide:
            err = self._check_wide()
            if err:
                return err
        if self.bk <= 0 or self.bk % KSTEP:
            return (f"bk={self.bk} is not a positive multiple of {KSTEP}, half the ring's "
                    "K stage")
        if self.acc_dtype not in ("float32", "bfloat16"):
            return f"unsupported acc_dtype {self.acc_dtype}"
        if self.grid_order not in ("mn", "nm"):
            return f"bad grid_order {self.grid_order}"
        if self.rhs_layout not in ("kn", "nk"):
            return f"bad rhs_layout {self.rhs_layout}"
        if self.wide and wide_stages(self.bm, self.bk) < WIDE_MIN_STAGES:
            return (f"shared memory: neither a resident A strip of bk={self.bk} nor a "
                    f"streamed A leaves {WIDE_MIN_STAGES} ring stages in the "
                    f"{SMEM_LIMIT}-byte limit")
        if self.smem_bytes() > SMEM_LIMIT:
            return f"shared memory {self.smem_bytes()} exceeds the {SMEM_LIMIT}-byte limit"
        return None

    def _check_wide(self) -> Optional[str]:
        if self.bm > WIDE_BM_MAX:
            return f"bm={self.bm} is above the wide blocks' largest edge {WIDE_BM_MAX}"
        if self.bn > WIDE_BN_MAX:
            return f"bn={self.bn} is above the wide blocks' largest edge {WIDE_BN_MAX}"
        return None

    def padding_waste(self, m: int, n: int, k: int) -> float:
        """Fraction of the MMA work spent on the zeros of partial tiles (the kernel
        predicates its edges, so the zeros cost MMAs, not copies).  A bk that covers K is
        one interval of K, as JAX's full-dim cover is one internally padded block."""
        padded = (round_up(m, self.bm) * round_up(n, self.bn)
                  * (k if self.bk >= k else round_up(k, self.bk)))
        return 1.0 - (m * n * k) / padded


def _pick_bk(k: int) -> int:
    """The JAX heuristic's bk rule (``tpul2/config.py:368``), kept so that untuned shapes
    get the same number of K intervals, and so the same rounding points, on both sides:
    one interval for k < 128, else the largest of 128..1024 not above round_up(k, 128).
    Sub-128 K rounds up to the kernel's K step; the extra columns read as zeros."""
    if k < 128:
        return round_up(k, KSTEP)
    best = 128
    for c in (128, 256, 512, 1024):
        if c <= round_up(k, 128):
            best = c
    return best


def heuristic_config(m: int, n: int, k: int, acc_dtype: str = "float32") -> KernelConfig:
    """Hopper config for a shape with no tuned entry (the role of ``tpul2/config.py:340``).

    Starts from the largest tile the problem fills, then halves the larger tile edge
    (bm on a tie) while the grid has fewer CTAs than the card has SMs, so a skinny or
    thin problem still spreads over the card, but never below the wide tiles' least edge
    (WGMMA_TILES): a 32-edge tile halves what each CTA's stage of B serves.  An edge is 32
    only where the problem's own dimension is at most 32 (decode-size M or N: the ring's
    width-32 or swapped tile).  Never returns the vendor sentinel."""
    def edge(dim: int) -> int:
        return next((t for t in TILE_CHOICES if t >= dim), TILE_CHOICES[-1])

    bm, bn = edge(m), edge(n)
    while cdiv(m, bm) * cdiv(n, bn) < NUM_SMS and max(bm, bn) > WGMMA_TILES[0]:
        if bm >= bn:
            bm //= 2
        else:
            bn //= 2
    return KernelConfig(bm=bm, bn=bn, bk=_pick_bk(k), acc_dtype=acc_dtype)


#: The JAX space's VMEM regime (``tpul2/config.py:40-63``), which its prior ranks by and its
#: footprint rule filters with; kept here only so that ``candidate_configs``' kStage axis can
#: take JAX's own picks (``_jax_kstage_picks``).  No Hopper launch reads them.
_JAX_VMEM_BUDGET = 14 << 20
_JAX_A_BLOCK_CAP = 2 << 20
_JAX_VMEM_CAP = 112 << 20
_JAX_VMEM_FLOOR = 32 << 20
_JAX_LANE = 128
#: JAX's bases of bm and bn (``tpul2/config.py:436-447``): its sublane up to 2048, its lane up
#: to 16384.
_JAX_BMS = (JAX_SUBLANE, 32, 64, 128) + WIDE_BM_CHOICES
_JAX_BNS = (WIDE_SUB_N,) + WIDE_BN_CHOICES


def _jax_vmem_limit(bm: int, bn: int, bk: int, acc_dtype: str, rhs_layout: str, depth: int,
                    m: int, n: int, k: int):
    """JAX's footprint model and ``assign_vmem_limit`` for a bf16 block at (m, n, k)
    (``tpul2/config.py:184-240``, ``:380-396``): 0 where it fits the default regime, 1 where
    it needs a raised limit, None where no limit fits (the config is not in JAX's space)."""
    def phys(rows: int, cols: int, sublane: int, item: int) -> int:
        return round_up(rows, sublane) * round_up(cols, _JAX_LANE) * item

    acc_item, acc_sub = (4, 8) if acc_dtype == "float32" else (2, 16)
    a_blk = phys(bm, bk, 16, 2)
    b_blk = phys(bn, bk, 16, 2) if rhs_layout == "nk" else phys(bk, bn, 16, 2)
    o_blk = phys(bm, bn, 16, 2)
    if depth >= 2:
        fp = depth * (a_blk + b_blk) + 2 * o_blk + phys(bm, bn, 8, 4)
    else:
        gm, gn, gk = cdiv(m, bm), cdiv(n, bn), cdiv(k, bk)
        acc = 0 if gk == 1 else phys(bm, bn, acc_sub, acc_item)
        fp = ((2 if gm > 1 or gk > 1 else 1) * a_blk + (2 if gn > 1 or gk > 1 else 1) * b_blk
              + (2 if gm > 1 or gn > 1 else 1) * o_blk + acc)
    if fp <= _JAX_VMEM_BUDGET and bm * bk * 2 <= _JAX_A_BLOCK_CAP:
        return 0
    limit = max(_JAX_VMEM_FLOOR, round_up(int(fp / 0.75), 1 << 20))
    return 1 if limit <= _JAX_VMEM_CAP else None


def _edges(dim: int, base: tuple, align: int, cover: bool) -> list:
    """The block edges of ``base`` up to the problem rounded to ``align``, and with
    ``cover`` the dimension itself (JAX's ``dim_choices``, ``tpul2/config.py:422-430``,
    whose least base never exceeds the rounded problem)."""
    return sorted({e for e in base if e <= round_up(dim, align)} | ({dim} if cover else set()))


def _jax_kstage_picks(m: int, n: int, k: int, acc_dtype: str, limit: int) -> list:
    """The staged configs JAX's ``candidate_configs`` emits at (m, n, k) (``tpul2/config.py:
    503-515``), as port configs: its first ``limit`` configs by its prior (padding waste,
    grid steps, default VMEM regime first, 'mn' first; ties in its enumeration order),
    staged at depths 2 and 4 where the blocks divide the problem with at least 3 K
    intervals and JAX's footprint rule admits the staged block.  Empty where JAX gates the
    axis off (not min(m, n) <= 256 and k >= 2048)."""
    if not (min(m, n) <= 256 and k >= 2048):
        return []
    bms = _edges(m, _JAX_BMS, JAX_SUBLANE, m <= WIDE_FULL_M_MAX)
    bns = _edges(n, _JAX_BNS, _JAX_LANE, n <= WIDE_BN_MAX)
    bks = _edges(k, _BK_CHOICES, _JAX_LANE, k <= 2 * _BK_CHOICES[-1])
    ranked = []
    for bm in bms:
        for bn in bns:
            for bk in bks:
                waste = 1.0 - (m * n * k) / (round_up(m, bm) * round_up(n, bn)
                                             * round_up(k, bk))
                if waste > 0.6:
                    continue
                steps = cdiv(m, bm) * cdiv(n, bn) * cdiv(k, bk)
                for order in ("mn", "nm"):
                    for rhs in ("kn", "nk"):
                        edges = ("pad", "mask") if (m % bm or n % bn or k % bk) else ("pad",)
                        for edge in edges:
                            regime = _jax_vmem_limit(bm, bn, bk, acc_dtype, rhs, 0, m, n, k)
                            if regime is not None:
                                ranked.append(((waste, steps, regime, order != "mn"),
                                               (bm, bn, bk, order, rhs, edge)))
    ranked.sort(key=lambda t: t[0])  # stable: ties keep JAX's enumeration order
    out = []
    for _, (bm, bn, bk, order, rhs, edge) in ranked[:limit]:
        if edge == "mask" or m % bm or n % bn or k % bk or k // bk < 3:
            continue
        for depth in (2, 4):
            if _jax_vmem_limit(bm, bn, bk, acc_dtype, rhs, depth, m, n, k) is not None:
                out.append(KernelConfig.from_jax(dict(
                    bm=bm, bn=bn, bk=bk, acc_dtype=acc_dtype, grid_order=order,
                    rhs_layout=rhs, edge=edge, pipeline_depth=depth)))
    return out


def candidate_configs(m: int, n: int, k: int, acc_dtype: str = "float32",
                      max_candidates: int = 64) -> list:
    """The tuner's candidate set for one shape (the role of ``tpul2/config.py:400``).

    Blocks: the ring's tiles (TILE_CHOICES in both edges, up to the problem rounded to
    32); the wide blocks of the ring's edges (bm in WGMMA_TILES or WIDE_BM_CHOICES, and M
    itself up to WIDE_FULL_M_MAX where 128 divides it, bn in WIDE_SUB_N or
    WIDE_BN_CHOICES, and N itself, each up to the problem rounded to 128, an edge above
    128); and every block the JAX space emits (``dim_choices``, ``tpul2/config.py:422-447``:
    bm its sublane 16, 32, 64, 128 and WIDE_BM_CHOICES up to the problem rounded to 16, and
    M itself up to WIDE_FULL_M_MAX, aligned or not; bn WIDE_SUB_N and WIDE_BN_CHOICES up to
    the problem rounded to 128, and N itself up to WIDE_BN_MAX).  bk from the JAX package's
    rule (128..16384 not above round_up(k, 128), plus the whole K rounded up to KSTEP, which
    ``KernelConfig.from_jax`` makes of JAX's whole-K cover); both raster orders and RHS
    layouts; 'mask' beside 'pad' only where the blocks do not divide.  Configs with more
    than 60% padding waste are dropped.

    The cost prior treats the kernel as bound by device-memory bytes, as the skinny and
    thin-K shapes are on the H100 (and nothing here reaches the tensor-core roof):
    least padding waste first (MMAs on zeros), then a grid that fills the card's NUM_SMS
    SMs, then the fewest bytes the CTAs read (each reads bm x K of A and K x bn of B, so
    larger tiles read less; a wide CTA reads its B once per strip of ``wide_sub_m`` rows,
    and where A streams (``wide_streamed``) its A once per 128-column sub-tile), then bk
    nearest the heuristic's (bk moves neither bytes nor MMAs on Hopper, so
    ties keep an untuned shape's rounding points), then 'mn' raster.
    The first ``max_candidates`` are kept.

    Then the kStage axis as the JAX package gates it (``tpul2/config.py:503``): only on
    streaming shapes (min(m, n) <= 256 and k >= 2048), at depths 2 and 4, from the top
    4 picks by the prior among the ring tiles (WGMMA_TILES in both edges, whatever
    ``max_candidates`` kept) whose blocks divide the problem with at least 3 K
    intervals.  Every tile runs the staged sum on tl2_wgmma.cu's ring with a split K
    (``ops.pipelined``); the prior's fill term would rank the 32-edge tiles first at the
    streaming shapes, where a 32-edge tile's CTAs read B twice as often as a 64-row
    tile's (and tl2_staged.cu's 32-edge mma.sync tile ran 2.7x behind the 64 x 64 ring
    at 64 x 8192 x 8192 on the H100, PERF.md).  Where the problem has no wide tile (a
    dimension of at most 32), the picks come from the kept candidates of the ring's tiles,
    as in the JAX package: the ring's width-32 or swapped tiles.  The ring's stages are as deep
    whatever bk is, and the prior ranks all four raster/layout variants of a (tile, bk)
    ahead of another bk for the same tile, so no two of these differ in bk alone.
    Beside them, JAX's own staged picks (``_jax_kstage_picks``: its top picks by its
    prior, wide blocks among them, which run the wide walk's staged sum).  Then every
    vendor variant, always, so the tuner can never do worse than the library.
    """
    tiles_m, tiles_n = (_edges(dim, TILE_CHOICES, TILE_CHOICES[0], False) for dim in (m, n))
    blocks = {(bm, bn) for bm in tiles_m for bn in tiles_n}
    # the wide blocks of the ring's edges, and JAX's full-dim covers of aligned dimensions
    blocks |= {(bm, bn)
               for bm in _edges(m, WGMMA_TILES + WIDE_BM_CHOICES, WIDE_SUB_N,
                                m % WIDE_SUB_N == 0 and m <= WIDE_FULL_M_MAX)
               for bn in _edges(n, _JAX_BNS, WIDE_SUB_N, n % WIDE_SUB_N == 0 and n <= WIDE_BN_MAX)
               if is_wide(bm, bn)}
    # the JAX space's blocks (its dim_choices), narrow, unaligned and wide alike
    blocks |= {(bm, bn)
               for bm in _edges(m, _JAX_BMS, JAX_SUBLANE, m <= WIDE_FULL_M_MAX)
               for bn in _edges(n, _JAX_BNS, WIDE_SUB_N, n <= WIDE_BN_MAX)}
    bks = {c for c in _BK_CHOICES if c <= round_up(k, 128)}
    if k <= 2 * _BK_CHOICES[-1]:
        bks.add(round_up(k, KSTEP))  # whole K in one interval (gk == 1)
    out, seen = [], set()
    for bm, bn in sorted(blocks):
        for bk in sorted(bks):
            for order in ("mn", "nm"):
                for rhs in ("kn", "nk"):
                    modes = ("pad", "mask") if (m % bm or n % bn or k % bk) else ("pad",)
                    for edge in modes:
                        cfg = KernelConfig(bm=bm, bn=bn, bk=bk, acc_dtype=acc_dtype,
                                           grid_order=order, rhs_layout=rhs, edge=edge)
                        if (cfg in seen or cfg.validate() is not None
                                or cfg.padding_waste(m, n, k) > 0.6):
                            continue
                        seen.add(cfg)
                        out.append(cfg)

    heuristic_bk = _pick_bk(k)

    def prior(c: KernelConfig) -> tuple:
        gm, gn = cdiv(m, c.bm), cdiv(n, c.bn)
        # a wide CTA reads its block's B once per strip of wide_sub_m rows, and a streamed
        # A once per sub-tile column
        b_reads = cdiv(c.bm, wide_sub_m(c.bm)) if c.wide else 1
        a_reads = cdiv(c.bn, WIDE_SUB_N) if c.wide and wide_streamed(c.bm, k) else 1
        return (round(c.padding_waste(m, n, k), 6),
                -min(1.0, gm * gn / NUM_SMS),
                gm * gn * (a_reads * c.bm + b_reads * c.bn) * round_up(k, c.bk),
                abs(math.log2(c.bk / heuristic_bk)),
                0 if c.grid_order == "mn" else 1)

    out.sort(key=prior)
    ring = [c for c in out if c.bm in WGMMA_TILES and c.bn in WGMMA_TILES]
    out = out[:max_candidates]
    if min(m, n) <= 256 and k >= 2048:
        deep = []
        tiles = ring or [c for c in out if c.bm in TILE_CHOICES and c.bn in TILE_CHOICES]
        for c in tiles[:min(4, max_candidates // 2)]:
            if c.edge == "mask" or m % c.bm or n % c.bn or k % c.bk or k // c.bk < 3:
                continue
            for depth in (2, 4):
                d = dataclasses.replace(c, pipeline_depth=depth)
                if d.validate() is None:
                    deep.append(d)
        for d in _jax_kstage_picks(m, n, k, acc_dtype, min(4, max_candidates // 2)):
            if d not in deep and d.validate() is None:
                deep.append(d)
        out.extend(deep)
    out.extend(KernelConfig.vendor(v) for v in VENDOR_VARIANTS)
    return out
