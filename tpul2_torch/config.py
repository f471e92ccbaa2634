"""Kernel configuration space of the Hopper GEMM kernels.

Counterpart of ``tpul2/config.py``.  One dataclass names a point of the searched space;
field names are the JAX package's, so a configuration carries across
(``KernelConfig.from_jax``).  What the fields mean on Hopper:

  bm, bn          CTA output tile; one of TILE_CHOICES.  Every tile runs tl2_wgmma.cu's
                  TMA + wgmma ring (``ops.matmul.launch_route``), for the K carry and the
                  single interval (gk == 1) alike: 64 or 128 in both edges, one consumer
                  warpgroup per 64 rows of m64 x bn wgmmas; bn = 32 the same at width 32;
                  bm = 32 over bn 64 / 128 with the operands swapped (the tile's N rows are
                  wgmma's M).  The route names the producer that fills the ring: TMA where
                  it can read both operands, the loads producer where it cannot.
                  ``smem_bytes`` models the ring a config's launches take: ``carry_stages``
                  stages for depth 0 (``wgmma_smem_bytes``), ``pipeline_depth`` stages for
                  a staged config.
                  Or a wide block (``is_wide``: an edge above 128), the JAX space's
                  "longest contiguous C stripes" (``tpul2/config.py:432-446``): bm 64, 128
                  or a multiple of 128 up to WIDE_BM_MAX, bn a multiple of 128 up to
                  WIDE_BN_MAX.  It runs tl2_wgmma_wide.cu (route 'wgmma_wide'): one CTA
                  walks the block in 64- or 128-row x 128-column sub-tiles over a resident
                  A strip and stores C by TMA.  It launches only with one K interval
                  (gk == 1) on operands TMA can read (``wide_launch_error``), and its
                  ``smem_bytes`` (``wide_smem_bytes`` at K = bk) must leave the B ring
                  WIDE_MIN_STAGES stages
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
                  shared memory, on every tile, with a split K where the output has few
                  tiles (``ops.pipelined``)
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

#: Output tile edges the ring kernel is instantiated for (csrc/tl2_wgmma*.cu).
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

#: The wide blocks (tl2_wgmma_wide.cu): the JAX space's edges above 128 (``dim_choices``,
#: ``tpul2/config.py:422-446``), each a multiple of WIDE_SUB_N, up to these.
WIDE_BM_MAX = 2048
WIDE_BN_MAX = 16384
#: The power-of-two edges above 128 that ``candidate_configs`` emits (JAX's bases).
WIDE_BM_CHOICES = (256, 512, 1024, 2048)
WIDE_BN_CHOICES = (256, 512, 1024, 2048, 4096, 8192, 16384)
#: Columns of the wide route's sub-tile (its wgmmas are m64n128); its rows are 64 at
#: bm = 64 and 128 otherwise (``wide_sub_m``).
WIDE_SUB_N = 128
#: The wide route's B ring: WIDE_STAGES deep where shared memory allows, WIDE_MIN_STAGES
#: at least (WIDE_STAGES / WIDE_MIN_STAGES in tl2_wgmma.cuh).
WIDE_STAGES = 4
WIDE_MIN_STAGES = 2
#: The wide route's C staging per consumer warpgroup: 64 rows x 128 columns of f32, two
#: sub-tiles' worth of bf16 (WIDE_C_BYTES).
WIDE_C_BYTES = 64 * WIDE_SUB_N * 4

#: Candidate-space revision, stamped into TuneDB entries.  1 = the first Hopper space:
#: TILE_CHOICES tiles, the JAX package's bk rule, the kStage axis, the vendor variants.
#: 2 = the wide blocks at gk == 1 (WIDE_BM_CHOICES x WIDE_BN_CHOICES, bk the whole K).
SPACE_REV = 2

#: TPU-only fields of ``tpul2.config.KernelConfig`` that have no Hopper meaning.
_TPU_ONLY_FIELDS = ("vmem_limit_bytes", "parallel_mn")


def carry_stages(bm: int, bn: int) -> int:
    """The ring depth of a carry or single-K launch (``tl2_wgmma_carry_stages``): WGMMA_STAGES
    on the wide tiles; on a 32-edge tile, whose stage is small, enough stages to keep
    RING_BYTES of the bn side in flight (cdiv(65536, bn * 128)), at least WGMMA_STAGES and
    at most MAX_RING, within SMEM_LIMIT: 32 x 64 8, 32 x 128 4, 32 x 32 and 64 x 32 16,
    128 x 32 the 11 that fit."""
    if bm in WGMMA_TILES and bn in WGMMA_TILES:
        return WGMMA_STAGES
    want = max(WGMMA_STAGES, cdiv(RING_BYTES, bn * WGMMA_KSTAGE * 2))
    fit = (SMEM_LIMIT - 1024) // ((bm + bn) * WGMMA_KSTAGE * 2 + 16)
    return min(want, MAX_RING, fit)


def wgmma_smem_bytes(bm: int, bn: int, stages: Optional[int] = None) -> int:
    """Shared memory of one ring CTA (``tl2_wgmma_smem_bytes``): 1024 bytes to align the
    ring to the swizzle period, ``stages`` (default: ``carry_stages``) stages of (bm + bn)
    rows of 128 bytes, and a full and an empty mbarrier per stage."""
    if stages is None:
        stages = carry_stages(bm, bn)
    return 1024 + stages * (bm + bn) * WGMMA_KSTAGE * 2 + 2 * stages * 8


def is_wide(bm: int, bn: int) -> bool:
    """A block with an edge above the ring tiles': the wide route's."""
    return bm > TILE_CHOICES[-1] or bn > TILE_CHOICES[-1]


def wide_sub_m(bm: int) -> int:
    """Rows of the wide route's sub-tile (and of its resident A strip): 64 at bm = 64, else
    128 (``tl2wg::wide_sub_m``)."""
    return 64 if bm == 64 else 128


def wide_smem_bytes(bm: int, k: int, stages: int) -> int:
    """Shared memory of one wide CTA (``tl2_wgmma_wide_smem_bytes``): 1024 bytes to align
    to the swizzle period, ``stages`` B stages of WIDE_SUB_N rows of 128 bytes, the A strip
    (``wide_sub_m`` rows x K rounded up to 64, in 128-byte rows), WIDE_C_BYTES of C staging
    per consumer warpgroup, a full and an empty mbarrier per stage and for the strip."""
    sub_m = wide_sub_m(bm)
    return (1024 + stages * WIDE_SUB_N * WGMMA_KSTAGE * 2
            + cdiv(k, WGMMA_KSTAGE) * sub_m * WGMMA_KSTAGE * 2
            + sub_m // 64 * WIDE_C_BYTES + (2 * stages + 2) * 8)


def wide_stages(bm: int, k: int) -> int:
    """The wide route's B ring depth at depth K (``tl2_wgmma_wide_stages``): WIDE_STAGES,
    or as many as fit in SMEM_LIMIT (0 where none does); below WIDE_MIN_STAGES the block
    does not fit."""
    per_stage = WIDE_SUB_N * WGMMA_KSTAGE * 2 + 16
    return max(0, min(WIDE_STAGES, (SMEM_LIMIT - wide_smem_bytes(bm, k, 0)) // per_stage))


def wide_launch_error(cfg: "KernelConfig", m: int, n: int, k: int) -> Optional[str]:
    """Why a valid wide config cannot launch at (m, n, k), or None (also for a ring tile).

    The wide route runs JAX's full-K-resident single-K variant only: one K interval
    (gk == 1); and it has no loads producer: TMA reads A (K % 8 == 0), B and B_t, and
    stores C (N % 8 == 0).  The bases' 16-byte alignment is checked where the tensors are
    known (``ops.matmul.check_operands``)."""
    if not is_wide(cfg.bm, cfg.bn):
        return None
    block = f"the wide block {cfg.bm}x{cfg.bn}"
    if cdiv(k, cfg.bk) > 1:
        return (f"{block} runs one K interval only (gk == 1, bk >= K): bk={cfg.bk} < "
                f"K={k}; a wide K carry is not ported")
    if k % 8:
        return (f"{block} reads A by TMA and has no loads producer: K={k} is not a "
                "multiple of 8")
    if n % 8:
        return (f"{block} reads B and stores C by TMA and has no loads producer: N={n} is "
                "not a multiple of 8")
    return None


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
        sentinel.  Tiles are carried as they are; ``validate`` judges them."""
        d = {k: v for k, v in d.items() if k not in _TPU_ONLY_FIELDS}
        use_xla = d.pop("use_xla", False)
        xla_variant = d.pop("xla_variant", "matmul")
        if use_xla:
            d["use_vendor"] = True
            d["vendor_variant"] = _vendor_for_xla(xla_variant)
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
        ``pipeline_depth`` of them for a staged config.  A wide block's at K = bk, the
        most a single-K launch of it holds (``wide_smem_bytes``)."""
        if self.wide:
            return wide_smem_bytes(self.bm, self.bk, wide_stages(self.bm, self.bk))
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
        if self.wide:
            err = self._check_wide()
            if err:
                return err
        elif self.bm not in TILE_CHOICES:
            return f"bm={self.bm} is not one of the kernel's tiles {TILE_CHOICES}"
        elif self.bn not in TILE_CHOICES:
            return f"bn={self.bn} is not one of the kernel's tiles {TILE_CHOICES}"
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
            return (f"shared memory: the wide block's A strip of bk={self.bk} leaves less "
                    f"than {WIDE_MIN_STAGES} B stages in the {SMEM_LIMIT}-byte limit")
        if self.smem_bytes() > SMEM_LIMIT:
            return f"shared memory {self.smem_bytes()} exceeds the {SMEM_LIMIT}-byte limit"
        return None

    def _check_wide(self) -> Optional[str]:
        if not (self.bm in WGMMA_TILES or (self.bm % WIDE_SUB_N == 0
                                           and self.bm <= WIDE_BM_MAX)):
            return (f"bm={self.bm} is not a wide block's edge (64, 128 or a multiple of "
                    f"{WIDE_SUB_N} up to {WIDE_BM_MAX})")
        if not (self.bn % WIDE_SUB_N == 0 and self.bn <= WIDE_BN_MAX):
            return (f"bn={self.bn} is not a wide block's edge (a multiple of {WIDE_SUB_N} "
                    f"up to {WIDE_BN_MAX})")
        if self.pipeline_depth:
            return (f"pipeline_depth={self.pipeline_depth}: the staged kernel has no wide "
                    "blocks (a wide block runs one K interval)")
        return None

    def padding_waste(self, m: int, n: int, k: int) -> float:
        """Fraction of the MMA work spent on the zeros of partial tiles (the kernel
        predicates its edges, so the zeros cost MMAs, not copies)."""
        padded = round_up(m, self.bm) * round_up(n, self.bn) * round_up(k, self.bk)
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


def candidate_configs(m: int, n: int, k: int, acc_dtype: str = "float32",
                      max_candidates: int = 64) -> list:
    """The tuner's candidate set for one shape (the role of ``tpul2/config.py:400``).

    Tiles from TILE_CHOICES up to the problem; bk from the JAX package's rule (128..16384
    not above round_up(k, 128), plus the whole K rounded up to KSTEP); both raster orders
    and RHS layouts; 'mask' beside 'pad' only where the blocks do not divide.  Then the
    wide blocks (bm in WGMMA_TILES or WIDE_BM_CHOICES, bn in WIDE_SUB_N or
    WIDE_BN_CHOICES, up to the problem rounded to WIDE_SUB_N, an edge above 128) with bk
    the whole K, where they fit and can launch (``wide_launch_error``).  Configs with more
    than 60% padding waste are dropped.

    The cost prior treats the kernel as bound by device-memory bytes, as the skinny and
    thin-K shapes are on the H100 (and nothing here reaches the tensor-core roof):
    least padding waste first (MMAs on zeros), then a grid that fills the card's NUM_SMS
    SMs, then the fewest bytes the CTAs read (each reads bm x K of A and K x bn of B, so
    larger tiles read less; a wide CTA reads its B once per strip of ``wide_sub_m``
    rows), then bk nearest the heuristic's (bk moves neither bytes nor MMAs on Hopper, so
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
    dimension of at most 32), the picks come from the kept candidates, as in the JAX
    package: the ring's width-32 or swapped tiles.  The ring's stages are as deep
    whatever bk is, and the prior ranks all four raster/layout variants of a (tile, bk)
    ahead of another bk for the same tile, so no two staged candidates differ in bk
    alone.  Then every vendor variant, always, so the tuner can never do worse than
    the library.
    """
    def tiles(dim: int) -> list:
        return [t for t in TILE_CHOICES if t <= round_up(dim, TILE_CHOICES[0])]

    bks = {c for c in _BK_CHOICES if c <= round_up(k, 128)}
    if k <= 2 * _BK_CHOICES[-1]:
        bks.add(round_up(k, KSTEP))  # whole K in one interval (gk == 1)
    blocks = [(bm, bn, bk) for bm in tiles(m) for bn in tiles(n) for bk in sorted(bks)]
    # the wide blocks: JAX's edges above 128 up to the problem, with the whole K in one
    # interval (its "full-K-resident bk = k" variant)
    blocks += [(bm, bn, round_up(k, KSTEP))
               for bm in WGMMA_TILES + WIDE_BM_CHOICES if bm <= round_up(m, WIDE_SUB_N)
               for bn in (WIDE_SUB_N,) + WIDE_BN_CHOICES if bn <= round_up(n, WIDE_SUB_N)
               if is_wide(bm, bn)]
    out, seen = [], set()
    for bm, bn, bk in blocks:
        for order in ("mn", "nm"):
            for rhs in ("kn", "nk"):
                edges = ("pad", "mask") if (m % bm or n % bn or k % bk) else ("pad",)
                for edge in edges:
                    cfg = KernelConfig(bm=bm, bn=bn, bk=bk, acc_dtype=acc_dtype,
                                       grid_order=order, rhs_layout=rhs, edge=edge)
                    if (cfg in seen or cfg.validate() is not None
                            or wide_launch_error(cfg, m, n, k) is not None
                            or cfg.padding_waste(m, n, k) > 0.6):
                        continue
                    seen.add(cfg)
                    out.append(cfg)

    heuristic_bk = _pick_bk(k)

    def prior(c: KernelConfig) -> tuple:
        gm, gn = cdiv(m, c.bm), cdiv(n, c.bn)
        # a wide CTA reads its block's B once per strip of wide_sub_m rows
        b_reads = c.bm // wide_sub_m(c.bm) if c.wide else 1
        return (round(c.padding_waste(m, n, k), 6),
                -min(1.0, gm * gn / NUM_SMS),
                gm * gn * (c.bm + b_reads * c.bn) * round_up(k, c.bk),
                abs(math.log2(c.bk / heuristic_bk)),
                0 if c.grid_order == "mn" else 1)

    out.sort(key=prior)
    ring = [c for c in out if c.bm in WGMMA_TILES and c.bn in WGMMA_TILES]
    out = out[:max_candidates]
    if min(m, n) <= 256 and k >= 2048:
        deep = []
        for c in (ring or out)[:min(4, max_candidates // 2)]:
            if c.edge == "mask" or m % c.bm or n % c.bn or k % c.bk or k // c.bk < 3:
                continue
            for depth in (2, 4):
                d = dataclasses.replace(c, pipeline_depth=depth)
                if d.validate() is None:
                    deep.append(d)
        out.extend(deep)
    out.extend(KernelConfig.vendor(v) for v in VENDOR_VARIANTS)
    return out
