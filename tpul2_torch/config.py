"""Kernel configuration space of the Hopper GEMM kernels.

Counterpart of ``tpul2/config.py``.  One dataclass names a point of the searched space;
field names are the JAX package's, so a configuration carries across
(``KernelConfig.from_jax``).  What the fields mean on Hopper:

  bm, bn          CTA output tile; one of TILE_CHOICES.  Two bodies serve them, picked per
                  launch by ``ops.matmul.multi_k_route``: a K carry (gk > 1) on a tile of
                  64 or 128 in both edges, with bk % 64 == 0 and operands TMA can read,
                  runs tl2_wgmma.cu (m64 x bn wgmmas, one consumer warpgroup per 64 rows,
                  a TMA ring of 64-deep K stages); everything else, the 32-edge tiles and
                  every gk == 1 launch included, runs tl2_matmul.cu (each warp a 32 x 32
                  sub-tile of m16n8k16 MMAs).  ``smem_bytes`` models tl2_matmul.cu; the
                  wgmma ring (``ops.matmul.wgmma_smem_bytes``, 132 KB at 128 x 128) fits
                  every tile, so ``validate`` needs no second model
  bk              the K interval after which the running sum is rounded to ``acc_dtype``
                  (the JAX meaning, ``tpul2/ops/matmul.py:116``); a multiple of KSTEP, the
                  kernel's shared-memory K step
  acc_dtype       'float32' (F32F16F16F32 family) or 'bfloat16' (F16F16F16F16 family)
  grid_order      CTA raster order: 'mn' walks N fastest, 'nm' walks M fastest
  rhs_layout      'kn' reads B (K, N); 'nk' reads B_t (N, K)
  edge            'pad' or 'mask': the same launch on Hopper, since the kernel predicates
                  its own loads and stores; kept so configurations carry across
  pipeline_depth  0: the single-stage kernel (tl2_matmul.cu); 2..8: the staged kernel
                  (tl2_staged.cu, the port of ``tpul2/ops/pipelined.py``) with a ring of
                  this many K slices in shared memory, fed by cp.async
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

#: Output tile edges the kernels are instantiated for (TL2_TILE, TL2_STAGED_TILE).
TILE_CHOICES = (32, 64, 128)
#: K depth of one shared-memory stage (tl2_matmul.cu KSTEP); every bk is a multiple.
KSTEP = 32
#: Row padding of the shared-memory tiles, in bf16 elements (tl2_matmul.cu KPAD).
KPAD = 8
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

#: Candidate-space revision, stamped into TuneDB entries.  1 = the first Hopper space:
#: TILE_CHOICES tiles, the JAX package's bk rule, the kStage axis, the vendor variants.
SPACE_REV = 1

#: TPU-only fields of ``tpul2.config.KernelConfig`` that have no Hopper meaning.
_TPU_ONLY_FIELDS = ("vmem_limit_bytes", "parallel_mn")


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

    def smem_bytes(self) -> int:
        """Shared memory of one CTA, rows padded by KPAD: one stage of the A and B tiles,
        or ``pipeline_depth`` of them for the staged kernel (``tl2_staged_smem_bytes``)."""
        return max(1, self.pipeline_depth) * (self.bm + self.bn) * (KSTEP + KPAD) * 2

    def validate(self) -> Optional[str]:
        """Return an error string if the kernel cannot run this config, else None."""
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
        if self.bm not in TILE_CHOICES:
            return (f"bm={self.bm} is not one of the kernel's tiles {TILE_CHOICES} "
                    "(multiples of the 32x32 warp tile of m16n8k16 MMAs)")
        if self.bn not in TILE_CHOICES:
            return (f"bn={self.bn} is not one of the kernel's tiles {TILE_CHOICES} "
                    "(multiples of the 32x32 warp tile of m16n8k16 MMAs)")
        if self.bk <= 0 or self.bk % KSTEP:
            return f"bk={self.bk} is not a positive multiple of the kernel's K step {KSTEP}"
        if self.acc_dtype not in ("float32", "bfloat16"):
            return f"unsupported acc_dtype {self.acc_dtype}"
        if self.grid_order not in ("mn", "nm"):
            return f"bad grid_order {self.grid_order}"
        if self.rhs_layout not in ("kn", "nk"):
            return f"bad rhs_layout {self.rhs_layout}"
        if self.smem_bytes() > SMEM_LIMIT:
            return f"shared memory {self.smem_bytes()} exceeds the {SMEM_LIMIT}-byte limit"
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
    thin problem still spreads over the card.  Never returns the vendor sentinel."""
    def edge(dim: int) -> int:
        return next((t for t in TILE_CHOICES if t >= dim), TILE_CHOICES[-1])

    bm, bn = edge(m), edge(n)
    while cdiv(m, bm) * cdiv(n, bn) < NUM_SMS and max(bm, bn) > TILE_CHOICES[0]:
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
    and RHS layouts; 'mask' beside 'pad' only where the blocks do not divide.  Configs
    with more than 60% padding waste are dropped.

    The cost prior treats the kernel as bound by device-memory bytes, as the skinny and
    thin-K shapes are on the H100 (and nothing here reaches the tensor-core roof):
    least padding waste first (MMAs on zeros), then a grid that fills the card's NUM_SMS
    SMs, then the fewest bytes the CTAs read (each reads bm x K of A and K x bn of B, so
    larger tiles read less), then bk nearest the heuristic's (bk moves neither bytes nor
    MMAs on Hopper, so ties keep an untuned shape's rounding points), then 'mn' raster.
    The first ``max_candidates`` are kept.

    Then the kStage axis exactly as the JAX package gates it (``tpul2/config.py:503``):
    only on streaming shapes (min(m, n) <= 256 and k >= 2048), from the top 4 picks
    whose blocks divide the problem with at least 3 K intervals, at depths 2 and 4.
    tl2_staged.cu's ring slots are 32 deep whatever bk is, and the prior ranks all four
    raster/layout variants of a (tile, bk) ahead of another bk for the same tile, so no
    two staged candidates differ in bk alone.  Then every vendor variant, always, so the tuner can never do worse than the library.
    """
    def tiles(dim: int) -> list:
        return [t for t in TILE_CHOICES if t <= round_up(dim, TILE_CHOICES[0])]

    bks = {c for c in _BK_CHOICES if c <= round_up(k, 128)}
    if k <= 2 * _BK_CHOICES[-1]:
        bks.add(round_up(k, KSTEP))  # whole K in one interval: the single-K body
    out, seen = [], set()
    for bm in tiles(m):
        for bn in tiles(n):
            for bk in sorted(bks):
                for order in ("mn", "nm"):
                    for rhs in ("kn", "nk"):
                        edges = ("pad", "mask") if (m % bm or n % bn or k % bk) else ("pad",)
                        for edge in edges:
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
        return (round(c.padding_waste(m, n, k), 6),
                -min(1.0, gm * gn / NUM_SMS),
                gm * gn * (c.bm + c.bn) * round_up(k, c.bk),
                abs(math.log2(c.bk / heuristic_bk)),
                0 if c.grid_order == "mn" else 1)

    out.sort(key=prior)
    out = out[:max_candidates]
    if min(m, n) <= 256 and k >= 2048:
        deep = []
        for c in out[:min(4, max_candidates // 2)]:
            if c.edge == "mask" or m % c.bm or n % c.bn or k % c.bk or k // c.bk < 3:
                continue
            for depth in (2, 4):
                d = dataclasses.replace(c, pipeline_depth=depth)
                if d.validate() is None:
                    deep.append(d)
        out.extend(deep)
    out.extend(KernelConfig.vendor(v) for v in VENDOR_VARIANTS)
    return out
