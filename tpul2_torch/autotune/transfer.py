"""Neighbour transfer: reuse tuned configs across similar shapes.

Counterpart of ``tpul2/autotune/transfer.py``.  A tuned neighbour's tiling is re-fitted
onto the destination shape and onto the kernel's TILE_CHOICES; a config that the kernel
cannot run afterwards (``validate``, and for a wide block ``wide_launch_error`` at the
destination shape) is dropped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from tpul2_torch.config import KSTEP, TILE_CHOICES, KernelConfig, wide_launch_error
from tpul2_torch.utils.padding import round_up


def _adapt(cfg: KernelConfig, src: tuple, dst: tuple) -> Optional[KernelConfig]:
    """Re-fit a neighbour's config to the destination shape, or None if it is invalid.

    Tiles: a tile that covered its whole source dim, or exceeds the destination dim,
    becomes the smallest TILE_CHOICES tile that covers the destination dim (or the
    largest tile); others carry over.  bk: a whole-K cover stays whole-K (rounded up to
    KSTEP); an oversized bk clamps the same way; others carry over.  A wide block that
    carries over must launch at the destination (one K interval, TMA-readable rows):
    where it cannot, None, as for any config ``validate`` refuses."""
    sm, sn, sk = src
    m, n, k = dst

    def fit_tile(block, src_dim, dst_dim):
        if block == src_dim or block > dst_dim:
            return next((t for t in TILE_CHOICES if t >= dst_dim), TILE_CHOICES[-1])
        return block

    def fit_bk(block):
        if block >= round_up(sk, KSTEP) or block > k:
            return round_up(k, KSTEP)
        return block

    adapted = dataclasses.replace(cfg, bm=fit_tile(cfg.bm, sm, m), bn=fit_tile(cfg.bn, sn, n),
                                  bk=fit_bk(cfg.bk))
    if adapted.validate() is not None or wide_launch_error(adapted, m, n, k) is not None:
        return None
    return adapted


def neighbor_seed_configs(db, m: int, n: int, k: int, acc: str = "float32",
                          in_dtype="bfloat16", limit: int = 3,
                          max_ratio: float = 4.0) -> list:
    """Top adapted kernel configs from the nearest tuned neighbours.

    Neighbours are DB entries of the same family within ``max_ratio`` on every dimension,
    ranked by log-space L1 distance, then by stored speedup; their non-sentinel configs
    are adapted to (m, n, k), deduplicated, and returned (at most ``limit``)."""
    scored = []
    for (em, en, ek), entry in db.entries_near(m, n, k, acc, in_dtype, max_ratio=max_ratio):
        cfg = entry.get("config") or {}
        if cfg.get("use_vendor") or (em, en, ek) == (m, n, k):
            continue
        dist = sum(abs(math.log(max(e, q) / min(e, q)))
                   for e, q in ((em, m), (en, n), (ek, k)))
        scored.append((dist, -entry.get("speedup_vs_torch_matmul", 1.0), (em, en, ek),
                       KernelConfig(**cfg)))
    scored.sort(key=lambda t: (t[0], t[1]))

    out, seen = [], set()
    for _, _, src, cfg in scored:
        adapted = _adapt(cfg, src, (m, n, k))
        if adapted is None or adapted in seen:
            continue
        seen.add(adapted)
        out.append(adapted)
        if len(out) >= limit:
            break
    return out
