"""Hopper kernels of tpul2_torch, their wrappers and plain versions, and the baselines."""

#: Every wrapper's launch counter (each adds one where it launches its kernel), by key:
#: (module under tpul2_torch.ops, attribute).  The 2-D and batched multi-K and single-K
#: bodies on each route (the ring with TMA or the loads producer; a wide block,
#: tl2_wgmma_wide.cu, with TMA or with the loads producer and predicated stores); the
#: width-32, swapped, mid-stage, streamed-A and tall-block launches of either, and those of
#: the JAX space's narrow and unaligned edges (a ring block narrower than its tile, the
#: swapped wide walk, narrow columns, a clipped wide block, more than 16384 columns); every
#: launch's store of C (by TMA from shared memory, or predicated, ``matmul.launch_store``,
#: the staged kernel's included); the
#: staged kernel's launches on each route, with a split, on a block with an edge of 32 or
#: less, and at a wide block.
COUNTERS = {
    **{f"{prefix}{body}_k_{route}": (mod, f"LAUNCHES_{body.upper()}_K_{route.upper()}")
       for prefix, mod in (("", "matmul"), ("batched_", "batched"))
       for body in ("multi", "single")
       for route in ("wgmma", "wgmma_lsu", "wgmma_wide", "wgmma_wide_lsu")},
    **{key: ("matmul", f"LAUNCHES_{key.upper()}")
       for key in ("width32", "swapped", "midstage", "wide_streamed", "wide_tall",
                   "ring_narrow", "wide_swapped", "wide_narrow_n", "wide_clipped",
                   "wide_long", "c_tma_store", "c_predicated")},
    **{f"staged_{key}": ("pipelined", f"LAUNCHES_STAGED_{key.upper()}")
       for key in ("ring", "ring_lsu", "split", "narrow", "wide")},
}

def _modules() -> dict:
    from tpul2_torch.ops import batched, matmul, pipelined
    return {"matmul": matmul, "batched": batched, "pipelined": pipelined}


def launch_counts() -> dict:
    """The value of every counter of COUNTERS.  A harness that wants the launches of one
    measurement takes the difference of two readings."""
    mods = _modules()
    return {key: getattr(mods[mod], attr) for key, (mod, attr) in COUNTERS.items()}


def zero_launch_counts() -> None:
    """Set every counter of COUNTERS to 0."""
    mods = _modules()
    for mod, attr in COUNTERS.values():
        setattr(mods[mod], attr, 0)
