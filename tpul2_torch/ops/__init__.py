"""Hopper kernels of tpul2_torch, their wrappers and plain versions, and the baselines."""

#: Every wrapper's launch counter (each adds one where it launches its kernel), by key:
#: (module under tpul2_torch.ops, attribute).  The 2-D and batched multi-K and single-K
#: bodies on each route (TMA or the loads producer); the 2-D single-K body at a wide block
#: (tl2_wgmma_wide.cu); the width-32, swapped and mid-stage launches of either; the staged
#: kernel's launches on each route, with a split and on a 32-edge tile.
COUNTERS = {
    **{f"{prefix}{body}_k_{route}": (mod, f"LAUNCHES_{body.upper()}_K_{route.upper()}")
       for prefix, mod in (("", "matmul"), ("batched_", "batched"))
       for body in ("multi", "single") for route in ("wgmma", "wgmma_lsu")},
    "single_k_wgmma_wide": ("matmul", "LAUNCHES_SINGLE_K_WGMMA_WIDE"),
    **{key: ("matmul", f"LAUNCHES_{key.upper()}") for key in ("width32", "swapped",
                                                              "midstage")},
    **{f"staged_{key}": ("pipelined", f"LAUNCHES_STAGED_{key.upper()}")
       for key in ("ring", "ring_lsu", "split", "narrow")},
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
