"""Hopper kernels of tpul2_torch, their wrappers and plain versions, and the baselines."""


def launch_counts() -> dict:
    """Every wrapper's launch counter (each adds one where it launches its kernel): the
    2-D and batched multi-K and single-K bodies on each route, and the staged kernel's
    ring, mma.sync and split launches.  A harness that wants the launches of one
    measurement takes the difference of two readings."""
    from tpul2_torch.ops import batched, matmul, pipelined
    counts = {f"{prefix}{body}_k_{route}": getattr(mod, f"LAUNCHES_{body.upper()}_K_"
                                                        f"{route.upper()}")
              for prefix, mod in (("", matmul), ("batched_", batched))
              for body in ("multi", "single") for route in ("wgmma", "mma_sync")}
    for key in ("ring", "mma_sync", "split"):
        counts[f"staged_{key}"] = getattr(pipelined, f"LAUNCHES_STAGED_{key.upper()}")
    return counts
