"""The reductions the metric files under ``metrics/`` share.

Each takes the run's record (``bench.Record``: ``setup_s``, the window ``win``, the
reduced device trace ``trace`` or None, the card's ``peaks`` or None) and returns a number,
or None where the run has nothing to read: never 0 for a share of a roofline or a peak.
"""

from __future__ import annotations

import numpy as np


def percentile_95(values) -> float | None:
    return float(np.percentile(values, 95)) if len(values) else None


def vendor_call_share(rec) -> float | None:
    w = rec.win
    return 100.0 * w.vendor_calls / w.calls if w.calls else None


def roofline_pct(rec) -> float | None:
    """Σ of the profiled calls' least times over Σ of the device time of every kernel they
    launched."""
    t = rec.trace
    if t is None or not t["kernel_s"]:
        return None
    return 100.0 * t["least_s"] / t["kernel_s"]


def mfu_pct(rec) -> float | None:
    """The window's operations over the window's wall time at the card's peak rate."""
    w = rec.win
    if rec.peaks is None or not w.wall_s or not w.flops:
        return None
    return 100.0 * w.flops / (w.wall_s * rec.peaks.flops)


def device_idle_pct(rec) -> float | None:
    t = rec.trace
    if t is None or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def vendor_busy_pct(rec) -> float | None:
    """The share of kernel time in kernels that are not the program's own (``tl2_``)."""
    t = rec.trace
    if t is None or not t["kernel_s"]:
        return None
    return 100.0 * (t["kernel_s"] - t["program_kernel_s"]) / t["kernel_s"]
