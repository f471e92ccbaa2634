"""Σ over the profiled calls of each GEMM's least time (yardstick.least_s, from its shape,
whatever implements it; a grouped one counts its routed rows) over Σ of the device time
of every kernel those calls launched."""
from gemmbench.readers import roofline_pct as read  # noqa: F401

KIND = "per_layer"
UNIT = "%"
MOVES = "decode_step_ms"
