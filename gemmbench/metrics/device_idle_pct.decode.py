"""The share of the profiled window in which no device operation ran."""
from gemmbench.readers import device_idle_pct as read  # noqa: F401

KIND = "per_layer"
UNIT = "%"
MOVES = "decode_step_ms"
