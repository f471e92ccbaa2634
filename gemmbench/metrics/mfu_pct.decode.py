"""The whole window's share of the card's peak: its operations over its wall time times
the dense bf16 peak (yardstick.PEAKS); a grouped linear counts its routed rows.
The traced run's window runs as the untraced one does, the profiled parts after it."""
from gemmbench.readers import mfu_pct as read  # noqa: F401

KIND = "per_layer"
UNIT = "%"
MOVES = "decode_step_ms"
