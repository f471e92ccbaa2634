"""The share of the profiled kernel time spent in kernels that are not the program's own
(names not starting with tl2_): the vendor sentinel's library and torch."""
from gemmbench.readers import vendor_busy_pct as read  # noqa: F401

KIND = "per_layer"
UNIT = "%"
MOVES = "decode_step_ms"
