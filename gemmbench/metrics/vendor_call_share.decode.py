"""The share of the window's calls whose shape the dispatch (resolve_config, read once per
shape at set-up) sends to the vendor sentinel."""
from gemmbench.readers import vendor_call_share as read  # noqa: F401

KIND = "per_layer"
UNIT = "%"
MOVES = "decode_step_ms"
