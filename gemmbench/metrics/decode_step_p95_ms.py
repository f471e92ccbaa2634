"""The 95th percentile over the window's steps (decode_step_ms's), each from the CUDA event
after the step before to the event after its own, recorded in the traced run only."""
from gemmbench.readers import percentile_95

KIND = "per_layer"
UNIT = "ms"
MOVES = "decode_step_ms"


def read(rec):
    return percentile_95(rec.win.step_ms)
