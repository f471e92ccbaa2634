"""The geometric mean over the grid's shapes of each shape's TFLOP/s: the operations of
all its calls in the window over the card time of all its bursts (each burst's calls
enqueued behind a gate and timed back to back between two CUDA events).  Every shape
weighs the same, as in CUDA-L2's tables."""
import numpy as np

KIND = "end_to_end"
UNIT = "TFLOP/s"


def read(rec):
    w = rec.win
    ran = w.shape_s > 0
    if not ran.any():
        return None
    return float(np.exp(np.mean(np.log(w.shape_flops[ran] / w.shape_s[ran] / 1e12))))
