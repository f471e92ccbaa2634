"""Host microseconds per call the program sent to its own kernels, in their wrappers: the
self time of its tl2.wrapper spans (check_operands, the output, launch_args, the ctypes
launch) over their number, in the traced part's session that recorded the card alone."""
from gemmbench.spans import us_per_call

KIND = "per_layer"
UNIT = "us"
MOVES = "grid_geomean_tflops"


def read(rec):
    return us_per_call("tl2.wrapper", "tl2.wrapper")
