"""Host microseconds per call the program sent to the vendor sentinel: the self time of its
tl2.sentinel spans (the library switch and the library's GEMM) over their number, in the
traced part's session that recorded the card alone."""
from gemmbench.spans import us_per_call

KIND = "per_layer"
UNIT = "us"
MOVES = "grid_geomean_tflops"


def read(rec):
    return us_per_call("tl2.sentinel", "tl2.sentinel")
