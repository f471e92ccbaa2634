"""The lowest share, over the dense linears, of Σ each call's least time (yardstick.least_s,
from the shape its span records) over Σ the device interval the program's CUDA events
took around each of its launches, in the traced part's session that recorded the card
alone."""
from gemmbench.spans import worst_dense_roofline_pct

KIND = "per_layer"
UNIT = "%"
MOVES = "gemm_tflops"


def read(rec):
    return worst_dense_roofline_pct()
