"""Host microseconds per call in the program's dispatch: the self time of its tl2.dispatch
spans (resolve_config) over its tl2.call spans, in the traced part's session that
recorded the card alone."""
from gemmbench.spans import us_per_call

KIND = "per_layer"
UNIT = "us"
MOVES = "grid_geomean_tflops"


def read(rec):
    return us_per_call("tl2.dispatch", "tl2.call")
