"""The 95th percentile over every step of the window; a step runs from the CUDA event after
the step before to the event after its own linears, so idle gaps count."""
from gemmbench.readers import percentile_95

KIND = "end_to_end"
UNIT = "ms"


def read(rec):
    return percentile_95(rec.win.step_ms)
