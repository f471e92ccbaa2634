"""The window's wall time over its steps; one step is one decode step of the batch through
every layer's linears, replayed from a CUDA graph."""
KIND = "end_to_end"
UNIT = "ms"


def read(rec):
    w = rec.win
    return w.wall_s * 1e3 / w.steps if w.steps else None
