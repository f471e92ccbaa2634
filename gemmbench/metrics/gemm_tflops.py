"""2·M·N·K of every call enqueued in the window over the window's wall time; the window
ends on a synchronize."""
KIND = "end_to_end"
UNIT = "TFLOP/s"


def read(rec):
    w = rec.win
    return w.flops / w.wall_s / 1e12 if w.wall_s and w.calls else None
