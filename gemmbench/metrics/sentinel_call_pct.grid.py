"""The program's calls sent to the vendor sentinel over all its calls, in %: its own
counters (tpul2_torch.trace, counted where dispatch decides each call's route), over every
call of the run."""
from gemmbench.spans import sentinel_call_pct

KIND = "per_layer"
UNIT = "%"
MOVES = "grid_geomean_tflops"


def read(rec):
    return sentinel_call_pct()
