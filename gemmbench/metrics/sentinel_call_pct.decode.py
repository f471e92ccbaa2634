"""The program's calls sent to the vendor sentinel over all its calls, in %: its own
counters (tpul2_torch.trace, counted where dispatch decides each call's route): the warm
calls and the CUDA graph's capture, since a replay runs no Python."""
from gemmbench.spans import sentinel_call_pct

KIND = "per_layer"
UNIT = "%"
MOVES = "decode_step_ms"


def read(rec):
    return sentinel_call_pct()
