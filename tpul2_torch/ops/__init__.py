"""Hopper kernels of tpul2_torch, their wrappers and plain versions, and the baselines.

Each wrapper counts its launches in the program's one registry of counters,
``tpul2_torch.trace.COUNTS`` (keys ``trace.LAUNCHES``), read here as before."""

from tpul2_torch.trace import launch_counts, zero_launch_counts  # noqa: F401
