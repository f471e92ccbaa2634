"""The yardstick: a GEMM's operations, bytes and least time on the card, and the peaks.

Copied from the program's ``harness/bench_utils.bound_ms`` and ``harness/profiling``'s
``DEVICE_PEAKS`` (NVIDIA's data sheet for the H100 SXM, dense rates), so that a change to
the program cannot move the yardstick.  The least time is counted from the call's shape
alone: A and B read once, C written once, 2·M·N·K operations.  It reads the same work
whichever kernel, or the vendor library, implements the call.
"""

from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    flops: float  # dense bf16 tensor-core operations per second
    bytes: float  # HBM bytes per second


#: Published peaks by ``torch.cuda.get_device_name()``.
PEAKS = {"NVIDIA H100 80GB HBM3": Peaks(flops=989e12, bytes=3.35e12)}
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def flops(m: int, n: int, k: int) -> float:
    """Operations of C = A @ B: a multiply and an add for each of M·N·K products."""
    return 2.0 * m * n * k


def bytes_moved(m: int, n: int, k: int, in_bytes: int = 2, out_bytes: int = 2) -> float:
    """A (M, K) and B (K, N) read once, C (M, N) written once."""
    return float((m * k + k * n) * in_bytes + m * n * out_bytes)


def least_s(m: int, n: int, k: int, peaks: Peaks = H100, out_bytes: int = 2) -> float:
    """The least time the card could take: the larger of the operations over the peak
    rate and the bytes over the peak bandwidth."""
    return max(flops(m, n, k) / peaks.flops,
               bytes_moved(m, n, k, out_bytes=out_bytes) / peaks.bytes)


def grouped_flops(loads: list, n: int, k: int) -> float:
    """Operations of a grouped product: each expert's routed rows times its (K, N) weight.
    Rows that only pad the batch are no work."""
    return sum(flops(rows, n, k) for rows in loads)


def grouped_least_s(loads: list, n: int, k: int, peaks: Peaks = H100) -> float:
    """The least time of a grouped product as one operation: its operations over the peak
    rate, or every expert's weight and routed rows read and their outputs written once
    over the peak bandwidth, whichever is larger."""
    moved = sum(bytes_moved(rows, n, k) for rows in loads)
    return max(grouped_flops(loads, n, k) / peaks.flops, moved / peaks.bytes)
