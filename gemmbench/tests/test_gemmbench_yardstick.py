"""The yardstick's arithmetic against values worked by hand."""

import math

import pytest

from gemmbench import yardstick


def test_flops_and_bytes_by_hand():
    assert yardstick.flops(4096, 4096, 4096) == 2 * 4096 ** 3 == 137438953472
    # A 64x8192 and B 8192x8192 read once, C 64x8192 written once, 2 bytes each
    assert yardstick.bytes_moved(64, 8192, 8192) == (524288 + 67108864 + 524288) * 2


@pytest.mark.parametrize("mnk, bound_s, by", [
    ((4096, 4096, 4096), 137438953472 / 989e12, "flops"),        # 0.13897 ms
    ((64, 8192, 8192), 136314880 / 3.35e12, "bytes"),             # 0.04069 ms
    ((64, 7168, 16384), (64 * 16384 + 16384 * 7168 + 64 * 7168) * 2 / 3.35e12, "bytes"),
])
def test_least_time_is_the_larger_bound(mnk, bound_s, by):
    assert math.isclose(yardstick.least_s(*mnk), bound_s, rel_tol=1e-12)
    f, b = yardstick.flops(*mnk) / 989e12, yardstick.bytes_moved(*mnk) / 3.35e12
    assert (f > b) == (by == "flops")


def test_peaks_are_the_h100_sxm_data_sheet():
    assert yardstick.PEAKS["NVIDIA H100 80GB HBM3"] == (989e12, 3.35e12)


def test_grouped_work_counts_routed_rows_only():
    loads = [384, 128]  # two held experts at decode
    assert yardstick.grouped_flops(loads, 4096, 7168) == 2 * 512 * 4096 * 7168
    moved = (512 * 7168 + 2 * 7168 * 4096 + 512 * 4096) * 2  # each expert's weight once
    assert math.isclose(yardstick.grouped_least_s(loads, 4096, 7168),
                        max(2 * 512 * 4096 * 7168 / 989e12, moved / 3.35e12), rel_tol=1e-12)
    # at prefill's loads the operations bound it
    pre = [6144, 2048]
    assert math.isclose(yardstick.grouped_least_s(pre, 4096, 7168),
                        yardstick.grouped_flops(pre, 4096, 7168) / 989e12, rel_tol=1e-12)
