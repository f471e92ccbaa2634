"""The readers of the program's own spans and counters (``spans.py``) on CPU runs of each
cell: a number or nothing, never 0 for a share; nothing at all from a program that has no
``tpul2_torch.trace``, as the parent of the change that added it has none."""

import sys
import time

import pytest
import torch

import tpul2_torch
from gemmbench import bench, spec

CELLS = ["tiny_grid.f32_offline", "tiny_layers.prefill", "tiny_layers.decode"]
SPAN_METRICS = {"sentinel_call_pct.grid", "sentinel_call_pct.decode",
                "dispatch_us_per_call.grid", "wrapper_us_per_call.grid",
                "sentinel_us_per_call.grid", "worst_linear_roofline_pct.prefill"}
#: Those a CPU run reads: the counters, and the grid's host times from the session its
#: profiler records (the CPU has no device interval for the roofline).
ON_THE_CPU = {"tiny_grid.f32_offline": {"sentinel_call_pct.grid", "dispatch_us_per_call.grid",
                                        "wrapper_us_per_call.grid",
                                        "sentinel_us_per_call.grid"},
              "tiny_layers.prefill": set(),
              "tiny_layers.decode": {"sentinel_call_pct.decode"}}


@pytest.mark.parametrize("cell", CELLS)
def test_the_span_readers_give_a_number_or_nothing(tiny_root, cell):
    res = bench.run(cell, 2 ** 31 + 11, 0.3, True, torch.device("cpu"), time.perf_counter(),
                    root=tiny_root)["result"]
    got = {name: m["value"] for name, m in res["metrics"].items() if name in SPAN_METRICS}
    assert set(got) == ON_THE_CPU[cell]
    assert all(v > 0 for v in got.values())
    assert all(v <= 100 for name, v in got.items() if "pct" in name)


def test_a_program_without_its_trace_module_reads_nothing(monkeypatch):
    monkeypatch.delattr(tpul2_torch, "trace")
    monkeypatch.setitem(sys.modules, "tpul2_torch.trace", None)  # the import fails
    readers = spec.readers()
    assert all(readers[name].read(None) is None for name in SPAN_METRICS)
