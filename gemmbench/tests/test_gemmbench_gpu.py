"""On the card: each cell at its own size for a short window is correct, and its control
(the program's bf16-accumulator family) is not.  ``python -m pytest gemmbench/tests -m gpu``
on a machine with an H100; skipped elsewhere."""

import gc
import time

import pytest
import torch

from gemmbench import bench, spec


@pytest.mark.gpu
@pytest.mark.parametrize("cell", spec.workload_names())
def test_the_cell_is_correct_and_its_control_is_not(card, cell):
    sound = bench.run(cell, 2 ** 31 + 101, 1.0, False, card, time.perf_counter())["result"]
    assert sound["correct"] and sound["failed"] == 0, sound["checks"]
    gc.collect()
    torch.cuda.empty_cache()  # the cell's weights again, beside nothing of the first run
    control = bench.run(cell, 2 ** 31 + 102, 1.0, False, card, time.perf_counter(),
                        call="control")["result"]
    assert not control["correct"], control["checks"]
