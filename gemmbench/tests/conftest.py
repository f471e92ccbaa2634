"""The benchmark's own tests (the repository's suite under tests/ does not collect them):

    python -m pytest gemmbench/tests -q

from the root of the repository.  Tests marked ``gpu`` need a CUDA card and skip without
one; each decides inside a fixture.  Nothing here imports jax."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(REPO))

BENCH = REPO / "gemmbench"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (an H100); skipped where none is present")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)


#: Cells small enough for the CPU, driven through the program's plain versions: a grid
#: whose K of 1536 is carried over two intervals on the ring and whose 1536x32x32 goes to
#: the sentinel, and three layers of three linears and three held experts, at 16 rows a
#: step of one layer (prefill) and at 8 rows a whole step (decode; a CUDA graph on the
#: card, run as it is on the CPU).
TINY_GRID = {"name": "tiny_grid", "dims": [16, 32, 1536]}
TINY_LAYERS = {"name": "tiny_layers", "num_hidden_layers": 3, "n_routed_experts": 3,
               "num_experts_per_tok": 2,
               "linears": [{"name": "a", "n": 96, "k": 1536}, {"name": "b", "n": 64, "k": 512},
                           {"name": "c", "n": 32, "k": 2048},
                           {"name": "g", "n": 48, "k": 1536, "grouped": True}]}


def tiny_workloads() -> dict:
    grid = json.loads((BENCH / "workloads" / "cudal2_grid.f32_offline.json").read_text())
    grid.update(config="tiny_grid", a_pool_bytes=1 << 22, b_rotate_below_bytes=1 << 20,
                check={"extra_shapes": 4, "max_kept_bytes": 1 << 24})
    prefill = json.loads((BENCH / "workloads" / "dsv3_ep32.prefill_m4096.json").read_text())
    prefill.update(config="tiny_layers", m=16, trace_steps=3, check={"layers_kept": 2})
    decode = json.loads((BENCH / "workloads" / "dsv3_ep144.decode_m64.json").read_text())
    decode.update(config="tiny_layers", m=8, trace_steps=2, check={"layers_kept": 2})
    return {"tiny_grid.f32_offline": grid, "tiny_layers.prefill": prefill,
            "tiny_layers.decode": decode}


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's metric readers with the tiny cells' files beside them."""
    root = tmp_path / "bench"
    shutil.copytree(BENCH / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    for cfg in (TINY_GRID, TINY_LAYERS):
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, wl in tiny_workloads().items():
        (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    return root
