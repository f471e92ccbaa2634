"""Whole runs but the look for a card, on the CPU with the program's plain versions: a
sound run is correct; the control (the program's bf16-accumulator family, the precision
below the configuration's float32) and each fault of the timed path are not; a workload
file added beside the others runs with no code edited."""

import functools
import json
import time

import pytest
import torch

from gemmbench import bench, spec
from gemmbench.tests.conftest import BENCH
from tpul2_torch import dispatch

CPU = torch.device("cpu")
CELLS = ["tiny_grid.f32_offline", "tiny_layers.prefill", "tiny_layers.decode"]


def _run(root, cell, trace=False, call="call", seed=2 ** 31 + 5):
    return bench.run(cell, seed, 0.3, trace, CPU, time.perf_counter(), call=call, root=root)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    res = out["result"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["checked"] >= 2 and res["checks"]["max_ulp_gap"]["value"] < 0.6  # half a step and the f32 sums
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"setup_s", *spec.workload(cell, tiny_root)["end_to_end"]}
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_the_traced_run_reads_its_per_layer_metrics(tiny_root, cell):
    res = _run(tiny_root, cell, trace=True)["result"]
    assert res["correct"] and "breakdown" in res
    assert "busy_s" in res["device"] and res["device"]["window_s"] > 0
    e2e = {"setup_s", *spec.workload(cell, tiny_root)["end_to_end"]}
    moving = {n for n, r in spec.readers(tiny_root).items()
              if r.KIND == "per_layer" and r.MOVES in e2e}
    assert set(res["metrics"]) <= moving
    # no device trace and no peaks on the CPU: the device's shares read nothing, never 0
    assert not any(n.startswith(("roofline_pct", "device_idle_pct", "mfu_pct"))
                   for n in res["metrics"])
    if cell.startswith("tiny_grid"):
        assert "vendor_call_share.grid" in res["metrics"]
    if cell.endswith("decode"):
        assert {"decode_step_p95_ms", "vendor_call_share.decode"} <= set(res["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, cell):
    res = _run(tiny_root, cell, call="control")["result"]
    assert not res["correct"]
    assert res["checks"]["max_ulp_gap"]["value"] > res["checks"]["max_ulp_gap"]["limit"]


def _broken(fault):
    """Wrap a program entry so that every output it returns is broken by ``fault``."""
    def wrap(fn):
        stale = {}

        @functools.wraps(fn)
        def entry(a, b, *rest, **kw):
            c = fn(a, b, *rest, **kw)
            if fault == "element":   # an answer altered where it is produced, by its rms
                c.view(-1)[c.numel() // 2] += c.float().pow(2).mean().sqrt()
            elif fault == "half":    # half of the batch left out: rows, or held experts
                c[c.shape[0] // 2:] = 0
            elif fault == "stale":   # the state returned unchanged: the shape's first output
                c = stale.setdefault(tuple(c.shape), c)
            return c
        return entry
    return wrap


@pytest.mark.parametrize("fault", ["element", "half", "stale"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    for name in ("cuda_l2_h100_f32", "matmul", "batched_matmul"):
        monkeypatch.setattr(dispatch, name, _broken(fault)(getattr(dispatch, name)))
    res = _run(tiny_root, cell)["result"]
    assert not res["correct"]


def test_a_raising_call_counts_as_failed(tiny_root, monkeypatch):
    calls = []

    def entry(a, b, b_t):
        calls.append(1)
        if len(calls) % 7 == 0:
            raise RuntimeError("launch refused")
        return (a.float() @ b.float()).bfloat16()
    monkeypatch.setattr(dispatch, "cuda_l2_h100_f32", entry)
    res = _run(tiny_root, "tiny_grid.f32_offline")["result"]
    assert res["failed"] > 0 and not res["correct"]
    assert res["checks"]["failed_calls"] == {"value": res["failed"], "limit": 0}


def test_a_workload_file_added_runs_with_no_code_edit(tiny_root):
    wl = json.loads((tiny_root / "workloads" / "tiny_layers.decode.json").read_text())
    wl.update(traffic="decode_m4", m=4, expert_skew=0.0)
    (tiny_root / "workloads" / "tiny_layers.decode_m4.json").write_text(json.dumps(wl))
    assert "tiny_layers.decode_m4" in spec.workload_names(tiny_root)
    res = _run(tiny_root, "tiny_layers.decode_m4")["result"]
    assert res["correct"] and set(res["metrics"]) == {"setup_s", "decode_step_ms"}
    traced = _run(tiny_root, "tiny_layers.decode_m4", trace=True)["result"]
    assert {"decode_step_p95_ms", "vendor_call_share.decode"} <= set(traced["metrics"])


def test_grouped_outputs_are_checked_expert_by_expert(tiny_root):
    out = _run(tiny_root, "tiny_layers.prefill")
    grouped = [w for w in out["gaps"] if ".g.expert" in w]
    assert len(grouped) == 2 * 3  # two kept layers, three held experts each
    assert max(out["rel_errs"].values()) < 2e-3  # a bf16 rounding


def test_a_whole_step_counts_every_layers_calls(tiny_root):
    res = _run(tiny_root, "tiny_layers.decode")["result"]
    wl = spec.workload("tiny_layers.decode", tiny_root)
    calls = len(wl["config_spec"]["linears"])
    # the warm calls of one layer, then whole steps of three layers each
    assert (res["attempted"] - calls) % (3 * calls) == 0 and res["attempted"] > calls


def test_the_cells_files_are_found_by_name():
    bm = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    readers = spec.readers()
    for cell in bm["workloads"]:
        wl = spec.workload(cell["name"])
        assert (wl["config"], wl["traffic"], wl["chips"]) == (
            cell["config"], cell["traffic"], cell["chips"])
    for metric in bm["end_to_end"] + bm["per_layer"]:
        r = readers[metric["name"]]
        assert r.UNIT == metric["unit"]
        if metric in bm["per_layer"]:
            assert r.KIND == "per_layer" and r.MOVES == metric["moves"]
            for cell in metric["workloads"]:
                assert r.MOVES in spec.workload(cell)["end_to_end"]
    assert set(readers) == {m["name"] for m in bm["end_to_end"] + bm["per_layer"]}
