"""tpul2_torch's shape suite on the CPU: DEFAULT_SHAPES, the CUDA-L2 CSV and its rows
(held against ``scripts/run_suite.py:_row_from_lean``), the resumable runner, and
dispatch through a temporary copy of the committed H100 DB.

``scripts/run_suite.py`` and ``bench.py`` import only the standard library at the top, so
loading them runs no JAX timing loop; only their pure functions and lists are used.
"""

import csv
import dataclasses
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tpul2_torch import dispatch
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.config import KernelConfig
from tpul2_torch.harness import suite

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent
COMMITTED_DB = REPO / "tpul2_torch" / "data" / "tunedb_h100.json"


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tmp_db(tmp_path, monkeypatch):
    path = tmp_path / "db.json"
    monkeypatch.setenv(db_mod.ENV_VAR, str(path))
    db_mod.reset_default_db()
    yield path
    db_mod.reset_default_db()


def test_default_shapes_are_the_jax_harness_suite():
    assert suite.DEFAULT_SHAPES == _load(REPO / "bench.py", "bench_jax").DEFAULT_SHAPES
    assert len(suite.DEFAULT_SHAPES) == len(set(suite.DEFAULT_SHAPES)) == 20


def test_csv_columns_and_order():
    assert suite.CSV_COLUMNS == [
        "mnk", "torch.matmul",
        "cuBLAS-tn", "cuBLAS-nn", "cuBLAS-max",
        "cuBLASLt-heuristic-tn", "cuBLASLt-heuristic-nn", "cuBLASLt-heuristic-max",
        "cuBLASLt-auto-tuning-tn", "cuBLASLt-auto-tuning-nn", "cuBLASLt-auto-tuning-max",
        "device"]
    assert suite.csv_path("eval_results", "bfloat16", "server").name == \
        "tpul2_torch_h100_bfloat16_speedup_server.csv"
    from tpul2_torch.ops.baselines import BASELINES
    assert set(suite.SPEEDUP_COLUMNS) == set(BASELINES)


@pytest.mark.parametrize("seed", range(4))
def test_csv_row_matches_the_jax_suite(seed):
    """The same speedups through both row functions give the same values, the -max
    columns (the lower of each family's rounded pair) included."""
    rng = np.random.default_rng(seed)
    sp = {pf: float(rng.uniform(0.2, 3.0)) for pf in suite.SPEEDUP_COLUMNS}
    if seed == 0:
        sp["cublas_nn"] = sp["cublas_tn"]  # a tie
    ours = suite.row_from_speedups("64x64x4096", sp, "NVIDIA H100 80GB HBM3, 700.00 W")
    jax_suite = _load(REPO / "scripts" / "run_suite.py", "run_suite_jax")
    # the JAX suite's columns name XLA formulations: the same three families, in its keys
    keys = {"torch_matmul": "xla_matmul", "cublas_tn": "xla_dot_tn", "cublas_nn": "xla_dot_nn",
            "cublaslt_tn": "xla_highest_tn", "cublaslt_nn": "xla_highest_nn",
            "cublaslt_autotuned_tn": "xla_autotuned_tn",
            "cublaslt_autotuned_nn": "xla_autotuned_nn"}
    theirs = jax_suite._row_from_lean("64x64x4096", {keys[pf]: v for pf, v in sp.items()})
    names = {"jnp.matmul": "torch.matmul", "XLA-dot": "cuBLAS",
             "XLA-highest": "cuBLASLt-heuristic", "XLA-AutoTuned": "cuBLASLt-auto-tuning"}
    for col, value in theirs.items():
        if col == "mnk":
            assert ours["mnk"] == value
            continue
        stem = next(s for s in names if col == s or col.startswith(s + "-"))
        assert ours[names[stem] + col[len(stem):]] == value, col
    assert list(ours) == suite.CSV_COLUMNS and ours["device"].startswith("NVIDIA")


def test_csv_row_refuses_a_missing_column():
    sp = {pf: 1.0 for pf in suite.SPEEDUP_COLUMNS}
    sp["cublaslt_autotuned_nn"] = None
    with pytest.raises(ValueError, match="cublaslt_autotuned_nn"):
        suite.row_from_speedups("1x2x3", sp, "cpu")


def test_append_row_and_resume(tmp_path):
    path = tmp_path / "x.csv"
    row = suite.row_from_speedups("1x2x3", {pf: 1.0 for pf in suite.SPEEDUP_COLUMNS}, "cpu")
    suite.append_row(path, row)
    suite.append_row(path, dict(row, mnk="4x5x6"))
    with path.open() as f:
        assert next(csv.reader(f)) == suite.CSV_COLUMNS
    assert suite.done_shapes(path) == {"1x2x3", "4x5x6"}
    bad = tmp_path / "bad.csv"
    bad.write_text("mnk,jnp.matmul\n1x2x3,1.0\n")
    with pytest.raises(ValueError, match="columns"):
        suite.append_row(bad, row)


def test_suite_runner_on_cpu_is_resumable(tmp_db, tmp_path):
    runner = _load(REPO / "scripts" / "run_suite_torch.py", "run_suite_torch")
    args = ["eval", "--device", "cpu", "--out_dir", str(tmp_path), "--warmup_seconds", "0",
            "--benchmark_seconds", "0.05", "--correctness_iters", "1"]
    assert runner.main(args + ["--shapes", "64,96,160"]) == 0
    assert runner.main(args + ["--shapes", "64,96,160;32,64,128"]) == 0
    path = tmp_path / "tpul2_torch_h100_float32_speedup_offline.csv"
    with path.open() as f:
        rows = list(csv.DictReader(f))
    assert [r["mnk"] for r in rows] == ["64x96x160", "32x64x128"]
    assert all(r["device"] == "cpu" for r in rows)
    for r in rows:
        for fam in ("cuBLAS", "cuBLASLt-heuristic", "cuBLASLt-auto-tuning"):
            assert float(r[f"{fam}-max"]) == min(float(r[f"{fam}-tn"]), float(r[f"{fam}-nn"]))
    side = [json.loads(ln) for ln in path.with_suffix(".jsonl").read_text().splitlines()]
    assert [s["mnk"] for s in side] == ["64x96x160", "32x64x128"]
    for s in side:
        assert set(s["funcs"]) == {"tpul2_torch", *suite.SPEEDUP_COLUMNS}
        assert all({"median_ms", "p99_ms", "iqr_ms"} <= set(v) for v in s["funcs"].values())
        assert s["device"]["name"] == "cpu" and KernelConfig(**s["config"])


def test_suite_runner_server_mode_needs_target_qps(tmp_path):
    runner = _load(REPO / "scripts" / "run_suite_torch.py", "run_suite_torch")
    with pytest.raises(SystemExit):
        runner.main(["eval", "--device", "cpu", "--mode", "server", "--out_dir", str(tmp_path)])
    assert runner.parse_shapes("default") == suite.DEFAULT_SHAPES
    assert runner.parse_shapes("1,2,3;4,5,6") == [(1, 2, 3), (4, 5, 6)]


def test_committed_db_covers_the_suite():
    db = db_mod.TuneDB(path=COMMITTED_DB).load()
    for acc in ("float32", "bfloat16"):
        for shape in suite.DEFAULT_SHAPES:
            entry = db.get_entry(*shape, acc)
            assert entry is not None, (shape, acc)
            assert entry["timing_rev"] == 2 and entry["device"].startswith("NVIDIA H100")
            assert entry["nvidia_smi"].startswith("NVIDIA H100")
            assert set(entry["device_ms"]) == set(entry["e2e_ms"]) == {"best", "torch_matmul"}
            for sub in (entry, entry["server"]):
                cfg = KernelConfig(**sub["config"])
                assert cfg.use_vendor or cfg.acc_dtype == acc
            assert entry["server"]["target_qps"] == 100.0 and entry["server"]["timing_rev"] == 2


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["offline", "server"])
def test_dispatch_through_a_copy_of_the_committed_db(tmp_path, monkeypatch, acc, mode):
    """Every suite shape resolves to the entry (or the server sub-entry) the committed DB
    holds, and the entry point's result on 0/1 inputs at a small stand-in shape through
    that config is exact."""
    path = tmp_path / "tunedb_h100.json"
    shutil.copy(COMMITTED_DB, path)
    monkeypatch.setenv(db_mod.ENV_VAR, str(path))
    db_mod.reset_default_db()
    try:
        db = db_mod.default_db()
        for shape in suite.DEFAULT_SHAPES:
            entry = db.get_entry(*shape, acc)
            stored = KernelConfig(**(entry["server"] if mode == "server" else entry)["config"])
            got = dispatch.resolve_config(*shape, acc, mode=mode)
            assert got == (stored if stored.validate() is None else KernelConfig.vendor())
        rng = np.random.default_rng(41)
        m, n, k = 64, 96, 160
        a = torch.from_numpy(rng.integers(0, 2, (m, k)).astype(np.float32)).bfloat16()
        b = torch.from_numpy(rng.integers(0, 2, (k, n)).astype(np.float32)).bfloat16()
        for shape in suite.DEFAULT_SHAPES[:4]:
            cfg = dataclasses.replace(dispatch.resolve_config(*shape, acc, mode=mode),
                                      pipeline_depth=0, bk=64)
            out = dispatch.matmul(a, b, acc=acc, config=cfg, out_dtype=torch.float32)
            assert torch.equal(out, a.float() @ b.float())
    finally:
        db_mod.reset_default_db()
