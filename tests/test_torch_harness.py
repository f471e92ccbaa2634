"""tpul2_torch.harness: the gate (with guard bands), the offline bench, the summary and
the driver script, run on the CPU through the plain versions."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import tpul2.harness.correctness as jcorr
import tpul2.utils.padding as jpad
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.harness import bench_utils as bu
from tpul2_torch.harness import correctness as corr
from tpul2_torch.harness.bench_offline import benchmark_offline_all
from tpul2_torch.harness.summarize import speedup_row, summarize_results
from tpul2_torch.utils import padding, platform

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def empty_tunedb(tmp_path, monkeypatch):
    """These tests hold the heuristic: TPUL2_TORCH_TUNEDB names a file that is not there,
    so no DB, the committed one included, steers their resolution."""
    monkeypatch.setenv(db_mod.ENV_VAR, str(tmp_path / "empty_tunedb.json"))
    db_mod.reset_default_db()
    yield
    db_mod.reset_default_db()


def _load_eval():
    spec = importlib.util.spec_from_file_location(
        "eval_one_shape_torch", REPO / "scripts" / "eval_one_shape_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_eval_one_shape_end_to_end_on_cpu(tmp_path, acc):
    rc = _load_eval().main(["--device", "cpu", "--mnk", "96", "160", "200", "--acc", acc,
                            "--base_dir", str(tmp_path), "--warmup_seconds", "0.05",
                            "--benchmark_seconds", "0.2", "--correctness_iters", "2"])
    assert rc == 0
    gate = json.loads((tmp_path / "zero_one_correctness_check_result.json").read_text())
    assert gate["pass"] and gate["device"] == "cpu"
    assert gate["stats"]["guard_hits"] == 0 and gate["stats"]["guard_iterations"] == 2
    assert all(gate["variants"][v] for v in ("plain_nn", "tn", "fused_bias_relu", "batched"))
    summary = (tmp_path / "summary.md").read_text()
    assert "| cuBLAS-max |" in summary and "| cuBLASLt-max |" in summary
    assert "· cpu" in summary
    row = json.loads((tmp_path / "speedup_row.json").read_text())
    assert row["mnk"] == "96x160x200"
    assert row["cuBLAS-max"] == min(row["cuBLAS-nn"], row["cuBLAS-tn"])
    assert "| cuBLASLt-auto-tuning-max |" in summary
    assert len(list(tmp_path.glob("benchmark_result_*.json"))) == 7


def test_eval_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert _load_eval().main(["--mnk", "8", "8", "8", "--base_dir", str(tmp_path)]) == 1


def _candidate(write):
    def fn(a, b, b_t, out=None):
        res = (a.float() @ b.float()).to(out.dtype)
        out.copy_(res)
        write(out)
        return out
    return fn


def _poke(out, offset):
    """Write one element at ``offset`` from the start of ``out`` in its storage."""
    flat = torch.as_strided(out, (1,), (1,), out.storage_offset() + offset)
    flat.fill_(7.0)


@pytest.mark.parametrize("where", ["past_end", "before_start"])
def test_guard_band_catches_an_out_of_bounds_write(where):
    m, n, k = 24, 40, 56
    offset = m * n if where == "past_end" else -1
    bad = _candidate(lambda out: _poke(out, offset))
    res = corr.run_correctness_check(m, n, k, iterations=2, device="cpu",
                                     funcs={corr.CANDIDATE: bad})
    assert not res["pass"]
    assert res["failure"] == "memory overflow detected."
    assert res["stats"]["guard_hits"] == 2


def test_gate_fails_an_off_by_one_candidate():
    def off_by_one(a, b, b_t, out=None):
        res = a[:, 1:].float() @ b[1:, :].float()   # drops one K column
        return out.copy_(res.to(out.dtype))
    res = corr.run_correctness_check(32, 48, 64, iterations=2, device="cpu",
                                     funcs={corr.CANDIDATE: off_by_one})
    assert not res["pass"] and "avg max diff" in res["failure"]


def test_gate_passes_a_correct_candidate_and_checks_baselines():
    res = corr.run_correctness_check(40, 72, 136, acc="bfloat16", iterations=2,
                                     device="cpu")
    assert res["pass"], res.get("failure")
    assert set(res["stats"]["avg_max_diff"]) == {"torch_matmul", "cublas_nn", "cublas_tn",
                                                 "cublaslt_nn", "cublaslt_tn",
                                                 "cublaslt_autotuned_nn",
                                                 "cublaslt_autotuned_tn", corr.CANDIDATE}
    assert res["variants"]["guard_hits"] == 0


def test_guarded_output_layout():
    buf, c = corr.guarded_output((3, 5), torch.float32, "cpu")
    assert buf.numel() == 2 * corr.GUARD + 15 and c.is_contiguous()
    c.fill_(1.0)
    assert corr.bands_intact(buf)
    buf[corr.GUARD + 15] = 0.0
    assert not corr.bands_intact(buf)


@pytest.mark.parametrize("k", [1, 64, 256, 1000, 8192, 16384])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_density_rule_matches_jax(k, out):
    assert corr.zero_one_density(k, out) == jcorr.zero_one_density(k, out)
    assert corr.zero_one_density(k, getattr(torch, out)) == jcorr.zero_one_density(k, out)
    assert corr.EXACT_BOUND == jcorr.EXACT_BOUND


def _fake_result(tmp_path, pf, speedup):
    r = {"mode": "offline", "mnk": [8, 16, 32], "acc": "float32", "in_dtype": "bfloat16",
         "perf_func": pf, "device": "cpu", "speedup": speedup,
         pf: {"tflops_mean": 1.0}, corr.CANDIDATE: {"tflops_mean": speedup}}
    (tmp_path / f"benchmark_result_{pf}.json").write_text(json.dumps(r))


def test_summary_max_rows_take_the_worst_case(tmp_path):
    for pf, s in [("torch_matmul", 1.0), ("cublas_nn", 0.9), ("cublas_tn", 1.2),
                  ("cublaslt_nn", 1.5), ("cublaslt_tn", 1.1)]:
        _fake_result(tmp_path, pf, s)
    md = summarize_results(tmp_path)
    assert "| cuBLAS-max | 1.000 | 0.900 | 0.9000x |" in md
    assert "| cuBLASLt-max | 1.000 | 1.100 | 1.1000x |" in md
    row = speedup_row(tmp_path, (8, 16, 32))
    assert row["cuBLAS-max"] == 0.9 and row["cuBLASLt-max"] == 1.1


def test_benchmark_offline_schema():
    r = benchmark_offline_all(32, 48, 64, perf_funcs=["cublas_tn"], warmup_seconds=0.0,
                              benchmark_seconds=0.05, device="cpu")["cublas_tn"]
    for key in ("per_call_ms", "tflops_mean", "tflops_median", "p99_ms", "iters"):
        assert key in r["cublas_tn"] and key in r[corr.CANDIDATE]
    assert r["speedup"] == r["cublas_tn"]["per_call_ms"] / r[corr.CANDIDATE]["per_call_ms"]
    assert r["device"] == "cpu" and r["version"] == bu.VERSION_STAMP


def test_fresh_inputs_layouts_and_seeding():
    a, b, b_t = bu.fresh_inputs(np.random.default_rng(0), 8, 16, 32, device="cpu")
    assert a.shape == (8, 32) and b.shape == (32, 16) and b_t.shape == (16, 32)
    assert b_t.is_contiguous() and torch.equal(b_t, b.t())
    a2, _, _ = bu.fresh_inputs(np.random.default_rng(0), 8, 16, 32, device="cpu")
    assert torch.equal(a, a2) and a.dtype == torch.bfloat16


def test_stats_and_tflops():
    s = bu.percentile_stats([1.0, 2.0, 3.0])
    assert s["mean_ms"] == 2.0 and s["median_ms"] == 2.0 and s["iters"] == 3
    assert bu.tflops(1000, 1000, 1000, 1.0) == pytest.approx(2.0)


@pytest.mark.parametrize("x,m", [(0, 8), (1, 8), (8, 8), (9, 128), (300, 32)])
def test_padding_helpers_match_jax(x, m):
    assert padding.cdiv(x, m) == jpad.cdiv(x, m)
    assert padding.round_up(x, m) == jpad.round_up(x, m)


def test_pad_to():
    x = torch.ones((3, 5))
    y = padding.pad_to(x, 4, 8)
    assert y.shape == (4, 8) and y.sum() == 15 and padding.pad_to(x, 3, 5) is x


def test_platform_record_on_cpu():
    info = platform.device_info()
    assert platform.gen() == "h100" and info["gen"] == "h100"
    for key in ("name", "capability", "count", "torch_cuda", "nvcc", "nvidia_smi"):
        assert key in info
    if not torch.cuda.is_available():
        assert info["name"] == "cpu"
        with pytest.raises(RuntimeError):
            platform.require_hopper()
