"""tpul2_torch's server mode on the CPU: the TuneDB's server sub-entries, dispatch by mode,
the server twins, the Poisson-arrival bench, the eval script and the tuner in server mode.

The DB and the dispatch resolution are held against the JAX package's on the same
entries (temporary DB files on both sides).  Those JAX functions are pure lookups and
run no timing.
"""

import dataclasses
import importlib.util
import json
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import tpul2.autotune.db as jdb
import tpul2.config as jcfg
import tpul2.dispatch as jdispatch
from tpul2_torch import dispatch
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.autotune import search
from tpul2_torch.config import KernelConfig
from tpul2_torch.harness import bench_server
from tpul2_torch.harness.correctness import CANDIDATE

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent
TUNE = dict(max_candidates=2, stage1_rounds=1, stage2_rounds=1, finalists=1, calls=(1, 2))


@pytest.fixture
def dbs(tmp_path, monkeypatch):
    """Empty default DBs of both packages on temporary files; returns their paths."""
    ours, theirs = tmp_path / "torch_db.json", tmp_path / "jax_db.json"
    monkeypatch.setenv(db_mod.ENV_VAR, str(ours))
    monkeypatch.setenv("TPUL2_TUNEDB", str(theirs))
    db_mod.reset_default_db()
    jdb.reset_default_db()
    yield ours, theirs
    db_mod.reset_default_db()
    jdb.reset_default_db()


def _pair(**kw):
    """The same config in both packages."""
    jax_cfg = jcfg.KernelConfig(**kw)
    return jax_cfg, KernelConfig.from_jax(dataclasses.asdict(jax_cfg))


OFFLINE = dict(bm=64, bn=128, bk=512)
SERVER = dict(bm=128, bn=64, bk=256, rhs_layout="nk")
SERVER_ONLY = dict(bm=64, bn=64, bk=1024)


def _fill(jax_db, our_db):
    """Shape A: offline + server entries; shape B: server only; shape C: offline only (an
    XLA/vendor sentinel) beside B, measured, so that a neighbour query near both ranks it
    first."""
    j_off, t_off = _pair(**OFFLINE)
    j_srv, t_srv = _pair(**SERVER)
    j_so, t_so = _pair(**SERVER_ONLY)
    j_x, t_x = jcfg.KernelConfig.xla("matmul"), KernelConfig.vendor("torch_matmul")
    for acc in ("float32", "bfloat16"):
        j_off_a, t_off_a = (dataclasses.replace(c, acc_dtype=acc) for c in (j_off, t_off))
        jax_db.put(256, 512, 1024, j_off_a, 10.0, acc=acc)
        our_db.put(256, 512, 1024, t_off_a, 10.0, acc=acc)
        jax_db.put_server(256, 512, 1024, dataclasses.replace(j_srv, acc_dtype=acc), acc=acc,
                          extra={"target_qps": 100.0})
        our_db.put_server(256, 512, 1024, dataclasses.replace(t_srv, acc_dtype=acc), acc=acc,
                          extra={"target_qps": 100.0})
        jax_db.put_server(128, 2048, 4096, dataclasses.replace(j_so, acc_dtype=acc), acc=acc)
        our_db.put_server(128, 2048, 4096, dataclasses.replace(t_so, acc_dtype=acc), acc=acc)
        jax_db.put(128, 2048, 3072, j_x, 5.0, acc=acc)
        our_db.put(128, 2048, 3072, t_x, 5.0, acc=acc)


def test_server_sub_entries_match_jax(dbs):
    ours_path, theirs_path = dbs
    jax_db, our_db = jdb.TuneDB(path=theirs_path, gen="h100"), db_mod.TuneDB(path=ours_path)
    _fill(jax_db, our_db)
    jax_db.save()
    our_db.save()
    for db_j, db_t in ((jax_db, our_db), (jdb.TuneDB(path=theirs_path, gen="h100").load(),
                                          db_mod.TuneDB(path=ours_path).load())):
        for shape in ((256, 512, 1024), (128, 2048, 4096), (128, 2048, 3072), (1, 2, 3)):
            for acc in ("float32", "bfloat16"):
                sj = db_j.get_server_entry(*shape, acc)
                st = db_t.get_server_entry(*shape, acc)
                assert (sj is None) == (st is None), shape
                if sj is not None:
                    assert KernelConfig(**st["config"]) == KernelConfig.from_jax(sj["config"])
                    assert {k: v for k, v in st.items() if k != "config"} == \
                        {k: v for k, v in sj.items() if k != "config"}
                ej, et = db_j.get_entry(*shape, acc), db_t.get_entry(*shape, acc)
                assert (ej is None) == (et is None)
                if ej is not None:
                    for key in ("tflops", "measured", "scope"):
                        assert et.get(key) == ej.get(key), (shape, key)
    # a server-only shape carries no offline measurement
    entry = our_db.get_entry(128, 2048, 4096)
    assert entry["measured"] is False and entry["scope"] == "server_only"
    assert entry["tflops"] == 0.0


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["offline", "server"])
@pytest.mark.parametrize("shape", [(256, 512, 1024), (128, 2048, 4096), (128, 2048, 3100)])
def test_resolve_by_mode_matches_jax(dbs, acc, mode, shape):
    """Shape A has both entries, B only a server one, and the third is untuned: its
    neighbours are B (server only, unmeasured) and a measured sentinel entry, which both
    packages rank first."""
    ours_path, theirs_path = dbs
    jax_db, our_db = jdb.TuneDB(path=theirs_path, gen="h100"), db_mod.TuneDB(path=ours_path)
    _fill(jax_db, our_db)
    jax_db.save()
    our_db.save()
    theirs = KernelConfig.from_jax(dataclasses.asdict(
        jdispatch.resolve_config(*shape, acc, mode=mode)))
    ours = dispatch.resolve_config(*shape, acc, mode=mode)
    if ours.use_vendor:  # a sentinel's tile fields are unused and differ by package
        assert theirs.use_vendor and ours.vendor_variant == theirs.vendor_variant
    else:
        assert ours == theirs
    expected = {((256, 512, 1024), "offline"): OFFLINE, ((256, 512, 1024), "server"): SERVER,
                ((128, 2048, 4096), "offline"): SERVER_ONLY,
                ((128, 2048, 4096), "server"): SERVER_ONLY}.get((shape, mode))
    if expected is None:
        assert ours.use_vendor and ours.vendor_variant == "torch_matmul"
    else:
        assert ours == KernelConfig(**expected, acc_dtype=acc)


def test_memo_goes_stale_on_a_server_put_and_keys_on_the_mode(dbs, monkeypatch):
    m, n, k = 64, 256, 1024
    calls = []
    real = dispatch.heuristic_config
    monkeypatch.setattr(dispatch, "heuristic_config",
                        lambda *args: calls.append(args) or real(*args))
    offline = dispatch.resolve_config(m, n, k)
    assert dispatch.resolve_config(m, n, k) is offline and len(calls) == 1
    # another mode is another decision, then kept too
    server = dispatch.resolve_config(m, n, k, mode="server")
    assert server == offline and len(calls) == 2
    assert dispatch.resolve_config(m, n, k, mode="server") is server and len(calls) == 2
    staged = KernelConfig(bm=64, bn=64, bk=256, pipeline_depth=4)
    version = db_mod.default_db().version
    db_mod.default_db().put_server(m, n, k, staged)
    assert db_mod.default_db().version == version + 1
    assert dispatch.resolve_config(m, n, k, mode="server") == staged
    # the server-only entry's config is the shape's entry for offline callers too (JAX's)
    assert dispatch.resolve_config(m, n, k) == staged
    with pytest.raises(ValueError, match="mode"):
        dispatch.resolve_config(m, n, k, mode="batch")


def test_put_keeps_the_server_sub_entry(tmp_path):
    db = db_mod.TuneDB(path=tmp_path / "db.json")
    srv = KernelConfig(bm=64, bn=64, bk=256)
    db.put_server(64, 256, 1024, srv, extra={"target_qps": 50.0})
    db.put(64, 256, 1024, KernelConfig.vendor(), 3.0)
    entry = db.get_entry(64, 256, 1024)
    assert entry["server"]["config"] == dataclasses.asdict(srv) and "scope" not in entry
    assert db.get(64, 256, 1024) == KernelConfig.vendor()


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_server_twins_resolve_server_sub_entries(dbs, acc, monkeypatch):
    m, n, k = 64, 96, 160
    vendor = KernelConfig.vendor("cublas_tn")
    db_mod.default_db().put(m, n, k, KernelConfig(bm=32, bn=32, bk=64, acc_dtype=acc), 1.0,
                            acc=acc)
    db_mod.default_db().put_server(m, n, k, vendor, acc=acc)
    seen = []
    real = dispatch._vendor
    monkeypatch.setattr(dispatch, "_vendor", lambda *a: seen.append(a[3]) or real(*a))
    rng = np.random.default_rng(31)
    a = torch.from_numpy(rng.integers(0, 2, (m, k)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.integers(0, 2, (k, n)).astype(np.float32)).bfloat16()
    twin = dispatch.candidate_fn(acc, "server")
    assert twin is {"float32": dispatch.cuda_l2_h100_f32_server,
                    "bfloat16": dispatch.cuda_l2_h100_bf16_server}[acc]
    out = torch.empty((m, n), dtype=torch.float32)
    assert twin(a, b, b.t().contiguous(), out=out) is out
    assert torch.equal(out, a.float() @ b.float()) and seen == [vendor]
    # the offline entry runs the kernel's plain version, not the sentinel
    assert torch.equal(dispatch.candidate_fn(acc)(a, b, b.t().contiguous()).float(),
                       (a.float() @ b.float()).bfloat16().float())
    assert seen == [vendor]


def _fake_time(gaps: list):
    return types.SimpleNamespace(sleep=gaps.append, time=time.time,
                                 perf_counter=time.perf_counter)


def test_server_bench_on_cpu_draws_exponential_gaps(tmp_path, monkeypatch):
    """Every warmup and benchmark iteration ends with one gap drawn from Exponential(mean
    1 / target_qps): the gaps are exactly the seeded draws, and their mean is near it."""
    gaps = []
    monkeypatch.setattr(bench_server, "time", _fake_time(gaps))
    qps = 200.0
    res = bench_server.benchmark_server_all(24, 40, 56, qps, perf_funcs=["torch_matmul",
                                                                        "cublas_tn"],
                                            warmup_seconds=0.0, benchmark_seconds=0.3,
                                            base_dir=str(tmp_path), seed=5, device="cpu")
    iters = res["torch_matmul"]["torch_matmul"]["iters"]
    assert len(gaps) == iters + 1  # one warmup iteration, then the timed ones
    assert gaps == list(np.random.default_rng((5, 1)).exponential(1.0 / qps, len(gaps)))
    assert len(gaps) >= 30 and abs(np.mean(gaps) * qps - 1.0) < 0.5
    for pf in ("torch_matmul", "cublas_tn"):
        r = json.loads((tmp_path / f"benchmark_result_{pf}.json").read_text())
        assert r["mode"] == "server" and r["target_qps"] == qps and r["device"] == "cpu"
        for name in (pf, CANDIDATE):
            assert r[name]["p50_ms"] > 0 and r[name]["p99_ms"] >= r[name]["p50_ms"]
        assert r["speedup"] == r[pf]["per_call_ms"] / r[CANDIDATE]["per_call_ms"]


@pytest.mark.parametrize("qps", [0.0, -1.0])
def test_target_qps_must_be_positive(qps, tmp_path):
    with pytest.raises(ValueError, match="target_qps"):
        bench_server.benchmark_server_all(8, 8, 8, qps, device="cpu")
    with pytest.raises(ValueError, match="target_qps"):
        search.tune_shape(8, 8, 8, device="cpu", mode="server", target_qps=qps, **TUNE)
    with pytest.raises(SystemExit):
        _load_eval().main(["--device", "cpu", "--mnk", "8", "8", "8", "--mode", "server",
                           "--target_qps", str(qps), "--base_dir", str(tmp_path)])
    with pytest.raises(SystemExit):  # and it is required in server mode
        _load_eval().main(["--device", "cpu", "--mnk", "8", "8", "8", "--mode", "server",
                           "--base_dir", str(tmp_path)])


def test_server_bench_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_server.benchmark_server_all(8, 8, 8, 100.0)


def _load_eval():
    spec = importlib.util.spec_from_file_location(
        "eval_one_shape_torch", REPO / "scripts" / "eval_one_shape_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_eval_script_server_mode_on_cpu(dbs, tmp_path, acc, monkeypatch):
    gaps = []
    monkeypatch.setattr(bench_server, "time", _fake_time(gaps))
    rc = _load_eval().main(["--device", "cpu", "--mnk", "64", "96", "160", "--acc", acc,
                            "--mode", "server", "--target_qps", "1000",
                            "--warmup_seconds", "0", "--benchmark_seconds", "0.1",
                            "--correctness_iters", "1", "--base_dir", str(tmp_path)])
    assert rc == 0 and gaps
    gate = json.loads((tmp_path / "zero_one_correctness_check_result.json").read_text())
    assert gate["pass"] and gate["mode"] == "server"
    summary = (tmp_path / "summary.md").read_text()
    assert "### server" in summary and "target_qps=1000.0" in summary and "p50 / p99" in summary
    assert len(list(tmp_path.glob("benchmark_result_*.json"))) == 7


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_tuner_server_mode_stores_a_server_sub_entry(dbs, acc, monkeypatch):
    gaps = []
    monkeypatch.setattr(search, "time", types.SimpleNamespace(
        sleep=gaps.append, perf_counter=time.perf_counter))
    m, n, k = 32, 128, 256
    offline = search.tune_shape(m, n, k, acc=acc, device="cpu", save=True, **TUNE)
    res = search.tune_shape(m, n, k, acc=acc, device="cpu", save=True, mode="server",
                            target_qps=50.0, **TUNE)
    assert res.mode == "server" and gaps
    assert abs(np.mean(gaps) * 50.0 - 1.0) < 1.0
    db = db_mod.default_db()
    sub = db.get_server_entry(m, n, k, acc)
    assert KernelConfig(**sub["config"]) == res.best
    assert sub["timing_rev"] == 2 and set(sub["server_ms"]) == {"best", "torch_matmul"}
    # the offline entry is left as the offline tune stored it
    assert db.get(m, n, k, acc) == offline.best
    assert dispatch.resolve_config(m, n, k, acc, mode="server") == res.best
    ranked = [d for d in res.medians_ms if d["server_ms"] is not None]
    assert {d["stage2_ms"] is not None for d in ranked} == {True}
