"""tpul2_torch's tuning path on the CPU: candidate space, TuneDB, transfer, tuner, dispatch.

The DB is held against the JAX package's (key format, neighbour pool) on the same file.
The tuner runs the plain versions here (``device='cpu'``), with at most 4 tile candidates,
one round and timers of one and two calls per candidate, into temporary DBs; ``tmp_default_db`` points the
default DB at a temporary file and drops it afterwards, so no test leaks a DB into another.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpul2.autotune import db as jdb
from tpul2_torch import dispatch
from tpul2_torch.autotune import __main__ as cli
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.autotune import search
from tpul2_torch.autotune.transfer import _adapt, neighbor_seed_configs
from tpul2_torch.config import (KSTEP, TILE_CHOICES, WGMMA_TILES, KernelConfig,
                                candidate_configs, heuristic_config)
from tpul2_torch.ops.baselines import VENDOR_VARIANTS
from tpul2_torch.utils.padding import round_up

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(64, 8192, 8192), (4096, 4096, 4096), (8192, 128, 64), (1000, 1000, 1000),
          (32, 128, 4096), (1, 1, 1), (200, 300, 203)]
TUNE = dict(max_candidates=4, stage1_rounds=1, stage2_rounds=1, finalists=2,
            calls=(1, 2))


@pytest.fixture
def tmp_default_db(tmp_path, monkeypatch):
    path = tmp_path / "default.json"
    monkeypatch.setenv(db_mod.ENV_VAR, str(path))
    db_mod.reset_default_db()
    yield path
    db_mod.reset_default_db()


def _01(seed, m, n, k):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 2, (m, k)).astype(np.float32)).bfloat16(),
            torch.from_numpy(rng.integers(0, 2, (k, n)).astype(np.float32)).bfloat16())


# ---- candidate space ----

@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_candidates_are_valid_and_distinct(m, n, k, acc):
    cands = candidate_configs(m, n, k, acc)
    assert len(cands) == len(set(cands))
    assert all(c.validate() is None for c in cands)
    kernels = [c for c in cands if not c.use_vendor]
    # every tile wastes more than 60% on a problem far smaller than the smallest tile
    assert bool(kernels) == ((m, n, k) != (1, 1, 1))
    assert all(c.acc_dtype == acc for c in kernels)
    assert all(c.padding_waste(m, n, k) <= 0.6 for c in kernels)
    # a ring tile, or a wide block (an edge above 128), at a bk of the set: the JAX
    # package's 128..16384 up to round_up(k, 128), or the whole K
    bks = {c for c in (128, 256, 512, 1024, 2048, 4096, 8192, 16384) if c <= round_up(k, 128)}
    assert all((c.bm in TILE_CHOICES and c.bn in TILE_CHOICES or c.wide)
               and c.bk in bks | {round_up(k, KSTEP)} and c.bk % KSTEP == 0
               for c in kernels)
    # 'mask' only where a block does not divide its dim
    assert all(m % c.bm or n % c.bn or k % c.bk for c in kernels if c.edge == "mask")
    # every vendor variant, always, last
    assert [c.vendor_variant for c in cands if c.use_vendor] == list(VENDOR_VARIANTS)
    assert all(c.use_vendor for c in cands[len(kernels):])


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_kstage_axis_where_jax_gates_it(acc):
    deep = [c for c in candidate_configs(64, 8192, 8192, acc) if c.pipeline_depth]
    assert {c.pipeline_depth for c in deep} == {2, 4}
    for c in deep:
        assert c.edge == "pad" and 64 % c.bm == 0 and 8192 % c.bn == 0
        assert 8192 % c.bk == 0 and 8192 // c.bk >= 3
    # the staged kernel's ring stages are 64 deep whatever bk is, so no two staged
    # candidates may differ in bk alone
    fields = [dataclasses.replace(c, bk=0) for c in deep]
    assert len(fields) == len(set(fields))
    # not a streaming shape (min(m, n) > 256): no staged candidates
    assert not [c for c in candidate_configs(4096, 4096, 4096, acc) if c.pipeline_depth]
    # streaming, but K too short (k < 2048)
    assert not [c for c in candidate_configs(64, 8192, 1024, acc) if c.pipeline_depth]


@pytest.mark.parametrize("m,n,k", [(64, 8192, 8192), (64, 64, 12288)])
@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_staged_candidates_are_ring_tiles(m, n, k, acc):
    """The kStage axis draws its picks from the top 4 by the prior among the ring tiles,
    whatever ``max_candidates`` kept: at 8 (chip_smoke.py's tune phase) the plain space's
    picks at these shapes are all 32-edge tiles, which the prior's fill term favours."""
    for max_candidates in (64, 8):
        cands = candidate_configs(m, n, k, acc, max_candidates=max_candidates)
        deep = [c for c in cands if c.pipeline_depth]
        assert len(deep) == 8 and {c.pipeline_depth for c in deep} == {2, 4}
        assert all(c.bm in WGMMA_TILES and c.bn in WGMMA_TILES for c in deep)
        assert all(c.edge == "pad" and m % c.bm == n % c.bn == k % c.bk == 0
                   and k // c.bk >= 3 for c in deep)
    plain = [c for c in cands if not c.use_vendor and not c.pipeline_depth]
    assert len(plain) == 8 and not any(c.bm in WGMMA_TILES and c.bn in WGMMA_TILES
                                       for c in plain)


def test_prior_puts_the_heuristic_tiling_first_on_square_shapes():
    top = candidate_configs(4096, 4096, 4096)[0]
    h = heuristic_config(4096, 4096, 4096)
    assert (top.bm, top.bn, top.bk, top.grid_order) == (h.bm, h.bn, h.bk, h.grid_order)


def test_max_candidates_bounds_the_tile_points():
    cands = candidate_configs(64, 8192, 8192, max_candidates=3)
    plain = [c for c in cands if not c.use_vendor and not c.pipeline_depth]
    assert len(plain) == 3


def test_config_json_round_trip():
    cfg = KernelConfig(bm=32, bn=64, bk=1024, acc_dtype="bfloat16", rhs_layout="nk",
                       pipeline_depth=4)
    assert KernelConfig.from_json(cfg.to_json()) == cfg


# ---- TuneDB ----

def test_db_key_is_the_jax_key():
    for m, n, k, acc in ((64, 8192, 8192, "float32"), (1, 2, 3, "bfloat16")):
        assert db_mod._key(m, n, k, acc, torch.bfloat16) == jdb._key(m, n, k, acc,
                                                                      jnp.bfloat16)
        assert db_mod._key(m, n, k, acc) == jdb._key(m, n, k, acc, jnp.bfloat16)


def test_db_round_trip_and_jax_reads_the_same_entries(tmp_path):
    path = tmp_path / "db.json"
    db = db_mod.TuneDB(path=path)
    staged = KernelConfig(bm=32, bn=64, bk=1024, pipeline_depth=2)
    db.put(64, 8192, 8192, staged, 12.5, extra={"speedup_vs_torch_matmul": 0.5})
    db.put(128, 8192, 8192, KernelConfig.vendor("cublas_tn"), 99.0)
    db.put(64, 8192, 8192, staged, 11.0, acc="bfloat16")
    db.save()
    assert not path.with_suffix(".tmp").exists()
    again = db_mod.TuneDB(path=path).load()
    assert len(again) == 3 and again.gen == "h100"
    assert again.get(64, 8192, 8192) == staged
    assert again.get_entry(64, 8192, 8192)["speedup_vs_torch_matmul"] == 0.5
    assert again.get(64, 8192, 8192, "bfloat16", torch.bfloat16) == staged
    assert again.get(64, 8192, 4096) is None
    keys = sorted(db_mod._key(*mnk, acc) for mnk, acc, _ in again.items())
    assert keys == sorted(json.loads(path.read_text())["entries"])
    assert {(mnk, acc) for mnk, acc, _ in again.items()} == {
        ((64, 8192, 8192), "float32"), ((128, 8192, 8192), "float32"),
        ((64, 8192, 8192), "bfloat16")}
    assert [mnk for mnk, _ in again.entries_for("bfloat16")] == [(64, 8192, 8192)]
    # the JAX package's DB class reads the file under the same keys and neighbour rules
    theirs = jdb.TuneDB(path=path, gen="h100").load()
    for q, ratio in (((64, 8192, 8192), 2.0), ((100, 6000, 9000), 2.0),
                     ((40, 8192, 8192), 2.0), ((32, 2048, 8192), 4.0),
                     ((16, 8192, 8192), 2.0)):
        ours = sorted(mnk for mnk, _ in again.entries_near(*q, max_ratio=ratio))
        jax_side = sorted(mnk for mnk, _ in theirs.entries_near(*q, "float32", jnp.bfloat16,
                                                                 max_ratio=ratio))
        assert ours == jax_side, q
    assert sorted(theirs.keys()) == keys


def test_db_env_var_sets_the_default_path(tmp_default_db):
    assert db_mod.default_db().path == tmp_default_db
    assert len(db_mod.default_db()) == 0


def test_resolution_follows_db_changes(tmp_default_db):
    """resolve_config reads the DB as it stands: a put or a load changes its answer."""
    before = dispatch.resolve_config(64, 256, 1024)
    assert before == heuristic_config(64, 256, 1024)
    staged = KernelConfig(bm=32, bn=64, bk=256, pipeline_depth=4)
    db_mod.default_db().put(64, 256, 1024, staged, 1.0)
    assert dispatch.resolve_config(64, 256, 1024) == staged
    other = db_mod.TuneDB(path=tmp_default_db)  # another writer of the same file
    other.put(64, 256, 1024, before, 1.0)
    other.save()
    db_mod.default_db().load()
    assert dispatch.resolve_config(64, 256, 1024) == before


@pytest.mark.parametrize("change", ["put", "reset_default_db", "env_var"])
def test_resolution_memo_is_invalidated(change, tmp_default_db, tmp_path, monkeypatch):
    """resolve_config keeps its decision per shape, so a repeated call resolves nothing
    again, until the DB it came from changes: a put into the default DB (the tuner's
    save), ``reset_default_db()`` after the file changed, and a change of
    TPUL2_TORCH_TUNEDB each make it stale."""
    m, n, k = 64, 256, 1024
    calls = []
    real = dispatch.heuristic_config
    monkeypatch.setattr(dispatch, "heuristic_config",
                        lambda *args: calls.append(args) or real(*args))
    first = dispatch.resolve_config(m, n, k)
    assert first == real(m, n, k)
    assert dispatch.resolve_config(m, n, k) is first and len(calls) == 1
    staged = KernelConfig(bm=32, bn=64, bk=256, pipeline_depth=4)
    if change == "put":
        db_mod.default_db().put(m, n, k, staged, 1.0)
    else:
        path = tmp_default_db if change == "reset_default_db" else tmp_path / "other.json"
        other = db_mod.TuneDB(path=path)
        other.put(m, n, k, staged, 1.0)
        other.save()
        if change == "reset_default_db":
            # the loaded DB has not read the file again, so the memo still holds
            assert dispatch.resolve_config(m, n, k) is first
            db_mod.reset_default_db()
        else:
            monkeypatch.setenv(db_mod.ENV_VAR, str(path))
    assert dispatch.resolve_config(m, n, k) == staged
    assert len(calls) == 1


def test_resolution_memo_is_bounded(tmp_default_db, monkeypatch):
    monkeypatch.setattr(dispatch, "MEMO_LIMIT", 4)
    for m in range(1, 11):
        assert dispatch.resolve_config(m, 256, 1024) == heuristic_config(m, 256, 1024)
        assert len(db_mod.default_db().memo) <= 4


def test_resolution_sends_an_unrunnable_entry_to_the_sentinel(tmp_default_db):
    """A DB entry the kernel cannot run (a tile it has no instance for) resolves to the
    vendor sentinel instead of failing at the launch."""
    db_mod.default_db().put(64, 256, 1024, KernelConfig(bm=16, bn=64, bk=256), 1.0)
    assert dispatch.resolve_config(64, 256, 1024) == KernelConfig.vendor()


def test_default_path_is_the_h100_file(monkeypatch):
    monkeypatch.delenv(db_mod.ENV_VAR, raising=False)
    path = db_mod.TuneDB().path
    assert path.name == "tunedb_h100.json" and path.parent.parent.name == "tpul2_torch"


# ---- transfer and neighbour rules ----

def test_adapt_refits_tiles_and_k():
    cfg = KernelConfig(bm=64, bn=128, bk=1024, pipeline_depth=4)
    # carried where they fit; whole-K cover stays whole-K
    assert _adapt(cfg, (64, 8192, 8192), (96, 4096, 6144)) == dataclasses.replace(
        cfg, bm=128)  # bm covered its whole dim: smallest tile covering 96
    got = _adapt(dataclasses.replace(cfg, bm=32, bk=8192), (64, 8192, 8192), (64, 8192, 5000))
    assert (got.bm, got.bn, got.bk) == (32, 128, 5024)
    # an oversized tile clamps to the tile covering the new dim
    got = _adapt(KernelConfig(bm=128, bn=128, bk=256), (512, 512, 512), (40, 512, 512))
    assert got.bm == 64
    # a config the kernel cannot run after re-fitting is dropped
    assert _adapt(dataclasses.replace(cfg, edge="mask"), (64, 8192, 8192), (64, 8192, 8192)) \
        is None


def _db_with(tmp_path, entries):
    db = db_mod.TuneDB(path=tmp_path / "n.json")
    for (m, n, k), cfg, extra in entries:
        db.put(m, n, k, cfg, 1.0, extra=extra)
    return db


def test_neighbor_rules(tmp_path):
    kernel = KernelConfig(bm=32, bn=64, bk=1024, pipeline_depth=2)
    db = _db_with(tmp_path, [((64, 8192, 8192), kernel, {"speedup_vs_torch_matmul": 1.3})])
    # a kernel winner with a real margin carries over, adapted
    assert dispatch._neighbor_config(db, 64, 6000, 8192, "float32") == kernel
    # beyond 2x on a dim: no neighbour
    assert dispatch._neighbor_config(db, 64, 2048, 8192, "float32") is None
    # the other family does not see it
    assert dispatch._neighbor_config(db, 64, 6000, 8192, "bfloat16") is None
    # a win within noise (< 1.05x) gives way to the sentinel
    db.put(64, 8192, 8192, kernel, 1.0, extra={"speedup_vs_torch_matmul": 1.01})
    assert dispatch._neighbor_config(db, 64, 6000, 8192, "float32") == KernelConfig.vendor()
    # a sentinel winner carries as it is
    db.put(64, 8192, 8192, KernelConfig.vendor("cublas_tn"), 1.0)
    assert dispatch._neighbor_config(db, 64, 6000, 8192, "float32") == \
        KernelConfig.vendor("cublas_tn")


def test_neighbor_seed_configs(tmp_path):
    a = KernelConfig(bm=32, bn=64, bk=1024, pipeline_depth=4)
    b = KernelConfig(bm=64, bn=32, bk=512)
    db = _db_with(tmp_path, [((64, 8192, 8192), a, {"speedup_vs_torch_matmul": 1.5}),
                             ((64, 4096, 8192), b, {"speedup_vs_torch_matmul": 3.0}),
                             ((64, 6144, 8192), KernelConfig.vendor(), {}),
                             ((64, 6144, 6144), a, {})])
    # the exact shape and the sentinel are skipped; nearest first
    assert neighbor_seed_configs(db, 64, 6144, 6144) == [a, b]
    assert neighbor_seed_configs(db, 64, 6144, 6144, limit=1) == [a]


# ---- tuner ----

def test_tune_on_cpu_then_dispatch_resolves_the_entry(tmp_default_db):
    m, n, k = 32, 128, 4096
    res = search.tune_shape(m, n, k, device="cpu", save=True, **TUNE)
    assert res.device == "cpu" and res.n_launched == res.n_candidates
    timed = [KernelConfig(**d["config"]) for d in res.medians_ms]
    assert len(timed) == res.n_candidates
    assert any(c.pipeline_depth >= 2 for c in timed)  # the kStage axis was timed
    assert all(d["stage1_ms"] > 0 for d in res.medians_ms)
    entry = db_mod.default_db().get_entry(m, n, k)
    assert KernelConfig(**entry["config"]) == res.best
    assert entry["speedup_vs_torch_matmul"] == res.speedup and entry["device"] == "cpu"
    assert dispatch.resolve_config(m, n, k) == res.best
    a, b = _01(20, m, n, k)
    out = dispatch.matmul(a, b, out_dtype=torch.float32)
    assert torch.equal(out, a.float() @ b.float())


def test_tune_persists_to_passed_empty_db(tmp_path, tmp_default_db):
    """Regression (tests/test_dispatch.py): an empty TuneDB is falsy (__len__); the winner
    must still go to the DB passed in, not to the default one."""
    mine = db_mod.TuneDB(path=tmp_path / "mine.json")
    assert len(mine) == 0
    search.tune_shape(32, 128, 256, db=mine, device="cpu", save=True, **TUNE)
    assert len(mine) == 1
    assert len(db_mod.default_db()) == 0 and not tmp_default_db.exists()


def test_improve_keeps_a_better_entry(tmp_path):
    db = db_mod.TuneDB(path=tmp_path / "db.json")
    stored = KernelConfig(bm=128, bn=128, bk=128)
    db.put(32, 128, 256, stored, 1e9)
    search.tune_shape(32, 128, 256, db=db, device="cpu", save="improve", **TUNE)
    assert db.get(32, 128, 256) == stored
    db.put(32, 128, 256, stored, 0.0)
    res = search.tune_shape(32, 128, 256, db=db, device="cpu", save="improve", **TUNE)
    assert db.get(32, 128, 256) == res.best
    db.put(32, 128, 256, stored, 1e9)
    search.tune_shape(32, 128, 256, db=db, device="cpu", save=False, **TUNE)
    assert db.get(32, 128, 256) == stored


def test_launch_screen_drops_only_refusals(tmp_path):
    db = db_mod.TuneDB(path=tmp_path / "db.json")
    # a staged seed on dims its blocks do not divide: the wrapper refuses it
    bad = KernelConfig(bm=64, bn=128, bk=128, pipeline_depth=2)
    st = search._ShapeTuning(32, 128, 512, "float32", torch.bfloat16, "cpu", 4, 1, 1, 2,
                             (1, 2), 0, [bad], False)
    assert [c for c, _ in st.refused] == [bad] and "divisible" in st.refused[0][1]
    assert len(st.launched) == st.n_candidates - 1
    st.finish(db, save=True)
    assert len(db) == 1


def test_a_rival_must_beat_the_sentinel_by_the_margin():
    """Within the 10% noise margin the torch_matmul sentinel stays the winner, so noise
    never picks one library call, or a kernel, over it; beyond it the rival wins."""
    st = search._ShapeTuning(32, 128, 256, "float32", torch.bfloat16, "cpu", **TUNE)
    rival = next(i for i, (c, _, _) in enumerate(st.launched) if not c.use_vendor)
    st.med2 = {st.ref_i: 1.0, rival: 1.0 / 1.05}
    res = st.finish(None, save=False)
    assert res.best == st.launched[st.ref_i][0] and res.speedup == 1.0
    st.med2 = {st.ref_i: 1.0, rival: 1.0 / 1.2}
    res = st.finish(None, save=False)
    assert res.best == st.launched[rival][0] and res.speedup == pytest.approx(1.2)
    assert set(res.device_ms) == set(res.e2e_ms) == {"best", "torch_matmul"}


def test_tune_many_skips_tuned_shapes(tmp_path):
    db = db_mod.TuneDB(path=tmp_path / "db.json")
    first = search.tune_many([(32, 128, 256)], db=db, device="cpu", save=True,
                             verbose=False, **TUNE)
    assert len(first) == 1
    again = search.tune_many([(32, 128, 256), (32, 64, 256)], db=db, device="cpu",
                             skip_tuned=True, save=True, verbose=False, **TUNE)
    assert [(r.m, r.n, r.k) for r in again] == [(32, 64, 256)] and len(db) == 2


def test_tuner_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.tune_shape(32, 128, 256, **TUNE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--mnk", "32", "128", "256"])


def test_cli_on_cpu(tmp_default_db, capsys):
    assert cli.main(["--mnk", "32", "64", "256", "--device", "cpu", "--max_candidates", "2",
                     "--stage1_rounds", "1", "--stage2_rounds", "1", "--finalists", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and (out["m"], out["n"], out["k"]) == (32, 64, 256)
    assert db_mod.default_db().get(32, 64, 256) == KernelConfig(**out["best"])


def test_tuned_staged_entry_drives_the_eval_driver_on_cpu(tmp_default_db, tmp_path):
    """The slice on a DB-resolved staged config: gate (guard bands) -> bench -> summary."""
    import importlib.util
    m, n, k = 64, 256, 1024
    staged = KernelConfig(bm=32, bn=64, bk=256, pipeline_depth=4)
    db = db_mod.TuneDB(path=tmp_default_db)
    for acc in ("float32", "bfloat16"):
        db.put(m, n, k, dataclasses.replace(staged, acc_dtype=acc), 1.0,
               acc=acc, extra={"speedup_vs_torch_matmul": 1.0})
    db.save()
    db_mod.reset_default_db()
    assert dispatch.resolve_config(m, n, k, "bfloat16").pipeline_depth == 4
    spec = importlib.util.spec_from_file_location(
        "eval_one_shape_torch", REPO / "scripts" / "eval_one_shape_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for acc in ("float32", "bfloat16"):
        base = tmp_path / acc
        rc = mod.main(["--device", "cpu", "--mnk", str(m), str(n), str(k), "--acc", acc,
                       "--warmup_seconds", "0", "--benchmark_seconds", "0",
                       "--correctness_iters", "1", "--perf_funcs", "torch_matmul",
                       "--base_dir", str(base)])
        assert rc == 0
        gate = json.loads((base / "zero_one_correctness_check_result.json").read_text())
        assert gate["pass"] and gate["stats"]["guard_hits"] == 0
