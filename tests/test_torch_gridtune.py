"""Grid-scale tuning and tail seeding of tpul2_torch on the CPU, held against the JAX scripts.

- ``run_suite_torch.py tune`` lists the shapes of ``scripts/run_suite.py``'s ``grid``,
  tunes them chunk by chunk into the DB named by ``--db`` (the plain versions here, with 2
  tile candidates and one round), keeps every finished shape on disk before the next chunk
  starts, tunes 0 on a re-run, and refuses the committed DB and a missing ``--db``;
- ``seed_tail_entries_torch.py`` takes a shape to its neighbour exactly where
  ``tpul2.dispatch._neighbor_config`` finds one on the same DB before seeding, leaves
  ``resolve_config`` as it was at every grid shape of both families, and marks its entries
  as unmeasured; the JAX script, seeding as it decides, sends the heuristic's shapes to the
  sentinel.

Only the JAX package's pure functions run (the grid, the neighbour search, the seed script's
puts); no JAX timing loop.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

import scripts.run_suite as jax_suite
from tpul2.autotune import db as jax_db_mod
from tpul2.config import KernelConfig as JaxConfig
from tpul2.dispatch import _neighbor_config as jax_neighbor_config
from tpul2_torch import dispatch
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.autotune import search
from tpul2_torch.autotune.db import TuneDB
from tpul2_torch.config import KernelConfig
from tpul2_torch.harness import campaign, suite

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import run_suite_torch  # noqa: E402
import seed_tail_entries_torch as seed  # noqa: E402

ACCS = ("float32", "bfloat16")
SMALL = ["--device", "cpu", "--max_candidates", "2", "--stage1_rounds", "1",
         "--stage2_rounds", "1", "--finalists", "1"]
GRID = suite.grid(suite.REFERENCE_DIMS)


@pytest.fixture
def tmp_default_db(tmp_path, monkeypatch):
    """The default DB (``resolve_config``'s) is a temporary file."""
    path = tmp_path / "default.json"
    monkeypatch.setenv(db_mod.ENV_VAR, str(path))
    db_mod.reset_default_db()
    yield path
    db_mod.reset_default_db()


# ---------------------------------------------------------------------------
# run_suite_torch.py tune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cut", [["--dims", "64", "96", "--max_shapes", "3"],
                                 ["--dims", "96", "64", "128"],
                                 ["--max_shapes", "37"],
                                 ["--max_elems", str(2048 * 4096)]])
def test_tune_shape_list_is_the_jax_grid(tmp_path, cut):
    args = run_suite_torch.parse_args(["tune", "--db", str(tmp_path / "db.json"), *cut])
    want = jax_suite.grid(args.dims, args.max_shapes, args.max_elems)
    assert args.order == "lex" and run_suite_torch.tune_shape_list(args) == want
    # the JAX flags' defaults
    assert (args.chunk, args.max_candidates, args.stage1_rounds, args.stage2_rounds,
            args.finalists, args.acc) == (8, 16, 3, 6, 4, "float32")


def test_tune_saves_each_chunk_and_resumes(tmp_path, monkeypatch, capsys):
    db_path = tmp_path / "db.json"
    seen = []
    real = search.tune_many

    def spy(chunk, **kw):
        on_disk = {mnk for mnk, _, _ in TuneDB(path=db_path).load().items()}
        seen.append((list(chunk), on_disk))
        return real(chunk, **kw)

    monkeypatch.setattr(search, "tune_many", spy)
    argv = ["tune", "--db", str(db_path), "--dims", "64", "96", "--max_shapes", "3",
            "--chunk", "2", *SMALL]
    assert run_suite_torch.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    shapes = jax_suite.grid([64, 96], 3)
    assert [tuple(t["mnk"]) for t in out["tuned"]] == shapes and out["shapes"] == 3
    assert all(t["kernel_vs_torch_matmul"] > 0 for t in out["tuned"])
    # the second chunk starts with the first chunk's winners on disk
    assert [c for c, _ in seen] == [shapes[:2], shapes[2:]]
    assert seen[0][1] == set() and seen[1][1] == set(shapes[:2])
    db = TuneDB(path=db_path).load()
    assert {mnk for mnk, _, _ in db.items()} == set(shapes)
    assert all(e["device"] == "cpu" and e["clock"] == "host" for _, _, e in db.items())
    # a re-run tunes nothing; a new family is new work
    assert run_suite_torch.main(argv) == 0
    assert json.loads(capsys.readouterr().out)["tuned"] == []
    assert run_suite_torch.main(argv + ["--acc", "bfloat16", "--max_shapes", "1"]) == 0
    assert len(json.loads(capsys.readouterr().out)["tuned"]) == 1


def test_tune_refuses_the_committed_db_and_a_missing_db(monkeypatch):
    monkeypatch.delenv(db_mod.ENV_VAR, raising=False)
    committed = campaign.COMMITTED_DB.read_bytes()
    for argv in (["tune", "--device", "cpu"],
                 ["tune", "--device", "cpu", "--db", str(campaign.COMMITTED_DB)]):
        with pytest.raises(SystemExit) as exc:
            run_suite_torch.main(argv)
        assert exc.value.code == 2  # argparse's error: nothing ran
    assert campaign.COMMITTED_DB.read_bytes() == committed


def test_tune_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_suite_torch.main(["tune", "--db", str(tmp_path / "db.json"),
                                 "--dims", "64"]) == 1
    assert not (tmp_path / "db.json").exists()


def test_tune_retunes_a_seeded_entry_and_skips_a_measured_one(tmp_path, capsys):
    db_path = tmp_path / "db.json"
    db = TuneDB(path=db_path)
    seed.apply_plan(db, [(64, 64, 64, "float32", KernelConfig(bm=64, bn=64, bk=64),
                          "heuristic")])
    db.put(64, 64, 96, KernelConfig.vendor(), 1.0, extra={"speedup_vs_torch_matmul": 1.0})
    db.save()
    assert run_suite_torch.main(["tune", "--db", str(db_path), "--dims", "64", "96",
                                 "--max_shapes", "2", *SMALL]) == 0
    assert [t["mnk"] for t in json.loads(capsys.readouterr().out)["tuned"]] == [[64, 64, 64]]
    entry = TuneDB(path=db_path).load().get_entry(64, 64, 64)
    assert "measured" not in entry and "scope" not in entry and entry["device"] == "cpu"


# ---------------------------------------------------------------------------
# seed_tail_entries_torch.py
# ---------------------------------------------------------------------------

def _jax_cfg(cfg: KernelConfig) -> JaxConfig:
    if cfg.use_vendor:
        return JaxConfig.xla("matmul")
    return JaxConfig(bm=cfg.bm, bn=cfg.bn, bk=cfg.bk, acc_dtype=cfg.acc_dtype)


#: Sparse DBs: (m, n, k, acc, config, speedup over the library).  Each package gets the same
#: shapes, sentinels as sentinels and the kernel entry in its own config space.
SPARSE_DBS = {
    "one measured kernel at 64^3": [
        (64, 64, 64, "float32", KernelConfig(bm=64, bn=128, bk=128), 1.2)],
    "sentinels and a measured kernel": [
        (64, 64, 64, "float32", KernelConfig.vendor(), 1.0),
        (1024, 1024, 1024, "bfloat16", KernelConfig.vendor(), 1.0),
        (4096, 64, 4096, "float32", KernelConfig.vendor(), 1.0),
        (100, 3000, 700, "float32", KernelConfig.vendor(), 1.0),  # off the grid
        (512, 512, 512, "float32", KernelConfig(bm=128, bn=128, bk=256), 1.3),
        (512, 8192, 2048, "bfloat16",
         KernelConfig(bm=64, bn=128, bk=512, acc_dtype="bfloat16"), 1.15)],
}


def _port_db(path, entries) -> TuneDB:
    db = TuneDB(path=path)
    for m, n, k, acc, cfg, sp in entries:
        db.put(m, n, k, cfg, 1.0, acc=acc, extra={"speedup_vs_torch_matmul": sp})
    db.save()
    return db


@pytest.mark.parametrize("case", list(SPARSE_DBS))
def test_seed_sources_match_the_jax_neighbour_search_before_seeding(tmp_path, case):
    entries = SPARSE_DBS[case]
    db = _port_db(tmp_path / "port.json", entries)
    jdb = jax_db_mod.TuneDB(path=tmp_path / "jax.json")
    for m, n, k, acc, cfg, sp in entries:
        jdb.put(m, n, k, _jax_cfg(cfg), 1.0, acc=acc, extra={"speedup_vs_xla": sp})
    plan = seed.seed_plan(db, GRID, ACCS)
    ours = {(m, n, k, acc): source for m, n, k, acc, _, source in plan}
    theirs = {(m, n, k, acc): ("heuristic" if jax_neighbor_config(
        jdb, m, n, k, acc, jnp.bfloat16) is None else "neighbour")
        for acc in ACCS for (m, n, k) in GRID if jdb.get_entry(m, n, k, acc) is None}
    assert ours == theirs
    if case == "one measured kernel at 64^3":
        # the issue's count: 7 grid neighbours within 2x, 992 shapes with none
        counts = {s: sum(v == s for k, v in ours.items() if k[3] == "float32")
                  for s in ("neighbour", "heuristic")}
        assert counts == {"neighbour": 7, "heuristic": 992}


def test_jax_seed_script_cascades_where_the_port_does_not(tmp_path, monkeypatch, capsys):
    """The reference's fault: seeding as it decides, each later shape sees the static
    entries just put, and every heuristic shape becomes a sentinel."""
    from scripts.seed_tail_entries import main as jax_seed_main
    monkeypatch.setenv("TPUL2_TUNEDB", str(tmp_path / "jax.json"))
    jax_db_mod.reset_default_db()
    try:
        jdb = jax_db_mod.default_db()
        jdb.put(64, 64, 64, JaxConfig(bm=64, bn=128, bk=128), 1.0,
                extra={"speedup_vs_xla": 1.2})
        jdb.save()
        assert jax_seed_main(["--accs", "float32"]) == 0
    finally:
        jax_db_mod.reset_default_db()
    assert "seeded: {'neighbor': 999, 'heuristic': 0}" in capsys.readouterr().err
    port = tmp_path / "port.json"
    _port_db(port, SPARSE_DBS["one measured kernel at 64^3"])
    assert seed.main(["--db", str(port), "--accs", "float32"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["counts"] == {"neighbour": 7, "heuristic": 992, "sentinel": 0, "kernel": 999}


def _resolved(monkeypatch, path) -> dict:
    monkeypatch.setenv(db_mod.ENV_VAR, str(path))
    db_mod.reset_default_db()
    return {(m, n, k, acc, mode): dispatch.resolve_config(m, n, k, acc, mode=mode)
            for acc in ACCS for mode in ("offline", "server") for (m, n, k) in GRID}


def test_seed_keeps_every_grid_decision_and_marks_its_entries(tmp_path, tmp_default_db,
                                                             monkeypatch, capsys):
    path = tmp_path / "db.json"
    db = _port_db(path, SPARSE_DBS["sentinels and a measured kernel"])
    db.put_server(64, 64, 64, KernelConfig.vendor("cublas_tn"))  # a server sub-entry
    db.save()
    measured = db.get_entry(512, 512, 512, "float32")
    before = _resolved(monkeypatch, path)
    assert seed.main(["--db", str(path)]) == 0
    summary = json.loads(capsys.readouterr().out)
    after = _resolved(monkeypatch, path)
    assert after == before
    db = TuneDB(path=path).load()
    # 5 of the 6 entries lie on the grid, so every grid shape x family now has one entry
    assert len(db) == 2 * len(GRID) + 1 == summary["entries_after"]
    assert db.get_entry(512, 512, 512, "float32") == measured
    assert summary["seeded"] == 2 * len(GRID) - 5
    assert sum(summary["counts"][s] for s in ("neighbour", "heuristic")) == summary["seeded"]
    seeded = [e for _, _, e in db.items() if e.get("scope") == "transfer_static"]
    assert len(seeded) == summary["seeded"]
    assert all(e["measured"] is False and e["speedup_vs_torch_matmul"] == 1.0
               and e["tflops"] == 0.0 and e["timing_rev"] == 2 and e["space_rev"] == 1
               and "server" not in e for e in seeded)
    # a kernel the neighbour search adapted, and one the heuristic gave, both stored
    cfgs = {(m, n, k, acc): KernelConfig(**e["config"]) for (m, n, k), acc, e in db.items()}
    adapted = cfgs[(512, 1024, 512, "float32")]
    assert not adapted.use_vendor and adapted == after[(512, 1024, 512, "float32", "offline")]
    assert not cfgs[(16384, 16384, 16384, "bfloat16")].use_vendor
    # a second run seeds nothing
    assert seed.main(["--db", str(path)]) == 0
    assert json.loads(capsys.readouterr().out)["seeded"] == 0


def test_seed_sends_an_off_grid_shape_with_no_measured_neighbour_to_the_sentinel(
        tmp_path, tmp_default_db):
    """The rule the seed keeps from the JAX package: an off-grid shape that had no
    neighbour ran the heuristic; a seeded kernel neighbour (1.0 < 1.05) gives way to its
    sentinel."""
    db = TuneDB(path=tmp_default_db)
    db.put(64, 64, 64, KernelConfig.vendor(), 1.0)
    db.save()
    shape = (3000, 3000, 3000)
    assert not dispatch.resolve_config(*shape).use_vendor
    assert dispatch.config_source(*shape) == {"source": "heuristic"}
    assert seed.main(["--db", str(tmp_default_db), "--accs", "float32"]) == 0
    db_mod.reset_default_db()
    assert dispatch.config_source(*shape)["scope"] == "transfer_static"
    assert dispatch.resolve_config(*shape) == KernelConfig.vendor()


def test_seed_refuses_the_committed_db_except_in_a_dry_run(monkeypatch, capsys):
    committed = campaign.COMMITTED_DB.read_bytes()
    with pytest.raises(SystemExit) as exc:
        seed.main(["--db", str(campaign.COMMITTED_DB)])
    assert exc.value.code == 2
    with pytest.raises(SystemExit):
        seed.main([])  # --db is required
    assert seed.main(["--db", str(campaign.COMMITTED_DB), "--dry_run"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["dry_run"] and out["entries_after"] == out["entries_before"]
    assert out["seeded"] == 2 * len(GRID) - out["entries_before"]
    assert campaign.COMMITTED_DB.read_bytes() == committed
