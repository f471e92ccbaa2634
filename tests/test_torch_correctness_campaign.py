"""The correctness campaign of tpul2_torch (``scripts/correctness_campaign_torch.py``).

- its resume rules (``load_done``, ``load_latest_configs``, ``verdict_covers``) give the
  answers of ``scripts/correctness_campaign_tpu.py``'s on the JSONL texts of
  ``tests/test_correctness_campaign_resume.py`` and a few more; the one named difference is
  the TPU pool's transient signatures, which the port does not retry (a local card has no
  remote service: ``TRANSIENT_SIGNATURES`` is empty);
- on the CPU (``--device cpu``, the plain versions) over a temporary DB of two kernel
  entries and a sentinel: both entries pass and the sentinel is not gated; a re-run gates
  none; a changed config is gated again; a wrong candidate fails, is demoted on the copy
  and the run exits 1; a raising candidate leaves a final record on disk and stops the run,
  and the next run demotes it; demotion is refused on the committed DB;
- on the card (marker ``gpu``): one sweep over a ring tile and a staged tile.

Neither the JAX tool's gate nor any JAX timing loop runs: only its pure resume functions,
which import no JAX.  On the card's machine:
``TPUL2_TEST_ON_TPU=1 python -m pytest tests/test_torch_correctness_campaign.py -m gpu``.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

import scripts.correctness_campaign_tpu as jax_campaign
from tpul2_torch import dispatch
from tpul2_torch.autotune.db import TuneDB
from tpul2_torch.config import KernelConfig
from tpul2_torch.harness import campaign

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import correctness_campaign_torch as cc  # noqa: E402

KEY = ("64x64x64", "float32")
CFG_OLD = {"bm": 64, "bn": 64, "bk": 64, "use_xla": False}
CFG_NEW = {"bm": 128, "bn": 64, "bk": 64, "use_xla": False}


def _line(mnk, acc, ok, error="", **extra):
    r = {"mnk": mnk, "acc": acc, "pass": ok, **extra}
    if error:
        r["error"] = error
    return json.dumps(r)


#: name -> (JSONL text, TPU-only transient signatures in it)
RESUME_TEXTS = {
    "pass and numerical failure": ("\n".join([
        _line("64x64x64", "float32", True),
        _line("128x128x128", "bfloat16", False, "AssertionError: diff 1.0 != 0.0")]), False),
    "garbage lines": ("not json\n{broken", False),
    "foreign JSON lines": ('[1, 2]\n{"x": 1}\n"text"\n' + _line(*KEY, True), False),
    "empty": ("", False),
    "later numerical failure supersedes a pass": (
        _line(*KEY, True) + "\n" + _line(*KEY, False, "wrong result"), False),
    "a CUDA fault is final": (_line(*KEY, False, "RuntimeError: CUDA error: an illegal "
                                    "memory access was encountered"), False),
    "a refused launch is final": (_line(*KEY, False, "LaunchRefused: tl2_wgmma: error 9"),
                                  False),
    "config-aware: retuned": (_line(*KEY, True, config=CFG_OLD), False),
    "config-aware: the latest config wins": (
        _line(*KEY, True, config=CFG_OLD) + "\n" + _line(*KEY, True, config=CFG_NEW), False),
    "legacy record with no config": (_line(*KEY, True), False),
    "legacy record after a configured one": (
        _line(*KEY, True, config=CFG_OLD) + "\n" + _line(*KEY, True), False),
    # the TPU pool's transient signatures: the JAX tool retries them, the port does not
    "TPU: remote compile HTTP 500": (
        _line("512x8192x256", "bfloat16", False,
              "JaxRuntimeError: INTERNAL: http://127.0.0.1:8103/remote_compile: HTTP 500: "
              "tpu_compile_helper exit 1"), True),
    "TPU: retry verdict supersedes a transient failure": (
        _line(*KEY, False, "HTTP 500: tpu_compile_helper exit 1") + "\n" + _line(*KEY, True),
        True),
    "TPU: transient failure after a pass": (
        _line(*KEY, True) + "\n" + _line(*KEY, False, "UNAVAILABLE: pool"), True),
}


@pytest.mark.parametrize("case", list(RESUME_TEXTS))
def test_resume_rules_match_the_jax_campaign(case):
    text, tpu_only = RESUME_TEXTS[case]
    ours, theirs = cc.load_done(text), jax_campaign.load_done(text)
    if tpu_only:
        # the named exception: every verdict is final on a local card, where the JAX tool
        # retries the TPU pool's transient failures
        assert ours == set(cc.latest_records(text)) and theirs <= ours
    else:
        assert ours == theirs
    latest = cc.load_latest_configs(text)
    assert latest == jax_campaign.load_latest_configs(text)
    for done in (ours, theirs):
        for current in (CFG_OLD, CFG_NEW, None):
            for key in (KEY, ("128x128x128", "bfloat16"), ("1x1x1", "float32")):
                assert cc.verdict_covers(done, latest, key, current) == \
                    jax_campaign.verdict_covers(done, latest, key, current)


def test_no_transient_signature_on_a_local_card():
    assert cc.TRANSIENT_SIGNATURES == ()
    assert jax_campaign.TRANSIENT_SIGNATURES  # the TPU pool's, which the port drops


# ---------------------------------------------------------------------------
# the campaign on the CPU
# ---------------------------------------------------------------------------

RING = KernelConfig(bm=64, bn=64, bk=64)
STAGED = KernelConfig(bm=64, bn=64, bk=128, pipeline_depth=2, rhs_layout="nk",
                      acc_dtype="bfloat16")


@pytest.fixture
def db_copy(tmp_path):
    """A DB of two kernel entries (a ring tile with three K intervals, a staged tile in
    the bf16 family) and one sentinel."""
    path = tmp_path / "db.json"
    db = TuneDB(path=path)
    db.put(64, 96, 192, RING, 1.0, extra={"speedup_vs_torch_matmul": 1.2})
    db.put(128, 64, 256, STAGED, 1.0, acc="bfloat16", extra={"speedup_vs_torch_matmul": 1.2})
    db.put(64, 64, 64, KernelConfig.vendor(), 1.0, extra={"speedup_vs_torch_matmul": 1.0})
    db.save()
    return path


def _run(tmp_path, db_path, *extra, capsys=None):
    argv = ["--db", str(db_path), "--device", "cpu", "--jsonl", str(tmp_path / "c.jsonl"),
            "--out", str(tmp_path / "c.json"), *extra]
    rc = cc.main(argv)
    summary = json.loads((tmp_path / "c.json").read_text())["summary"]
    if capsys is not None:
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    return rc, summary


def _records(tmp_path) -> list:
    return [json.loads(ln) for ln in (tmp_path / "c.jsonl").read_text().splitlines()]


def test_campaign_gates_the_kernel_entries_and_resumes(tmp_path, db_copy, capsys):
    rc, s = _run(tmp_path, db_copy, capsys=capsys)
    assert rc == 0
    assert (s["checked"], s["passed"], s["total_kernel_entries"], s["skipped"]) == (2, 2, 2, 0)
    assert s["failed"] == [] and s["demotions"] == [] and s["guard_hits"] == 0
    assert s["device"] == "cpu" and s["iterations"] == 2 and s["run"]["checked"] == 2
    recs = _records(tmp_path)
    assert {(r["mnk"], r["acc"]) for r in recs} == {("64x96x192", "float32"),
                                                    ("128x64x256", "bfloat16")}
    assert all(r["diffs"] == [0.0, 0.0] and r["guard_hits"] == 0 and r["pass"]
               and r["out_dtype"] == "float32" for r in recs)
    # a re-run gates nothing
    rc, s = _run(tmp_path, db_copy)
    assert rc == 0 and s["run"]["checked"] == 0 and s["checked"] == 2
    # a retuned config is gated again; its old verdict is history
    db = TuneDB(path=db_copy).load()
    db.put(64, 96, 192, KernelConfig(bm=64, bn=128, bk=96), 1.0)
    db.save()
    rc, s = _run(tmp_path, db_copy)
    assert rc == 0 and s["run"]["checked"] == 1 and s["checked"] == 2
    assert _records(tmp_path)[-1]["config"]["bk"] == 96


def test_campaign_order_and_budget(tmp_path, db_copy):
    db = TuneDB(path=db_copy).load()
    order = [(mnk, acc) for mnk, acc, _ in cc.kernel_entries(db, "cost")]
    assert order == [((64, 96, 192), "float32"), ((128, 64, 256), "bfloat16")]
    rc, s = _run(tmp_path, db_copy, "--budget_s", "-1")
    assert rc == 0 and s["run"]["checked"] == 0 and s["run"]["skipped_for_budget"] == 2
    assert s["skipped"] == 2
    rc, s = _run(tmp_path, db_copy, "--order", "cost")
    assert s["run"]["checked"] == 2 and _records(tmp_path)[0]["mnk"] == "64x96x192"
    rc, s = _run(tmp_path, db_copy, "--order", "cost")
    assert rc == 0 and s["run"]["checked"] == 0


def test_a_wrong_candidate_fails_and_is_demoted_on_the_copy(tmp_path, db_copy, monkeypatch):
    real = dispatch.matmul

    def wrong(a, b, *, config=None, out=None, **kw):
        res = real(a, b, config=config, out=out, **kw)
        if config == RING:
            out[0, 0] += 1.0
        return res

    monkeypatch.setattr(dispatch, "matmul", wrong)
    rc, s = _run(tmp_path, db_copy)
    assert rc == 1
    assert s["run"]["failed"] == 1 and s["run"]["demoted"] == 1
    entry = TuneDB(path=db_copy).load().get_entry(64, 96, 192)
    assert entry["config"]["use_vendor"] and entry["demoted_from"]["bk"] == 64
    assert "0/1 gate failure" in entry["demotion_reason"]
    bad = next(r for r in _records(tmp_path) if r["mnk"] == "64x96x192")
    assert not bad["pass"] and bad["diffs"] == [1.0, 1.0]
    assert bad["demoted_to"] == entry["config"]["vendor_variant"]
    # the demoted entry is a sentinel now: its verdict is history, the demotion is on record
    assert s["total_kernel_entries"] == 1 and s["failed"] == []
    assert [d["mnk"] for d in s["demotions"]] == ["64x96x192"]
    rc, s = _run(tmp_path, db_copy)
    assert rc == 0 and s["run"]["checked"] == 0


def test_a_wrong_candidate_without_demotion_fails_every_run(tmp_path, db_copy, monkeypatch):
    real = dispatch.matmul

    def guard_hit(a, b, *, config=None, out=None, **kw):
        res = real(a, b, config=config, out=out, **kw)
        if config == STAGED:
            torch.as_strided(out, (1,), (1,), out.storage_offset() + out.numel()).fill_(7.0)
        return res

    monkeypatch.setattr(dispatch, "matmul", guard_hit)
    before = db_copy.read_text()
    rc, s = _run(tmp_path, db_copy, "--no_demote")
    assert rc == 1 and db_copy.read_text() == before
    bad = s["failed"][0]
    assert bad["mnk"] == "128x64x256" and bad["guard_hits"] == 2 and bad["diffs"] == [0.0, 0.0]
    monkeypatch.setattr(dispatch, "matmul", real)
    rc, s = _run(tmp_path, db_copy, "--no_demote")
    assert rc == 1 and s["run"]["checked"] == 0 and len(s["failed"]) == 1


def test_a_raising_candidate_leaves_a_final_record_and_is_demoted_next_run(
        tmp_path, db_copy, monkeypatch):
    real = dispatch.matmul

    def raising(a, b, *, config=None, **kw):
        if config == RING:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(a, b, config=config, **kw)

    monkeypatch.setattr(dispatch, "matmul", raising)
    rc, s = _run(tmp_path, db_copy, "--order", "lex")
    assert rc == 1
    recs = _records(tmp_path)
    assert len(recs) == 1 and recs[0]["mnk"] == "64x96x192" and not recs[0]["pass"]
    assert "illegal memory access" in recs[0]["error"] and "traceback" in recs[0]
    assert s["run"]["checked"] == 1 and s["skipped"] == 1  # the run stopped there
    assert not TuneDB(path=db_copy).load().get_entry(64, 96, 192)["config"]["use_vendor"]
    monkeypatch.setattr(dispatch, "matmul", real)
    rc, s = _run(tmp_path, db_copy, "--order", "lex")
    assert rc == 1 and s["run"]["demoted"] == 1 and s["run"]["checked"] == 1
    entry = TuneDB(path=db_copy).load().get_entry(64, 96, 192)
    assert entry["config"]["use_vendor"] and "illegal memory access" in entry["demotion_reason"]
    rc, s = _run(tmp_path, db_copy, "--order", "lex")
    assert rc == 0 and s["failed"] == [] and s["passed"] == 1


def test_demotion_on_the_committed_db_is_refused(tmp_path, monkeypatch):
    monkeypatch.delenv("TPUL2_TORCH_TUNEDB", raising=False)
    committed = campaign.COMMITTED_DB.read_bytes()
    for argv in ([], ["--db", str(campaign.COMMITTED_DB)]):
        with pytest.raises(SystemExit) as exc:
            cc.main(argv + ["--device", "cpu", "--jsonl", str(tmp_path / "c.jsonl"),
                            "--out", str(tmp_path / "c.json")])
        assert exc.value.code == 2
    rc, s = _run(tmp_path, campaign.COMMITTED_DB, "--no_demote")
    assert rc == 0 and s["total_kernel_entries"] == 0  # all 40 entries are sentinels
    assert campaign.COMMITTED_DB.read_bytes() == committed


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [RING, STAGED], ids=["ring", "staged"])
def test_gate_sweep_on_the_card(cuda, tmp_path, cfg):
    from tpul2_torch.ops import launch_counts, zero_launch_counts
    path = tmp_path / "db.json"
    db = TuneDB(path=path)
    for m, n, k in ((256, 512, 1024), (100, 200, 320)):
        db.put(m, n, k, cfg, 1.0, acc=cfg.acc_dtype)
    db.save()
    zero_launch_counts()
    rc = cc.main(["--db", str(path), "--jsonl", str(tmp_path / "c.jsonl"),
                  "--out", str(tmp_path / "c.json")])
    summary = json.loads((tmp_path / "c.json").read_text())["summary"]
    assert rc == 0 and summary["passed"] == summary["checked"] == 2
    assert summary["guard_hits"] == 0 and "H100" in summary["device"]
    counts = launch_counts()
    assert (counts["staged_ring"] + counts["staged_ring_lsu"] if cfg.pipeline_depth
            else counts["multi_k_wgmma"] + counts["multi_k_wgmma_lsu"]) > 0
