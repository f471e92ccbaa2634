"""tpul2_torch's grid campaign on the CPU, held against the JAX package's.

- ``grid`` in all three orders and ``band`` over the 1000 reference shapes equal
  ``scripts/run_suite.py``'s and ``scripts/aggregate_results.py``'s;
- ``repair_csv`` drops and journals what ``scripts/run_suite.py:_repair_csv`` does on the
  same synthetic CSVs (the JAX columns mapped onto the port's), one case per taint class
  and budget; the one named difference is the JAX function's fall-through once an
  implausible row's budget is spent (``run_suite.py:174``), which the port does not take;
- ``heal_entries_from_eval`` demotes the same families and adopts the same variants as the
  JAX function on synthetic eval results (a JAX ``TuneDB`` on a temporary path), and in
  server mode leaves the offline entry byte-identical;
- ``eval_shape_lean`` on the CPU measures every column for both families from one set of
  baseline calls; the campaign, its sidecar, the aggregate means and the notes.

Only pure functions of the JAX scripts are called, and the JAX heal runs its 0/1 screen
(a small jitted product); no JAX timing loop runs.
"""

import csv
import dataclasses
import json
import math
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.aggregate_results as jax_agg
import scripts.run_suite as jax_suite
from tpul2.autotune.db import TuneDB as JaxTuneDB
from tpul2.config import KernelConfig as JaxConfig
from tpul2.harness import bench_suite as jax_bench_suite
from tpul2_torch.autotune import db as db_mod
from tpul2_torch.autotune.db import TuneDB
from tpul2_torch.config import KernelConfig, _vendor_for_xla
from tpul2_torch.harness import bench_suite, campaign, suite
from tpul2_torch.ops import baselines, lt_autotune

torch.set_num_threads(1)  # the tier-1 run shares its cores among its workers

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import aggregate_results_torch as agg  # noqa: E402
import update_bench_notes_torch as notes  # noqa: E402

#: JAX CSV column -> the port's (the same three families, ``test_torch_suite.py``).
COLUMNS = {"mnk": "mnk", "jnp.matmul": "torch.matmul",
           "XLA-dot-tn": "cuBLAS-tn", "XLA-dot-nn": "cuBLAS-nn", "XLA-dot-max": "cuBLAS-max",
           "XLA-highest-tn": "cuBLASLt-heuristic-tn", "XLA-highest-nn": "cuBLASLt-heuristic-nn",
           "XLA-highest-max": "cuBLASLt-heuristic-max",
           "XLA-AutoTuned-tn": "cuBLASLt-auto-tuning-tn",
           "XLA-AutoTuned-nn": "cuBLASLt-auto-tuning-nn",
           "XLA-AutoTuned-max": "cuBLASLt-auto-tuning-max", "iqr_rel": "iqr_rel"}
#: The port's perf_func -> the JAX eval's key.
FUNCS = {"torch_matmul": "xla_matmul", "cublas_nn": "xla_dot_nn", "cublas_tn": "xla_dot_tn",
         "cublaslt_nn": "xla_highest_nn", "cublaslt_tn": "xla_highest_tn",
         "cublaslt_autotuned_nn": "xla_autotuned_nn",
         "cublaslt_autotuned_tn": "xla_autotuned_tn"}


@pytest.fixture
def tmp_db(tmp_path, monkeypatch):
    path = tmp_path / "db.json"
    monkeypatch.setenv(db_mod.ENV_VAR, str(path))
    db_mod.reset_default_db()
    yield path
    db_mod.reset_default_db()


# ---------------------------------------------------------------------------
# grid and band
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["lex", "cost", "stratified"])
@pytest.mark.parametrize("cut", [{}, {"max_shapes": 37}, {"max_elems": 2048 * 4096}])
def test_grid_equals_the_jax_suite(order, cut):
    ours = suite.grid(suite.REFERENCE_DIMS, order=order, **cut)
    assert ours == jax_suite.grid(jax_suite.REFERENCE_DIMS, order=order, **cut)
    assert suite.REFERENCE_DIMS == jax_suite.REFERENCE_DIMS


def test_band_equals_the_jax_band_on_every_shape():
    shapes = suite.grid(suite.REFERENCE_DIMS)
    assert len(shapes) == 1000
    for s in shapes:
        name = suite.mnk_name(*s)
        assert suite.band(name) == jax_agg.band(name)


def test_stratified_prefix_keeps_the_band_mix():
    strat = suite.grid(suite.REFERENCE_DIMS, order="stratified")
    full = {b: sum(suite.band(suite.mnk_name(*s)) == b for s in strat) / 1000
            for b in agg.BANDS}
    for n in (100, 250, 500):
        for b, share in full.items():
            got = sum(suite.band(suite.mnk_name(*s)) == b for s in strat[:n]) / n
            assert abs(got - share) < 0.02
    with pytest.raises(ValueError):
        suite.grid([64], order="random")


# ---------------------------------------------------------------------------
# repair_csv against _repair_csv
# ---------------------------------------------------------------------------

def _write(path: Path, rows: list, port: bool, iqr: bool) -> None:
    """The rows (port columns) as the port's CSV or, columns renamed, the JAX one's."""
    if port:
        cols = suite.CSV_COLUMNS[:-1] + (["iqr_rel"] if iqr else []) + ["device"]
        data = [{**{c: r[c] for c in cols[:-1]}, "device": "cpu"} for r in rows]
    else:
        cols = jax_suite.CSV_COLUMNS + (["iqr_rel"] if iqr else [])
        data = [{c: r[COLUMNS[c]] for c in cols} for r in rows]
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(data)


def _row(mnk: str, tm: float, others: float, low=None, iqr=None) -> dict:
    """A port-column row: torch.matmul ``tm``, every other column ``others`` (one column
    ``low`` where given), the -max columns the lower of each pair."""
    r = {"mnk": mnk, "torch.matmul": f"{tm}"}
    for fam in ("cuBLAS", "cuBLASLt-heuristic", "cuBLASLt-auto-tuning"):
        r[f"{fam}-tn"] = f"{others}"
        r[f"{fam}-nn"] = f"{others}"
    if low is not None:
        r["cuBLAS-tn"] = f"{low}"
    for fam in ("cuBLAS", "cuBLASLt-heuristic", "cuBLASLt-auto-tuning"):
        r[f"{fam}-max"] = f"{min(float(r[f'{fam}-tn']), float(r[f'{fam}-nn']))}"
    if iqr is not None:
        r["iqr_rel"] = f"{iqr}"
    return r


def _journal_as_port(journal: dict) -> dict:
    out = {}
    for mnk, rec in journal.items():
        rec = dict(rec)
        if "last_row" in rec:
            rec["last_row"] = {COLUMNS[c]: v for c, v in rec["last_row"].items()}
        out[mnk] = rec
    return out


def _journal_without_device(journal: dict) -> dict:
    out = {}
    for mnk, rec in journal.items():
        rec = dict(rec)
        if "last_row" in rec:
            rec["last_row"] = {c: v for c, v in rec["last_row"].items() if c != "device"}
        out[mnk] = rec
    return out


#: case -> (the tainted row, whether the CSV has iqr_rel, the pass at which the JAX
#: fall-through drops a row that the port publishes as it stands, or None)
REPAIR_CASES = {
    "clean": (_row("64x64x64", 1.0, 1.0), False, None),
    "loss_vs_torch_matmul": (_row("64x64x128", 0.90, 1.0), False, None),
    "loss_vs_any_column": (_row("64x128x64", 1.0, 1.0, low=0.85), False, None),
    "inconsistent": (_row("128x64x64", 1.0, 1.0, low=0.3), False, None),
    "implausible_by_iqr": (_row("64x64x256", 1.0, 1.0, iqr=1.5), True, None),
    # every column < 0.5: lossy too, so after its 3 implausible re-measurements the JAX
    # function drops it once more under the loss budget
    "implausible_then_loss": (_row("256x64x64", 0.3, 0.31), False, 3),
    # every column < 0.5 and spread > 2.5: the JAX function spends the inconsistent
    # budget (3 more) after the implausible one
    "implausible_then_inconsistent": (_row("64x256x64", 0.45, 0.45, low=0.1), False, 3),
}


@pytest.mark.parametrize("case", list(REPAIR_CASES))
def test_repair_csv_matches_the_jax_repair(tmp_path, case):
    tainted, iqr, fall_through = REPAIR_CASES[case]
    clean = _row("2048x2048x2048", 1.01, 1.02, iqr=0.1 if iqr else None)
    rows = [clean, tainted]
    ours_p, theirs_p = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    _write(ours_p, rows, True, iqr)
    _write(theirs_p, rows, False, iqr)
    for attempt in range(7):
        ours = campaign.repair_csv(ours_p, any_col_floor=0.90)
        theirs = jax_suite._repair_csv(theirs_p, any_col_floor=0.90)
        if fall_through is not None and attempt >= fall_through:
            # the one named difference: the JAX function lets the spent implausible
            # budget fall through to another class's; the port publishes the row
            assert ours == set()
            if attempt == fall_through:
                assert theirs == {tainted["mnk"]}
            ours_j = json.loads(Path(str(ours_p) + ".repairs.json").read_text())
            assert ours_j[tainted["mnk"]]["implausible"] == 3
            assert ours_j[tainted["mnk"]]["loss"] == ours_j[tainted["mnk"]]["inconsistent"] == 0
            continue
        assert ours == theirs, attempt
        ours_j = Path(str(ours_p) + ".repairs.json")
        theirs_j = Path(str(theirs_p) + ".repairs.json")
        assert ours_j.exists() == theirs_j.exists()
        if ours_j.exists():
            assert _journal_without_device(json.loads(ours_j.read_text())) == \
                _journal_as_port(json.loads(theirs_j.read_text()))
        if ours:  # the re-measurement gives the same numbers again
            with ours_p.open("a", newline="") as f:
                csv.DictWriter(f, fieldnames=next(csv.reader(ours_p.open()))).writerow(
                    {**tainted, "device": "cpu"})
            with theirs_p.open("a", newline="") as f:
                jax_of = {v: k for k, v in COLUMNS.items()}
                csv.DictWriter(f, fieldnames=next(csv.reader(theirs_p.open()))).writerow(
                    {jax_of[c]: v for c, v in tainted.items()})
    if case == "clean":
        assert not Path(str(ours_p) + ".repairs.json").exists()


def test_restore_and_failures_match_the_jax_driver(tmp_path):
    rows = [_row("64x64x64", 0.9, 1.0), _row("128x128x128", 1.0, 1.0)]
    ours_p, theirs_p = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    _write(ours_p, rows, True, False)
    _write(theirs_p, rows, False, False)
    assert campaign.repair_csv(ours_p) == jax_suite._repair_csv(theirs_p) == {"64x64x64"}
    failures = tmp_path / "x.failures"
    failures.write_text("64x64x64\tRuntimeError: a\n64x64x64\tRuntimeError: b\n"
                        "1x1x1\tValueError: c\n")
    assert campaign.load_failures(failures) == jax_suite._load_failures(
        tmp_path / "x.jsonl") == {"64x64x64"}
    assert campaign.restore_exhausted_rows(ours_p, {"64x64x64"}) == \
        jax_suite._restore_exhausted_rows(theirs_p, {"64x64x64"}) == 1
    assert suite.done_shapes(ours_p) == {"64x64x64", "128x128x128"}


# ---------------------------------------------------------------------------
# heal_entries_from_eval against the JAX function
# ---------------------------------------------------------------------------

_MS = {"torch_matmul": 1.0, "cublas_nn": 1.02, "cublas_tn": 0.99, "cublaslt_nn": 1.01,
       "cublaslt_tn": 0.995, "cublaslt_autotuned_nn": 1.0, "cublaslt_autotuned_tn": 0.996}


def _res_pair(cand: float, ms: dict, accs=("float32",)) -> tuple:
    """The same synthetic eval as the port's result and the JAX one."""
    ours = {"per_func": {}, "speedups": {}}
    theirs = {"per_func": {}, "speedups": {}}
    for name, v in ms.items():
        rec = {"ms": v, "iqr_ms": 0.0, "tflops": 1.0 / v}
        ours["per_func"][name] = dict(rec)
        theirs["per_func"][FUNCS[name]] = dict(rec)
    cand_ms = ms["torch_matmul"] / cand
    for acc in accs:
        rec = {"ms": cand_ms, "iqr_ms": 0.0, "tflops": 1.0 / cand_ms}
        ours["per_func"][bench_suite.cand_name(acc)] = dict(rec)
        theirs["per_func"][f"tpul2_{acc}"] = dict(rec)
        ours["speedups"][acc] = {n: v / cand_ms for n, v in ms.items()}
        theirs["speedups"][acc] = {FUNCS[n]: v / cand_ms for n, v in ms.items()}
    return ours, theirs


_JAX_VARIANT = {"torch_matmul": "matmul", "cublas_nn": "dot_nn", "cublas_tn": "dot_tn",
                "cublaslt_nn": "highest_nn", "cublaslt_tn": "highest_tn"}


def _configs(kind):
    """(port config, JAX config) of an entry kind: 'kernel' or a vendor variant."""
    if kind == "kernel":
        return KernelConfig(bm=64, bn=128, bk=64), JaxConfig(bm=64, bn=256, bk=64)
    return KernelConfig.vendor(kind), JaxConfig.xla(_JAX_VARIANT[kind])


#: case -> (entry kind or None, its extras, server sub-entry kind or None, candidate
#: speedup, ms overrides, mode, families)
HEAL_CASES = {
    "losing_kernel_demoted": ("kernel", {}, None, 0.80, {}, "offline", ("float32",)),
    "losing_kernel_demoted_bf16": ("kernel", {}, None, 0.80, {}, "offline", ("bfloat16",)),
    "noise_loss_on_best_sentinel_remeasures": ("cublas_tn", {}, None, 0.90, {}, "offline",
                                               ("float32",)),
    "bogus_sentinel_bookkeeping_refreshed": ("cublas_nn", {"speedup": 15.48}, None, 1.0, {},
                                             "offline", ("float32",)),
    "loss_to_a_published_column": ("cublas_nn", {}, None, 1.0,
                                   {"cublas_nn": 1.0, "cublas_tn": 0.94}, "offline",
                                   ("float32", "bfloat16")),
    "fastest_is_the_lt_heuristic": ("kernel", {}, None, 0.9,
                                    {"cublaslt_tn": 0.9, "cublas_tn": 0.99}, "offline",
                                    ("float32",)),
    "winning_kernel_kept": ("kernel", {"speedup": 1.3}, None, 1.25, {}, "offline",
                            ("float32",)),
    "seeded_sentinel_promoted": ("cublas_nn", {"measured": False, "scope": "transfer_static"},
                                 None, 1.0, {}, "offline", ("float32",)),
    "seeded_kernel_promoted": ("kernel", {"measured": False, "scope": "transfer_static"},
                               None, 1.2, {}, "offline", ("float32",)),
    "no_entry_losing": (None, {}, None, 0.8, {}, "offline", ("float32", "bfloat16")),
    "no_entry_winning": (None, {}, None, 1.1, {}, "offline", ("float32",)),
    "server_losing_kernel": ("kernel", {"speedup": 1.3}, None, 0.80, {}, "server",
                             ("float32",)),
    "server_no_loss": ("cublas_nn", {"speedup": 1.01}, None, 1.05, {}, "server",
                       ("float32",)),
    "server_sentinel_already_best": ("kernel", {"speedup": 1.2}, "cublas_tn", 0.90, {},
                                     "server", ("float32",)),
    "server_bookkeeping_refreshed": ("cublas_nn", {"speedup": 1.02}, "cublas_nn", 1.0, {},
                                     "server", ("float32",)),
    "server_no_entry_losing": (None, {}, None, 0.8, {}, "server", ("bfloat16",)),
}


def _same_entry(ours: dict, theirs: dict) -> None:
    if theirs is None:
        assert ours is None
        return
    assert ours is not None
    assert ours["config"]["use_vendor"] == theirs["config"]["use_xla"]
    if theirs["config"]["use_xla"]:
        jv = theirs["config"]["xla_variant"]
        assert ours["config"]["vendor_variant"] == {v: k for k, v in _JAX_VARIANT.items()}[jv]
        if jv in ("matmul", "dot_nn", "dot_tn"):
            assert ours["config"]["vendor_variant"] == _vendor_for_xla(jv)
    for key in ("scope", "measured"):
        assert ours.get(key) == theirs.get(key), key
    assert ("demoted_from" in ours) == ("demoted_from" in theirs)
    if theirs.get("demoted_from") is not None:
        assert ours["demoted_from"]["use_vendor"] == theirs["demoted_from"]["use_xla"]
    else:
        assert ours.get("demoted_from") is None
    if "speedup_vs_xla" in theirs:
        assert ours["speedup_vs_torch_matmul"] == pytest.approx(theirs["speedup_vs_xla"])
    assert ("server" in ours) == ("server" in theirs)
    if "server" in theirs:
        _same_entry(ours["server"], theirs["server"])


@pytest.mark.parametrize("case", list(HEAL_CASES))
def test_heal_matches_the_jax_heal(tmp_path, case):
    kind, extra, server_kind, cand, ms_over, mode, accs = HEAL_CASES[case]
    m, n, k = 64, 128, 96
    ours_db = TuneDB(path=tmp_path / "ours.json")
    theirs_db = JaxTuneDB(path=tmp_path / "theirs.json")
    for acc in accs:
        if kind is not None:
            cfg, jcfg = _configs(kind)
            if acc == "bfloat16" and not cfg.use_vendor:
                cfg, jcfg = (dataclasses.replace(cfg, acc_dtype=acc),
                             dataclasses.replace(jcfg, acc_dtype=acc))
            ex = {key: v for key, v in extra.items() if key != "speedup"}
            sp = extra.get("speedup", 1.0)
            ours_db.put(m, n, k, cfg, 1.0, acc=acc, extra={"speedup_vs_torch_matmul": sp, **ex})
            theirs_db.put(m, n, k, jcfg, tflops=1.0, acc=acc,
                          extra={"speedup_vs_xla": sp, **ex})
        if server_kind is not None:
            cfg, jcfg = _configs(server_kind)
            ours_db.put_server(m, n, k, cfg, acc=acc, extra={"speedup_vs_torch_matmul": 9.9})
            theirs_db.put_server(m, n, k, jcfg, acc=acc, extra={"speedup_vs_xla": 9.9})
    offline_before = {acc: json.dumps({key: v for key, v in (ours_db.get_entry(m, n, k, acc)
                                                              or {}).items()
                                       if key != "server"}, sort_keys=True) for acc in accs}
    ours_res, theirs_res = _res_pair(cand, {**_MS, **ms_over}, accs)
    ours = bench_suite.heal_entries_from_eval(ours_db, m, n, k, accs, ours_res, mode=mode,
                                              device="cpu")
    theirs = jax_bench_suite.heal_entries_from_eval(theirs_db, m, n, k, accs, jnp.bfloat16,
                                                    theirs_res, mode=mode)
    assert ours == theirs
    for acc in accs:
        ours_e = ours_db.get_entry(m, n, k, acc)
        _same_entry(ours_e, theirs_db.get_entry(m, n, k, acc, jnp.bfloat16))
        if mode == "server" and kind is not None:  # the offline entry stays byte-identical
            assert json.dumps({key: v for key, v in ours_e.items() if key != "server"},
                              sort_keys=True) == offline_before[acc]


def test_screen_rejects_a_bf16_reduction(monkeypatch):
    """The family rule: a variant that sums in bf16 fails the f32 family's screen once
    partial sums pass 256, and the bf16 family's where |truth| <= 256 only."""
    m, n, k = 32, 48, 2048
    assert bench_suite.screen_variant_exact("cublas_tn", m, n, k, "float32", device="cpu")

    def bf16_sum(a, b, b_t):
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.bfloat16)
        for i in range(0, a.shape[1], 64):
            acc = (acc.float() + a[:, i:i + 64].float() @ b[i:i + 64].float()).bfloat16()
        return acc

    monkeypatch.setitem(baselines.BASELINES, "cublas_tn", bf16_sum)
    assert not bench_suite.screen_variant_exact("cublas_tn", m, n, k, "float32", device="cpu")
    ms = {"cublas_tn": 0.5, "torch_matmul": 1.0}
    assert bench_suite.best_screened_variant(ms, m, n, k, "float32", device="cpu") == \
        "torch_matmul"


def test_tune_sentinels_from_eval_fills_missing_and_stale_only(tmp_path):
    db = TuneDB(path=tmp_path / "db.json")
    kernel = KernelConfig(bm=64, bn=64, bk=128)
    db.put(64, 64, 256, kernel, 5.0, acc="float32")
    db.put(64, 64, 256, KernelConfig.vendor("cublas_nn"), 1.0, acc="bfloat16",
           extra={"timing_rev": 1})
    sel = {"torch_matmul": 1.0, "cublas_nn": 1.1, "cublas_tn": 0.9, "cublaslt_nn": 1.0,
           "cublaslt_tn": 1.0}
    assert bench_suite.tune_sentinels_from_eval(db, 64, 64, 256, ["float32", "bfloat16"],
                                                sel, device="cpu")
    assert db.get(64, 64, 256, "float32") == kernel  # a stored kernel winner stays
    bf = db.get_entry(64, 64, 256, "bfloat16")
    assert bf["config"]["vendor_variant"] == "cublas_tn" and bf["scope"] == "sentinels"
    assert bf["speedup_vs_torch_matmul"] == pytest.approx(1.0 / 0.9)
    assert not bench_suite.tune_sentinels_from_eval(db, 64, 64, 256, ["bfloat16"], sel,
                                                    device="cpu")  # now current


def test_demote_uncompilable_entries(tmp_path, monkeypatch):
    import tpul2_torch.autotune.search as search
    from tpul2_torch.ops._build import LaunchRefused

    db = TuneDB(path=tmp_path / "db.json")
    db.put(64, 64, 64, KernelConfig(bm=64, bn=64, bk=64), 9.0, acc="float32")
    db.put(64, 64, 64, KernelConfig.vendor("cublas_nn"), 1.0, acc="bfloat16")
    db.put(64, 64, 128, KernelConfig(bm=64, bn=64, bk=64), 9.0, acc="float32")
    real = search._make_fn

    def fake(cfg, out_dtype):
        if not cfg.use_vendor and cfg.bk == 64:
            def refused(a, b, b_t):
                raise LaunchRefused("tl2_wgmma: error 9 (simulated)")
            return refused
        return real(cfg, out_dtype)

    monkeypatch.setattr(search, "_make_fn", fake)
    demoted = bench_suite.demote_uncompilable_entries(db, 64, 64, 64, ["float32", "bfloat16"],
                                                      device="cpu", retry_pause_s=0.0)
    assert demoted == ["float32"]
    entry = TuneDB(path=tmp_path / "db.json").load().get_entry(64, 64, 64, "float32")
    assert entry["config"]["use_vendor"] and entry["scope"] == "compile_demote"
    assert entry["demotion_reason"].startswith("on-device build/launch failure: LaunchRefused")
    assert entry["demoted_from"]["bk"] == 64
    assert db.get(64, 64, 64, "bfloat16").vendor_variant == "cublas_nn"
    monkeypatch.setattr(search, "_make_fn", real)  # a config that runs is kept
    assert bench_suite.demote_uncompilable_entries(db, 64, 64, 128, ["float32"],
                                                   device="cpu") == []


# ---------------------------------------------------------------------------
# the lean engine and the campaign on the CPU
# ---------------------------------------------------------------------------

def _count_baseline_calls(monkeypatch) -> dict:
    calls = {}
    for name, fn in list(baselines.BASELINES.items()):
        def counted(a, b, b_t, fn=fn, name=name):
            calls[name] = calls.get(name, 0) + 1
            return fn(a, b, b_t)
        monkeypatch.setitem(baselines.BASELINES, name, counted)
    return calls


def test_eval_shape_lean_measures_both_families_from_one_baseline_set(tmp_db, monkeypatch):
    counts = {}
    for accs in (("float32",), ("float32", "bfloat16")):
        calls = _count_baseline_calls(monkeypatch)
        res = bench_suite.eval_shape_lean(96, 160, 200, accs=accs, trials=3, sel_trials=2,
                                          device="cpu")
        counts[accs] = dict(calls)
        monkeypatch.undo()
    one, both = counts.values()
    assert one == both  # a second family adds no baseline call
    for name, c in both.items():  # warm-ups, selection, publication
        plain = name not in bench_suite.AUTOTUNED
        assert c == (1 + 2 if plain else 0) + 1 + 3, name
    assert set(res["per_func"]) == set(baselines.BASELINES) | {
        "tpul2_torch_float32", "tpul2_torch_bfloat16"}
    for rec in res["per_func"].values():
        assert set(rec) == {"ms", "p99_ms", "iqr_ms", "tflops"} and rec["ms"] > 0
    for acc in ("float32", "bfloat16"):
        cand = res["per_func"][bench_suite.cand_name(acc)]["ms"]
        assert set(res["speedups"][acc]) == set(baselines.BASELINES)
        for name, sp in res["speedups"][acc].items():
            assert sp == res["per_func"][name]["ms"] / cand
        assert not res["configs"][acc]["use_vendor"]  # the heuristic on an empty DB
    assert res["device"] == "cpu" and res["clock"] == "host" and res["launches"] == {}
    server = bench_suite.eval_shape_server_lean(64, 64, 64, n_requests=3, sel_trials=1,
                                                target_qps=2000.0, device="cpu")
    assert server["mode"] == "server" and server["target_qps"] == 2000.0
    with pytest.raises(ValueError, match="target_qps"):
        bench_suite.eval_shape_server_lean(64, 64, 64, target_qps=0.0, device="cpu")


def test_campaign_heals_publishes_and_resumes(tmp_path):
    db_path = tmp_path / "db.json"
    shutil.copy(campaign.COMMITTED_DB, db_path)
    out = tmp_path / "grid"
    shapes = [(64, 64, 64), (96, 160, 200)]
    with pytest.raises(ValueError, match="committed"):
        campaign.run_campaign(shapes, out, heal=True, device="cpu")
    # the lean engine never falls back: a column that fails fails the shape
    summary = campaign.run_campaign(shapes, out, db_path=db_path, heal=True, defend=True,
                                    trials=3, device="cpu")
    assert summary["rows"] == 2 and not summary["failed"] and not summary["defense_failed"]
    records = [json.loads(ln) for ln in campaign.sidecar_path(out, "offline").read_text()
               .splitlines()]
    assert [r["mnk"] for r in records] == ["64x64x64", "96x160x200"]
    assert records[-1]["db"] == {"path": str(db_path.resolve()),
                                 "sha256": campaign.file_sha256(db_path)}
    for r in records:
        assert r["remeasured_after_heal"] == bool(r["healed"])
        assert set(r["defense"]) == {"float32", "bfloat16"}
        assert all(d["pass"] for d in r["defense"].values())
        assert set(r["config_source"]) == {"float32", "bfloat16"}
    for acc in ("float32", "bfloat16"):
        assert suite.done_shapes(suite.csv_path(out, acc, "offline")) == {"64x64x64",
                                                                         "96x160x200"}
    again = campaign.run_campaign(shapes, out, db_path=db_path, device="cpu")
    assert again["rows"] == 0  # resumed: nothing left to measure


def test_campaign_records_failures_and_goes_on(tmp_path, monkeypatch, tmp_db):
    def boom(*a, **kw):
        raise RuntimeError("no card")

    monkeypatch.setitem(baselines.BASELINES, "cublas_nn", boom)
    out = tmp_path / "grid"
    sidecar = campaign.sidecar_path(out, "offline")
    for attempt in range(2):  # a failure is recorded, then raised
        with pytest.raises(RuntimeError, match="no card"):
            campaign.run_campaign([(64, 64, 64)], out, db_path=tmp_db, device="cpu",
                                  trials=2)
        records = [json.loads(ln) for ln in sidecar.read_text().splitlines()]
        assert len(records) == attempt + 1
        assert records[-1]["error"] == "RuntimeError: no card"
        assert records[-1]["published"] is False and "speedups" not in records[-1]
        assert sidecar.with_suffix(".failures").read_text().splitlines()[-1] == \
            "64x64x64\tRuntimeError: no card"
    for acc in ("float32", "bfloat16"):
        assert suite.done_shapes(suite.csv_path(out, acc, "offline")) == set()
    # given up after two recorded failures: passed over, and still reported failed
    s = campaign.run_campaign([(64, 64, 64)], out, db_path=tmp_db, device="cpu", trials=2)
    assert s["failed"] == ["64x64x64"] and s["rows"] == 0


def test_campaign_heal_publishes_no_row_in_place_of_a_failure(tmp_path, monkeypatch):
    """A shape whose eval raises under ``heal`` leaves the DB as it was (no stored config
    is demoted within the campaign) and gets no row, in either family."""
    import tpul2_torch.dispatch as dispatch

    db_path = tmp_path / "db.json"
    db = TuneDB(path=db_path)
    for acc in ("float32", "bfloat16"):
        db.put(64, 64, 64, KernelConfig(bm=64, bn=64, bk=64, acc_dtype=acc), 9.0, acc=acc)
    db.save()
    before = db_path.read_text()

    def refused(a, b, *args, **kwargs):  # the stored kernel config's launch fails
        raise RuntimeError("tl2_wgmma: launch refused (simulated)")

    monkeypatch.setattr(dispatch, "cuda_matmul_fused", refused)
    out = tmp_path / "grid"
    with pytest.raises(RuntimeError, match="launch refused"):
        campaign.run_campaign([(64, 64, 64)], out, db_path=db_path, heal=True, trials=2,
                              device="cpu")
    assert db_path.read_text() == before
    for acc in ("float32", "bfloat16"):
        assert not suite.csv_path(out, acc, "offline").exists()
    (record,) = [json.loads(ln) for ln in
                 campaign.sidecar_path(out, "offline").read_text().splitlines()]
    assert record["error"].startswith("RuntimeError: tl2_wgmma: launch refused")
    assert record["db"]["sha256"] == campaign.file_sha256(db_path)


def test_lt_search_budget_bounds_the_rounds():
    assert lt_autotune.bounded_rounds(2000.0, 10.0) == lt_autotune.TIMED_ROUNDS
    assert lt_autotune.bounded_rounds(2000.0, 200.0) == 10
    assert lt_autotune.bounded_rounds(2000.0, 5000.0) == lt_autotune.MIN_TIMED_ROUNDS


# ---------------------------------------------------------------------------
# aggregate and the notes
# ---------------------------------------------------------------------------

def test_aggregate_means_match_numpy(tmp_path):
    rng = np.random.default_rng(0)
    shapes = suite.grid(suite.REFERENCE_DIMS, max_shapes=60, order="stratified")
    rows = []
    for s in shapes:
        sp = {pf: float(rng.uniform(0.3, 2.0)) for pf in suite.SPEEDUP_COLUMNS}
        rows.append(suite.row_from_speedups(suite.mnk_name(*s), sp, "cpu"))
    path = tmp_path / "x.csv"
    for r in rows:
        suite.append_row(path, r)
    res = agg.aggregate(path)
    assert set(res) == set(suite.CSV_COLUMNS) - {"mnk", "device"}
    for c, s in res.items():
        vals = np.array([float(r[c]) for r in rows])
        assert s["n"] == len(vals)
        assert s["mean"] == pytest.approx(vals.mean(), rel=1e-12)
        assert s["geomean"] == pytest.approx(math.exp(np.log(vals).mean()), rel=1e-12)
        assert s["wins"] == int((vals > 1.001).sum())
    bands = agg.band_table(path)
    for b, s in bands.items():
        vals = np.array([float(r["torch.matmul"]) for r in rows if suite.band(r["mnk"]) == b])
        assert s["n"] == len(vals) and s["max"] == vals.max()
        assert s["geomean"] == pytest.approx(math.exp(np.log(vals).mean()), rel=1e-12)
    assert agg.main([str(path)]) == 0


def test_notes_print_no_none(tmp_path):
    db_path = tmp_path / "db.json"
    shutil.copy(campaign.COMMITTED_DB, db_path)
    grid_dir = tmp_path / "grid"
    campaign.run_campaign([(64, 64, 64)], grid_dir, db_path=db_path, heal=True, trials=2,
                          device="cpu")
    text = notes.render([grid_dir], suite_dirs=(tmp_path / "nothing",))
    assert "None" not in text and "not measured" in text  # no suite CSV there
    assert "1/1000 reference-grid shapes" in text
    text = notes.render([tmp_path / "empty"], suite_dirs=(REPO / "eval_results",))
    assert "None" not in text and "No campaign CSV: not measured." in text
    out = tmp_path / "notes.md"
    assert notes.main(["--grid_dirs", str(grid_dir), "--out", str(out)]) == 0
    assert out.read_text() == notes.render([grid_dir])


def test_reverify_and_repair_scripts_on_the_cpu(tmp_path, capsys):
    import repair_losses_torch as repair
    import reverify_db_torch as reverify

    db_path = tmp_path / "db.json"
    db = TuneDB(path=db_path)
    db.put(64, 64, 128, KernelConfig(bm=64, bn=64, bk=64), 1.0,
           extra={"speedup_vs_torch_matmul": 1.2})
    db.put(64, 64, 128, KernelConfig.vendor(), 1.0, acc="bfloat16")
    db.save()
    before = db_path.read_text()
    argv = ["--db", str(db_path), "--device", "cpu", "--trials", "2"]
    assert reverify.main(argv + ["--dry_run"]) == 0
    assert db_path.read_text() == before  # a dry run writes nothing
    assert reverify.main(argv + ["--demote_below", "1e9"]) == 0
    entry = TuneDB(path=db_path).load().get_entry(64, 64, 128, "float32")
    assert entry["config"]["use_vendor"] and entry["demoted_from"]["bk"] == 64
    assert entry["reverify_trials"] == 2 and entry["reverified_speedup"] > 0
    csv_path = tmp_path / "x.csv"
    suite.append_row(csv_path, suite.row_from_speedups(
        "64x64x128", {pf: 0.9 for pf in suite.SPEEDUP_COLUMNS}, "cpu"))
    suite.append_row(csv_path, suite.row_from_speedups(
        "64x64x256", {pf: 1.1 for pf in suite.SPEEDUP_COLUMNS}, "cpu"))
    assert repair.main(["--csv", str(csv_path), "--dry_run"]) == 0
    assert "1 losing rows: ['64x64x128']" in capsys.readouterr().err
    assert suite.done_shapes(csv_path) == {"64x64x128", "64x64x256"}


def test_config_source_names_entry_neighbour_and_heuristic(tmp_db):
    from tpul2_torch.dispatch import config_source

    db = db_mod.default_db()
    db.put(64, 4096, 64, KernelConfig.vendor("cublas_tn"), 1.0, acc="float32",
           extra={"scope": "heal_demote"})
    db.put_server(64, 4096, 64, KernelConfig.vendor(), acc="float32")
    assert config_source(64, 4096, 64) == {"source": "entry", "scope": "heal_demote"}
    assert config_source(64, 4096, 64, mode="server") == {"source": "server_entry"}
    # a neighbour within 2x on every dimension carries the heal entry over
    assert config_source(64, 6000, 64) == {"source": "neighbour", "from": [64, 4096, 64],
                                           "scope": "heal_demote"}
    assert config_source(64, 6000, 64, "bfloat16") == {"source": "heuristic"}
    assert config_source(1024, 1024, 1024) == {"source": "heuristic"}


def test_notes_count_config_sources():
    assert notes._sources([{"source": "entry", "scope": "heal_demote"},
                           {"source": "neighbour", "from": [1, 2, 3], "scope": "heal_demote"},
                           {"source": "neighbour", "from": [1, 2, 3], "scope": "tuned"},
                           {"source": "heuristic"}, {"source": "heuristic"}, None]) == (
        "entry (a heal entry) 1, heuristic 2, neighbour 1, neighbour (a heal entry) 1, "
        "not recorded 1")


def test_reverify_and_repair_refuse_the_committed_db(tmp_path, monkeypatch):
    import repair_losses_torch as repair
    import reverify_db_torch as reverify

    monkeypatch.delenv(db_mod.ENV_VAR, raising=False)
    committed = campaign.COMMITTED_DB.read_bytes()
    csv_path = tmp_path / "x.csv"
    suite.append_row(csv_path, suite.row_from_speedups(
        "64x64x128", {pf: 0.9 for pf in suite.SPEEDUP_COLUMNS}, "cpu"))
    for main, argv in ((reverify.main, ["--device", "cpu"]),
                       (reverify.main, ["--device", "cpu", "--db",
                                        str(campaign.COMMITTED_DB)]),
                       (repair.main, ["--csv", str(csv_path), "--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2  # argparse's error: nothing ran, nothing was written
    assert campaign.COMMITTED_DB.read_bytes() == committed
    assert suite.done_shapes(csv_path) == {"64x64x128"}


def test_reverify_demotes_a_config_that_cannot_run_and_fails(tmp_path, monkeypatch, capsys):
    import reverify_db_torch as reverify

    import tpul2_torch.autotune.search as search
    from tpul2_torch.ops._build import LaunchRefused

    db_path = tmp_path / "db.json"
    db = TuneDB(path=db_path)
    db.put(64, 64, 128, KernelConfig(bm=64, bn=64, bk=64), 1.0,
           extra={"speedup_vs_torch_matmul": 1.2})
    db.save()
    real = search._make_fn

    def fake(cfg, out_dtype):
        if not cfg.use_vendor:
            def refused(a, b, b_t):
                raise LaunchRefused("tl2_wgmma: error 9 (simulated)")
            return refused
        return real(cfg, out_dtype)

    monkeypatch.setattr(search, "_make_fn", fake)
    argv = ["--db", str(db_path), "--device", "cpu", "--trials", "2"]
    before = db_path.read_text()
    assert reverify.main(argv + ["--dry_run"]) == 1
    assert db_path.read_text() == before
    assert reverify.main(argv) == 1
    assert "1 failed to run" in capsys.readouterr().err
    entry = TuneDB(path=db_path).load().get_entry(64, 64, 128, "float32")
    assert entry["config"]["use_vendor"] and entry["scope"] == "compile_demote"
    assert "LaunchRefused: tl2_wgmma: error 9 (simulated)" in entry["demotion_reason"]
    assert entry["demoted_from"]["bk"] == 64
