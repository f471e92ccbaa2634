"""The grid campaign: the lean engine over a shape list, with the heal loop and the
repair rules of its CSVs.

Counterpart of ``scripts/run_suite.py``'s ``_repair_csv``, ``_restore_exhausted_rows``,
``_load_failures`` and the lean/heal path of ``cmd_eval`` and ``cmd_eval_server``;
``scripts/run_suite_torch.py eval --engine lean`` is its command line.  One campaign run:

  1. with ``heal``: drop the tainted rows of each family's CSV, each within its journaled
     budget (``repair_csv``), so that they are measured again;
  2. for each shape not in both CSVs: the lean eval of both families (one set of baseline
     measurements); with ``heal``, the DB repairs of ``heal_entries_from_eval`` and, where
     a family was demoted, one re-measurement, which is what gets published.  An eval
     that raises (a kernel config that does not build or launch, a column that fails) is
     a failure: the shape goes to the ``.failures`` file and to the sidecar with its
     error, no row stands in for it, and the exception ends the campaign.  A shape
     recorded as failed twice is passed over by later runs and still reported failed,
     so a campaign over it never succeeds.  Nothing here rewrites a stored config that
     raised: ``bench_suite.demote_uncompilable_entries`` is an explicit offline step
     (``scripts/reverify_db_torch.py``), whose record names the error;
  3. with ``defend``: ``run_all_defenses`` on each family's candidate at the shape; a row
     whose candidate fails a defense is not published, and the run reports it;
  4. a row per family in ``tpul2_torch_h100_<acc>_speedup_<mode>.csv`` and one record per
     shape in the family-neutral ``tpul2_torch_h100_all_speedup_<mode>.jsonl``: every
     column's numbers, the dispatched configs and where each came from (the shape's
     entry, a neighbour's, or the heuristic: ``dispatch.config_source``), the kernel
     launches of the publication phase, the DB file's sha256 and whether the row was
     re-measured after a heal.

Two departures from the JAX driver: a row whose implausible-taint budget is spent is
published as it stands (``run_suite.py:174`` lets it fall through to the other taint
classes' budgets), and there is no Pallas win-band pre-tune (``pallas_win_band``: v5e
thresholds; the port's tuner runs apart, ``python -m tpul2_torch.autotune``).
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from tpul2_torch.autotune import db as db_mod
from tpul2_torch.dispatch import candidate_fn
from tpul2_torch.harness import suite
from tpul2_torch.harness.bench_suite import (N_REQUESTS, TRIALS, eval_shape_lean,
                                             eval_shape_server_lean, heal_entries_from_eval)
from tpul2_torch.harness.bench_utils import fresh_inputs
from tpul2_torch.harness.defense import run_all_defenses
from tpul2_torch.utils.platform import check_device, nvidia_smi_name_power

#: CSV columns that are not a speedup.
NON_SPEEDUP_COLUMNS = ("mnk", "device", "iqr_rel", "quality")
#: The any-column loss floor of the repair, per mode (the JAX driver's defaults).
REPAIR_FLOOR = {"offline": 0.95, "server": 0.98}
COMMITTED_DB = db_mod._DATA_DIR / "tunedb_h100.json"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def repair_csv(path: Path, threshold: float = 0.97, ratio_cap: float = 2.5,
               max_loss_repairs: int = 1, max_inconsistent_repairs: int = 3,
               any_col_floor: float = 0.90, implausible_ceiling: float = 0.5,
               iqr_invalid: float = 1.0) -> set:
    """Drop tainted rows from a campaign CSV so that they are measured again; return their
    mnk names.

    Three taint classes, each with its own budget, journaled per mnk in
    ``<csv>.repairs.json``:

      implausible   every speedup column < ``implausible_ceiling``, or the row's own
                    ``iqr_rel`` > ``iqr_invalid``: a stall inside the candidate's calls
                    sinks every column together.  Up to ``max_inconsistent_repairs``
                    re-measurements; then the row is published as it stands.
      inconsistent  max / min of the speedup columns > ``ratio_cap``: a corrupted
                    column.  Up to ``max_inconsistent_repairs`` re-measurements.
      loss          torch.matmul < ``threshold``, or any column < ``any_col_floor``, in a
                    row that is not inconsistent.  At most ``max_loss_repairs``
                    re-measurements; the re-measurement is published whatever it says,
                    so a row still losing is an honest loss.

    A dropped row's data is kept in the journal (``last_row``) so that a re-measurement
    that then fails for good can put it back (``restore_exhausted_rows``)."""
    path = Path(path)
    if not path.exists():
        return set()
    with path.open(newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return set()
    journal_path = Path(str(path) + ".repairs.json")
    journal = json.loads(journal_path.read_text()) if journal_path.exists() else {}
    fieldnames = list(rows[0].keys())
    dropped = set()
    for r in rows:
        vals = [float(v) for c, v in r.items() if c not in NON_SPEEDUP_COLUMNS and v]
        if not vals:
            continue
        inconsistent = max(vals) / min(vals) > ratio_cap
        implausible = (max(vals) < implausible_ceiling
                       or float(r.get("iqr_rel") or 0.0) > iqr_invalid)
        lossy = float(r["torch.matmul"]) < threshold or min(vals) < any_col_floor
        if not (inconsistent or lossy or implausible):
            continue  # clean rows never enter the journal
        rec = journal.setdefault(r["mnk"], {"loss": 0, "inconsistent": 0})
        if implausible:
            # its own budget only: once spent, the row stands as measured
            if rec.setdefault("implausible", 0) < max_inconsistent_repairs:
                rec["implausible"] += 1
                dropped.add(r["mnk"])
        elif inconsistent and rec["inconsistent"] < max_inconsistent_repairs:
            rec["inconsistent"] += 1
            dropped.add(r["mnk"])
        elif lossy and not inconsistent and rec["loss"] < max_loss_repairs:
            rec["loss"] += 1
            dropped.add(r["mnk"])
        if r["mnk"] in dropped:
            rec["last_row"] = dict(r)
    if dropped:
        keep = [r for r in rows if r["mnk"] not in dropped]
        tmp = path.with_suffix(".tmp")
        with tmp.open("w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames)
            w.writeheader()
            w.writerows(keep)
        tmp.replace(path)
        journal_path.write_text(json.dumps(journal, indent=1, sort_keys=True))
    return dropped


def restore_exhausted_rows(path: Path, failed: set) -> int:
    """Put back the journaled row of each repair-dropped shape whose re-measurement has
    failed for good, so that the CSV shows its coverage honestly; return the count."""
    path = Path(path)
    journal_path = Path(str(path) + ".repairs.json")
    if not path.exists() or not journal_path.exists() or not failed:
        return 0
    journal = json.loads(journal_path.read_text())
    with path.open(newline="") as f:
        reader = csv.DictReader(f)
        fieldnames = reader.fieldnames
        present = {row["mnk"] for row in reader}
    restored = 0
    with path.open("a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        for mnk in sorted(failed):
            rec = journal.get(mnk)
            if mnk in present or not rec or "last_row" not in rec:
                continue
            w.writerow({c: rec["last_row"].get(c, "") for c in fieldnames})
            restored += 1
            _log(f"restored repair-dropped row {mnk} after its re-measurement failed "
                 "for good (the original measurement stands)")
    return restored


def load_failures(path: Path, max_attempts: int = 2) -> set:
    """The mnk names recorded at least ``max_attempts`` times in a ``.failures`` file: a
    shape that keeps failing counts as done, so the campaign can finish."""
    path = Path(path)
    if not path.exists():
        return set()
    counts: dict = {}
    for line in path.read_text().splitlines():
        mnk = line.split("\t", 1)[0].strip()
        if mnk:
            counts[mnk] = counts.get(mnk, 0) + 1
    return {mnk for mnk, c in counts.items() if c >= max_attempts}


def sidecar_path(out_dir, mode: str, gen: str = "h100") -> Path:
    """The family-neutral JSONL sidecar of a mode: every record holds both families."""
    return Path(out_dir) / f"tpul2_torch_{gen}_all_speedup_{mode}.jsonl"


def refuse_committed_db(path, what: str) -> Path:
    """``path`` resolved; raises ``ValueError`` where it is the committed DB, which
    ``what`` would rewrite."""
    path = Path(path).resolve()
    if path == COMMITTED_DB.resolve():
        raise ValueError(f"{what} rewrites the DB it runs through; pass a copy of "
                         f"{COMMITTED_DB.name}, not the committed file")
    return path


def file_sha256(path: Path) -> Optional[str]:
    path = Path(path)
    return hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() else None


def _defense_summary(res: dict) -> dict:
    out = {"pass": res["pass"]}
    for d in res["defenses"]:
        out[d["name"]] = d["pass"]
        if d["name"] == "stream_injection":
            out["stream"] = {key: d[key] for key in ("event_ms", "sync_ms", "ratio",
                                                     "floor_ms", "runs_flagged")}
    return out


def run_campaign(shapes: Sequence[tuple], out_dir, mode: str = "offline",
                 accs: Sequence[str] = ("float32", "bfloat16"),
                 db_path=COMMITTED_DB, heal: bool = False, defend: bool = False,
                 trials: Optional[int] = None, target_qps: float = 100.0, seed: int = 0,
                 device: str = "cuda") -> dict:
    """Evaluate ``shapes`` into ``out_dir`` through the DB at ``db_path`` (module
    docstring).  Resumable: a shape already in every family's CSV is skipped.  With
    ``heal`` the DB file is repaired in place, so it must not be the committed one.
    An eval that raises is recorded and raised again.  Returns a summary: rows written,
    the shapes given up after repeated failures, the shapes healed or failing a defense,
    and the seconds."""
    check_device(device, "the campaign times the card")
    if mode not in REPAIR_FLOOR:
        raise ValueError(f"mode must be 'offline' or 'server', got {mode!r}")
    db_path = refuse_committed_db(db_path, "heal") if heal else Path(db_path).resolve()
    label = (nvidia_smi_name_power() or "cuda") if device == "cuda" else "cpu"
    trials = trials or (TRIALS if mode == "offline" else N_REQUESTS)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    outs = {acc: suite.csv_path(out_dir, acc, mode) for acc in accs}
    sidecar = sidecar_path(out_dir, mode)
    failures = sidecar.with_suffix(".failures")
    if heal:
        for acc, p in outs.items():
            dropped = repair_csv(p, any_col_floor=REPAIR_FLOOR[mode])
            if dropped:
                _log(f"repair[{acc}]: measuring {len(dropped)} tainted rows again: "
                     f"{sorted(dropped)}")
    failed = load_failures(failures)
    for p in outs.values():
        restore_exhausted_rows(p, failed)
    done = {acc: suite.done_shapes(p) | failed for acc, p in outs.items()}
    todo = [s for s in shapes if any(suite.mnk_name(*s) not in done[acc] for acc in accs)]
    _log(f"campaign ({mode}): {len(todo)} shapes to evaluate into {out_dir} "
         f"({ {a: len(d) for a, d in done.items()} } done), DB {db_path}")

    old_env = os.environ.get(db_mod.ENV_VAR)
    os.environ[db_mod.ENV_VAR] = str(db_path)
    db_mod.reset_default_db()
    db = db_mod.default_db()

    def evaluate(m, n, k):
        if mode == "server":
            return eval_shape_server_lean(m, n, k, accs, n_requests=trials,
                                          target_qps=target_qps, seed=seed, device=device)
        return eval_shape_lean(m, n, k, accs, trials=trials, seed=seed, device=device)

    summary = {"rows": 0, "healed": [], "defense_failed": [], "shape_seconds": {},
               "failed": [suite.mnk_name(*s) for s in shapes if suite.mnk_name(*s) in failed]}
    t_start = time.perf_counter()
    try:
        for (m, n, k) in todo:
            mnk = suite.mnk_name(m, n, k)
            t0 = time.perf_counter()
            before, healed = None, []
            try:
                res = evaluate(m, n, k)
                if heal:
                    healed = heal_entries_from_eval(db, m, n, k, accs, res, mode=mode,
                                                    seed=seed, device=device)
                    if healed:
                        _log(f"{mnk}: healed {healed}, measuring again")
                        before, res = res, evaluate(m, n, k)
            except Exception as e:  # recorded, then raised: a failure is never published over
                error = f"{type(e).__name__}: {str(e)[:300]}"
                _log(f"{mnk}: FAILED\n{traceback.format_exc()}")
                with failures.open("a") as f:
                    f.write(f"{mnk}\t{error}\n")
                suite.append_sidecar(sidecar, {
                    "mnk": mnk, "mode": mode, "device": label, "published": False,
                    "error": error, "traceback": traceback.format_exc()[-4000:],
                    "db": {"path": str(db_path), "sha256": file_sha256(db_path)},
                    "shape_seconds": time.perf_counter() - t0})
                raise
            record = {"mnk": mnk}
            record.update({key: res[key] for key in ("mode", "target_qps", "per_func",
                                                "speedups", "configs", "config_source",
                                                "launches", "lt_search", "trials",
                                                "sel_trials", "clock", "elapsed_s")})
            record.update({"device": label,
                           "db": {"path": str(db_path), "sha256": file_sha256(db_path)},
                           "healed": healed, "remeasured_after_heal": bool(healed)})
            if before is not None:
                record["before_heal"] = {key: before[key] for key in
                                         ("speedups", "configs", "config_source",
                                          "launches")}
                summary["healed"].append(mnk)
            publish = True
            if defend:
                data = fresh_inputs(np.random.default_rng(seed), m, n, k, device=device)
                record["defense"] = {acc: _defense_summary(
                    run_all_defenses(candidate_fn(acc, mode), data)) for acc in accs}
                del data
                if not all(d["pass"] for d in record["defense"].values()):
                    summary["defense_failed"].append(mnk)
                    publish = False
                    _log(f"{mnk}: a defense FAILED, no row: {record['defense']}")
            if publish:
                for acc in accs:
                    if mnk not in done[acc]:
                        suite.append_row(outs[acc], suite.row_from_speedups(
                            mnk, res["speedups"][acc], label))
                summary["rows"] += 1
            record["published"] = publish
            record["shape_seconds"] = time.perf_counter() - t0
            summary["shape_seconds"][mnk] = record["shape_seconds"]
            suite.append_sidecar(sidecar, record)
            sp = res["speedups"]
            _log(f"{mnk}: " + " ".join(
                f"{acc} torch.matmul={sp[acc]['torch_matmul']:.3f} worst="
                f"{min(sp[acc].values()):.3f}" for acc in accs)
                + f" ({record['shape_seconds']:.1f} s)")
    finally:
        if old_env is None:
            os.environ.pop(db_mod.ENV_VAR, None)
        else:
            os.environ[db_mod.ENV_VAR] = old_env
        db_mod.reset_default_db()
    summary["seconds"] = time.perf_counter() - t_start
    return summary
