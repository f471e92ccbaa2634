#!/usr/bin/env python
"""Correctness campaign of a tpul2_torch TuneDB: every stored kernel config through the 0/1
gate on the card that serves it.

The counterpart of ``scripts/correctness_campaign_tpu.py`` and of the interpret-mode
``scripts/correctness_campaign.py`` in one: the card is the serving device, and the guard
bands check the caller's memory, so an interpret-mode sanitizer has nothing to add.  Every
entry that is not the vendor sentinel, in ``--order`` over its shapes (stratified by
default: a run cut by ``--budget_s`` covers every band), goes ``--iterations`` times
through the gate, on the device:

  - 0/1 operands at ``harness.correctness.zero_one_density``, drawn on the device;
  - the truth is an independent f32 product on the device with TF32 off
    (``ops.baselines.pin_precision``), exact for every sum below 2^24; elements whose truth
    exceeds the family's ``EXACT_BOUND`` are masked;
  - the candidate is ``dispatch.matmul(a, b, config=cfg, acc=acc, b_t=b_t)`` written into
    ``harness.correctness.guarded_output``, at the widest output the config serves: f32,
    which every config of the port writes (the ring's shared memory does not depend on
    the output dtype, ``config.wgmma_smem_bytes``);
  - one max |diff| per iteration comes to the host (inf where the output is not finite);
    the entry passes where every diff is 0.0 and the guard bands are intact.

Resumable and config-aware, as the JAX tool: every verdict is appended to ``--jsonl`` with
the config it ran against, so a retuned entry is gated again; a numerical verdict is final;
a failure whose error names a transient cause is retried (``TRANSIENT_SIGNATURES``: none
on a local card).  A persistent failure is demoted to the fastest screened sentinel
(``bench_suite.demote_to_fastest_sentinel``, which records ``demoted_from`` and
``demotion_reason``) unless ``--no_demote`` is given.  Demotion writes the DB, so it refuses
the committed ``tpul2_torch/data/tunedb_h100.json``; ``--no_demote`` may read it.

A gate that raises (a CUDA fault leaves the process's context unusable) is recorded,
flushed to ``--jsonl`` before anything else touches the card, and ends the run with exit 1;
the next run finds the verdict final and demotes the entry if its config is still current.
The summary (``--out``) covers the whole JSONL: records for configs that are no longer
current are history, not coverage.  Exit 1 where any entry failed.

Usage:
  cp tpul2_torch/data/tunedb_h100.json runs/db.json     # tuned and seeded
  python scripts/correctness_campaign_torch.py --db runs/db.json --budget_s 3300
  python scripts/correctness_campaign_torch.py --no_demote          # the committed DB
  python scripts/correctness_campaign_torch.py --db /tmp/db.json --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: Error signatures of failures that are retried, not final.  The JAX tool lists the TPU
#: pool's (its remote compile service's HTTP 500s and outages).  A local card has no
#: service in between: a kernel that faults or is refused does so again, and an
#: out-of-memory is the shape's own in a process that frees each entry's tensors.
TRANSIENT_SIGNATURES: tuple = ()


def load_done(jsonl_text: str) -> set:
    """(mnk, acc) keys not to run again: a pass, or a failure with no transient signature
    (a final verdict); a later record of a key supersedes an earlier one."""
    done: set = set()
    for line in jsonl_text.splitlines():
        try:
            r = json.loads(line)
            key = (r["mnk"], r["acc"])
        except Exception:  # a garbage or foreign line must not stop the resume
            continue
        if r.get("pass"):
            done.add(key)
        elif any(s in r.get("error", "") for s in TRANSIENT_SIGNATURES):
            done.discard(key)
        else:
            done.add(key)
    return done


def load_latest_configs(jsonl_text: str) -> dict:
    """(mnk, acc) -> the config of the latest record that carries one."""
    latest: dict = {}
    for line in jsonl_text.splitlines():
        try:
            r = json.loads(line)
            if isinstance(r, dict) and "config" in r:
                latest[(r["mnk"], r["acc"])] = r["config"]
        except Exception:
            continue
    return latest


def verdict_covers(done: set, latest_cfg: dict, key, current_cfg) -> bool:
    """True where a stored verdict covers the current config: a record with no config
    counts by its key."""
    rec_cfg = latest_cfg.get(key)
    return key in done and (rec_cfg is None or rec_cfg == current_cfg)


def latest_records(jsonl_text: str) -> dict:
    """(mnk, acc) -> the latest record of the key."""
    by_key: dict = {}
    for line in jsonl_text.splitlines():
        try:
            r = json.loads(line)
            by_key[(r["mnk"], r["acc"])] = r
        except Exception:
            continue
    return by_key


def kernel_entries(db, order: str) -> list:
    """((m, n, k), acc, entry) of every entry that is not the vendor sentinel, with the
    shapes in ``order`` (``harness.suite.order_shapes``) and float32 before bfloat16."""
    from tpul2_torch.harness.suite import order_shapes
    items = [(mnk, acc, e) for mnk, acc, e in db.items() if not e["config"].get("use_vendor")]
    rank = {s: i for i, s in enumerate(order_shapes({mnk for mnk, _, _ in items}, order))}
    return sorted(items, key=lambda it: (rank[it[0]], it[1] != "float32", it[1]))


def gate_entry(m: int, n: int, k: int, acc: str, cfg, iterations: int, seed: int = 0,
               device: str = "cuda") -> dict:
    """The 0/1 gate of one config on ``device`` (module docstring): each iteration's max
    |diff| against the f32 truth (inf where the output is not finite), the guard-band
    hits, and the verdict."""
    import torch

    from tpul2_torch import dispatch
    from tpul2_torch.harness.correctness import (EXACT_BOUND, bands_intact, guarded_output,
                                                 zero_one_density)
    from tpul2_torch.ops.baselines import pin_precision

    pin_precision()
    dens = zero_one_density(k, acc)  # f32 output: the family's own bound
    bound = float(EXACT_BOUND[acc])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    diffs, guard_hits = [], 0
    for _ in range(iterations):
        a = (torch.rand((m, k), generator=gen, device=device) < dens).to(torch.bfloat16)
        b = (torch.rand((k, n), generator=gen, device=device) < dens).to(torch.bfloat16)
        b_t = b.t().contiguous()
        truth = a.float() @ b.float()
        buf, c = guarded_output((m, n), torch.float32, device)
        dispatch.matmul(a, b, acc=acc, config=cfg, b_t=b_t, out=c)
        d = torch.where(truth.abs() <= bound, (c - truth).abs(), 0.0).amax()
        diffs.append(float(torch.where(torch.isfinite(c).all(), d, float("inf"))))
        guard_hits += 0 if bands_intact(buf) else 1
        del a, b, b_t, truth, buf, c, d
    return {"diffs": diffs, "guard_hits": guard_hits,
            "pass": all(x == 0.0 for x in diffs) and guard_hits == 0}


def _append(jsonl: Path, rec: dict) -> None:
    with jsonl.open("a") as f:
        f.write(json.dumps(rec) + "\n")


def summarize(db, jsonl: Path, iterations: int, device: str, run: dict) -> tuple:
    """(summary, records) over the whole JSONL: the records are the latest of every current
    kernel entry whose config they ran against (or that carry none)."""
    from tpul2_torch.utils.platform import nvidia_smi_name_power

    by_key = latest_records(jsonl.read_text() if jsonl.exists() else "")
    kernel = {(f"{m}x{n}x{k}", acc): e for (m, n, k), acc, e in db.items()
              if not e["config"].get("use_vendor")}
    recs = [r for key, r in by_key.items()
            if key in kernel and r.get("config") in (None, kernel[key]["config"])]
    demotions = [{"mnk": r["mnk"], "acc": r["acc"], "demoted_to": r["demoted_to"],
                  "error": r.get("error", "0/1 gate failure")[:140]}
                 for r in by_key.values() if r.get("demoted_to")]
    return {"checked": len(recs), "total_kernel_entries": len(kernel),
            "passed": sum(bool(r["pass"]) for r in recs),
            "failed": [r for r in recs if not r["pass"]],
            "demotions": demotions, "skipped": len(kernel) - len(recs),
            "guard_hits": sum(r.get("guard_hits", 0) for r in recs),
            "iterations": iterations,
            "device": (nvidia_smi_name_power() or "cuda") if device == "cuda" else "cpu",
            "run": run}, recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--db", default=None,
                    help="the TuneDB file (default: TPUL2_TORCH_TUNEDB or the committed one, "
                         "which only --no_demote may read)")
    ap.add_argument("--out", default=str(REPO / "eval_results"
                                         / "correctness_campaign_torch_h100.json"))
    ap.add_argument("--jsonl", default=str(REPO / "eval_results"
                                           / "correctness_campaign_torch_h100.jsonl"))
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--budget_s", type=float, default=3300.0,
                    help="start no entry past this many seconds (the next run resumes)")
    ap.add_argument("--order", choices=["lex", "cost", "stratified"], default="stratified")
    ap.add_argument("--no_demote", dest="demote", action="store_false",
                    help="report persistent failures without demoting their entries")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    from tpul2_torch.autotune.db import TuneDB
    from tpul2_torch.config import KernelConfig
    from tpul2_torch.harness.bench_suite import demote_to_fastest_sentinel
    from tpul2_torch.harness.campaign import refuse_committed_db
    from tpul2_torch.utils.platform import check_device

    db = TuneDB(path=args.db)
    if args.demote:
        try:
            refuse_committed_db(db.path, "demotion")
        except ValueError as e:
            ap.error(f"{e} (or pass --no_demote)")
    check_device(args.device, "the campaign gates the card's kernels")
    db.load()
    jsonl, out = Path(args.jsonl), Path(args.out)
    jsonl.parent.mkdir(parents=True, exist_ok=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    text = jsonl.read_text() if jsonl.exists() else ""
    done, latest_cfg, by_key = load_done(text), load_latest_configs(text), latest_records(text)
    entries = kernel_entries(db, args.order)
    run = {"checked": 0, "passed": 0, "failed": 0, "demoted": 0, "skipped_for_budget": 0,
           "seconds": 0.0, "seconds_per_entry": None}
    t0 = time.perf_counter()

    def demote(m, n, k, acc, rec, reason) -> None:
        variant = demote_to_fastest_sentinel(db, m, n, k, acc, reason=reason,
                                             device=args.device)
        if variant is not None:
            rec["demoted_to"] = variant
            run["demoted"] += 1

    def finish(rc: int) -> int:
        run["seconds"] = time.perf_counter() - t0
        if run["checked"]:
            run["seconds_per_entry"] = run["seconds"] / run["checked"]
        summary, recs = summarize(db, jsonl, args.iterations, args.device, run)
        out.write_text(json.dumps({"summary": summary, "results": recs}, indent=1))
        print(f"correctness campaign: {summary['passed']}/{summary['checked']} of "
              f"{summary['total_kernel_entries']} kernel entries pass ({summary['skipped']} "
              f"not yet run, {len(summary['demotions'])} demotions on record); this run "
              f"checked {run['checked']} in {run['seconds']:.1f} s, "
              f"{run['skipped_for_budget']} left for the budget", file=sys.stderr)
        print(json.dumps(summary))
        return 1 if rc or run["failed"] or summary["failed"] else 0

    todo = []
    for (m, n, k), acc, entry in entries:
        key = (f"{m}x{n}x{k}", acc)
        if not verdict_covers(done, latest_cfg, key, entry["config"]):
            todo.append(((m, n, k), acc, entry))
        elif args.demote and not by_key[key]["pass"] and by_key[key].get("config") \
                == entry["config"]:
            # a final failure of a config that is still served: an earlier run recorded
            # it and stopped (a gate that raised), so the demotion happens now
            rec = {**by_key[key], "demotion_of_earlier_verdict": True}
            run["failed"] += 1
            demote(m, n, k, acc, rec, "on-card 0/1 gate failure: "
                   + rec.get("error", "wrong result")[:140])
            _append(jsonl, rec)
    print(f"correctness campaign on {args.device}: {len(todo)} kernel configs to gate "
          f"({len(entries) - len(todo)} covered by a verdict), {db.path}", file=sys.stderr)

    for i, ((m, n, k), acc, entry) in enumerate(todo):
        if time.perf_counter() - t0 > args.budget_s:
            run["skipped_for_budget"] = len(todo) - i
            print(f"budget reached with {len(todo) - i} configs left; resumable",
                  file=sys.stderr)
            break
        t1 = time.perf_counter()
        cfg = KernelConfig(**entry["config"])
        base = {"mnk": f"{m}x{n}x{k}", "acc": acc, "config": dict(entry["config"]),
                "out_dtype": "float32", "iterations": args.iterations}
        try:
            rec = {**base, **gate_entry(m, n, k, acc, cfg, args.iterations,
                                        device=args.device)}
        except Exception as e:  # recorded before anything else touches the card
            rec = {**base, "pass": False, "error": f"{type(e).__name__}: {str(e)[:300]}",
                   "traceback": traceback.format_exc()[-4000:],
                   "elapsed_s": time.perf_counter() - t1}
            _append(jsonl, rec)
            run["checked"] += 1
            run["failed"] += 1
            print(f"{m}x{n}x{k}/{acc}: FAILED, raised {rec['error']}; stopping (the next "
                  "run demotes it unless --no_demote)", file=sys.stderr)
            return finish(1)
        run["checked"] += 1
        if rec["pass"]:
            run["passed"] += 1
        else:
            run["failed"] += 1
            if args.demote:
                demote(m, n, k, acc, rec, f"on-card 0/1 gate failure: diffs {rec['diffs']}, "
                       f"guard hits {rec['guard_hits']}")
        rec["elapsed_s"] = time.perf_counter() - t1
        _append(jsonl, rec)
        print(f"{m}x{n}x{k}/{acc}: {'PASS' if rec['pass'] else 'FAIL ' + json.dumps(rec)} "
              f"({rec['elapsed_s']:.3f} s)", file=sys.stderr)
    return finish(0)


if __name__ == "__main__":
    sys.exit(main())
