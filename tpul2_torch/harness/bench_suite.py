"""Suite-scale (lean) evaluation of one shape, and the heal loop's repairs of the DB.

Counterpart of ``tpul2/harness/bench_suite.py``.  The reference's product is a speedup
CSV per family over the {64..16384}^3 grid (SURVEY.md C14, about 1000 rows each).
``bench_offline._run_mode`` costs about ten seconds per shape, family and mode; the lean
engine measures the same thing for less:

  - one set of baseline measurements serves both accumulator families (the baselines do
    not depend on the candidate's family);
  - fixed iteration counts (``SEL_TRIALS``, ``TRIALS``) instead of seconds;
  - the cuBLASLt auto-tuning search is bounded per shape (``LT_BUDGET_MS`` of summed
    algo time per layout, ``ops.lt_autotune.search(budget_ms=)``).

Each iteration is ``_run_mode``'s: fresh normal inputs, a shuffled order, one call per
function between CUDA events on the current stream.  So the lean row and the
``_run_mode`` row time the same thing, and the lean row is cheaper only for the sharing
and the counts.  Two phases, as in the JAX engine: a *selection* phase times the plain
baselines alone (and runs the bounded cuBLASLt searches, which select the auto-tuning
columns' algos); the *publication* phase then times every published column and both
candidates, interleaved and shuffled, so no column reuses the sample that selected it.
A column that fails raises: no column is ever filled from another.

The JAX engine's ``_candidate_with_options`` (program-scope XLA compiler options of a
flag-variant sentinel) has no counterpart: the port's sentinels are plain library calls
with no options to carry.  Its server engine chains requests to get past a TPU fence
floor of ~30 ms that the card does not have, so ``eval_shape_server_lean`` times one
call per function per request, with an Exponential gap after every round of requests,
as ``harness/bench_server.py`` does.

The heal loop's side: ``heal_entries_from_eval`` demotes a losing entry to the fastest
vendor variant that passes the 0/1 screen, from the eval's own publication-phase
numbers; ``demote_uncompilable_entries`` demotes a stored kernel config the card cannot
build or launch, through a sentinel-only tuner race, with the error in the entry's
``demotion_reason``.  It is an offline step of ``scripts/reverify_db_torch.py``, never
part of a campaign: an eval that raises is a failure there, not a row to publish.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tpul2_torch.config import SPACE_REV, KernelConfig
from tpul2_torch.dispatch import candidate_fn, config_source, resolve_config
from tpul2_torch.harness import bench_utils as bu
from tpul2_torch.harness.bench_offline import AUTOTUNED, _one_iteration
from tpul2_torch.harness.correctness import CANDIDATE, EXACT_BOUND, zero_one_density
from tpul2_torch.ops import launch_counts, lt_autotune
from tpul2_torch.ops.baselines import BASELINES, VENDOR_VARIANTS, pin_precision, vendor_product
from tpul2_torch.utils.platform import check_device, device_name

#: Publication iterations (each: one call of every column and candidate).
TRIALS = 30
#: Selection iterations (the plain baselines alone).
SEL_TRIALS = 10
#: Summed algo milliseconds of one layout's cuBLASLt search's timed rounds.
LT_BUDGET_MS = 2000.0
#: Requests per function of the server engine, and their mean rate.
N_REQUESTS = 20
TARGET_QPS = 100.0
#: Speedup keys of the published CSV columns; the heal gate runs over all of them.
PUBLISHED_SPEEDUP_KEYS = tuple(BASELINES)
#: How the lean engine's numbers are taken (stamped beside them in the DB).
CLOCK = "cuda_event_per_call"


def _iqr(xs) -> float:
    arr = np.asarray(xs, np.float64)
    return float(np.percentile(arr, 75) - np.percentile(arr, 25))


def cand_name(acc: str) -> str:
    return f"{CANDIDATE}_{acc}"


def _lean(mode: str, m: int, n: int, k: int, accs: Sequence[str], trials: int,
          sel_trials: int, seed: int, device: str, db, target_qps: Optional[float]) -> dict:
    check_device(device, "the lean engine times the card")
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    order_rng = random.Random(seed)
    gap = None
    if mode == "server":
        if not target_qps or target_qps <= 0:
            raise ValueError(f"target_qps must be > 0 in server mode, got {target_qps}")
        gaps = np.random.default_rng((seed, 1))

        def gap():
            time.sleep(float(gaps.exponential(1.0 / target_qps)))

    def rounds(funcs: dict, count: int) -> dict:
        records = {name: [] for name in funcs}
        for _ in range(count):
            for name, ms in _one_iteration(funcs, rng, order_rng, m, n, k, device).items():
                records[name].append(ms)
            if gap is not None:
                gap()
        return records

    # ---- phase 1: selection (the plain baselines alone; the bounded cuBLASLt searches) --
    plain = {pf: fn for pf, fn in BASELINES.items() if pf not in AUTOTUNED}
    data0 = bu.fresh_inputs(rng, m, n, k, device=device)
    for fn in plain.values():
        fn(*data0)
    sel_ms = {name: float(np.median(v))
              for name, v in rounds(plain, max(sel_trials, 1)).items()}
    searches = {}
    if device == "cuda":
        for pf, layout in AUTOTUNED.items():
            found = lt_autotune.search(m, n, k, layout, seed=seed, budget_ms=LT_BUDGET_MS)
            searches[pf] = {"n_algos": found.n_algos, "n_skipped": found.n_skipped,
                            "best": found.best, "timed_rounds": found.timed_rounds,
                            "seconds": found.seconds}
    if db is not None:
        tune_sentinels_from_eval(db, m, n, k, accs, sel_ms, seed=seed, device=device)

    # ---- phase 2: publication (every column and both candidates, interleaved) ----
    funcs = dict(BASELINES)
    for acc in accs:
        funcs[cand_name(acc)] = candidate_fn(acc, mode)
    for fn in funcs.values():
        fn(*data0)  # first calls: kernel builds and config resolution, untimed
    configs = {acc: dataclasses.asdict(resolve_config(m, n, k, acc, mode=mode))
               for acc in accs}
    sources = {acc: config_source(m, n, k, acc, mode=mode) for acc in accs}
    if device == "cuda":
        torch.cuda.synchronize()
    before = launch_counts()
    records = rounds(funcs, trials)
    after = launch_counts()

    per_func = {}
    for name, ms_list in records.items():
        med = float(np.median(ms_list))
        per_func[name] = {"ms": med, "p99_ms": float(np.percentile(ms_list, 99)),
                          "iqr_ms": _iqr(ms_list), "tflops": bu.tflops(m, n, k, med)}
    speedups = {acc: {pf: per_func[pf]["ms"] / per_func[cand_name(acc)]["ms"]
                      for pf in BASELINES} for acc in accs}
    return {"mnk": [m, n, k], "mode": mode, "target_qps": target_qps,
            "per_func": per_func, "speedups": speedups, "sel_ms": sel_ms,
            "configs": configs, "config_source": sources,
            "launches": {key: after[key] - before[key] for key in after
                         if after[key] != before[key]},
            "lt_search": searches, "trials": trials, "sel_trials": sel_trials,
            "clock": CLOCK if device == "cuda" else "host", "device": device_name(device),
            "elapsed_s": time.perf_counter() - t0}


def eval_shape_lean(m: int, n: int, k: int,
                    accs: Sequence[str] = ("float32", "bfloat16"),
                    trials: int = TRIALS,
                    sel_trials: int = SEL_TRIALS,
                    seed: int = 0,
                    device: str = "cuda",
                    db=None) -> dict:
    """Measure the candidates of ``accs`` and every baseline column at one shape.

    Returns {"per_func": {name: {"ms", "p99_ms", "iqr_ms", "tflops"}},
    "speedups": {acc: {baseline: speedup}}, "configs": {acc: the dispatched config},
    "config_source": {acc: ``dispatch.config_source``}, "launches": the kernel launches
    of the publication phase, ...}.  With ``db``, the selection phase also fills the shape's missing or stale sentinel entries
    (``tune_sentinels_from_eval``)."""
    return _lean("offline", m, n, k, accs, trials, sel_trials, seed, device, db, None)


def eval_shape_server_lean(m: int, n: int, k: int,
                           accs: Sequence[str] = ("float32", "bfloat16"),
                           n_requests: int = N_REQUESTS,
                           target_qps: float = TARGET_QPS,
                           sel_trials: int = SEL_TRIALS,
                           seed: int = 0,
                           device: str = "cuda",
                           db=None) -> dict:
    """The server regime of ``eval_shape_lean``: each candidate is its server twin, and
    after every round of one call per function the engine sleeps an Exponential gap of
    mean 1 / target_qps seconds, so each round's requests find the card idle.  ``ms`` is
    the median (p50) per call, with p99 beside it."""
    return _lean("server", m, n, k, accs, n_requests, sel_trials, seed, device, db,
                 target_qps)


# ---------------------------------------------------------------------------
# the vendor sentinel's 0/1 screen, and the choice of a variant
# ---------------------------------------------------------------------------

def screen_variant_exact(variant: str, m: int, n: int, k: int, acc: str, seed: int = 0,
                         device: str = "cuda") -> bool:
    """The 0/1 exactness screen of one vendor variant, by the family's rule.

    The variant runs as dispatch runs it for the candidate (bf16 output).  The f32 family
    passes where the output equals the f32 sum, or the f32 sum after one final bf16
    rounding; the bf16 family where it equals the sum wherever |truth| <= 256.  A
    product that accumulates in bf16 differs from both wherever partial sums pass 256."""
    bf16ish = acc == "bfloat16"
    dens = zero_one_density(k, "bfloat16" if bf16ish else "float32")
    bound = float(EXACT_BOUND["bfloat16" if bf16ish else "float32"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sa = (torch.rand((m, k), generator=gen, device=device) < dens).to(torch.bfloat16)
    sb = (torch.rand((k, n), generator=gen, device=device) < dens).to(torch.bfloat16)
    pin_precision()
    truth = sa.float() @ sb.float()
    out = vendor_product(variant, sa, sb, sb.t().contiguous(), torch.bfloat16).float()
    if not bool(torch.isfinite(out).all()):
        return False
    d = (out - truth).abs()
    if not bf16ish:
        d = torch.minimum(d, (out - truth.to(torch.bfloat16).float()).abs())
    return float(torch.where(truth.abs() <= bound, d, 0.0).max()) == 0.0


def best_screened_variant(ms: dict, m: int, n: int, k: int, acc: str, seed: int = 0,
                          device: str = "cuda") -> Optional[str]:
    """The fastest vendor variant by ``ms`` (name -> milliseconds) that passes the
    family's screen, or None.  Every ``VENDOR_VARIANTS`` entry reduces in f32, so both
    families admit all of them."""
    for name in sorted((v for v in VENDOR_VARIANTS if v in ms), key=ms.get):
        if screen_variant_exact(name, m, n, k, acc, seed, device):
            return name
    return None


def _bookkeeping(ms: float, tm_ms: float, m: int, n: int, k: int) -> dict:
    return {"tflops": bu.tflops(m, n, k, ms), "speedup_vs_torch_matmul": tm_ms / ms,
            "timing_rev": bu.TIMING_REV, "clock": CLOCK}


def tune_sentinels_from_eval(db, m: int, n: int, k: int, accs, sel_ms: dict,
                             seed: int = 0, device: str = "cuda") -> bool:
    """Fill the shape's missing or stale-sentinel entries with the fastest screened
    vendor variant by the selection phase's medians (no extra measurement).  A stored
    kernel winner is left for the tuner.  Returns whether the DB changed."""
    changed = False
    for acc in accs:
        entry = db.get_entry(m, n, k, acc)
        if entry is not None:
            stale = (entry.get("timing_rev", 1) < bu.TIMING_REV
                     or entry.get("space_rev", 1) < SPACE_REV)
            if not (stale and entry["config"].get("use_vendor")):
                continue
        best = best_screened_variant(sel_ms, m, n, k, acc, seed, device)
        if best is None:
            continue
        extra = _bookkeeping(sel_ms[best], sel_ms["torch_matmul"], m, n, k)
        tflops = extra.pop("tflops")
        db.put(m, n, k, KernelConfig.vendor(best), tflops, acc=acc,
               extra={**extra, "torch_matmul_tflops": bu.tflops(m, n, k,
                                                                sel_ms["torch_matmul"]),
                      "space_rev": SPACE_REV, "scope": "sentinels"})
        changed = True
    if changed:
        db.save()
    return changed


def _promote(entry: dict) -> None:
    """An entry stored with no measurement of its own has one now."""
    if not entry.get("measured", True):
        entry["measured"] = True
        if entry.get("scope") == "transfer_static":
            entry["scope"] = "transfer"


def heal_entries_from_eval(db, m: int, n: int, k: int, accs, res: dict,
                           threshold: float = 0.97, max_threshold: float = 0.98,
                           seed: int = 0, mode: str = "offline",
                           device: str = "cuda") -> list:
    """Repair the DB from one eval's publication-phase numbers (the never-lose contract).

    1. Demote on a loss: where the candidate lost to torch.matmul (speedup < ``threshold``)
       or to any published column (< ``max_threshold``; the ``-max`` columns are the
       worse of two draws, so their gate is looser), the shape's config becomes the
       fastest vendor variant that passes the 0/1 screen, and the old one is kept as
       ``demoted_from``.  Where dispatch already runs that variant, only a real loss
       (against torch.matmul) asks for a re-measurement; the config stays.
    2. Refresh the bookkeeping of a sentinel entry (and of a kernel entry that did not
       lose) from the publication medians, and promote an entry stored unmeasured.

    ``mode='server'``: the eval measured the Poisson regime, so demotions and refreshes
    go to the shape's ``server`` sub-entry; the offline entry is never touched.
    Returns the families whose row should be re-measured."""
    per_func = res["per_func"]
    tm_ms = per_func["torch_matmul"]["ms"]
    demoted = []
    changed = False
    for acc in accs:
        entry = db.get_entry(m, n, k, acc)
        sp = res["speedups"][acc]
        lost = (sp.get("torch_matmul", 1.0) < threshold
                or min((sp.get(c, 1.0) for c in PUBLISHED_SPEEDUP_KEYS),
                       default=1.0) < max_threshold)
        server_sub = (entry or {}).get("server") if mode == "server" else None
        live_cfg = (server_sub["config"] if server_sub
                    else entry["config"] if entry else None)
        is_sentinel = bool(live_cfg and live_cfg.get("use_vendor"))
        if lost:
            best = best_screened_variant({v: per_func[v]["ms"] for v in per_func}, m, n, k,
                                         acc, seed, device)
            if best is None:
                continue
            if is_sentinel and live_cfg.get("vendor_variant") == best:
                if sp.get("torch_matmul", 1.0) < threshold:
                    demoted.append(acc)
                continue
            extra = {**_bookkeeping(per_func[best]["ms"], tm_ms, m, n, k),
                     "space_rev": SPACE_REV,
                     "scope": "heal_demote" if mode == "offline" else f"{mode}_heal",
                     "demoted_from": dict(live_cfg) if live_cfg else None}
            if mode == "server":
                db.put_server(m, n, k, KernelConfig.vendor(best), acc=acc, extra=extra)
            else:
                tflops = extra.pop("tflops")
                db.put(m, n, k, KernelConfig.vendor(best), tflops, acc=acc, extra=extra)
            demoted.append(acc)
            changed = True
        elif mode == "server":
            if server_sub and server_sub["config"].get("use_vendor"):
                name = server_sub["config"].get("vendor_variant", "torch_matmul")
                if name in per_func:
                    server_sub.update(_bookkeeping(per_func[name]["ms"], tm_ms, m, n, k))
                    changed = True
        elif is_sentinel:
            name = entry["config"].get("vendor_variant", "torch_matmul")
            if name in per_func:
                entry.update(_bookkeeping(per_func[name]["ms"], tm_ms, m, n, k))
                _promote(entry)
                changed = True
        elif entry is not None and cand_name(acc) in per_func:
            entry.update(_bookkeeping(per_func[cand_name(acc)]["ms"], tm_ms, m, n, k))
            _promote(entry)
            changed = True
    if changed:
        db.save()
    return demoted


def demote_to_fastest_sentinel(db, m: int, n: int, k: int, acc: str, reason: str,
                               device: str = "cuda") -> Optional[str]:
    """Replace the stored winner with the winner of a sentinel-only tuner race
    (``tune_shape(max_candidates=0)``: the vendor variants, with the tuner's own ranking
    and 0/1 screen), keeping ``demoted_from`` and ``demotion_reason``.  Returns the
    adopted variant, or None where the race itself failed (the entry is then left for a
    later pass)."""
    from tpul2_torch.autotune.search import tune_shape
    old = db.get_entry(m, n, k, acc)
    old_cfg = dict(old["config"]) if old else None
    try:
        res = tune_shape(m, n, k, acc=acc, db=db, device=device, max_candidates=0,
                         stage1_rounds=3, stage2_rounds=8, finalists=4, save=True)
    except RuntimeError:
        return None
    entry = db.get_entry(m, n, k, acc)
    entry.update({"demoted_from": old_cfg, "demotion_reason": reason,
                  "scope": "compile_demote"})
    db.save()
    return res.best.vendor_variant


def demote_uncompilable_entries(db, m: int, n: int, k: int, accs, device: str = "cuda",
                                retry_pause_s: float = 1.0) -> list:
    """After an eval failed: demote the shape's stored kernel configs that the card cannot
    build or launch, so the row can be measured instead of dropped.  Runs only if a
    trivial product still runs on the card (the failure is then the config's, not the
    card's); each config gets one retry after ``retry_pause_s``.  Returns the demoted
    families."""
    from tpul2_torch.autotune.search import _make_fn
    try:  # the card is alive
        float((torch.ones((8, 128), device=device) * 2)[0, 0])
    except RuntimeError:
        return []
    demoted = []
    for acc in accs:
        entry = db.get_entry(m, n, k, acc)
        if entry is None or entry["config"].get("use_vendor"):
            continue
        cfg = KernelConfig(**entry["config"])
        a = torch.zeros((m, k), dtype=torch.bfloat16, device=device)
        b = torch.zeros((k, n), dtype=torch.bfloat16, device=device)
        err = None
        for attempt in range(2):
            try:
                float(_make_fn(cfg, torch.bfloat16)(a, b, b.t().contiguous())[0, 0])
                err = None
                break
            except (RuntimeError, ValueError) as e:  # LaunchRefused is a RuntimeError
                err = f"{type(e).__name__}: {str(e)[:160]}"
                if attempt == 0:
                    time.sleep(retry_pause_s)
        if err is None:
            continue
        if demote_to_fastest_sentinel(db, m, n, k, acc, device=device,
                                      reason=f"on-device build/launch failure: {err}"):
            demoted.append(acc)
    return demoted
